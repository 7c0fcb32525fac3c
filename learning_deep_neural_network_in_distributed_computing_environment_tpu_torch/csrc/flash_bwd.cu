// Flash-attention backward for Hopper (sm_90a), written by hand: the
// two-pass FlashAttention-2 construction, the default backward (as in the
// JAX package, FLASH_BWD unset).
//
// Replaces: ops/pallas_ops.py::_bwd_dq_kernel (flash_bwd_dq) and
// ::_bwd_dkv_kernel (flash_bwd_dkv) of the JAX package, reached via
// _flash_backward.
//
// What they compute, from q, k, v, dO, the forward's lse and
// delta = rowsum(dO * O) (computed outside, as in the JAX package):
//   p  = exp(q k^T * scale - lse)            (recomputed by each pass)
//   ds = p * (dO v^T - delta) * scale
//   dq = ds k                                 (flash_bwd_dq)
//   dv = p^T dO,  dk = ds^T q                 (flash_bwd_dkv)
// For grouped-query attention dk/dv of a K/V head sum over its H / KV
// query heads.  Every block keeps its accumulators in registers for its
// whole loop and writes each output once: nothing is carried between
// blocks, no atomics are needed, and the results are the same bits from
// run to run.
//
// Two instances of each, chosen by dtype in the C entry points below:
// - bf16, the tensor-core kernels every backward of the gpt2 path runs.
//   At its shape (B=64, L=128, H=12, D=64, causal) dq does 3 and dkv 4
//   products per visible (query, key) pair, 2.4 and 3.2 GFLOP against
//   ~64 and ~76 MB of inputs and outputs, so both are bound by bytes
//   (~19 and ~23 us at 3.35 TB/s; the bf16 tensor cores need ~3 us).  The
//   first versions ran every product on the fp32 FMA pipes from fp32
//   shared tiles (~10x their bound); here every product is
//   mma.sync.m16n8k16 (bf16 operands from cp.async-staged tiles read by
//   ldmatrix, fp32 accumulators), and p and ds stay in registers, rounded
//   only where the TPU kernels round.
//   - bwd_dq_kernel_tc: the forward's arrangement.  One block of 4 warps
//     per (64-row query tile, query head, batch), each warp owning 16 query
//     rows; Q and dO are staged once, lse and delta of the lane's two rows
//     live in registers, and K/V stream through a two-stage cp.async ring
//     over the key tiles, stopping at the last visible one under causal
//     (each warp skips the 16-key slices its rows cannot see).  Per key
//     tile S = Q K^T and dP = dO V^T come out in C fragments (K and V read
//     by non-transposed ldmatrix), p and ds are fp32 on them, and ds packed
//     to bf16 (k's dtype, pallas_ops.py:227) is the A fragment of
//     dq += ds K, with K read by transposed ldmatrix from the same staged
//     tile: ds never touches shared memory.  dq is written once, as bf16,
//     through the warp's own rows of the Q tile as 16-byte stores.
//   - bwd_dkv_kernel_tc: bwd_kv_body<D, false> (flash_bwd_kv.cuh), the
//     fused kernel's FA-2 body without its dq: one block per (64-row key
//     tile, K/V head, batch), warps owning key rows, the group's (member,
//     query tile) cells streaming through a Q/dO/lse/delta ring, and
//     dv += p^T dO, dk += ds^T q fed from registers (p rounded to dO's
//     dtype, :274; ds to q's, :281).  Without ds^T in shared memory and
//     the dq cell it needs less of both than the fused kernel: 3 blocks
//     per SM at D <= 64 (DkvOccupancy) where the fused kernel fits 2.
// - fp32, bwd_dq_kernel / bwd_dkv_kernel: the first version's FMA kernels,
//   kept so that fp32 inputs keep full fp32 products (a TF32 product would
//   drop to ~3 decimal digits).  One block per output tile, products from
//   fp32 shared tiles, p and ds through shared memory (probs_and_ds).
#include "flash_bwd_kv.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int H, int KV, int Lq, int Lk,
              long long sqb, long long sql, long long sqh, long long skb, long long skl,
              long long skh, long long svb, long long svl, long long svh, long long sdb,
              long long sdl, long long sdh, int causal, float scale) {
  constexpr int LD = Tile<D>::LD, DJ = Tile<D>::DJ;
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][LD]
  float* sdO = sQ + BQ * LD;     // [BQ][LD]
  float* sK = sdO + BQ * LD;     // [BK][LD]
  float* sV = sK + BK * LD;      // [BK][LD]
  float* sDS = sV + BK * LD;     // [BQ][LS]
  float* sLse = sDS + BQ * LS;   // [BQ]
  float* sDelta = sLse + BQ;     // [BQ]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<T, D>(sQ, q + b * sqb + h * sqh, sql, q0, BQ, Lq);
  load_rows<T, D>(sdO, dout + b * sdb + h * sdh, sdl, q0, BQ, Lq);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const bool in = q0 + r < Lq;
    const long long at = ((long long)b * H + h) * Lq + q0 + r;
    sLse[r] = in ? lse[at] : 0.f;
    sDelta[r] = in ? delta[at] : 0.f;
  }
  const T* kb = k + b * skb + g * skh;
  const T* vb = v + b * svb + g * svh;

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int nk = (Lk + BK - 1) / BK;
  const int kt_end = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers are done with sK/sV/sDS
    load_rows<T, D>(sK, kb, skl, k0, BK, Lk);
    load_rows<T, D>(sV, vb, svl, k0, BK, Lk);
    __syncthreads();
    probs_and_ds<D>(sQ, sdO, sK, sV, sLse, sDelta, nullptr, sDS, q0, k0, Lk, causal, scale);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[4], kk[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sDS[(ty * 4 + i) * LS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kk[j] = sK[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= Lq) continue;
    T* row = dq + (((long long)b * Lq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
               int KV, int Lq, int Lk, long long sqb, long long sql, long long sqh, long long skb,
               long long skl, long long skh, long long svb, long long svl, long long svh,
               long long sdb, long long sdl, long long sdh, int causal, float scale) {
  constexpr int LD = Tile<D>::LD, DJ = Tile<D>::DJ;
  extern __shared__ float smem[];
  float* sK = smem;              // [BK][LD]
  float* sV = sK + BK * LD;      // [BK][LD]
  float* sQ = sV + BK * LD;      // [BQ][LD]
  float* sdO = sQ + BQ * LD;     // [BQ][LD]
  float* sP = sdO + BQ * LD;     // [BQ][LS]
  float* sDS = sP + BQ * LS;     // [BQ][LS]
  float* sLse = sDS + BQ * LS;   // [BQ]
  float* sDelta = sLse + BQ;     // [BQ]

  const int kt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = H / KV;
  const int k0 = kt * BK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<T, D>(sK, k + b * skb + g * skh, skl, k0, BK, Lk);
  load_rows<T, D>(sV, v + b * svb + g * svh, svl, k0, BK, Lk);

  // this thread owns key rows ty*4+i, head-dim columns tx+16j of dk and dv
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (Lq + BQ - 1) / BQ;
  // causal: query tile i sees this key tile iff i*BQ + BQ - 1 >= k0,
  // i.e. i >= floor(k0 / BQ)
  const int qt_begin = causal ? k0 / BQ : 0;
  for (int m = 0; m < rep; ++m) {
    const int h = g * rep + m;
    const T* qb = q + b * sqb + h * sqh;
    const T* db = dout + b * sdb + h * sdh;
    for (int qt = qt_begin; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // previous tile's readers are done with sQ/sdO/sP/sDS
      load_rows<T, D>(sQ, qb, sql, q0, BQ, Lq);
      load_rows<T, D>(sdO, db, sdl, q0, BQ, Lq);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        const bool in = q0 + r < Lq;
        const long long at = ((long long)b * H + h) * Lq + q0 + r;
        sLse[r] = in ? lse[at] : 0.f;
        sDelta[r] = in ? delta[at] : 0.f;
      }
      __syncthreads();
      probs_and_ds<D>(sQ, sdO, sK, sV, sLse, sDelta, sP, sDS, q0, k0, Lk, causal, scale);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float p[4], ds[4], go[DJ], qq[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = sP[r * LS + ty * 4 + i];
          ds[i] = sDS[r * LS + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          go[j] = sdO[r * LD + tx + 16 * j];
          qq[j] = sQ[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv_acc[i][j] = fmaf(p[i], go[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ds[i], qq[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= Lk) continue;
    const long long at = (((long long)b * Lk + kpos) * KV + g) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[at + tx + 16 * j] = from_f<T>(dk_acc[i][j]);
      dv[at + tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}


namespace tc {

constexpr int DQ_BQ = 64;  // query rows per block, 16 per warp
constexpr int DQ_BK = 64;  // key rows per stage of the K/V ring

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int H, int KV, int Lq, int Lk, long long sqb,
                 long long sql, long long sqh, long long skb, long long skl, long long skh,
                 long long svb, long long svl, long long svh, long long sdb, long long sdl,
                 long long sdh, int causal, float scale) {
  constexpr int BQ = DQ_BQ, BK = DQ_BK, LD = Pad<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);  // [BQ][LD]; the dq tile at the end
  bf16* sdO = sQ + BQ * LD;                     // [BQ][LD]
  bf16* sK = sdO + BQ * LD;                     // [2][BK][LD] ring
  bf16* sV = sK + 2 * BK * LD;                  // [2][BK][LD] ring

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wrow = warp * 16;  // this warp's first query row in the tile

  const bf16* kb = k + b * skb + g * skh;
  const bf16* vb = v + b * svb + g * svh;
  const int nk = (Lk + BK - 1) / BK;
  // causal: key tiles past the tile's last query row are fully masked
  const int kt_end = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;

  copy_rows<D, BQ>(sQ, q + b * sqb + h * sqh, sql, q0, Lq);
  copy_rows<D, BQ>(sdO, dout + b * sdb + h * sdh, sdl, q0, Lq);
  copy_rows<D, BK>(sK, kb, skl, 0, Lk);
  copy_rows<D, BK>(sV, vb, svl, 0, Lk);
  cp_async_commit();

  // rows gid (i = 0) and gid + 8 (i = 1): lse in log2 units, and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + wrow + gid + 8 * i;
    const long long at = ((long long)b * H + h) * Lq + qpos;
    lse2[i] = qpos < Lq ? lse[at] * LOG2E : 0.f;
    dlt[i] = qpos < Lq ? delta[at] : 0.f;
  }
  float acc[D / 8][4];  // dq rows gid (c0, c1) and gid + 8 (c2, c3), 8 columns per n-tile
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float sl2 = scale * LOG2E;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kt_end) {  // the next tile into the other stage
      copy_rows<D, BK>(sK + (st ^ 1) * BK * LD, kb, skl, (kt + 1) * BK, Lk);
      copy_rows<D, BK>(sV + (st ^ 1) * BK * LD, vb, svl, (kt + 1) * BK, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and Q, dO) has landed for every thread
    const bf16* cK = sK + st * BK * LD;
    const bf16* cV = sV + st * BK * LD;
    const int k0 = kt * BK;
    // causal: the last column of this tile any row of this warp can see;
    // 16-key slices past it are skipped (their p and ds are exactly 0)
    const int kmax = causal ? q0 + wrow + 15 - k0 : BK - 1;

    // S = Q K^T and dP = dO V^T: this warp's 16 query rows x BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, a_addr<LD>(sQ, wrow, kk * 16, lane));
      ldsm_x4(da, a_addr<LD>(sdO, wrow, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        if (np * 16 > kmax) continue;
        uint32_t f[4];
        ldsm_x4(f, bt_addr<LD>(cK, np * 16, kk * 16, lane));
        mma(s[2 * np], qa, f[0], f[1]);
        mma(s[2 * np + 1], qa, f[2], f[3]);
        ldsm_x4(f, bt_addr<LD>(cV, np * 16, kk * 16, lane));
        mma(dp[2 * np], da, f[0], f[1]);
        mma(dp[2 * np + 1], da, f[2], f[3]);
      }
    }

    // p = exp(s scale - lse), ds = p (dp - delta) scale, in fp32; masked
    // pairs (causal, ragged keys) get p = ds = 0 on the diagonal and
    // ragged tiles
    const bool edge = (causal && k0 + BK - 1 > q0 + wrow) || k0 + BK > Lk;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kpos = k0 + j * 8 + tig * 2 + (e & 1);
        float p = exp2_fast(fmaf(s[j][e], sl2, -lse2[i]));
        if (edge && !visible(q0 + wrow + gid + 8 * i, kpos, Lk, causal)) p = 0.f;
        dp[j][e] = p * (dp[j][e] - dlt[i]) * scale;
      }

    // dq += ds K, ds rounded to bf16 (k's dtype) in registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kk * 16 > kmax) continue;
      uint32_t a[4];
      c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t f[4];
        ldsm_x4_t(f, bn_addr<LD>(cK, dn * 16, kk * 16, lane));
        mma(acc[2 * dn], a, f[0], f[1]);
        mma(acc[2 * dn + 1], a, f[2], f[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  cp_async_wait<0>();

  // dq through this warp's own rows of sQ (no other warp reads them), then
  // out as 16-byte row chunks
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    bf16* at = sQ + (wrow + gid) * LD + j * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(at + 8 * LD) = pack_bf16(acc[j][2], acc[j][3]);
  }
  __syncwarp();
  constexpr int CHUNKS = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const int qpos = q0 + wrow + r;
    if (qpos < Lq)
      *reinterpret_cast<uint4*>(dq + (((long long)b * Lq + qpos) * H + h) * D + c) =
          *reinterpret_cast<const uint4*>(sQ + (wrow + r) * LD + c);
  }
}

// Blocks per SM asked of ptxas for bwd_dkv_kernel_tc.  At D <= 64, 3 caps
// the registers at 168 so that 3 blocks of 4 warps share an SM (56 KB of
// shared memory each at D=64; uncapped, 180 registers allow 2), which ran
// faster at every shape chip_smoke.py times despite 56 bytes of spill
// stores at D=64, and gave the same bits.  At D = 128 the cap would spill heavily, so
// it asks for none.
template <int D>
struct DkvOccupancy {
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 1;
};

template <int D>
__global__ void __launch_bounds__(THREADS, DkvOccupancy<D>::MIN_BLOCKS)
bwd_dkv_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV, int Lq, int Lk,
                  long long sqb, long long sql, long long sqh, long long skb, long long skl,
                  long long skh, long long svb, long long svl, long long svh, long long sdb,
                  long long sdl, long long sdh, int causal, float scale) {
  bwd_kv_body<D, false>(q, k, v, dout, lse, delta, nullptr, dk, dv, H, KV, Lq, Lk, sqb, sql, sqh,
                        skb, skl, skh, svb, svl, svh, sdb, sdl, sdh, causal, scale);
}

}  // namespace tc

}  // namespace flash

// q/dout [B, Lq, H, D], k/v [B, Lk, KV, D] (strided; head_dim contiguous;
// for bf16 the batch/seq/head strides and the base are 16-byte aligned,
// see ops/flash.py); lse/delta contiguous fp32 [B, H, Lq]; dq contiguous
// [B, Lq, H, D] in the input dtype.  Returns the launch status.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq, int dtype, int B,
                            int H, int KV, int Lq, int Lk, int head_dim, long long sqb,
                            long long sql, long long sqh, long long skb, long long skl,
                            long long skh, long long svb, long long svl, long long svh,
                            long long sdb, long long sdl, long long sdh, int causal,
                            float scale, void* stream) {
  using namespace flash;
  if (dtype == FLASH_DTYPE_BF16) {
    using tc::bf16;
    const dim3 grid((Lq + tc::DQ_BQ - 1) / tc::DQ_BQ, H, B);
    FLASH_HEAD_DIM(head_dim, {
      const size_t smem = sizeof(bf16) * (2 * tc::DQ_BQ + 4 * tc::DQ_BK) * tc::Pad<D>::LD;
      return tc::launch(tc::bwd_dq_kernel_tc<D>, grid, smem, stream, (const bf16*)q,
                        (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, (bf16*)dq,
                        H, KV, Lq, Lk, sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sdb, sdl,
                        sdh, causal, scale);
    });
  } else if (dtype == FLASH_DTYPE_F32) {
    const dim3 grid((Lq + BQ - 1) / BQ, H, B);
    FLASH_HEAD_DIM(head_dim, {
      constexpr int LD = Tile<D>::LD;
      const size_t smem = sizeof(float) * (2 * BQ * LD + 2 * BK * LD + BQ * LS + 2 * BQ);
      return launch(bwd_dq_kernel<float, D>, grid, smem, stream, (const float*)q,
                    (const float*)k, (const float*)v, (const float*)dout, lse, delta, (float*)dq,
                    H, KV, Lq, Lk, sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sdb, sdl, sdh,
                    causal, scale);
    });
  }
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq; dk/dv contiguous [B, Lk, KV, D] in the input dtype.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv,
                             int dtype, int B, int H, int KV, int Lq, int Lk, int head_dim,
                             long long sqb, long long sql, long long sqh, long long skb,
                             long long skl, long long skh, long long svb, long long svl,
                             long long svh, long long sdb, long long sdl, long long sdh,
                             int causal, float scale, void* stream) {
  using namespace flash;
  if (dtype == FLASH_DTYPE_BF16) {
    using tc::bf16;
    const dim3 grid((Lk + tc::BWD_BK - 1) / tc::BWD_BK, KV, B);
    FLASH_HEAD_DIM(head_dim, {
      return tc::launch(tc::bwd_dkv_kernel_tc<D>, grid, tc::bwd_kv_smem<D, false>(), stream,
                        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
                        delta, (bf16*)dk, (bf16*)dv, H, KV, Lq, Lk, sqb, sql, sqh, skb, skl,
                        skh, svb, svl, svh, sdb, sdl, sdh, causal, scale);
    });
  } else if (dtype == FLASH_DTYPE_F32) {
    const dim3 grid((Lk + BK - 1) / BK, KV, B);
    FLASH_HEAD_DIM(head_dim, {
      constexpr int LD = Tile<D>::LD;
      const size_t smem = sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BQ * LS + 2 * BQ);
      return launch(bwd_dkv_kernel<float, D>, grid, smem, stream, (const float*)q,
                    (const float*)k, (const float*)v, (const float*)dout, lse, delta,
                    (float*)dk, (float*)dv, H, KV, Lq, Lk, sqb, sql, sqh, skb, skl, skh, svb,
                    svl, svh, sdb, sdl, sdh, causal, scale);
    });
  }
  return (int)cudaErrorInvalidValue;
}
