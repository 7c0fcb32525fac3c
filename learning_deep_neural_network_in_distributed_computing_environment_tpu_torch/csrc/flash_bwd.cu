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
//   shared tiles (~10x their bound); p and ds stay in registers, rounded
//   only where the TPU kernels round.
//   - bwd_dq_kernel_tc: mma.sync.m16n8k16 (bf16 operands from
//     cp.async-staged tiles read by ldmatrix, fp32 accumulators), in the
//     forward's old arrangement.  One block of 4 warps
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
//   - bwd_dkv_kernel_sm90: designed for this card (wgmma on TMA-fed shared
//     memory, helpers in flash_sm90.cuh), organised around the key block
//     so that Q and dO are read once per 128 keys, not once per 64.  An
//     item is 128 key rows of one (batch, K/V head): two consumer
//     warpgroups of 64 key rows (wgmma's M) and one producer warp a block.
//     The producer loads the item's K and V once, then streams the group's
//     (member, query tile) cells through a four-stage ring: Q and dO by
//     TMA, lse and delta by its lanes' plain loads; each cell feeds every
//     key row of the item.  Per cell S^T = K Q^T and dP^T = V dO^T are
//     wgmma from shared memory, p and ds are fp32 on the accumulators, and
//     dv += p^T dO, dk += ds^T q are wgmma with p^T and ds^T as register A
//     operands (p rounded to dO's dtype, :274; ds to q's, :281) and dO, Q
//     read transposed.  dk and dv sum in registers over the whole group
//     and are written once through the warpgroup's own rows of the K and V
//     tiles by TMA: no atomics, so the pair's bits repeat from run to run.
//     The registers allow one block an SM, so the grid is persistent: the
//     resident blocks walk the items (heaviest first under causal, in
//     alternating order), K and V double-buffered, so the next item's K, V
//     and first cells land while this one is multiplied and stored.  A
//     ragged last query tile is cut to a multiple of 16 rows (vit's 196
//     queries cost 208 columns); causal items start at their diagonal
//     tile, and a warpgroup skips the cells its keys cannot be seen by.
// - fp32, bwd_dq_kernel / bwd_dkv_kernel: the first version's FMA kernels,
//   kept so that fp32 inputs keep full fp32 products (a TF32 product would
//   drop to ~3 decimal digits).  One block per output tile, products from
//   fp32 shared tiles, p and ds through shared memory (probs_and_ds).
#include "flash_sm90.cuh"

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

}  // namespace tc

namespace sm90 {

constexpr int DKV_WG_KEYS = 64;                  // key rows of a consumer warpgroup (wgmma M)
constexpr int DKV_BK = CONSUMERS * DKV_WG_KEYS;  // key rows of a block
constexpr int DKV_STAGES = 4;                    // cells in the Q/dO/lse/delta ring

template <int D>
struct DkvSmem {
  // query rows of a cell: 32 at D = 128 keeps dk, dv, S^T and dP^T in registers
  static constexpr int BQ = D <= 64 ? 64 : 32;
  static constexpr int KV_TILE = Layout<D>::bytes(DKV_BK);
  static constexpr int Q_TILE = Layout<D>::bytes(BQ);
  // K, V of two items (the next item's land while this one's are used),
  // then the cell ring
  static constexpr int Q = 4 * KV_TILE, DO = Q + DKV_STAGES * Q_TILE;
  static constexpr int ROWS = DO + DKV_STAGES * Q_TILE;  // fp32 [stage][lse, delta][BQ]
  static constexpr int TILES = ROWS + DKV_STAGES * 2 * BQ * 4;
  static constexpr int BARRIERS = 4 + 2 * DKV_STAGES;
  static constexpr size_t BYTES = TILES + BARRIERS * 8 + 1024;  // + the alignment of the tiles
};

// One cell of NQ query rows (BQ, or 16/32/48 for a ragged last tile) for
// the warpgroup's 64 key rows from kw: S^T = K Q^T and dP^T = V dO^T, p and
// ds on the accumulators, dv += p^T dO and dk += ds^T q.
template <int D, int NQ>
__device__ __forceinline__ void dkv_cell(float (&dk)[D / 2], float (&dv)[D / 2], uint32_t sk,
                                         uint32_t sv, uint32_t sq, uint32_t sdo,
                                         const float* rows, int q0, int kw, int Lq, int Lk,
                                         int causal, float scale) {
  constexpr int BQ = DkvSmem<D>::BQ;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  float s[NQ / 2], dp[NQ / 2];
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) s[i] = dp[i] = 0.f;
  hold(s);
  hold(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<NQ>(s, desc_k<D>(sk, DKV_BK, wg * DKV_WG_KEYS, kk), desc_k<D>(sq, BQ, 0, kk),
                 kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<NQ>(dp, desc_k<D>(sv, DKV_BK, wg * DKV_WG_KEYS, kk), desc_k<D>(sdo, BQ, 0, kk),
                 kk > 0);
  wgmma_commit();
  wgmma_wait();
  hold(s);
  hold(dp);

  // p = exp(s scale - lse), ds = p (dp - delta) scale, in fp32; masked
  // pairs (causal, ragged keys or queries) get p = ds = 0
  const float sl2 = scale * LOG2E;
  const int kr = kw + warp * 16 + gid;  // this thread's key rows: kr, kr + 8
  const bool edge = (causal && kw + DKV_WG_KEYS - 1 > q0) || kw + DKV_WG_KEYS > Lk ||
                    q0 + NQ > Lq;
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qc = j * 8 + tig * 2 + (e & 1), kpos = kr + (e >> 1) * 8;
      float p = exp2_fast(fmaf(s[4 * j + e], sl2, -rows[qc] * LOG2E));
      if (edge && !(q0 + qc < Lq && visible(q0 + qc, kpos, Lk, causal))) p = 0.f;
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - rows[BQ + qc]) * scale;
    }

  // dv += p^T dO and dk += ds^T q, p and ds rounded to bf16 in registers
  // (dO's and q's dtype), dO and Q read transposed
  uint32_t pa[NQ / 16][4], da[NQ / 16][4];
#pragma unroll
  for (int kq = 0; kq < NQ / 16; ++kq) {
    a_from_acc(pa[kq], s, kq);
    a_from_acc(da[kq], dp, kq);
  }
  hold(dk);
  hold(dv);
  hold(pa);
  hold(da);
  wgmma_fence();
#pragma unroll
  for (int kq = 0; kq < NQ / 16; ++kq) {
    wgmma_rs_tb<D>(dv, pa[kq], desc_mn<D>(sdo, BQ, kq));
    wgmma_rs_tb<D>(dk, da[kq], desc_mn<D>(sq, BQ, kq));
  }
  wgmma_commit();
  wgmma_wait();
  hold(dk);
  hold(dv);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdk,
                    const __grid_constant__ CUtensorMap tdv, const float* __restrict__ lse,
                    const float* __restrict__ delta, int B, int H, int KV, int Lq, int Lk,
                    int causal, float scale) {
  static_assert(sizeof(T) == 2, "the bf16 instance");
  using S = DkvSmem<D>;
  constexpr int BQ = S::BQ;
  extern __shared__ __align__(16) unsigned char smem_dkv[];
  const uint32_t raw = smem_addr(smem_dkv);
  const uint32_t tiles = (raw + S::BARRIERS * 8 + 1023) & ~1023u;
  unsigned char* tiles_p = smem_dkv + (tiles - raw);
  float* rows_p = reinterpret_cast<float*>(tiles_p + S::ROWS);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem_dkv);  // [2]
  uint64_t* kv_empty = kv_full + 2;                            // [2]
  uint64_t* cell_full = kv_empty + 2;                          // [DKV_STAGES]
  uint64_t* cell_empty = cell_full + DKV_STAGES;               // [DKV_STAGES]

  const int rep = H / KV;
  const int nq = (Lq + BQ - 1) / BQ, nkb = (Lk + DKV_BK - 1) / DKV_BK;
  const int items = nkb * KV * B;
  // item i: key block i / (KV B) of K/V head i % KV of batch (i / KV) % B, so
  // under causal the items come heaviest first (the first key block sees
  // every query tile); its cells: member c / ntv, query tile t0 + c % ntv,
  // for c < rep ntv.  Block x takes item k G + x in even turns k and
  // k G + G - 1 - x in odd ones (G blocks), which evens out the blocks'
  // loads when the items' costs fall.
  struct Item {
    int k0, g, b, t0, ntv;
  };
  auto item = [&](int i) {
    Item it;
    it.k0 = (i / (KV * B)) * DKV_BK;
    it.g = i % KV;
    it.b = (i / KV) % B;
    // causal: query tile t sees the block's keys iff t BQ + BQ - 1 >= k0
    it.t0 = causal ? min(it.k0 / BQ, nq) : 0;
    it.ntv = nq - it.t0;
    return it;
  };
  auto turn = [&](int k) {  // this block's item in its k-th turn
    return k * gridDim.x + (k & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(&kv_full[i], 1);
      bar_init(&kv_empty[i], CONSUMERS);  // thread 0 of each consumer warpgroup
    }
    for (int i = 0; i < DKV_STAGES; ++i) {
      bar_init(&cell_full[i], 32);              // the producer warp's lanes
      bar_init(&cell_empty[i], CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / 32 == PRODUCER_WARP) {
    const int lane = threadIdx.x % 32;
    int cc = 0;  // cells streamed so far
    for (int n = 0, i = turn(0); i < items; i = turn(++n)) {
      const Item it = item(i);
      const int buf = n & 1;
      if (lane == 0) {
        // the buffer's last item has been stored out of it
        bar_wait(&kv_empty[buf], ((n >> 1) & 1) ^ 1);
        bar_arrive_tx(&kv_full[buf], 2 * S::KV_TILE);
        for (int w = 0; w < CONSUMERS; ++w) {
          const uint32_t at = tiles + buf * 2 * S::KV_TILE + w * DKV_WG_KEYS * Layout<D>::ROW;
          const int row0 = it.k0 + w * DKV_WG_KEYS;
          load_tile<D>(at, &tk, &kv_full[buf], DKV_BK, it.g, row0, it.b);
          load_tile<D>(at + S::KV_TILE, &tv, &kv_full[buf], DKV_BK, it.g, row0, it.b);
        }
      }
      for (int c = 0; c < rep * it.ntv; ++c, ++cc) {
        const int st = cc % DKV_STAGES;
        const int h = it.g * rep + c / it.ntv, q0 = (it.t0 + c % it.ntv) * BQ;
        bar_wait(&cell_empty[st], ((cc / DKV_STAGES) & 1) ^ 1);
        float* sl = rows_p + st * 2 * BQ;
        const long long at = ((long long)it.b * H + h) * Lq + q0;
        for (int r = lane; r < BQ; r += 32) {
          const bool ok = q0 + r < Lq;
          sl[r] = ok ? lse[at + r] : 0.f;
          sl[BQ + r] = ok ? delta[at + r] : 0.f;
        }
        if (lane == 0) {
          bar_arrive_tx(&cell_full[st], 2 * S::Q_TILE);
          load_tile<D>(tiles + S::Q + st * S::Q_TILE, &tq, &cell_full[st], BQ, h, q0, it.b);
          load_tile<D>(tiles + S::DO + st * S::Q_TILE, &tdo, &cell_full[st], BQ, h, q0, it.b);
        } else {
          bar_arrive(&cell_full[st]);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;
  int cc = 0;  // cells consumed so far
  for (int n = 0, i = turn(0); i < items; i = turn(++n)) {
    const Item it = item(i);
    const int buf = n & 1;
    const int kw = it.k0 + wg * DKV_WG_KEYS;  // this warpgroup's first key row
    const uint32_t sk = tiles + buf * 2 * S::KV_TILE, sv = sk + S::KV_TILE;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.f;
    bar_wait(&kv_full[buf], (n >> 1) & 1);
    if (leader && n > 0) {
      // the previous item's dk/dv have left the other buffer: hand it back
      tma_store_wait();
      bar_arrive(&kv_empty[buf ^ 1]);
    }
    for (int c = 0; c < rep * it.ntv; ++c, ++cc) {
      const int st = cc % DKV_STAGES;
      const int q0 = (it.t0 + c % it.ntv) * BQ, rows = min(BQ, Lq - q0);
      bar_wait(&cell_full[st], (cc / DKV_STAGES) & 1);
      // causal: a cell whose queries all precede this warpgroup's keys adds nothing
      if (!(causal && q0 + rows - 1 < kw)) {
        const uint32_t sq = tiles + S::Q + st * S::Q_TILE, sdo = tiles + S::DO + st * S::Q_TILE;
        const float* sl = rows_p + st * 2 * BQ;
        const int n16 = (rows + 15) / 16;
        if (n16 == 1) {
          dkv_cell<D, 16>(dk, dv, sk, sv, sq, sdo, sl, q0, kw, Lq, Lk, causal, scale);
        } else if (n16 == 2 || BQ == 32) {
          dkv_cell<D, 32>(dk, dv, sk, sv, sq, sdo, sl, q0, kw, Lq, Lk, causal, scale);
        } else if constexpr (BQ == 64) {
          if (n16 == 3)
            dkv_cell<D, 48>(dk, dv, sk, sv, sq, sdo, sl, q0, kw, Lq, Lk, causal, scale);
          else
            dkv_cell<D, 64>(dk, dv, sk, sv, sq, sdo, sl, q0, kw, Lq, Lk, causal, scale);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&cell_empty[st]);
    }

    // dk and dv into this warpgroup's rows of the item's K and V tiles
    // (only this warpgroup reads them, and its last product is done), in
    // the layout they came in, then out by TMA (rows past Lk are not
    // written); the buffer goes back to the producer once TMA has read it
    unsigned char* kp = tiles_p + buf * 2 * S::KV_TILE;
    const int row = wg * DKV_WG_KEYS + warp * 16 + gid;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tig * 2;
      const uint32_t lo = swizzled<D>(DKV_BK, row, col), hi = swizzled<D>(DKV_BK, row + 8, col);
      *reinterpret_cast<uint32_t*>(kp + lo) = pack_bf16(dk[4 * j], dk[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(kp + hi) = pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(kp + S::KV_TILE + lo) = pack_bf16(dv[4 * j], dv[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(kp + S::KV_TILE + hi) =
          pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
    }
    fence_async_smem();
    warpgroup_sync(wg);
    if (leader) {
      const uint32_t at = wg * DKV_WG_KEYS * Layout<D>::ROW;
      store_tile<D>(&tdk, sk + at, DKV_BK, it.g, kw, it.b);
      store_tile<D>(&tdv, sv + at, DKV_BK, it.g, kw, it.b);
      tma_store_commit();
    }
  }
  if (leader) tma_store_wait();
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, void* dk, void* dv, int B, int H, int KV, int Lq, int Lk,
        long long sqb, long long sql, long long sqh, long long skb, long long skl,
        long long skh, long long svb, long long svl, long long svh, long long sdb,
        long long sdl, long long sdh, int causal, float scale, void* stream) {
  using S = DkvSmem<D>;
  const long long pb = (long long)Lk * KV * D, pl = (long long)KV * D;  // dk/dv: contiguous
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  int err = encode<D>(&tq, q, B, Lq, H, sqb, sql, sqh, S::BQ);
  if (!err) err = encode<D>(&tdo, dout, B, Lq, H, sdb, sdl, sdh, S::BQ);
  if (!err) err = encode<D>(&tk, k, B, Lk, KV, skb, skl, skh, DKV_WG_KEYS);
  if (!err) err = encode<D>(&tv, v, B, Lk, KV, svb, svl, svh, DKV_WG_KEYS);
  if (!err) err = encode<D>(&tdk, dk, B, Lk, KV, pb, pl, D, DKV_WG_KEYS);
  if (!err) err = encode<D>(&tdv, dv, B, Lk, KV, pb, pl, D, DKV_WG_KEYS);
  if (err) return err;
  auto kernel = bwd_dkv_kernel_sm90<bf16, D>;
  constexpr size_t smem = S::BYTES;
  static const int per_sm = resident_blocks(kernel, smem);
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  cudaError_t set = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (set != cudaSuccess) return (int)set;
  // persistent: the resident blocks walk the (key block, K/V head, batch)
  // items
  const int items = (Lk + DKV_BK - 1) / DKV_BK * KV * B;
  const dim3 grid(std::min(items, sm_count() * per_sm));
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(tq, tk, tv, tdo, tdk, tdv, lse, delta,
                                                         B, H, KV, Lq, Lk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace sm90

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
    FLASH_HEAD_DIM(head_dim, {
      return sm90::dkv<D>(q, k, v, dout, lse, delta, dk, dv, B, H, KV, Lq, Lk, sqb, sql, sqh,
                          skb, skl, skh, svb, svl, svh, sdb, sdl, sdh, causal, scale, stream);
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
