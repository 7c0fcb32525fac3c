// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces: ops/pallas_ops.py::_flash_kernel (and its no-lse twin
// _fwd_kernel_nolse) of the JAX package, reached via _flash_forward.
//
// What it computes: O = softmax(Q K^T / sqrt(D)) V per (batch, query head),
// with K/V head h / (H / KV) for grouped-query attention, and optionally
// the per-row log-sum-exp lse = m + log(l) as fp32 [B, H, Lq] (the TPU
// kernel's 128-lane broadcast is dropped).
//
// Two instances, chosen by dtype in flash_fwd() below:
// - bf16, fwd_kernel_tc: the tensor-core kernel, the one both training
//   paths run.  At the main-path shape (B=64, L=128, H=12, D=64, causal) the
//   work is ~1.6 GFLOP against ~50 MB of q/k/v/o, so it is bound by bytes
//   (~15 us at 3.35 TB/s); at L=2048 the visible pairs make it bound by
//   the bf16 tensor-core rate.  S = Q K^T and O += P V run as
//   mma.sync.m16n8k16 (bf16 operands, fp32 accumulators), rounding where
//   the TPU kernel rounds: p is cast to v's dtype before P V
//   (pallas_ops.py:104), and the softmax state, l and O stay fp32.
// - fp32, fwd_kernel: the first version's FMA kernel, kept as it was so
//   that fp32 inputs keep full fp32 products (a TF32 tensor-core product
//   would drop to ~3 decimal digits).
//
// The tensor-core design: one block of 4 warps per (64-row query tile,
// head, batch), each warp owning 16 query rows; the TPU's sequential K/V
// grid axis becomes a loop over 64-row key tiles.  Q, K and V are staged
// as bf16 by 16-byte cp.async, K/V through a two-stage ring so tile j+1
// lands while tile j is multiplied (two __syncthreads per tile: one when
// it has landed, one before its stage is refilled).  Q's fragments are
// read once into registers.  The scores stay in the C fragments of Q K^T:
// the online softmax (row max and sum by quad shuffles) runs on them and
// they are packed to bf16 straight into the A fragments of P V, so S and
// P never touch shared memory; each exp is one MUFU ex2 with the scale
// folded into an fma ahead of it.  Under causal the loop stops at the last
// key tile with a visible key, each warp skips the 16-key slices its rows
// cannot see, and diagonal and ragged tiles are masked element-wise.  O is
// staged through the warp's own rows of the Q tile and stored as 16-byte
// rows.  With mma.sync rather than wgmma a warp issues its own products
// from ldmatrix fragments, which keeps the 16-row-per-warp softmax simple;
// wgmma, TMA and warp specialisation are later work.
#include "flash_mma.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int H, int KV, int Lq, int Lk,
           long long sqb, long long sql, long long sqh, long long skb, long long skl,
           long long skh, long long svb, long long svl, long long svh, int causal,
           float scale) {
  constexpr int LD = Tile<D>::LD, DJ = Tile<D>::DJ;
  extern __shared__ float smem[];
  float* sQ = smem;               // [BQ][LD]
  float* sK = sQ + BQ * LD;       // [BK][LD]
  float* sV = sK + BK * LD;       // [BK][LD]
  float* sP = sV + BK * LD;       // [BQ][LS] scores, then probabilities
  float* sCorr = sP + BQ * LS;    // [BQ] rescale of each row for this tile
  float* sM = sCorr + BQ;         // [BQ] final running max
  float* sL = sM + BQ;            // [BQ] final denominator

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // softmax phase: 4 consecutive lanes own one row, 16 columns each
  const int srow = threadIdx.x / 4, spart = threadIdx.x % 4;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + g * skh;
  const T* vb = v + b * svb + g * svh;
  load_rows<T, D>(sQ, qb, sql, q0, BQ, Lq);

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  float m_i = -INFINITY, l_i = 0.f;

  const int nk = (Lk + BK - 1) / BK;
  // causal: key tiles past the tile's last query row are fully masked
  const int kt_end = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with sK/sV/sP
    load_rows<T, D>(sK, kb, skl, k0, BK, Lk);
    load_rows<T, D>(sV, vb, svl, k0, BK, Lk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        sP[r * LS + c] = visible(q0 + r, k0 + c, Lk, causal) ? s[i][j] * scale : -INFINITY;
      }
    __syncthreads();

    {  // online softmax over this tile's 64 columns of row srow
      float* row = sP + srow * LS + spart * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i, mx);
      float corr = 1.f, sum = 0.f;
      if (m_new == -INFINITY) {  // nothing visible yet in this row
#pragma unroll
        for (int c = 0; c < 16; ++c) row[c] = 0.f;
      } else {
        corr = expf(m_i - m_new);
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float p = expf(row[c] - m_new);
          row[c] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_i = l_i * corr + sum;
      m_i = m_new;
      if (spart == 0) sCorr[srow] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = sCorr[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= cr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * LS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  if (spart == 0) {
    sM[srow] = m_i;
    sL[srow] = l_i;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qpos = q0 + r;
    if (qpos >= Lq) continue;
    const float l = sL[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = o + (((long long)b * Lq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Lq + qpos] = sM[r] + logf(l);
  }
}

namespace tc {

constexpr int FWD_BQ = 64;  // query rows per block, 16 per warp
constexpr int FWD_BK = 64;  // key rows per stage of the K/V ring

// Blocks per SM asked of ptxas.  At D <= 64, 4 caps the registers at 128
// so that 4 blocks of 4 warps share an SM (46 KB of shared memory each at
// D=64), which ran faster than the uncapped 146 registers (3 blocks) at
// every shape chip_smoke.py times.  At D = 128 the cap would spill, so it
// asks for none.
template <int D>
struct FwdOccupancy {
  static constexpr int MIN_BLOCKS = D <= 64 ? 4 : 1;
};

template <int D>
__global__ void __launch_bounds__(THREADS, FwdOccupancy<D>::MIN_BLOCKS)
fwd_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse, int H,
              int KV, int Lq, int Lk, long long sqb, long long sql, long long sqh,
              long long skb, long long skl, long long skh, long long svb, long long svl,
              long long svh, int causal, float scale) {
  constexpr int BQ = FWD_BQ, BK = FWD_BK, LD = Pad<D>::LD;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);  // [BQ][LD]; the O tile at the end
  bf16* sK = sQ + BQ * LD;                      // [2][BK][LD] ring
  bf16* sV = sK + 2 * BK * LD;                  // [2][BK][LD] ring

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wrow = warp * 16;  // this warp's first row in the tile

  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + g * skh;
  const bf16* vb = v + b * svb + g * svh;

  const int nk = (Lk + BK - 1) / BK;
  // causal: key tiles past the tile's last query row are fully masked
  const int kt_end = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;

  copy_rows<D, BQ>(sQ, qb, sql, q0, Lq);
  copy_rows<D, BK>(sK, kb, skl, 0, Lk);
  copy_rows<D, BK>(sV, vb, svl, 0, Lk);
  cp_async_commit();

  uint32_t qf[D / 16][4];  // this warp's Q rows as A fragments, one per 16-wide k-step
  float acc[D / 8][4];     // O rows gid (c0, c1) and gid + 8 (c2, c3), 8 columns per n-tile
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // rows gid (i = 0) and gid + 8 (i = 1): running max in log2 units, and
  // this thread's share of the row sum (the quad's shares add up at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
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
    __syncthreads();  // tile kt has landed for every thread
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qf[kk], a_addr<LD>(sQ, wrow, kk * 16, lane));
    }
    const bf16* cK = sK + st * BK * LD;
    const bf16* cV = sV + st * BK * LD;
    const int k0 = kt * BK;
    // causal: the last column of this tile any row of this warp can see;
    // 16-key slices past it are skipped (their p is exactly 0)
    const int kmax = causal ? q0 + wrow + 15 - k0 : BK - 1;

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        if (np * 16 > kmax) continue;
        uint32_t kf[4];
        ldsm_x4(kf, bt_addr<LD>(cK, np * 16, kk * 16, lane));
        mma(s[2 * np], qf[kk], kf[0], kf[1]);
        mma(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }

    // mask the diagonal and ragged tiles
    const bool edge = (causal && k0 + BK - 1 > q0 + wrow) || k0 + BK > Lk;
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + wrow + gid + (e >> 1) * 8, kpos = k0 + j * 8 + tig * 2 + (e & 1);
          if (!visible(qpos, kpos, Lk, causal)) s[j][e] = -INFINITY;
        }
    }

    // online softmax on the fragments, in log2 units: the scale folds into
    // one fma per score ahead of the exp
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(m[i], mx * sl2);
      const float base = mx == -INFINITY ? 0.f : mx;  // nothing visible yet: p = 0
      const float corr = exp2_fast(m[i] - base);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][2 * i] = exp2_fast(fmaf(s[j][2 * i], sl2, -base));
        s[j][2 * i + 1] = exp2_fast(fmaf(s[j][2 * i + 1], sl2, -base));
        sum += s[j][2 * i] + s[j][2 * i + 1];
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * i] *= corr;
        acc[j][2 * i + 1] *= corr;
      }
    }

    // O += P V, P rounded to bf16 (v's dtype) from the registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kk * 16 > kmax) continue;
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, bn_addr<LD>(cV, dp * 16, kk * 16, lane));
        mma(acc[2 * dp], pa, vf[0], vf[1]);
        mma(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  // O through this warp's own rows of sQ (no other warp reads them), then
  // out as 16-byte row chunks
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    bf16* at = sQ + (wrow + gid) * LD + j * 8 + tig * 2;
    *reinterpret_cast<uint32_t*>(at) = pack_bf16(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(at + 8 * LD) = pack_bf16(acc[j][2] * inv[1], acc[j][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CHUNKS = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const int qpos = q0 + wrow + r;
    if (qpos < Lq)
      *reinterpret_cast<uint4*>(o + (((long long)b * Lq + qpos) * H + h) * D + c) =
          *reinterpret_cast<const uint4*>(sQ + (wrow + r) * LD + c);
  }
  if (lse != nullptr && tig == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = q0 + wrow + gid + 8 * i;
      if (qpos < Lq) lse[((long long)b * H + h) * Lq + qpos] = (m[i] + log2f(l[i])) * LN2;
    }
  }
}

}  // namespace tc
}  // namespace flash

// q [B, Lq, H, D], k/v [B, Lk, KV, D] (strided; head_dim contiguous; for
// bf16 the batch/seq/head strides and the base are 16-byte aligned, see
// ops/flash.py); o contiguous [B, Lq, H, D] in the input dtype; lse
// contiguous fp32 [B, H, Lq], or null for the no-lse variant.  Returns the
// launch status.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         int dtype, int B, int H, int KV, int Lq, int Lk, int head_dim,
                         long long sqb, long long sql, long long sqh, long long skb,
                         long long skl, long long skh, long long svb, long long svl,
                         long long svh, int causal, float scale, void* stream) {
  using namespace flash;
  if (dtype == FLASH_DTYPE_BF16) {
    using tc::bf16;
    const dim3 grid((Lq + tc::FWD_BQ - 1) / tc::FWD_BQ, H, B);
    FLASH_HEAD_DIM(head_dim, {
      const size_t smem = sizeof(bf16) * (tc::FWD_BQ + 4 * tc::FWD_BK) * tc::Pad<D>::LD;
      return tc::launch(tc::fwd_kernel_tc<D>, grid, smem, stream, (const bf16*)q,
                        (const bf16*)k, (const bf16*)v, (bf16*)o, lse, H, KV, Lq, Lk, sqb, sql,
                        sqh, skb, skl, skh, svb, svl, svh, causal, scale);
    });
  } else if (dtype == FLASH_DTYPE_F32) {
    const dim3 grid((Lq + BQ - 1) / BQ, H, B);
    FLASH_HEAD_DIM(head_dim, {
      constexpr int LD = Tile<D>::LD;
      const size_t smem = sizeof(float) * (BQ * LD + 2 * BK * LD + BQ * LS + 3 * BQ);
      return launch(fwd_kernel<float, D>, grid, smem, stream, (const float*)q, (const float*)k,
                    (const float*)v, (float*)o, lse, H, KV, Lq, Lk, sqb, sql, sqh, skb, skl,
                    skh, svb, svl, svh, causal, scale);
    });
  }
  return (int)cudaErrorInvalidValue;
}
