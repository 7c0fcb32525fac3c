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
// What bounds it on this card: at the main-path shape (B=64, L=128, H=12,
// D=64, causal, bf16) the work is ~1.6 GFLOP against ~50 MB of q/k/v/o, so
// the ideal kernel is memory-bound (~15 us at 3.35 TB/s).  This first
// version does its products on the fp32 FMA pipes from shared memory, not
// on the tensor cores, so in practice it is bound by shared-memory traffic
// and FMA issue, well above that floor.
//
// What the design does about it: one block per (query tile of 64 rows,
// head, batch); the TPU's sequential K/V grid axis becomes a loop inside
// the block, with the online-softmax state (running max m, denominator l)
// and the output accumulator in registers, so the L x L score matrix never
// reaches device memory and every q/k/v byte is read once per query tile.
// Under causal the loop stops at the last key tile that has a visible key,
// and the diagonal tile is masked element-wise; ragged tails (L not a
// multiple of 64) are masked the same way.  Each thread owns a 4 x 4
// micro-tile of scores and a 4 x (D/16) micro-tile of the output, reusing
// every shared-memory load across 4 FMAs.  wgmma, TMA and warp
// specialisation are later work.
#include "flash_common.cuh"

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

}  // namespace flash

// q [B, Lq, H, D], k/v [B, Lk, KV, D] (strided; head_dim contiguous);
// o contiguous [B, Lq, H, D] in the input dtype; lse contiguous fp32
// [B, H, Lq], or null for the no-lse variant.  Returns the launch status.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         int dtype, int B, int H, int KV, int Lq, int Lk, int head_dim,
                         long long sqb, long long sql, long long sqh, long long skb,
                         long long skl, long long skh, long long svb, long long svl,
                         long long svh, int causal, float scale, void* stream) {
  using namespace flash;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  FLASH_DISPATCH(dtype, head_dim, {
    constexpr int LD = Tile<D>::LD;
    const size_t smem = sizeof(float) * (BQ * LD + 2 * BK * LD + BQ * LS + 3 * BQ);
    return launch(fwd_kernel<T, D>, grid, smem, stream, (const T*)q, (const T*)k,
                  (const T*)v, (T*)o, lse, H, KV, Lq, Lk, sqb, sql, sqh, skb, skl, skh, svb,
                  svl, svh, causal, scale);
  });
}
