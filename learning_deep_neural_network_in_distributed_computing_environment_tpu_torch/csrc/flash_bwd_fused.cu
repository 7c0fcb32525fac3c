// Flash-attention backward for Hopper (sm_90a), written by hand: the
// single-pass fused construction.
//
// Replaces: ops/pallas_ops.py::_bwd_fused_kernel of the JAX package,
// reached via _flash_backward_fused (selected there and here by
// FLASH_BWD=fused).
//
// What it computes, from q, k, v, dO, the forward's lse and
// delta = rowsum(dO * O) (computed outside, as in the JAX package):
//   p  = exp(q k^T * scale - lse)            (recomputed ONCE per tile pair)
//   ds = p * (dO v^T - delta) * scale
//   dv = p^T dO,  dk = ds^T q,  dq = ds k     (all three from that one p)
// For grouped-query attention dk/dv of a K/V head sum over its H / KV
// query heads.
//
// Both instances share one layout: one block per (key tile, K/V head,
// batch), the layout of bwd_dkv_kernel.  The block loops over the rep
// query heads of its group and, for each, over the query tiles that can see
// its key tile (causal skips the earlier ones), so dk/dv sum on chip across
// the whole group and are written once, with no atomics.  dq is the one
// output several blocks add into: TPU grid steps run in order and the
// Pallas kernel writes per-key-tile fp32 partials [B, H, nj, L, D] summed
// outside, but Hopper blocks run in no order, so each (query tile, key
// tile) cell's ds k is added straight into a zero-filled fp32 accumulator
// [B, L, H, D], cast to q's dtype once by the caller.  That keeps the sum
// in fp32 like the JAX reduction and costs 1x the dq bytes instead of
// nj x; masked cells add nothing, so the Pallas kernel's partial-zeroing
// branch has no counterpart.  The atomics make the summation order, and so
// the last bits of dq, change from run to run.
//
// Two instances, chosen by dtype in flash_bwd_fused() below:
// - bf16, bwd_fused_kernel_tc: the tensor-core kernel the llama path runs.
//   At its shape (B=64, L=128, H=16, KV=4, D=64, causal) the five products
//   per visible (query, key) pair come to ~5 GFLOP against ~68 MB of
//   inputs and outputs, so it is bound by bytes (~20 us at 3.35 TB/s).  Its
//   body is bwd_kv_body<D> in flash_bwd_kv.cuh, the FA-2 backward
//   arrangement: warps own key rows, p and ds go from the C fragments of
//   S^T and dP^T straight into dv += p^T dO and dk += ds^T q, and only
//   ds^T goes to shared memory
//   (bf16, once per cell) for dq_cell = ds k, which is added as float4
//   reductions after a quad-neighbour exchange (a quarter of the scalar
//   atomics).  Query tiles are 64 rows at D <= 64 and 32 at D = 128.
// - fp32, bwd_fused_kernel: the first version's FMA kernel, kept as it was
//   so that fp32 inputs keep full fp32 products; its dq cells go in by
//   scalar atomicAdd (red.global.add.f32).
#include "flash_bwd_kv.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 T* __restrict__ dk, T* __restrict__ dv, int H, int KV, int Lq, int Lk,
                 long long sqb, long long sql, long long sqh, long long skb, long long skl,
                 long long skh, long long svb, long long svl, long long svh, long long sdb,
                 long long sdl, long long sdh, int causal, float scale) {
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
  // causal: query tile i sees this key tile iff i*BQ + BQ - 1 >= k0
  const int qt_begin = causal ? k0 / BQ : 0;
  for (int m = 0; m < rep; ++m) {
    const int h = g * rep + m;  // query head m of K/V head g's group
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

      // dv += p^T dO, dk += ds^T q over this tile's query rows
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

      // this cell's dq = ds k for query rows ty*4+i, columns tx+16j,
      // added into the fp32 accumulator
      float dq_part[4][DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq_part[i][j] = 0.f;
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
          for (int j = 0; j < DJ; ++j) dq_part[i][j] = fmaf(ds[i], kk[j], dq_part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty * 4 + i;
        if (qpos >= Lq) continue;
        float* row = dq_acc + (((long long)b * Lq + qpos) * H + h) * D;
#pragma unroll
        for (int j = 0; j < DJ; ++j) atomicAdd(row + tx + 16 * j, dq_part[i][j]);
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

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_fused_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int H, int KV, int Lq, int Lk, long long sqb, long long sql, long long sqh,
                    long long skb, long long skl, long long skh, long long svb, long long svl,
                    long long svh, long long sdb, long long sdl, long long sdh, int causal,
                    float scale) {
  bwd_kv_body<D>(q, k, v, dout, lse, delta, dq_acc, dk, dv, H, KV, Lq, Lk, sqb, sql, sqh,
                       skb, skl, skh, svb, svl, svh, sdb, sdl, sdh, causal, scale);
}

}  // namespace tc

}  // namespace flash

// q/dout [B, Lq, H, D], k/v [B, Lk, KV, D] (strided; head_dim contiguous;
// for bf16 the batch/seq/head strides and the base are 16-byte aligned,
// see ops/flash.py); lse/delta contiguous fp32 [B, H, Lq]; dq_acc
// contiguous fp32 [B, Lq, H, D], zero-filled by the caller; dk/dv
// contiguous [B, Lk, KV, D] in the input dtype.  Returns the launch status.
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, float* dq_acc, void* dk,
                               void* dv, int dtype, int B, int H, int KV, int Lq, int Lk,
                               int head_dim, long long sqb, long long sql, long long sqh,
                               long long skb, long long skl, long long skh, long long svb,
                               long long svl, long long svh, long long sdb, long long sdl,
                               long long sdh, int causal, float scale, void* stream) {
  using namespace flash;
  if (dtype == FLASH_DTYPE_BF16) {
    using tc::bf16;
    const dim3 grid((Lk + tc::BWD_BK - 1) / tc::BWD_BK, KV, B);
    FLASH_HEAD_DIM(head_dim, {
      return tc::launch(tc::bwd_fused_kernel_tc<D>, grid, tc::bwd_kv_smem<D>(), stream,
                        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
                        delta, dq_acc, (bf16*)dk, (bf16*)dv, H, KV, Lq, Lk, sqb, sql, sqh, skb,
                        skl, skh, svb, svl, svh, sdb, sdl, sdh, causal, scale);
    });
  } else if (dtype == FLASH_DTYPE_F32) {
    const dim3 grid((Lk + BK - 1) / BK, KV, B);
    FLASH_HEAD_DIM(head_dim, {
      constexpr int LD = Tile<D>::LD;
      const size_t smem = sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BQ * LS + 2 * BQ);
      return launch(bwd_fused_kernel<float, D>, grid, smem, stream, (const float*)q,
                    (const float*)k, (const float*)v, (const float*)dout, lse, delta, dq_acc,
                    (float*)dk, (float*)dv, H, KV, Lq, Lk, sqb, sql, sqh, skb, skl, skh, svb,
                    svl, svh, sdb, sdl, sdh, causal, scale);
    });
  }
  return (int)cudaErrorInvalidValue;
}
