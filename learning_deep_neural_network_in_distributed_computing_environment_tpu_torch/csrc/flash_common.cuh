// Shared pieces of the hand-written flash-attention kernels (sm_90a), and
// the fp32 FMA kernels' helpers.
//
// Tensors keep the JAX layout [batch, seq, heads, head_dim] and are read
// through their batch/seq/head strides (head_dim must be the contiguous
// axis), so no transpose copy is ever made.  The fp32 kernels stage every
// tile in shared memory as fp32; all softmax state and accumulators are
// fp32 in every kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace flash {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // threads per block: a 16 x 16 grid of 4-row micro-tiles
constexpr int LS = BK + 1;  // padded row stride of [BQ][BK] score tiles

// Padded row stride of a [rows][D] tile: odd, so the 16 rows a half-warp
// reads at one column fall in 16 different banks.
template <int D>
struct Tile {
  static constexpr int LD = D + 1;
  static constexpr int DJ = D / 16;  // output columns per thread (tx + 16 * j)
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// Stage rows [row0, row0 + rows) of one (batch, head) slice of a strided
// [*, L, *, D] tensor into tile[r * LD + d] as fp32; rows past L read 0.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* tile, const T* base, long long row_stride,
                                          int row0, int rows, int L) {
  constexpr int LD = Tile<D>::LD;
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    tile[r * LD + d] = row < L ? to_f(base[(long long)row * row_stride + d]) : 0.f;
  }
}

// The mask every kernel applies to score (query qpos, key kpos): the key
// exists and, under causal, is not in the query's future.
__device__ __forceinline__ bool visible(int qpos, int kpos, int Lk, int causal) {
  return kpos < Lk && (!causal || kpos <= qpos);
}

// For one (query tile, key tile) pair staged in shared memory, compute the
// 4 x 4 micro-tile of p and ds this thread owns (query rows ty*4+i, key
// columns tx+16j) and store them to sP / sDS (either may be null).
template <int D>
__device__ __forceinline__ void probs_and_ds(const float* sQ, const float* sdO, const float* sK,
                                             const float* sV, const float* sLse,
                                             const float* sDelta, float* sP, float* sDS, int q0,
                                             int k0, int Lk, int causal, float scale) {
  constexpr int LD = Tile<D>::LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], g[4], kk[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = sQ[(ty * 4 + i) * LD + d];
      g[i] = sdO[(ty * 4 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kk[j] = sK[(tx + 16 * j) * LD + d];
      vv[j] = sV[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const float lse = sLse[r], delta = sDelta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p = visible(q0 + r, k0 + c, Lk, causal) ? expf(s[i][j] * scale - lse) : 0.f;
      if (sP != nullptr) sP[r * LS + c] = p;
      sDS[r * LS + c] = p * (dp[i][j] - delta) * scale;
    }
  }
}

// Launch one template instance: opt in to the dynamic shared memory it
// needs beyond 48 KB, launch on the caller's stream, and report the launch
// status (a refused launch never runs, so the caller must check it).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace flash

// dtype codes shared with ops/flash.py
#define FLASH_DTYPE_F32 0
#define FLASH_DTYPE_BF16 1

// Expand the body once per supported head dim (ops/flash.py
// SUPPORTED_HEAD_DIMS), with D bound; an unsupported one falls through.
#define FLASH_HEAD_DIM(head_dim, ...)                  \
  switch (head_dim) {                                  \
    case 32: { constexpr int D = 32; __VA_ARGS__; }    \
    case 64: { constexpr int D = 64; __VA_ARGS__; }    \
    case 128: { constexpr int D = 128; __VA_ARGS__; }  \
  }
