// Shared pieces of the hand-written flash-attention kernels (sm_90a).
//
// Tensors keep the JAX layout [batch, seq, heads, head_dim] and are read
// through their batch/seq/head strides (head_dim must be the contiguous
// axis), so no transpose copy is ever made.  Every tile is staged in
// shared memory as fp32; all softmax state and accumulators are fp32.
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
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// Expand the body (the variadic argument) once per supported (element type, head_dim) pair; unsupported
// pairs return cudaErrorInvalidValue.  ops/flash.py::SUPPORTED_HEAD_DIMS
// lists the same head dims.
#define FLASH_DISPATCH(dtype, head_dim, ...)                           \
  do {                                                                 \
    if (dtype == FLASH_DTYPE_F32) {                                    \
      using T = float;                                                 \
      switch (head_dim) {                                              \
        case 32: { constexpr int D = 32; __VA_ARGS__; }                       \
        case 64: { constexpr int D = 64; __VA_ARGS__; }                       \
        case 128: { constexpr int D = 128; __VA_ARGS__; }                     \
      }                                                                \
    } else if (dtype == FLASH_DTYPE_BF16) {                            \
      using T = __nv_bfloat16;                                         \
      switch (head_dim) {                                              \
        case 32: { constexpr int D = 32; __VA_ARGS__; }                       \
        case 64: { constexpr int D = 64; __VA_ARGS__; }                       \
        case 128: { constexpr int D = 128; __VA_ARGS__; }                     \
      }                                                                \
    }                                                                  \
    return (int)cudaErrorInvalidValue;                                 \
  } while (0)
