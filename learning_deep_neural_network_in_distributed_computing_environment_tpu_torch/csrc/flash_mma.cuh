// Tensor-core building blocks of the bf16 dq and fused backward kernels
// (sm_90a): tiles staged as bf16 in shared memory by 16-byte cp.async, read
// with ldmatrix, multiplied by mma.sync.m16n8k16 (bf16 in, fp32
// accumulate).  The wgmma kernels (flash_sm90.cuh) share its scalar
// helpers: exp2_fast, pack_bf16, the constants.
//
// Fragment layouts of mma.m16n8k16 (gid = lane / 4, tig = lane % 4):
//   A 16x16: a0 (gid, 2tig..+1), a1 (gid+8, 2tig..), a2 (gid, 8+2tig..),
//            a3 (gid+8, 8+2tig..)                     [row, col]
//   B 16x8:  b0 (2tig..+1, gid), b1 (8+2tig.., gid)   [k, n]
//   C 16x8:  c0,c1 (gid, 2tig..+1), c2,c3 (gid+8, 2tig..+1)
// so the C fragments of two neighbouring n-tiles, packed to bf16 pairs,
// are the A fragment of the next product's 16-wide k-step: a score tile
// never leaves the registers on its way into P V.
//
// Shared tiles are [rows][D + 8] bf16: the 16-byte pad puts the 8 rows an
// ldmatrix reads at one column into 8 different 4-bank groups, so every
// ldmatrix is free of bank conflicts, and every row stays 16-byte aligned
// for cp.async.
#pragma once

#include <stdint.h>

#include "flash_common.cuh"

namespace flash {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// padded row stride (elements) of a shared [rows][cols] bf16 tile
template <int COLS>
struct Pad {
  static constexpr int LD = COLS + 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src
// is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b on the tensor cores (bf16 operands, fp32 accumulator)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit: one MUFU.EX2, ~2 ulp, subnormal
// results flushed to 0 (ex2(-inf) = 0, which masked scores rely on)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of the k-step over columns 16kk..16kk+15 from the C
// fragments of n-tiles 2kk and 2kk+1, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Lane addresses for ldmatrix.x4 into a shared tile of row stride LD.
// A operand (rows m, cols k) stored [m][k]: the 16x16 block at (m0, k0).
template <int LD>
__device__ __forceinline__ const bf16* a_addr(const bf16* s, int m0, int k0, int lane) {
  return s + (m0 + (lane & 15)) * LD + k0 + ((lane >> 4) << 3);
}
// B operands of two n-tiles (n0, n0+8) at k-step k0, stored [n][k]
// (non-transposed load): registers b0(n0), b1(n0), b0(n0+8), b1(n0+8).
template <int LD>
__device__ __forceinline__ const bf16* bt_addr(const bf16* s, int n0, int k0, int lane) {
  return s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 + (((lane >> 3) & 1) << 3);
}
// B operands of two n-tiles (n0, n0+8) at k-step k0, stored [k][n]
// (transposed load): registers b0(n0), b1(n0), b0(n0+8), b1(n0+8).
template <int LD>
__device__ __forceinline__ const bf16* bn_addr(const bf16* s, int n0, int k0, int lane) {
  return s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD + n0 + ((lane >> 4) << 3);
}
// A operand (rows m, cols k) stored [k][m] (transposed load): the 16x16
// block at (m0, k0).
template <int LD>
__device__ __forceinline__ const bf16* at_addr(const bf16* s, int m0, int k0, int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * LD + m0 + (((lane >> 3) & 1) << 3);
}

// Stage rows [row0, row0 + ROWS) of one (batch, head) slice of a strided
// [*, L, *, D] bf16 tensor into tile[r][Pad<D>::LD] by 16-byte cp.async;
// rows past L are zero-filled.  The caller commits the group.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(bf16* tile, const bf16* base, long long row_stride,
                                          int row0, int L) {
  constexpr int LD = Pad<D>::LD, CHUNKS = D / 8;
  static_assert(ROWS * CHUNKS % THREADS == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int it = 0; it < ROWS * CHUNKS / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const bool ok = row0 + r < L;
    cp_async16(tile + r * LD + c, ok ? base + (long long)(row0 + r) * row_stride + c : base, ok);
  }
}

// Launch with the tensor-core kernels' block size (see flash::launch).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace flash

// Expand the body once per supported head dim (ops/flash.py
// SUPPORTED_HEAD_DIMS), with D bound; an unsupported one falls through.
#define FLASH_HEAD_DIM(head_dim, ...)                  \
  switch (head_dim) {                                  \
    case 32: { constexpr int D = 32; __VA_ARGS__; }    \
    case 64: { constexpr int D = 64; __VA_ARGS__; }    \
    case 128: { constexpr int D = 128; __VA_ARGS__; }  \
  }
