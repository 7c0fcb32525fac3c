// Hopper building blocks of the bf16 flash kernels, all four designed for
// sm_90a: flash_fwd's fwd_kernel_sm90 (flash_fwd.cu), flash_bwd_dq's
// bwd_dq_kernel_sm90 and flash_bwd_dkv's bwd_dkv_kernel_sm90 (flash_bwd.cu)
// and flash_bwd_fused's bwd_fused_kernel_sm90 (flash_bwd_fused.cu).  Inline
// PTX only (no CuTe, no CUTLASS): mbarriers, TMA tile copies, wgmma
// shared-memory descriptors and the wgmma instructions the kernels issue,
// plus the host code that encodes their tensor maps.
//
// Tiles in shared memory.  TMA copies a tile of rows of one (batch, head)
// slice of a strided [B, L, heads, D] tensor, a box {cols, 1, rows, 1} of
// the 4-D view {D, heads, L, B}, and swizzles it on the way in: rows of 64
// bf16 (128 bytes) in the 128-byte swizzle at D = 64, two such 64-column
// atoms one after the other at D = 128 (atom a holds columns 64a..64a+63
// of every row), and rows of 32 bf16 (64 bytes) in the 64-byte swizzle at
// D = 32.  Rows past L arrive as zeros.  The same layouts are what wgmma
// reads through a descriptor and what the epilogues write for a TMA store:
//   K-major operand (the contraction runs along a row: Q, K, V, dO as A or
//     B of a product over head_dim): one k-step of 16 columns is 32 bytes
//     into the row's atom, 8-row groups SBO = 8 rows apart;
//   MN-major operand (the contraction runs down the rows: V in P V, dO and
//     Q in p^T dO and ds^T q, K in ds K, read transposed): one k-step is 16
//     rows further, 8-row groups SBO apart, the 64-column atoms LBO apart.
// Every tile starts on a 1024-byte boundary, so the swizzle, which works on
// absolute shared-memory address bits, is the same for TMA, wgmma and the
// epilogue's stores.
//
// Register fragments.  The accumulator of wgmma m64nNk16 gives warp w of
// the warpgroup rows 16w..16w+15, and lane (gid = lane / 4, tig = lane % 4)
// d[4j + e]: row gid (+8 for e >= 2), column 8j + 2 tig + (e & 1), the
// C layout of mma.sync m16n8 repeated every 8 columns.  The A fragment of
// wgmma with A in registers is mma.sync's A fragment of the warp's 16 rows,
// so two neighbouring 8-column accumulator blocks, rounded to bf16 pairs,
// are the A operand of the next product's 16-wide k-step (a_from_acc): a
// score tile never leaves the registers on its way into P V.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: the driver is reached at run time)
#include <stdint.h>

#include <algorithm>

#include "flash_common.cuh"

namespace flash {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

constexpr int CONSUMERS = 2;                      // consumer warpgroups a block
constexpr int THREADS = CONSUMERS * 128 + 32;     // and one producer warp
constexpr int PRODUCER_WARP = CONSUMERS * 4;

// ---------------------------------------------------------------------------
// shared-memory layout of a tile with D columns
// ---------------------------------------------------------------------------

template <int D>
struct Layout {
  static constexpr int ATOM_COLS = D >= 64 ? 64 : 32;  // columns of one swizzle row
  static constexpr int ROW = ATOM_COLS * 2;            // bytes of one swizzle row
  static constexpr int ATOMS = D / ATOM_COLS;          // 1, or 2 at D = 128
  static constexpr int GROUP = 8 * ROW;                // 8 rows: one swizzle period
  static constexpr uint64_t KIND = ROW == 128 ? 1 : 2;  // descriptor: 128- / 64-byte swizzle
  static constexpr CUtensorMapSwizzle SWIZZLE =
      ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // bytes of a tile of `rows` rows
  __host__ __device__ static constexpr int bytes(int rows) { return rows * D * 2; }
};

// byte offset of element (row, col) in a tile of `rows` rows
template <int D>
__device__ __forceinline__ uint32_t swizzled(int rows, int row, int col) {
  using Lt = Layout<D>;
  const int atom = col / Lt::ATOM_COLS, c = col % Lt::ATOM_COLS;
  const int phase = Lt::ROW == 128 ? (row & 7) : ((row >> 1) & 3);
  return atom * rows * Lt::ROW + row * Lt::ROW + (((c >> 3) ^ phase) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint64_t kind) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (kind << 62);
}

// K-major operand: rows r0..r0+63 (A) or the tile's first N rows (B) of a
// tile of `rows` rows at shared address `tile`, k-step kk (columns 16kk..)
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0, int kk) {
  using Lt = Layout<D>;
  const uint32_t at = tile + (kk * 16 / Lt::ATOM_COLS) * rows * Lt::ROW + r0 * Lt::ROW +
                      (kk * 16 % Lt::ATOM_COLS) * 2;
  return descriptor(at, 16, Lt::GROUP, Lt::KIND);
}

// MN-major B operand, all D columns: rows 16kk..16kk+15 of a tile of `rows`
// rows at shared address `tile`
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  using Lt = Layout<D>;
  return descriptor(tile + kk * 16 * Lt::ROW, rows * Lt::ROW, Lt::GROUP, Lt::KIND);
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to every thread and to TMA
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive, and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that
// never ends (a fault in the protocol) traps, so the launch fails instead
// of holding the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// the 128 threads of consumer warpgroup `wg` meet (barrier 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// the threads of both consumer warpgroups meet (the producer warp does not)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMERS + 1), "n"(CONSUMERS * 128) : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// one box of a 4-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box from shared memory out to a 4-D tensor map (rows past the
// tensor's extent are not written)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until TMA has read the sources of this thread's committed stores
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// order this thread's plain shared-memory stores before later TMA reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// all D columns of the map's box of rows from row0 of (head, batch) into
// shared memory at `dst`, in a tile of `rows` rows (the stride of its
// 64-column atoms; the box may fill part of them): one box per atom
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                          int rows, int head, int row0, int b) {
  using Lt = Layout<D>;
#pragma unroll
  for (int a = 0; a < Lt::ATOMS; ++a)
    tma_load(dst + a * rows * Lt::ROW, map, bar, a * Lt::ATOM_COLS, head, row0, b);
}

// the reverse of load_tile
template <int D>
__device__ __forceinline__ void store_tile(const CUtensorMap* map, uint32_t src, int rows,
                                           int head, int row0, int b) {
  using Lt = Layout<D>;
#pragma unroll
  for (int a = 0; a < Lt::ATOMS; ++a)
    tma_store(map, src + a * rows * Lt::ROW, a * Lt::ATOM_COLS, head, row0, b);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Tie registers that an in-flight wgmma reads or writes to the asm around
// it, so the compiler neither moves their uses across the wait nor their
// definitions past the fence.
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void hold(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// The A fragment of k-step kk (columns 16kk..16kk+15) from an accumulator,
// rounded to bf16.
template <int R>
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float (&d)[R], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// d (+)= A B, m64nNk16, bf16 in, fp32 accumulate; A and B K-major in shared
// memory; scale_d = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

// d += A B, m64nNk16; A in registers, B MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t b);

// d (+)= A B, m64n32k16, A and B both MN-major in shared memory (the
// contraction runs down the rows of both tiles); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_tt32(float (&d)[16], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The instances the kernels issue, the operand lists spelled out (PTX
// takes the accumulator registers one by one).
template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// host: tensor maps and launches
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// libraries link nothing but the runtime
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiled)p
                                                                      : nullptr;
  }();
  return fn;
}

// Error codes of the C entry points beyond the runtime's: no driver entry
// point, or a tensor map the driver refused (2000 + its CUresult).
constexpr int ERR_NO_ENCODE = 1999;
constexpr int ERR_ENCODE = 2000;

// The map of a bf16 [B, L, heads, D] tensor read through its element
// strides (head_dim contiguous), in boxes of `rows` rows of one (head,
// batch) slice, swizzled for Layout<D>.  A dimension of extent 1 never
// steps, so its stride is replaced by a packed one (the driver wants every
// stride a 16-byte multiple).  Returns 0 or an error code.
template <int D>
int encode(CUtensorMap* map, const void* base, int B, int L, int heads, long long sb,
           long long sl, long long sh, int rows) {
  using Lt = Layout<D>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const long long packed[3] = {D, (long long)heads * D, (long long)L * heads * D};
  const long long given[3] = {sh, sl, sb};
  const int extent[3] = {heads, L, B};
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L, (cuuint64_t)B};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = (cuuint64_t)(extent[i] == 1 ? packed[i] : given[i]) * sizeof(bf16);
  cuuint32_t box[4] = {(cuuint32_t)Lt::ATOM_COLS, 1, (cuuint32_t)rows, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                  strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, Lt::SWIZZLE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// Blocks of `kernel` one SM holds at once with `smem` bytes of dynamic
// shared memory, after opting in to that much; 0 if the launch would fail.
template <typename Kernel>
int resident_blocks(Kernel kernel, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem) != cudaSuccess)
    return 0;
  return n;
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// Slices of each head's cells for a kernel organised around the K/V head
// (the forward and dq): enough blocks to fill the card's resident blocks
// (each extra slice re-reads its head's K/V once), an even number of cells
// a slice (two warpgroups take them in turns).  Returns the cells a block
// takes; the grid's x extent is ceil(cells / that).
inline int cells_per_block(int cells, int heads, int slots) {
  int slices = std::max(1, (slots + heads / 2) / heads);
  slices = std::min(slices, (cells + CONSUMERS - 1) / CONSUMERS);
  return CONSUMERS * ((cells + CONSUMERS * slices - 1) / (CONSUMERS * slices));
}

}  // namespace sm90
}  // namespace flash
