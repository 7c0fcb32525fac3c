// The cell of the key-block backward kernels for Hopper (sm_90a):
// bwd_dkv_kernel_sm90 (flash_bwd.cu) and bwd_fused_kernel_sm90
// (flash_bwd_fused.cu), both organised around a block of 128 key rows of
// one (batch, K/V head), two consumer warpgroups of 64 key rows (wgmma's
// M), one producer warp streaming the group's (member, query tile) cells.
#pragma once

#include "flash_sm90.cuh"

namespace flash {
namespace sm90 {

constexpr int DKV_WG_KEYS = 64;                  // key rows of a consumer warpgroup (wgmma M)
constexpr int DKV_BK = CONSUMERS * DKV_WG_KEYS;  // key rows of a block
constexpr int DKV_STAGES = 4;                    // cells in the Q/dO/lse/delta ring

// Byte offset of ds^T's (key row, query) in the fused kernel's tile: 128
// key rows of 32-query halves, each half laid out as a D = 32 tile (64-byte
// rows in the 64-byte swizzle), so wgmma reads a half as an MN-major
// operand with no sub-atom offset.
__device__ __forceinline__ uint32_t ds_at(int row, int col) {
  return (col / 32) * Layout<32>::bytes(CONSUMERS * 64) + swizzled<32>(CONSUMERS * 64, row, col % 32);
}

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
// ds on the accumulators, dv += p^T dO and dk += ds^T q.  With DS_OUT, ds^T
// (rounded to bf16) also goes to shared memory at `ds`, the fused kernel's
// tile of 128 key rows (the warpgroup's own from row 64 wg) in 32-query
// halves (ds_at).
template <int D, int NQ, bool DS_OUT = false>
__device__ __forceinline__ void dkv_cell(float (&dk)[D / 2], float (&dv)[D / 2], uint32_t sk,
                                         uint32_t sv, uint32_t sq, uint32_t sdo,
                                         const float* rows, int q0, int kw, int Lq, int Lk,
                                         int causal, float scale, unsigned char* ds = nullptr) {
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
  if constexpr (DS_OUT) {
    // the A fragments are ds^T's bf16 pairs: rows kr and kr + 8, queries
    // 16 kq + 2 tig (+ 8)
    const int kr = wg * DKV_WG_KEYS + warp * 16 + gid;
#pragma unroll
    for (int kq = 0; kq < NQ / 16; ++kq)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<uint32_t*>(ds + ds_at(kr + (e & 1) * 8, kq * 16 + (e >> 1) * 8 + tig * 2)) =
            da[kq][e];
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


}  // namespace sm90
}  // namespace flash
