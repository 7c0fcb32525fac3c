// The key-rows-per-warp tensor-core backward body (sm_90a) of the fused
// kernel's bf16 instance, bwd_fused_kernel_tc (flash_bwd_fused.cu): dk, dv
// and each cell's dq = ds k, added into a zero-filled fp32 accumulator.
//
// One block of 4 warps per (64-row key tile, K/V head, batch), each warp
// owning 16 key rows (FA-2's backward arrangement).  The block walks the
// (member, query tile) cells of its K/V head's query group; causal skips
// the query tiles that cannot see its key tile.  Q, dO, lse and delta
// stream by cp.async through a two-stage ring, so cell c+1 lands while
// cell c is multiplied; K and V are staged once.  Per cell:
//   S^T = K Q^T and dP^T = V dO^T      (C fragments: key rows x queries)
//   p  = exp(S^T scale - lse),  ds = p (dP^T - delta) scale   (fp32)
//   dv += p^T dO,  dk += ds^T q        (p, ds packed to bf16 A fragments)
// so p and ds never touch shared memory and dk/dv sum in registers across
// the whole group, written once with no atomics.  Rounding is where the
// TPU kernels round: p to dO's dtype for dv (pallas_ops.py:274, :335), ds to
// q's for dk (:281, :342) and, for dq, to k's (:345).  dq needs ds^T in
// shared memory (bf16, once per cell), read back by a transposed ldmatrix;
// the warps each own a 16-row slice of the cell and add it as float4
// reductions after a quad-neighbour exchange.
#pragma once

#include "flash_mma.cuh"

namespace flash {
namespace tc {

constexpr int BWD_BK = 64;  // key rows per block, 16 per warp

// query rows per tile of the (member, query tile) loop: 32 at D = 128
// keeps the registers in budget
template <int D>
struct BwdTile {
  static constexpr int BQ = D <= 64 ? 64 : 32;
};

// Dynamic shared memory of the body: K, V, the Q/dO ring, ds^T and the
// lse/delta ring.
template <int D>
constexpr size_t bwd_kv_smem() {
  constexpr int BQ = BwdTile<D>::BQ, LD = Pad<D>::LD, LDS = Pad<BQ>::LD;
  return sizeof(bf16) * (2 * BWD_BK * LD + 4 * BQ * LD + BWD_BK * LDS) + sizeof(float) * 4 * BQ;
}

template <int D>
__device__ __forceinline__ void bwd_kv_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq_acc, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int KV, int Lq, int Lk, long long sqb, long long sql,
    long long sqh, long long skb, long long skl, long long skh, long long svb, long long svl,
    long long svh, long long sdb, long long sdl, long long sdh, int causal, float scale) {
  constexpr int BK = BWD_BK, BQ = BwdTile<D>::BQ, LD = Pad<D>::LD, LDS = Pad<BQ>::LD;
  extern __shared__ __align__(16) unsigned char smem_kv[];
  bf16* sK = reinterpret_cast<bf16*>(smem_kv);  // [BK][LD]
  bf16* sV = sK + BK * LD;                      // [BK][LD]
  bf16* sQ = sV + BK * LD;                      // [2][BQ][LD] ring
  bf16* sdO = sQ + 2 * BQ * LD;                 // [2][BQ][LD] ring
  bf16* sdS = sdO + 2 * BQ * LD;                // [BK][LDS] ds^T of the current cell
  float* sLse = reinterpret_cast<float*>(sdS + BK * LDS);  // [2][BQ] ring
  float* sDelta = sLse + 2 * BQ;                           // [2][BQ] ring

  const int kt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = H / KV;
  const int k0 = kt * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wrow = warp * 16;  // this warp's first key row in the tile

  copy_rows<D, BK>(sK, k + b * skb + g * skh, skl, k0, Lk);
  copy_rows<D, BK>(sV, v + b * svb + g * svh, svl, k0, Lk);

  const int nq = (Lq + BQ - 1) / BQ;
  // causal: query tile i sees this key tile iff i*BQ + BQ - 1 >= k0
  const int qt_begin = causal ? k0 / BQ : 0;
  const int nqv = max(nq - qt_begin, 0);
  const int ncell = rep * nqv;  // cell c: member c / nqv, query tile qt_begin + c % nqv
  auto stage = [&](int c, int st) {
    const int h = g * rep + c / nqv, q0 = (qt_begin + c % nqv) * BQ;
    copy_rows<D, BQ>(sQ + st * BQ * LD, q + b * sqb + h * sqh, sql, q0, Lq);
    copy_rows<D, BQ>(sdO + st * BQ * LD, dout + b * sdb + h * sdh, sdl, q0, Lq);
    const long long row = ((long long)b * H + h) * Lq + q0;
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool ok = q0 + i < Lq;
      cp_async4(sLse + st * BQ + i, ok ? lse + row + i : lse, ok);
      cp_async4(sDelta + st * BQ + i, ok ? delta + row + i : delta, ok);
    }
  };
  if (ncell > 0) stage(0, 0);
  cp_async_commit();

  // key rows gid (c0, c1) and gid + 8 (c2, c3), 8 head-dim columns per n-tile
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const float sl2 = scale * LOG2E;

  for (int c = 0; c < ncell; ++c) {
    const int st = c & 1;
    if (c + 1 < ncell) {  // the next cell into the other stage
      stage(c + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // cell c (and K/V) has landed for every thread
    const int q0 = (qt_begin + c % nqv) * BQ;
    const bf16* cQ = sQ + st * BQ * LD;
    const bf16* cdO = sdO + st * BQ * LD;
    const float* cLse = sLse + st * BQ;
    const float* cDelta = sDelta + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 key rows x BQ queries
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, a_addr<LD>(sK, wrow, kk * 16, lane));
      ldsm_x4(va, a_addr<LD>(sV, wrow, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t f[4];
        ldsm_x4(f, bt_addr<LD>(cQ, np * 16, kk * 16, lane));
        mma(s[2 * np], ka, f[0], f[1]);
        mma(s[2 * np + 1], ka, f[2], f[3]);
        ldsm_x4(f, bt_addr<LD>(cdO, np * 16, kk * 16, lane));
        mma(dp[2 * np], va, f[0], f[1]);
        mma(dp[2 * np + 1], va, f[2], f[3]);
      }
    }

    // p = exp(s scale - lse), ds = p (dp - delta) scale, in fp32; masked
    // pairs (causal, ragged keys or queries) get p = ds = 0
    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > Lk || q0 + BQ > Lq;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + tig * 2 + (e & 1), kpos = k0 + wrow + gid + (e >> 1) * 8;
        float p = exp2_fast(fmaf(s[j][e], sl2, -cLse[qc] * LOG2E));
        if (edge && !(q0 + qc < Lq && visible(q0 + qc, kpos, Lk, causal))) p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - cDelta[qc]) * scale;
      }

    // dv += p^T dO and dk += ds^T q, p and ds rounded to bf16 in registers
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t pa[4], da[4];
      c_to_a(pa, s[2 * kq], s[2 * kq + 1]);
      c_to_a(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t f[4];
        ldsm_x4_t(f, bn_addr<LD>(cdO, dn * 16, kq * 16, lane));
        mma(dv_acc[2 * dn], pa, f[0], f[1]);
        mma(dv_acc[2 * dn + 1], pa, f[2], f[3]);
        ldsm_x4_t(f, bn_addr<LD>(cQ, dn * 16, kq * 16, lane));
        mma(dk_acc[2 * dn], da, f[0], f[1]);
        mma(dk_acc[2 * dn + 1], da, f[2], f[3]);
      }
    }

    // ds^T to shared memory as bf16, for dq
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      bf16* at = sdS + (wrow + gid) * LDS + j * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(dp[j][0], dp[j][1]);
      *reinterpret_cast<uint32_t*>(at + 8 * LDS) = pack_bf16(dp[j][2], dp[j][3]);
    }
    __syncthreads();  // ds^T complete

    // dq_cell = ds k: warp w owns query rows 16 (w % RG).. and head-dim
    // columns [cp0, cp0 + DC)
    constexpr int RG = BQ / 16, DC = D / (WARPS / RG);
    const int rg = warp % RG, cp0 = (warp / RG) * DC;
    float dqc[DC / 8][4];
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_t(a, at_addr<LDS>(sdS, rg * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < DC / 16; ++np) {
        uint32_t f[4];
        ldsm_x4_t(f, bn_addr<LD>(sK, cp0 + np * 16, kk * 16, lane));
        mma(dqc[2 * np], a, f[0], f[1]);
        mma(dqc[2 * np + 1], a, f[2], f[3]);
      }
    }
    // into the fp32 accumulator as float4 reductions: the quad neighbours
    // swap halves, so even lanes hold 4 columns of row gid and odd lanes 4
    // columns of row gid + 8
    const int h = g * rep + c / nqv;
    const bool odd = tig & 1;
    const int qpos = q0 + rg * 16 + gid + (odd ? 8 : 0);
    float* dq_row = dq_acc + (((long long)b * Lq + qpos) * H + h) * D + cp0 + (tig & 2) * 2;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      const float y0 = __shfl_xor_sync(0xffffffffu, odd ? dqc[j][0] : dqc[j][2], 1);
      const float y1 = __shfl_xor_sync(0xffffffffu, odd ? dqc[j][1] : dqc[j][3], 1);
      if (qpos < Lq)
        atomicAdd(reinterpret_cast<float4*>(dq_row + j * 8),
                  odd ? make_float4(y0, y1, dqc[j][2], dqc[j][3])
                      : make_float4(dqc[j][0], dqc[j][1], y0, y1));
    }
    __syncthreads();  // every warp is done with stage st (and sdS)
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kpos = k0 + wrow + gid + 8 * i;
      if (kpos >= Lk) continue;
      const long long at = (((long long)b * Lk + kpos) * KV + g) * D + j * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
}

}  // namespace tc
}  // namespace flash
