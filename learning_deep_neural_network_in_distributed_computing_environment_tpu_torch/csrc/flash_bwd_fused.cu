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
//   inputs and outputs, so it is bound by bytes (~20 us at 3.35 TB/s).  The
//   FA-2 backward arrangement: each of the 4 warps owns 16 key rows, so
//   S^T = K Q^T and dP^T = V dO^T come out with key rows in the warp's C
//   fragments; p = exp(S^T scale - lse) and ds = p (dP^T - delta) scale
//   are fp32 on those fragments, and packed to bf16 they are the A
//   fragments of dv += p^T dO and dk += ds^T q (dO and q read by transposed
//   ldmatrix), so p never touches shared memory and dk/dv stay in
//   registers.  ds^T goes to shared memory once, as bf16, for
//   dq_cell = ds k (ds read back by transposed ldmatrix), whose warps each
//   own a 16-row slice of the cell.  Products are mma.sync.m16n8k16 with
//   fp32 accumulators, rounding where the TPU kernel rounds: p to dO's
//   dtype for dv (pallas_ops.py:335), ds to q's for dk (:342) and to k's for
//   dq (:345).  K and V are staged once per block; Q, dO, lse and delta
//   stream by cp.async through a two-stage ring over the (member, query
//   tile) loop.  dq is added as float4 reductions after a quad-neighbour
//   exchange (a quarter of the scalar atomics).  Query tiles are 64 rows
//   at D <= 64 and 32 at D = 128, which keeps the registers in budget.
// - fp32, bwd_fused_kernel: the first version's FMA kernel, kept as it was
//   so that fp32 inputs keep full fp32 products; its dq cells go in by
//   scalar atomicAdd (red.global.add.f32).
#include "flash_mma.cuh"

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

constexpr int BWD_BK = 64;  // key rows per block, 16 per warp

// query rows per tile of the (member, query tile) loop
template <int D>
struct BwdTile {
  static constexpr int BQ = D <= 64 ? 64 : 32;
};

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
  constexpr int BK = BWD_BK, BQ = BwdTile<D>::BQ, LD = Pad<D>::LD, LDS = Pad<BQ>::LD;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* sK = reinterpret_cast<bf16*>(smem_tc);  // [BK][LD]
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
    const int h = g * rep + c / nqv, q0 = (qt_begin + c % nqv) * BQ;
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
    __syncthreads();  // every warp is done with stage st and sdS
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
      constexpr int TQ = tc::BwdTile<D>::BQ, LD = tc::Pad<D>::LD, LDS = tc::Pad<TQ>::LD;
      const size_t smem = sizeof(bf16) * (2 * tc::BWD_BK * LD + 4 * TQ * LD + tc::BWD_BK * LDS) +
                          sizeof(float) * 4 * TQ;
      return tc::launch(tc::bwd_fused_kernel_tc<D>, grid, smem, stream, (const bf16*)q,
                        (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, dq_acc,
                        (bf16*)dk, (bf16*)dv, H, KV, Lq, Lk, sqb, sql, sqh, skb, skl, skh, svb,
                        svl, svh, sdb, sdl, sdh, causal, scale);
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
