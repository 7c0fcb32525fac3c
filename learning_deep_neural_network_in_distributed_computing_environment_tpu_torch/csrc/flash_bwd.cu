// Flash-attention backward for Hopper (sm_90a), written by hand: the
// two-pass FlashAttention-2 construction, the default backward (as in the
// JAX package, FLASH_BWD unset).
//
// Replaces: ops/pallas_ops.py::_bwd_dq_kernel (flash_bwd_dq) and
// ::_bwd_dkv_kernel (flash_bwd_dkv) of the JAX package, reached via
// _flash_backward.
//
// What they compute, from q, k, v, dO, the forward's lse and
// delta = rowsum(dO * O) (computed outside, as in the JAX package):
//   p  = exp(q k^T * scale - lse)            (recomputed by each pass)
//   ds = p * (dO v^T - delta) * scale
//   dq = ds k                                 (flash_bwd_dq)
//   dv = p^T dO,  dk = ds^T q                 (flash_bwd_dkv)
// For grouped-query attention dk/dv of a K/V head sum over its H / KV
// query heads.  Every block keeps its accumulators in registers for its
// whole loop and writes each output once: nothing is carried between
// blocks, no atomics are needed, and the results are the same bits from
// run to run.
//
// Two instances of each, chosen by dtype in the C entry points below:
// - bf16, the wgmma kernels every backward of the gpt2 path runs, both
//   designed for this card (wgmma on TMA-fed shared memory, helpers in
//   flash_sm90.cuh).  At its shape (B=64, L=128, H=12, D=64, causal) dq
//   does 3 and dkv 4 products per visible (query, key) pair, 2.4 and 3.2
//   GFLOP against ~64 and ~76 MB of inputs and outputs, so both are bound
//   by bytes (~19 and ~23 us at 3.35 TB/s; the bf16 tensor cores need
//   ~3 us).  p and ds stay in registers, rounded only where the TPU
//   kernels round.
//   - bwd_dq_kernel_sm90: organised around the K/V head, as the forward
//     is, so each K/V byte is read once per head and not once per query
//     tile and GQA member.  An item is one (batch, K/V head) and a slice
//     of its cells (one 64-row query tile of one member; slices follow
//     cells_per_block): one producer warp issues every copy by TMA, two
//     consumer warpgroups of 64 query rows take the item's cells in
//     turns (which takes the later tile of a pair alternates, so causal
//     work splits evenly), each with two Q/dO slots.  The grid is
//     persistent, one block an SM (168 registers: a 64-key chunk a step),
//     because blocks that each load, multiply and store in lockstep leave
//     memory idle while they multiply: the resident blocks walk the items,
//     and a ring of four K/V chunks carries over from item to item, so the
//     next head's K/V and cells land while this one is multiplied.  Where a
//     head's K/V fits the ring (Lk <= 256) the producer loads each chunk
//     once for all of the item's cells and GQA members and it is handed
//     back when the item is done; longer heads stream their chunks a round
//     of two cells at a time (an item is then one round).  Per chunk S =
//     Q K^T and dP = dO V^T are wgmma from shared memory, p and ds fp32 on
//     the accumulators (lse and delta of the thread's two rows in
//     registers), and dq += ds K is wgmma with ds rounded to bf16 (k's
//     dtype, pallas_ops.py:227) as the register A operand and K read
//     transposed.  A chunk's key extent is the smallest multiple of 16
//     that holds its keys (vit's 196 keys cost 208 columns), and causal
//     cells stop at their last visible chunk.  dq is written once, as
//     bf16, through the cell's Q slot by TMA, the slot handed back during
//     the next cell; no atomics, so its bits repeat from run to run.
//   - bwd_dkv_kernel_sm90: organised around the key block (its cell,
//     dkv_cell, in flash_bwd_sm90.cuh, shared with the fused kernel) so
//     that Q and dO are read once per 128 keys, not once per 64.  An
//     item is 128 key rows of one (batch, K/V head): two consumer
//     warpgroups of 64 key rows (wgmma's M) and one producer warp a block.
//     The producer loads the item's K and V once, then streams the group's
//     (member, query tile) cells through a four-stage ring: Q and dO by
//     TMA, lse and delta by its lanes' plain loads; each cell feeds every
//     key row of the item.  Per cell S^T = K Q^T and dP^T = V dO^T are
//     wgmma from shared memory, p and ds are fp32 on the accumulators, and
//     dv += p^T dO, dk += ds^T q are wgmma with p^T and ds^T as register A
//     operands (p rounded to dO's dtype, :274; ds to q's, :281) and dO, Q
//     read transposed.  dk and dv sum in registers over the whole group
//     and are written once through the warpgroup's own rows of the K and V
//     tiles by TMA: no atomics, so the pair's bits repeat from run to run.
//     The registers allow one block an SM, so the grid is persistent: the
//     resident blocks walk the items (heaviest first under causal, in
//     alternating order), K and V double-buffered, so the next item's K, V
//     and first cells land while this one is multiplied and stored.  A
//     ragged last query tile is cut to a multiple of 16 rows (vit's 196
//     queries cost 208 columns); causal items start at their diagonal
//     tile, and a warpgroup skips the cells its keys cannot be seen by.
// - fp32, bwd_dq_kernel / bwd_dkv_kernel: the first version's FMA kernels,
//   kept so that fp32 inputs keep full fp32 products (a TF32 product would
//   drop to ~3 decimal digits).  One block per output tile, products from
//   fp32 shared tiles, p and ds through shared memory (probs_and_ds).
#include "flash_bwd_sm90.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int H, int KV, int Lq, int Lk,
              long long sqb, long long sql, long long sqh, long long skb, long long skl,
              long long skh, long long svb, long long svl, long long svh, long long sdb,
              long long sdl, long long sdh, int causal, float scale) {
  constexpr int LD = Tile<D>::LD, DJ = Tile<D>::DJ;
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][LD]
  float* sdO = sQ + BQ * LD;     // [BQ][LD]
  float* sK = sdO + BQ * LD;     // [BK][LD]
  float* sV = sK + BK * LD;      // [BK][LD]
  float* sDS = sV + BK * LD;     // [BQ][LS]
  float* sLse = sDS + BQ * LS;   // [BQ]
  float* sDelta = sLse + BQ;     // [BQ]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  load_rows<T, D>(sQ, q + b * sqb + h * sqh, sql, q0, BQ, Lq);
  load_rows<T, D>(sdO, dout + b * sdb + h * sdh, sdl, q0, BQ, Lq);
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const bool in = q0 + r < Lq;
    const long long at = ((long long)b * H + h) * Lq + q0 + r;
    sLse[r] = in ? lse[at] : 0.f;
    sDelta[r] = in ? delta[at] : 0.f;
  }
  const T* kb = k + b * skb + g * skh;
  const T* vb = v + b * svb + g * svh;

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int nk = (Lk + BK - 1) / BK;
  const int kt_end = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers are done with sK/sV/sDS
    load_rows<T, D>(sK, kb, skl, k0, BK, Lk);
    load_rows<T, D>(sV, vb, svl, k0, BK, Lk);
    __syncthreads();
    probs_and_ds<D>(sQ, sdO, sK, sV, sLse, sDelta, nullptr, sDS, q0, k0, Lk, causal, scale);
    __syncthreads();
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
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= Lq) continue;
    T* row = dq + (((long long)b * Lq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
               int KV, int Lq, int Lk, long long sqb, long long sql, long long sqh, long long skb,
               long long skl, long long skh, long long svb, long long svl, long long svh,
               long long sdb, long long sdl, long long sdh, int causal, float scale) {
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
  // causal: query tile i sees this key tile iff i*BQ + BQ - 1 >= k0,
  // i.e. i >= floor(k0 / BQ)
  const int qt_begin = causal ? k0 / BQ : 0;
  for (int m = 0; m < rep; ++m) {
    const int h = g * rep + m;
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


namespace sm90 {

constexpr int DQ_BQ = 64;     // query rows of a cell: one warpgroup's wgmma M
constexpr int DQ_BK = 64;     // key rows of a K/V chunk
constexpr int DQ_STAGES = 4;  // chunks in the K/V ring: a whole head up to Lk = 256

template <int D>
struct DqSmem {
  // Q/dO slots a warpgroup: two (the next cell's land while this one's
  // are used), one at D = 128 for room
  static constexpr int SLOTS = D <= 64 ? 2 : 1;
  static constexpr int CHUNK = Layout<D>::bytes(DQ_BK);  // one chunk of K (or V)
  static constexpr int QTILE = Layout<D>::bytes(DQ_BQ);
  static constexpr int K = 0, V = DQ_STAGES * CHUNK, Q = 2 * DQ_STAGES * CHUNK;
  static constexpr int DO = Q + CONSUMERS * SLOTS * QTILE;
  static constexpr int TILES = DO + CONSUMERS * SLOTS * QTILE;
  static constexpr int BARRIERS = 2 * DQ_STAGES + 2 * CONSUMERS * SLOTS;
  static constexpr size_t BYTES = TILES + BARRIERS * 8 + 1024;  // + the alignment of the tiles
};

// K/V chunks the query tile t sees
__device__ __forceinline__ int dq_chunks(int t, int Lk, int causal) {
  const int end = causal ? min(Lk, (t + 1) * DQ_BQ) : Lk;
  return (end + DQ_BK - 1) / DQ_BK;
}

// NS keys (16..64) from row ks of the K/V chunk at sk/sv (keys k0 + ks..)
// for the warpgroup's 64 query rows from q0: S = Q K^T and dP = dO V^T,
// p = exp(s scale - lse) and ds = p (dp - delta) scale on the accumulators
// (lse2: the thread's rows' lse in log2 units, dlt their delta), then
// dq += ds K, ds rounded to bf16 (k's dtype) in registers and K read
// transposed.
template <int D, int NS>
__device__ __forceinline__ void dq_step(float (&dq)[D / 2], uint32_t sq, uint32_t sdo,
                                        uint32_t sk, uint32_t sv, int ks, const float (&lse2)[2],
                                        const float (&dlt)[2], int q0, int k0, int Lk, int causal,
                                        float scale) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  float s[NS / 2], dp[NS / 2];
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) s[i] = dp[i] = 0.f;
  hold(s);
  hold(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<NS>(s, desc_k<D>(sq, DQ_BQ, 0, kk), desc_k<D>(sk, DQ_BK, ks, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<NS>(dp, desc_k<D>(sdo, DQ_BQ, 0, kk), desc_k<D>(sv, DQ_BK, ks, kk), kk > 0);
  wgmma_commit();
  wgmma_wait();
  hold(s);
  hold(dp);

  // masked pairs (causal, ragged keys) get p = ds = 0
  const float sl2 = scale * LOG2E;
  const int qw = q0 + warp * 16, kb = k0 + ks;  // this warp's first query, the step's first key
  const bool edge = (causal && kb + NS - 1 > qw) || kb + NS > Lk;
#pragma unroll
  for (int j = 0; j < NS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, kpos = kb + j * 8 + tig * 2 + (e & 1);
      float p = exp2_fast(fmaf(s[4 * j + e], sl2, -lse2[i]));
      if (edge && !visible(qw + gid + 8 * i, kpos, Lk, causal)) p = 0.f;
      dp[4 * j + e] = p * (dp[4 * j + e] - dlt[i]) * scale;
    }

  uint32_t da[NS / 16][4];
#pragma unroll
  for (int kq = 0; kq < NS / 16; ++kq) a_from_acc(da[kq], dp, kq);
  hold(dq);
  hold(da);
  wgmma_fence();
#pragma unroll
  for (int kq = 0; kq < NS / 16; ++kq)
    wgmma_rs_tb<D>(dq, da[kq], desc_mn<D>(sk, DQ_BK, ks / 16 + kq));
  wgmma_commit();
  wgmma_wait();
  hold(dq);
}

// One K/V chunk for the warpgroup's cell: its keys rounded up to 16 (a
// ragged last chunk is cut), in one step at D <= 64 and steps of 32 keys at
// D = 128 (S, dP and dq fit the registers).
template <int D>
__device__ __forceinline__ void dq_chunk(float (&dq)[D / 2], uint32_t sq, uint32_t sdo,
                                         uint32_t sk, uint32_t sv, const float (&lse2)[2],
                                         const float (&dlt)[2], int q0, int k0, int Lk,
                                         int causal, float scale) {
  const int n16 = (min(DQ_BK, Lk - k0) + 15) / 16;
  if constexpr (D <= 64) {
    switch (n16) {
      case 1: dq_step<D, 16>(dq, sq, sdo, sk, sv, 0, lse2, dlt, q0, k0, Lk, causal, scale); break;
      case 2: dq_step<D, 32>(dq, sq, sdo, sk, sv, 0, lse2, dlt, q0, k0, Lk, causal, scale); break;
      case 3: dq_step<D, 48>(dq, sq, sdo, sk, sv, 0, lse2, dlt, q0, k0, Lk, causal, scale); break;
      default: dq_step<D, 64>(dq, sq, sdo, sk, sv, 0, lse2, dlt, q0, k0, Lk, causal, scale); break;
    }
  } else {
    for (int ks = 0; ks < n16 * 16; ks += 32) {
      if (n16 * 16 - ks >= 32)
        dq_step<D, 32>(dq, sq, sdo, sk, sv, ks, lse2, dlt, q0, k0, Lk, causal, scale);
      else
        dq_step<D, 16>(dq, sq, sdo, sk, sv, ks, lse2, dlt, q0, k0, Lk, causal, scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
                   const float* __restrict__ delta, int B, int H, int KV, int Lq, int Lk,
                   int cells_per_block, int causal, float scale) {
  static_assert(sizeof(T) == 2, "the bf16 instance");
  using S = DqSmem<D>;
  constexpr int SLOTS = S::SLOTS;
  extern __shared__ __align__(16) unsigned char smem_dq[];
  const uint32_t raw = smem_addr(smem_dq);
  const uint32_t tiles = (raw + S::BARRIERS * 8 + 1023) & ~1023u;
  unsigned char* tiles_p = smem_dq + (tiles - raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem_dq);  // [DQ_STAGES]
  uint64_t* kv_empty = kv_full + DQ_STAGES;                   // [DQ_STAGES]
  uint64_t* q_full = kv_empty + DQ_STAGES;                    // [CONSUMERS][SLOTS]: Q and dO
  uint64_t* q_empty = q_full + CONSUMERS * SLOTS;             // [CONSUMERS][SLOTS]

  const int rep = H / KV;
  const int cells = rep * ((Lq + DQ_BQ - 1) / DQ_BQ);
  const int slices = (cells + cells_per_block - 1) / cells_per_block;
  const int items = slices * KV * B;
  const int nkv = (Lk + DQ_BK - 1) / DQ_BK;
  const bool resident = nkv <= DQ_STAGES;
  // item i: slice i % slices of K/V head (i / slices) % KV of batch
  // i / (slices KV); its cells c (query tile c / rep of member c % rep)
  // from cell0, in rounds that give warpgroup w the cell cell0 + 2 r + (w
  // ^ flip), flip alternating from turn to turn so that under causal
  // neither warpgroup always takes the later tile of a pair.  Block x
  // takes item k G + x in even turns k and k G + G - 1 - x in odd ones (G
  // blocks), as bwd_dkv_kernel_sm90 does.
  struct Item {
    int g, b, cell0, cell_end, rounds, flip;
  };
  auto item = [&](int i, int k) {
    Item it;
    it.g = (i / slices) % KV;
    it.b = i / (slices * KV);
    it.cell0 = (i % slices) * cells_per_block;
    it.cell_end = min(cells, it.cell0 + cells_per_block);
    it.rounds = (it.cell_end - it.cell0 + CONSUMERS - 1) / CONSUMERS;
    it.flip = k & 1;
    return it;
  };
  auto turn = [&](int k) {
    return k * gridDim.x + (k & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  };
  auto cell_of = [&](const Item& it, int r, int w) {
    return it.cell0 + r * CONSUMERS + (w ^ it.flip);
  };
  auto round_chunks = [&](const Item& it, int r) {  // the chunks a streamed round walks
    int n = 0;
    for (int w = 0; w < CONSUMERS; ++w) {
      const int c = cell_of(it, r, w);
      if (c < it.cell_end) n = max(n, dq_chunks(c / rep, Lk, causal));
    }
    return n;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < DQ_STAGES; ++i) {
      bar_init(&kv_full[i], 1);
      bar_init(&kv_empty[i], CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    for (int i = 0; i < CONSUMERS * SLOTS; ++i) {
      bar_init(&q_full[i], 1);
      bar_init(&q_empty[i], 1);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / 32 == PRODUCER_WARP) {
    if (threadIdx.x % 32 == 0) {
      int n = 0;                     // chunks loaded so far: the ring's position
      int used[CONSUMERS] = {0, 0};  // cells loaded so far for each warpgroup
      auto load_chunk = [&](int m, int kc, const Item& it) {  // the m-th chunk into the ring
        const int st = m % DQ_STAGES;
        bar_wait(&kv_empty[st], ((m / DQ_STAGES) & 1) ^ 1);
        bar_arrive_tx(&kv_full[st], 2 * S::CHUNK);
        load_tile<D>(tiles + S::K + st * S::CHUNK, &tk, &kv_full[st], DQ_BK, it.g, kc * DQ_BK,
                     it.b);
        load_tile<D>(tiles + S::V + st * S::CHUNK, &tv, &kv_full[st], DQ_BK, it.g, kc * DQ_BK,
                     it.b);
      };
      for (int k = 0, i = turn(0); i < items; i = turn(++k)) {
        const Item it = item(i, k);
        // resident: the item's chunks once, kept until its last round is done
        if (resident)
          for (int kc = 0; kc < nkv; ++kc) load_chunk(n + kc, kc, it);
        for (int r = 0; r < it.rounds; ++r) {
          for (int w = 0; w < CONSUMERS; ++w) {
            const int c = cell_of(it, r, w);
            if (c >= it.cell_end) continue;
            const int slot = w * SLOTS + used[w] % SLOTS;
            const int h = it.g * rep + c % rep, q0 = (c / rep) * DQ_BQ;
            bar_wait(&q_empty[slot], ((used[w] / SLOTS) & 1) ^ 1);
            bar_arrive_tx(&q_full[slot], 2 * S::QTILE);
            load_tile<D>(tiles + S::Q + slot * S::QTILE, &tq, &q_full[slot], DQ_BQ, h, q0, it.b);
            load_tile<D>(tiles + S::DO + slot * S::QTILE, &tdo, &q_full[slot], DQ_BQ, h, q0,
                         it.b);
            ++used[w];
          }
          if (!resident)
            for (int kc = 0, nk = round_chunks(it, r); kc < nk; ++kc, ++n) load_chunk(n, kc, it);
        }
        if (resident) n += nkv;
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;
  int n = 0;          // chunks the ring has taken so far
  int used = 0;       // cells of this warpgroup so far
  int pending = -1;   // the slot whose dq store may still be reading it
  // the slot back to the producer once TMA has read this warpgroup's last
  // store out of it: with two slots, during the next cell's first chunk,
  // when the store is long done (the next but one cell's copies still land
  // a cell ahead); with one, at once
  auto release = [&]() {
    if (leader && pending >= 0) {
      tma_store_wait();
      bar_arrive(&q_empty[pending]);
    }
    pending = -1;
  };
  // wait for the m-th chunk; release it (every consumer warp's lane 0)
  auto chunk_wait = [&](int m) { bar_wait(&kv_full[m % DQ_STAGES], (m / DQ_STAGES) & 1); };
  auto chunk_release = [&](int m) {
    __syncwarp();
    if (lane == 0) bar_arrive(&kv_empty[m % DQ_STAGES]);
  };
  for (int k = 0, i = turn(0); i < items; i = turn(++k)) {
    const Item it = item(i, k);
    for (int r = 0; r < it.rounds; ++r) {
      const int c = cell_of(it, r, wg);
      const bool mine = c < it.cell_end;
      const int t = mine ? c / rep : 0, h = it.g * rep + c % rep, q0 = t * DQ_BQ;
      const int nk = mine ? dq_chunks(t, Lk, causal) : 0;
      const int walk = resident ? nk : round_chunks(it, r);
      const int slot = wg * SLOTS + used % SLOTS;
      const uint32_t sq = tiles + S::Q + slot * S::QTILE, sdo = tiles + S::DO + slot * S::QTILE;

      float dq[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;
      // rows gid (j = 0) and gid + 8 (j = 1) of this warp: lse in log2
      // units and delta
      float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qpos = q0 + warp * 16 + gid + 8 * j;
        if (mine && qpos < Lq) {
          const long long at = ((long long)it.b * H + h) * Lq + qpos;
          lse2[j] = lse[at] * LOG2E;
          dlt[j] = delta[at];
        }
      }
      if (mine) bar_wait(&q_full[slot], (used / SLOTS) & 1);
      for (int kc = 0; kc < walk; ++kc) {
        const int m = resident ? n + kc : n;
        chunk_wait(m);
        if (kc < nk) {
          const uint32_t st = m % DQ_STAGES;
          dq_chunk<D>(dq, sq, sdo, tiles + S::K + st * S::CHUNK, tiles + S::V + st * S::CHUNK,
                      lse2, dlt, q0, kc * DQ_BK, Lk, causal, scale);
          release();
        }
        if (!resident) {
          chunk_release(m);
          ++n;
        }
      }
      if (!mine) continue;

      // dq into the cell's Q slot (its last reader, S = Q K^T, is done), in
      // the layout the Q tile came in, then out by TMA (rows past Lq are
      // not written)
      unsigned char* so = tiles_p + (sq - tiles);
      const int row = warp * 16 + gid;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = j * 8 + tig * 2;
        *reinterpret_cast<uint32_t*>(so + swizzled<D>(DQ_BQ, row, col)) =
            pack_bf16(dq[4 * j], dq[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(so + swizzled<D>(DQ_BQ, row + 8, col)) =
            pack_bf16(dq[4 * j + 2], dq[4 * j + 3]);
      }
      fence_async_smem();
      warpgroup_sync(wg);
      if (leader) {
        store_tile<D>(&tdq, sq, DQ_BQ, h, q0, it.b);
        tma_store_commit();
      }
      pending = slot;
      if (SLOTS == 1) release();
      ++used;
    }
    if (resident) {
      // the item's chunks go back once both warpgroups are done with them
      // (a warpgroup that took no cell waits for them first, so that its
      // release cannot count towards the slot's previous use)
      for (int kc = 0; kc < nkv; ++kc) {
        chunk_wait(n + kc);
        chunk_release(n + kc);
      }
      n += nkv;
    }
  }
  release();
}

template <int D>
int dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
       const float* delta, void* dq, int B, int H, int KV, int Lq, int Lk, long long sqb,
       long long sql, long long sqh, long long skb, long long skl, long long skh, long long svb,
       long long svl, long long svh, long long sdb, long long sdl, long long sdh, int causal,
       float scale, void* stream) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  int err = encode<D>(&tq, q, B, Lq, H, sqb, sql, sqh, DQ_BQ);
  if (!err) err = encode<D>(&tdo, dout, B, Lq, H, sdb, sdl, sdh, DQ_BQ);
  if (!err) err = encode<D>(&tk, k, B, Lk, KV, skb, skl, skh, DQ_BK);
  if (!err) err = encode<D>(&tv, v, B, Lk, KV, svb, svl, svh, DQ_BK);
  if (!err)  // dq: contiguous
    err = encode<D>(&tdq, dq, B, Lq, H, (long long)Lq * H * D, (long long)H * D, D, DQ_BQ);
  if (err) return err;
  auto kernel = bwd_dq_kernel_sm90<bf16, D>;
  constexpr size_t smem = DqSmem<D>::BYTES;
  static const int per_sm = resident_blocks(kernel, smem);
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  cudaError_t set = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (set != cudaSuccess) return (int)set;
  // persistent: the resident blocks walk the (slice, K/V head, batch)
  // items; a head streamed through the ring reads its K/V once a round
  // anyway, so its items are single rounds, which balance the blocks best
  const int slots = sm_count() * per_sm;
  const int cells = (H / KV) * ((Lq + DQ_BQ - 1) / DQ_BQ);
  const bool resident = (Lk + DQ_BK - 1) / DQ_BK <= DQ_STAGES;
  const int per_block = resident ? cells_per_block(cells, B * KV, slots) : CONSUMERS;
  const int items = (cells + per_block - 1) / per_block * KV * B;
  const dim3 grid(std::min(items, slots));
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(tq, tk, tv, tdo, tdq, lse, delta, B, H,
                                                         KV, Lq, Lk, per_block, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tdk,
                    const __grid_constant__ CUtensorMap tdv, const float* __restrict__ lse,
                    const float* __restrict__ delta, int B, int H, int KV, int Lq, int Lk,
                    int causal, float scale) {
  static_assert(sizeof(T) == 2, "the bf16 instance");
  using S = DkvSmem<D>;
  constexpr int BQ = S::BQ;
  extern __shared__ __align__(16) unsigned char smem_dkv[];
  const uint32_t raw = smem_addr(smem_dkv);
  const uint32_t tiles = (raw + S::BARRIERS * 8 + 1023) & ~1023u;
  unsigned char* tiles_p = smem_dkv + (tiles - raw);
  float* rows_p = reinterpret_cast<float*>(tiles_p + S::ROWS);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem_dkv);  // [2]
  uint64_t* kv_empty = kv_full + 2;                            // [2]
  uint64_t* cell_full = kv_empty + 2;                          // [DKV_STAGES]
  uint64_t* cell_empty = cell_full + DKV_STAGES;               // [DKV_STAGES]

  const int rep = H / KV;
  const int nq = (Lq + BQ - 1) / BQ, nkb = (Lk + DKV_BK - 1) / DKV_BK;
  const int items = nkb * KV * B;
  // item i: key block i / (KV B) of K/V head i % KV of batch (i / KV) % B, so
  // under causal the items come heaviest first (the first key block sees
  // every query tile); its cells: member c / ntv, query tile t0 + c % ntv,
  // for c < rep ntv.  Block x takes item k G + x in even turns k and
  // k G + G - 1 - x in odd ones (G blocks), which evens out the blocks'
  // loads when the items' costs fall.
  struct Item {
    int k0, g, b, t0, ntv;
  };
  auto item = [&](int i) {
    Item it;
    it.k0 = (i / (KV * B)) * DKV_BK;
    it.g = i % KV;
    it.b = (i / KV) % B;
    // causal: query tile t sees the block's keys iff t BQ + BQ - 1 >= k0
    it.t0 = causal ? min(it.k0 / BQ, nq) : 0;
    it.ntv = nq - it.t0;
    return it;
  };
  auto turn = [&](int k) {  // this block's item in its k-th turn
    return k * gridDim.x + (k & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      bar_init(&kv_full[i], 1);
      bar_init(&kv_empty[i], CONSUMERS);  // thread 0 of each consumer warpgroup
    }
    for (int i = 0; i < DKV_STAGES; ++i) {
      bar_init(&cell_full[i], 32);              // the producer warp's lanes
      bar_init(&cell_empty[i], CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / 32 == PRODUCER_WARP) {
    const int lane = threadIdx.x % 32;
    int cc = 0;  // cells streamed so far
    for (int n = 0, i = turn(0); i < items; i = turn(++n)) {
      const Item it = item(i);
      const int buf = n & 1;
      if (lane == 0) {
        // the buffer's last item has been stored out of it
        bar_wait(&kv_empty[buf], ((n >> 1) & 1) ^ 1);
        bar_arrive_tx(&kv_full[buf], 2 * S::KV_TILE);
        for (int w = 0; w < CONSUMERS; ++w) {
          const uint32_t at = tiles + buf * 2 * S::KV_TILE + w * DKV_WG_KEYS * Layout<D>::ROW;
          const int row0 = it.k0 + w * DKV_WG_KEYS;
          load_tile<D>(at, &tk, &kv_full[buf], DKV_BK, it.g, row0, it.b);
          load_tile<D>(at + S::KV_TILE, &tv, &kv_full[buf], DKV_BK, it.g, row0, it.b);
        }
      }
      for (int c = 0; c < rep * it.ntv; ++c, ++cc) {
        const int st = cc % DKV_STAGES;
        const int h = it.g * rep + c / it.ntv, q0 = (it.t0 + c % it.ntv) * BQ;
        bar_wait(&cell_empty[st], ((cc / DKV_STAGES) & 1) ^ 1);
        float* sl = rows_p + st * 2 * BQ;
        const long long at = ((long long)it.b * H + h) * Lq + q0;
        for (int r = lane; r < BQ; r += 32) {
          const bool ok = q0 + r < Lq;
          sl[r] = ok ? lse[at + r] : 0.f;
          sl[BQ + r] = ok ? delta[at + r] : 0.f;
        }
        if (lane == 0) {
          bar_arrive_tx(&cell_full[st], 2 * S::Q_TILE);
          load_tile<D>(tiles + S::Q + st * S::Q_TILE, &tq, &cell_full[st], BQ, h, q0, it.b);
          load_tile<D>(tiles + S::DO + st * S::Q_TILE, &tdo, &cell_full[st], BQ, h, q0, it.b);
        } else {
          bar_arrive(&cell_full[st]);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const bool leader = threadIdx.x % 128 == 0;
  int cc = 0;  // cells consumed so far
  for (int n = 0, i = turn(0); i < items; i = turn(++n)) {
    const Item it = item(i);
    const int buf = n & 1;
    const int kw = it.k0 + wg * DKV_WG_KEYS;  // this warpgroup's first key row
    const uint32_t sk = tiles + buf * 2 * S::KV_TILE, sv = sk + S::KV_TILE;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.f;
    bar_wait(&kv_full[buf], (n >> 1) & 1);
    if (leader && n > 0) {
      // the previous item's dk/dv have left the other buffer: hand it back
      tma_store_wait();
      bar_arrive(&kv_empty[buf ^ 1]);
    }
    for (int c = 0; c < rep * it.ntv; ++c, ++cc) {
      const int st = cc % DKV_STAGES;
      const int q0 = (it.t0 + c % it.ntv) * BQ, rows = min(BQ, Lq - q0);
      bar_wait(&cell_full[st], (cc / DKV_STAGES) & 1);
      // causal: a cell whose queries all precede this warpgroup's keys adds nothing
      if (!(causal && q0 + rows - 1 < kw)) {
        const uint32_t sq = tiles + S::Q + st * S::Q_TILE, sdo = tiles + S::DO + st * S::Q_TILE;
        const float* sl = rows_p + st * 2 * BQ;
        const int n16 = (rows + 15) / 16;
        if (n16 == 1) {
          dkv_cell<D, 16>(dk, dv, sk, sv, sq, sdo, sl, q0, kw, Lq, Lk, causal, scale);
        } else if (n16 == 2 || BQ == 32) {
          dkv_cell<D, 32>(dk, dv, sk, sv, sq, sdo, sl, q0, kw, Lq, Lk, causal, scale);
        } else if constexpr (BQ == 64) {
          if (n16 == 3)
            dkv_cell<D, 48>(dk, dv, sk, sv, sq, sdo, sl, q0, kw, Lq, Lk, causal, scale);
          else
            dkv_cell<D, 64>(dk, dv, sk, sv, sq, sdo, sl, q0, kw, Lq, Lk, causal, scale);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&cell_empty[st]);
    }

    // dk and dv into this warpgroup's rows of the item's K and V tiles
    // (only this warpgroup reads them, and its last product is done), in
    // the layout they came in, then out by TMA (rows past Lk are not
    // written); the buffer goes back to the producer once TMA has read it
    unsigned char* kp = tiles_p + buf * 2 * S::KV_TILE;
    const int row = wg * DKV_WG_KEYS + warp * 16 + gid;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tig * 2;
      const uint32_t lo = swizzled<D>(DKV_BK, row, col), hi = swizzled<D>(DKV_BK, row + 8, col);
      *reinterpret_cast<uint32_t*>(kp + lo) = pack_bf16(dk[4 * j], dk[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(kp + hi) = pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(kp + S::KV_TILE + lo) = pack_bf16(dv[4 * j], dv[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(kp + S::KV_TILE + hi) =
          pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
    }
    fence_async_smem();
    warpgroup_sync(wg);
    if (leader) {
      const uint32_t at = wg * DKV_WG_KEYS * Layout<D>::ROW;
      store_tile<D>(&tdk, sk + at, DKV_BK, it.g, kw, it.b);
      store_tile<D>(&tdv, sv + at, DKV_BK, it.g, kw, it.b);
      tma_store_commit();
    }
  }
  if (leader) tma_store_wait();
}

template <int D>
int dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, void* dk, void* dv, int B, int H, int KV, int Lq, int Lk,
        long long sqb, long long sql, long long sqh, long long skb, long long skl,
        long long skh, long long svb, long long svl, long long svh, long long sdb,
        long long sdl, long long sdh, int causal, float scale, void* stream) {
  using S = DkvSmem<D>;
  const long long pb = (long long)Lk * KV * D, pl = (long long)KV * D;  // dk/dv: contiguous
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  int err = encode<D>(&tq, q, B, Lq, H, sqb, sql, sqh, S::BQ);
  if (!err) err = encode<D>(&tdo, dout, B, Lq, H, sdb, sdl, sdh, S::BQ);
  if (!err) err = encode<D>(&tk, k, B, Lk, KV, skb, skl, skh, DKV_WG_KEYS);
  if (!err) err = encode<D>(&tv, v, B, Lk, KV, svb, svl, svh, DKV_WG_KEYS);
  if (!err) err = encode<D>(&tdk, dk, B, Lk, KV, pb, pl, D, DKV_WG_KEYS);
  if (!err) err = encode<D>(&tdv, dv, B, Lk, KV, pb, pl, D, DKV_WG_KEYS);
  if (err) return err;
  auto kernel = bwd_dkv_kernel_sm90<bf16, D>;
  constexpr size_t smem = S::BYTES;
  static const int per_sm = resident_blocks(kernel, smem);
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  cudaError_t set = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (set != cudaSuccess) return (int)set;
  // persistent: the resident blocks walk the (key block, K/V head, batch)
  // items
  const int items = (Lk + DKV_BK - 1) / DKV_BK * KV * B;
  const dim3 grid(std::min(items, sm_count() * per_sm));
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(tq, tk, tv, tdo, tdk, tdv, lse, delta,
                                                         B, H, KV, Lq, Lk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace sm90

}  // namespace flash

// q/dout [B, Lq, H, D], k/v [B, Lk, KV, D] (strided; head_dim contiguous;
// for bf16 the batch/seq/head strides and the base are 16-byte aligned,
// see ops/flash.py); lse/delta contiguous fp32 [B, H, Lq]; dq contiguous
// [B, Lq, H, D] in the input dtype.  Returns the launch status.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq, int dtype, int B,
                            int H, int KV, int Lq, int Lk, int head_dim, long long sqb,
                            long long sql, long long sqh, long long skb, long long skl,
                            long long skh, long long svb, long long svl, long long svh,
                            long long sdb, long long sdl, long long sdh, int causal,
                            float scale, void* stream) {
  using namespace flash;
  if (dtype == FLASH_DTYPE_BF16) {
    FLASH_HEAD_DIM(head_dim, {
      return sm90::dq<D>(q, k, v, dout, lse, delta, dq, B, H, KV, Lq, Lk, sqb, sql, sqh, skb,
                         skl, skh, svb, svl, svh, sdb, sdl, sdh, causal, scale, stream);
    });
  } else if (dtype == FLASH_DTYPE_F32) {
    const dim3 grid((Lq + BQ - 1) / BQ, H, B);
    FLASH_HEAD_DIM(head_dim, {
      constexpr int LD = Tile<D>::LD;
      const size_t smem = sizeof(float) * (2 * BQ * LD + 2 * BK * LD + BQ * LS + 2 * BQ);
      return launch(bwd_dq_kernel<float, D>, grid, smem, stream, (const float*)q,
                    (const float*)k, (const float*)v, (const float*)dout, lse, delta, (float*)dq,
                    H, KV, Lq, Lk, sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sdb, sdl, sdh,
                    causal, scale);
    });
  }
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq; dk/dv contiguous [B, Lk, KV, D] in the input dtype.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv,
                             int dtype, int B, int H, int KV, int Lq, int Lk, int head_dim,
                             long long sqb, long long sql, long long sqh, long long skb,
                             long long skl, long long skh, long long svb, long long svl,
                             long long svh, long long sdb, long long sdl, long long sdh,
                             int causal, float scale, void* stream) {
  using namespace flash;
  if (dtype == FLASH_DTYPE_BF16) {
    FLASH_HEAD_DIM(head_dim, {
      return sm90::dkv<D>(q, k, v, dout, lse, delta, dk, dv, B, H, KV, Lq, Lk, sqb, sql, sqh,
                          skb, skl, skh, svb, svl, svh, sdb, sdl, sdh, causal, scale, stream);
    });
  } else if (dtype == FLASH_DTYPE_F32) {
    const dim3 grid((Lk + BK - 1) / BK, KV, B);
    FLASH_HEAD_DIM(head_dim, {
      constexpr int LD = Tile<D>::LD;
      const size_t smem = sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BQ * LS + 2 * BQ);
      return launch(bwd_dkv_kernel<float, D>, grid, smem, stream, (const float*)q,
                    (const float*)k, (const float*)v, (const float*)dout, lse, delta,
                    (float*)dk, (float*)dv, H, KV, Lq, Lk, sqb, sql, sqh, skb, skl, skh, svb,
                    svl, svh, sdb, sdl, sdh, causal, scale);
    });
  }
  return (int)cudaErrorInvalidValue;
}
