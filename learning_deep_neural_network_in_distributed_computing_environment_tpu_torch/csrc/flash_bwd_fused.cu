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
// Two instances, chosen by dtype in flash_bwd_fused() below:
// - bf16, bwd_fused_kernel_sm90: the kernel the llama path runs, designed
//   for this card (wgmma on TMA-fed shared memory, helpers in
//   flash_sm90.cuh).  At its shape (B=64, L=128, H=16, KV=4, D=64, causal)
//   the five products per visible (query, key) pair come to ~5 GFLOP
//   against ~68 MB of inputs and outputs, so it is bound by bytes (~20 us
//   at 3.35 TB/s).  It is bwd_dkv_kernel_sm90 (flash_bwd.cu) with dq
//   added: an item is a block of 128 key rows of one (batch, K/V head),
//   two consumer warpgroups of 64 key rows and one producer warp, the
//   group's (member, query tile) cells streamed by TMA through a
//   four-stage ring, the grid persistent (one block an SM), K and V
//   double-buffered; per cell S^T, dP^T, p, ds, dv += p^T dO and dk +=
//   ds^T q as in dkv_cell (flash_bwd_sm90.cuh), dk and dv summed in
//   registers over the whole group and written once.  For dq each
//   warpgroup also writes its ds^T rows (bf16, k's dtype, :345) to shared
//   memory; after both have, the cell's dq = ds K over the block's keys
//   is one wgmma chain a warpgroup (fused_dq: dq^T = K^T ds^T, both read
//   MN-major, each warpgroup whole sums for half of the dims or queries).
//   Where one block holds every key of its (batch, K/V head), Lk <= 128
//   (llama, tp llama and every L = 128 shape), that dq is complete: it is
//   written once, as bf16, through the cell's Q slot by TMA, with no
//   atomics, no fp32 accumulator and no cast, so its bits repeat from run
//   to run.  Past 128 keys each block adds its cells' dq into a
//   zero-filled fp32 accumulator (one red.add per element per 128 keys),
//   cast to q's dtype once by the caller; the order of those adds, and so
//   the last bits of dq, changes from run to run.  Query tiles are 64 rows
//   at D <= 64 and 32 at D = 128; causal items start at their diagonal
//   tile and a warpgroup skips the cells its keys cannot be seen by.
// - fp32, bwd_fused_kernel: the first version's FMA kernel, kept so that
//   fp32 inputs keep full fp32 products; one block per (64-key tile, K/V
//   head, batch) walks the group's query tiles, dk/dv summed on chip, and
//   each cell's dq = ds k added by scalar atomicAdd (red.global.add.f32)
//   into the zero-filled fp32 [B, L, H, D] that is the fp32 dq itself.
//   TPU grid steps run in order and the Pallas kernel writes per-key-tile
//   fp32 partials summed outside; Hopper blocks run in no order, so the
//   sum is taken in place, and masked cells add nothing (the Pallas
//   kernel's partial-zeroing branch has no counterpart).
#include <cstring>

#include "flash_bwd_sm90.cuh"

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

namespace sm90 {

// The dkv kernel's tiles, then two ds^T tiles by cell parity (each 128 key
// rows of the cell's queries, ds_at), so one warpgroup writes the next
// cell's while the other still reads this one's.
template <int D>
struct FusedSmem {
  using Dkv = DkvSmem<D>;
  static constexpr int BQ = Dkv::BQ;
  static constexpr int DS_TILE = (BQ / 32) * Layout<32>::bytes(DKV_BK);
  static constexpr int DS = Dkv::TILES;
  static constexpr int TILES = DS + 2 * DS_TILE;
  static constexpr int BARRIERS = Dkv::BARRIERS;
  static constexpr size_t BYTES = TILES + BARRIERS * 8 + 1024;  // + the alignment of the tiles
};

// dq^T (+)= K^T ds^T over the block's first NK keys: A the rows of K^T at
// `ka` (LBO to the next 32 dims at D = 32), B the ds^T half at `db`, both
// MN-major.
template <int D, int NK>
__device__ __forceinline__ void fused_dq_product(float (&acc)[16], uint32_t ka, uint32_t lbo,
                                                 uint32_t db) {
  using Lt = Layout<D>;
  hold(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
    wgmma_ss_tt32(acc, descriptor(ka + kk * 16 * Lt::ROW, lbo, Lt::GROUP, Lt::KIND),
                  desc_mn<32>(db, DKV_BK, kk), kk > 0);
  wgmma_commit();
  wgmma_wait();
  hold(acc);
}

// The cell's dq = ds K over the block's keys, once both warpgroups' ds^T
// is in the tile at `ds`.  It runs as dq^T = K^T ds^T, so that wgmma's 64
// rows are head dims and both operands are read MN-major with no sub-atom
// offset: at D = 128 warpgroup w takes dims 64w.. of the cell's 32
// queries, at D <= 64 all dims of queries 32w.. (at D = 32 the upper 32
// rows come from the V tile, LBO on, and are dropped).  Each is a whole
// sum over the keys, so no partial sums meet.  The product stops after the
// first 64 keys where the cell sees no more (a warpgroup that skipped the
// cell wrote no ds^T rows, and it can skip only then); every other row
// holds this cell's ds, zero where masked, against K's rows (zero past
// Lk).  Where the block holds every key (whole), dq goes out as bf16
// through the cell's Q slot (`so`, shared address sq; both warpgroups are
// done with it) by TMA, and the function returns whether this warpgroup's
// store may still be reading the slot (the caller's leader waits for it
// before handing the slot back); else it is added into the fp32
// accumulator.
template <int D>
__device__ __forceinline__ bool fused_dq(const CUtensorMap* tdq, float* dq_acc, uint32_t sk,
                                         uint32_t ds, unsigned char* so, uint32_t sq, int kspan,
                                         int rows, int q0, int h, int b, int H, int Lq,
                                         bool whole) {
  using Lt = Layout<D>;
  constexpr int BQ = DkvSmem<D>::BQ;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int qh = D == 128 ? 0 : 32 * wg;  // this warpgroup's first query of the cell
  const int dh = D == 128 ? 64 * wg : 0;  // and first head dim
  if (qh < rows) {                        // not a ragged cell's empty half
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    const uint32_t ka = sk + (dh / 64) * DKV_BK * Lt::ROW;  // K^T's rows: dims dh..
    const uint32_t lbo = D == 32 ? Lt::bytes(DKV_BK) : DKV_BK * Lt::ROW;
    const uint32_t db = ds + (qh / 32) * Layout<32>::bytes(DKV_BK);
    if (kspan > DKV_WG_KEYS)
      fused_dq_product<D, DKV_BK>(acc, ka, lbo, db);
    else
      fused_dq_product<D, DKV_WG_KEYS>(acc, ka, lbo, db);

    // acc[4j + e]: head dim dh + dr (+8 for e >= 2), query qh + 8j + 2 tig
    // (+1 for odd e)
    const int dr = warp * 16 + gid;
    const bool real = D != 32 || warp < 2;  // D = 32: rows 32.. are the V tile's
    if (whole) {
      if (real) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            *reinterpret_cast<bf16*>(so + swizzled<D>(BQ, qh + j * 8 + tig * 2 + (e & 1),
                                                      dh + dr + (e >> 1) * 8)) =
                __float2bfloat16_rn(acc[4 * j + e]);
      }
      fence_async_smem();
      warpgroup_sync(wg);
      if (threadIdx.x % 128 == 0) {
        // rows past Lq are not written
        tma_store(tdq, sq + qh * Lt::ROW + (dh / 64) * BQ * Lt::ROW, dh, h, q0 + qh, b);
        tma_store_commit();
      }
      return true;
    } else if (real) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = q0 + qh + j * 8 + tig * 2 + (e & 1);
          if (qpos < Lq)
            atomicAdd(dq_acc + (((long long)b * Lq + qpos) * H + h) * D + dh + dr + (e >> 1) * 8,
                      acc[4 * j + e]);
        }
    }
  }
  return false;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_fused_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tdk,
                      const __grid_constant__ CUtensorMap tdv,
                      const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq_acc, int B, int H,
                      int KV, int Lq, int Lk, int causal, float scale) {
  static_assert(sizeof(T) == 2, "the bf16 instance");
  using S = FusedSmem<D>;
  using Dkv = DkvSmem<D>;
  constexpr int BQ = S::BQ;
  extern __shared__ __align__(16) unsigned char smem_fused[];
  const uint32_t raw = smem_addr(smem_fused);
  const uint32_t tiles = (raw + S::BARRIERS * 8 + 1023) & ~1023u;
  unsigned char* tiles_p = smem_fused + (tiles - raw);
  float* rows_p = reinterpret_cast<float*>(tiles_p + Dkv::ROWS);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem_fused);  // [2]
  uint64_t* kv_empty = kv_full + 2;                              // [2]
  uint64_t* cell_full = kv_empty + 2;                            // [DKV_STAGES]
  uint64_t* cell_empty = cell_full + DKV_STAGES;                 // [DKV_STAGES]

  const int rep = H / KV;
  const int nq = (Lq + BQ - 1) / BQ, nkb = (Lk + DKV_BK - 1) / DKV_BK;
  const int items = nkb * KV * B;
  const bool whole = nkb == 1;  // one block holds every key: each cell's dq is complete
  // items, cells and turns as in bwd_dkv_kernel_sm90 (flash_bwd.cu)
  struct Item {
    int k0, g, b, t0, ntv;
  };
  auto item = [&](int i) {
    Item it;
    it.k0 = (i / (KV * B)) * DKV_BK;
    it.g = i % KV;
    it.b = (i / KV) % B;
    it.t0 = causal ? min(it.k0 / BQ, nq) : 0;
    it.ntv = nq - it.t0;
    return it;
  };
  auto turn = [&](int k) {
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
        bar_wait(&kv_empty[buf], ((n >> 1) & 1) ^ 1);
        bar_arrive_tx(&kv_full[buf], 2 * Dkv::KV_TILE);
        for (int w = 0; w < CONSUMERS; ++w) {
          const uint32_t at = tiles + buf * 2 * Dkv::KV_TILE + w * DKV_WG_KEYS * Layout<D>::ROW;
          const int row0 = it.k0 + w * DKV_WG_KEYS;
          load_tile<D>(at, &tk, &kv_full[buf], DKV_BK, it.g, row0, it.b);
          load_tile<D>(at + Dkv::KV_TILE, &tv, &kv_full[buf], DKV_BK, it.g, row0, it.b);
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
          bar_arrive_tx(&cell_full[st], 2 * Dkv::Q_TILE);
          load_tile<D>(tiles + Dkv::Q + st * Dkv::Q_TILE, &tq, &cell_full[st], BQ, h, q0, it.b);
          load_tile<D>(tiles + Dkv::DO + st * Dkv::Q_TILE, &tdo, &cell_full[st], BQ, h, q0,
                       it.b);
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
  int cc = 0;         // cells consumed so far
  int pending = -1;   // (leader) the ring stage its last dq store may still read
  // the leader hands a stage its dq went out of back once TMA has read it:
  // during the next cell, after its products, when the store is long done
  auto release = [&]() {
    if (leader && pending >= 0) {
      tma_store_wait();
      bar_arrive(&cell_empty[pending]);
    }
    pending = -1;
  };
  for (int n = 0, i = turn(0); i < items; i = turn(++n)) {
    const Item it = item(i);
    const int buf = n & 1;
    const int kw = it.k0 + wg * DKV_WG_KEYS;  // this warpgroup's first key row
    const uint32_t sk = tiles + buf * 2 * Dkv::KV_TILE, sv = sk + Dkv::KV_TILE;
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
      const int h = it.g * rep + c / it.ntv;
      const int q0 = (it.t0 + c % it.ntv) * BQ, rows = min(BQ, Lq - q0);
      const uint32_t sq = tiles + Dkv::Q + st * Dkv::Q_TILE;
      const uint32_t sdo = tiles + Dkv::DO + st * Dkv::Q_TILE;
      unsigned char* ds = tiles_p + S::DS + (cc & 1) * S::DS_TILE;
      bar_wait(&cell_full[st], (cc / DKV_STAGES) & 1);
      // causal: a cell whose queries all precede this warpgroup's keys adds
      // nothing (and the other's dq does not read its ds^T rows)
      if (!(causal && q0 + rows - 1 < kw)) {
        const float* sl = rows_p + st * 2 * BQ;
        const int n16 = (rows + 15) / 16;
        if (n16 == 1) {
          dkv_cell<D, 16, true>(dk, dv, sk, sv, sq, sdo, sl, q0, kw, Lq, Lk, causal, scale, ds);
        } else if (n16 == 2 || BQ == 32) {
          dkv_cell<D, 32, true>(dk, dv, sk, sv, sq, sdo, sl, q0, kw, Lq, Lk, causal, scale, ds);
        } else if constexpr (BQ == 64) {
          if (n16 == 3)
            dkv_cell<D, 48, true>(dk, dv, sk, sv, sq, sdo, sl, q0, kw, Lq, Lk, causal, scale, ds);
          else
            dkv_cell<D, 64, true>(dk, dv, sk, sv, sq, sdo, sl, q0, kw, Lq, Lk, causal, scale, ds);
        }
      }
      release();
      fence_async_smem();
      consumers_sync();  // ds^T is whole; both warpgroups are done with Q and dO
      const int seen = (causal ? min(Lk, q0 + rows) : Lk) - it.k0;
      const bool stored = fused_dq<D>(&tdq, dq_acc, sk, tiles + S::DS + (cc & 1) * S::DS_TILE,
                                      tiles_p + (sq - tiles), sq, min(DKV_BK, seen), rows, q0, h,
                                      it.b, H, Lq, whole);
      __syncwarp();
      if (leader && stored)
        pending = st;
      else if (lane == 0)
        bar_arrive(&cell_empty[st]);
    }
    consumers_sync();  // both warpgroups' dq products are done with K and V

    // dk and dv into this warpgroup's rows of the item's K and V tiles, in
    // the layout they came in, then out by TMA (rows past Lk are not
    // written); the buffer goes back to the producer once TMA has read it
    unsigned char* kp = tiles_p + buf * 2 * Dkv::KV_TILE;
    const int row = wg * DKV_WG_KEYS + warp * 16 + gid;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tig * 2;
      const uint32_t lo = swizzled<D>(DKV_BK, row, col), hi = swizzled<D>(DKV_BK, row + 8, col);
      *reinterpret_cast<uint32_t*>(kp + lo) = pack_bf16(dk[4 * j], dk[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(kp + hi) = pack_bf16(dk[4 * j + 2], dk[4 * j + 3]);
      *reinterpret_cast<uint32_t*>(kp + Dkv::KV_TILE + lo) = pack_bf16(dv[4 * j], dv[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(kp + Dkv::KV_TILE + hi) =
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
  release();
  if (leader) tma_store_wait();
}

template <int D>
int fused(const void* q, const void* k, const void* v, const void* dout, const float* lse,
          const float* delta, void* dq, void* dk, void* dv, int B, int H, int KV, int Lq, int Lk,
          long long sqb, long long sql, long long sqh, long long skb, long long skl,
          long long skh, long long svb, long long svl, long long svh, long long sdb,
          long long sdl, long long sdh, int causal, float scale, void* stream) {
  using S = FusedSmem<D>;
  const long long pb = (long long)Lk * KV * D, pl = (long long)KV * D;  // dk/dv: contiguous
  CUtensorMap tq, tk, tv, tdo, tdk, tdv, tdq;
  int err = encode<D>(&tq, q, B, Lq, H, sqb, sql, sqh, S::BQ);
  if (!err) err = encode<D>(&tdo, dout, B, Lq, H, sdb, sdl, sdh, S::BQ);
  if (!err) err = encode<D>(&tk, k, B, Lk, KV, skb, skl, skh, DKV_WG_KEYS);
  if (!err) err = encode<D>(&tv, v, B, Lk, KV, svb, svl, svh, DKV_WG_KEYS);
  if (!err) err = encode<D>(&tdk, dk, B, Lk, KV, pb, pl, D, DKV_WG_KEYS);
  if (!err) err = encode<D>(&tdv, dv, B, Lk, KV, pb, pl, D, DKV_WG_KEYS);
  // a whole block's bf16 dq (contiguous), stored 32 rows a warpgroup; else
  // dq is the fp32 accumulator and the map is not read
  const bool whole = Lk <= DKV_BK;
  std::memset(&tdq, 0, sizeof(tdq));
  if (!err && whole)
    err = encode<D>(&tdq, dq, B, Lq, H, (long long)Lq * H * D, (long long)H * D, D, 32);
  if (err) return err;
  auto kernel = bwd_fused_kernel_sm90<bf16, D>;
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
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(tq, tk, tv, tdo, tdk, tdv, tdq, lse,
                                                         delta, whole ? nullptr : (float*)dq, B,
                                                         H, KV, Lq, Lk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace sm90

}  // namespace flash

// The largest Lk at which the bf16 instance writes dq whole, as bf16 in q's
// layout (one block holds every key); past it, and for fp32, dq is the
// fp32 accumulator (ops/flash.py FUSED_BLOCK_KEYS reads the same).
extern "C" const int flash_bwd_fused_whole_keys = flash::sm90::DKV_BK;

// q/dout [B, Lq, H, D], k/v [B, Lk, KV, D] (strided; head_dim contiguous;
// for bf16 the batch/seq/head strides and the base are 16-byte aligned,
// see ops/flash.py); lse/delta contiguous fp32 [B, H, Lq]; dq contiguous
// [B, Lq, H, D]: bf16, written whole, for bf16 inputs with Lk <=
// flash_bwd_fused_whole_keys, else fp32, zero-filled by the caller, into
// which the blocks add; dk/dv contiguous [B, Lk, KV, D] in the input
// dtype.  Returns the launch status (or a tensor-map error, flash_sm90.cuh).
extern "C" int flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, void* dq, void* dk,
                               void* dv, int dtype, int B, int H, int KV, int Lq, int Lk,
                               int head_dim, long long sqb, long long sql, long long sqh,
                               long long skb, long long skl, long long skh, long long svb,
                               long long svl, long long svh, long long sdb, long long sdl,
                               long long sdh, int causal, float scale, void* stream) {
  using namespace flash;
  if (dtype == FLASH_DTYPE_BF16) {
    FLASH_HEAD_DIM(head_dim, {
      return sm90::fused<D>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV, Lq, Lk, sqb, sql,
                            sqh, skb, skl, skh, svb, svl, svh, sdb, sdl, sdh, causal, scale,
                            stream);
    });
  } else if (dtype == FLASH_DTYPE_F32) {
    const dim3 grid((Lk + BK - 1) / BK, KV, B);
    FLASH_HEAD_DIM(head_dim, {
      constexpr int LD = Tile<D>::LD;
      const size_t smem = sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BQ * LS + 2 * BQ);
      return launch(bwd_fused_kernel<float, D>, grid, smem, stream, (const float*)q,
                    (const float*)k, (const float*)v, (const float*)dout, lse, delta, (float*)dq,
                    (float*)dk, (float*)dv, H, KV, Lq, Lk, sqb, sql, sqh, skb, skl, skh, svb,
                    svl, svh, sdb, sdl, sdh, causal, scale);
    });
  }
  return (int)cudaErrorInvalidValue;
}
