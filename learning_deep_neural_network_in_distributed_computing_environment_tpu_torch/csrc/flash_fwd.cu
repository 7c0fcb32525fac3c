// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces: ops/pallas_ops.py::_flash_kernel (and its no-lse twin
// _fwd_kernel_nolse) of the JAX package, reached via _flash_forward.
//
// What it computes: O = softmax(Q K^T / sqrt(D)) V per (batch, query head),
// with K/V head h / (H / KV) for grouped-query attention, and optionally
// the per-row log-sum-exp lse = m + log(l) as fp32 [B, H, Lq] (the TPU
// kernel's 128-lane broadcast is dropped).
//
// Two instances, chosen by dtype in flash_fwd() below:
// - bf16, fwd_kernel_sm90: the kernel both training paths run, designed
//   for this card (wgmma on TMA-fed shared memory, helpers in
//   flash_sm90.cuh).  At the main-path shape (B=64, L=128, H=12, D=64,
//   causal) the work is ~1.6 GFLOP against ~50 MB of q/k/v/o, so it is
//   bound by bytes (~15 us at 3.35 TB/s); at L=2048 the visible pairs make
//   it bound by the tensor-core rate.  Rounding is where the TPU kernel
//   rounds: p is cast to v's dtype before P V (pallas_ops.py:104), and the
//   softmax state, l and O stay fp32.
// - fp32, fwd_kernel: the first version's FMA kernel, kept as it was so
//   that fp32 inputs keep full fp32 products (a TF32 tensor-core product
//   would drop to ~3 decimal digits).
//
// The bf16 design is organised around the K/V head, so each K/V byte is
// read as few times as the card allows.  A block owns one (batch, K/V
// head) and a slice of that head's cells, a cell being one 64-row query
// tile of one query head of the group (the group's members of one tile
// are neighbours).  One producer warp issues every copy by TMA; two
// consumer warpgroups take the slice's cells in turns, 64 query rows each
// (wgmma's M):
// - K/V resident: where the head's K/V fits the four-chunk ring (Lk <= 256),
//   the producer loads each 64-key chunk once and every cell of the block
//   reuses it, every query head of a GQA group included; only Q streams in
//   (two slots a warpgroup) and O goes out.  Longer heads stream their
//   chunks through the same ring for each round of two cells (one a
//   warpgroup: the members of a tile need the same chunks), the online
//   softmax carrying over, the consumers releasing each chunk by an
//   mbarrier.
// - The products: S = Q K^T is wgmma with both operands in shared memory;
//   O += P V is wgmma with P taken from S's accumulator, rounded to bf16
//   A fragments in registers (as FlashAttention-3 does), and V read
//   transposed, so S and P never touch shared memory.  The online softmax
//   runs on the accumulator in log2 units (the scale folds into one fma
//   ahead of each MUFU ex2), each row's max and sum by quad shuffles.
// - Ragged tails: TMA zero-fills rows past L, and a chunk's key extent is
//   the smallest multiple of 16 that holds its keys, so vit's 196 keys cost
//   208 columns, not 256.  Causal cells stop at their last visible chunk;
//   diagonal and ragged chunks are masked element-wise.
// - The grid: B x KV x slices, two blocks an SM (96 registers, 98 KB of
//   shared memory at D = 64), the slices per head the resident blocks over
//   the heads, rounded (each extra slice reads its head's K/V once more;
//   cells_per_block in flash_sm90.cuh): one at every path shape but tp llama's
//   shard (two) and the long ones.  Blocks come and go, so one block's
//   copies overlap the other's products; a persistent grid measured slower.
// - O goes back through the cell's Q slot as the 64-row tile TMA stores
//   (rows past Lq are not written); lse by plain stores.
#include "flash_sm90.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int H, int KV, int Lq, int Lk,
           long long sqb, long long sql, long long sqh, long long skb, long long skl,
           long long skh, long long svb, long long svl, long long svh, int causal,
           float scale) {
  constexpr int LD = Tile<D>::LD, DJ = Tile<D>::DJ;
  extern __shared__ float smem[];
  float* sQ = smem;               // [BQ][LD]
  float* sK = sQ + BQ * LD;       // [BK][LD]
  float* sV = sK + BK * LD;       // [BK][LD]
  float* sP = sV + BK * LD;       // [BQ][LS] scores, then probabilities
  float* sCorr = sP + BQ * LS;    // [BQ] rescale of each row for this tile
  float* sM = sCorr + BQ;         // [BQ] final running max
  float* sL = sM + BQ;            // [BQ] final denominator

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // softmax phase: 4 consecutive lanes own one row, 16 columns each
  const int srow = threadIdx.x / 4, spart = threadIdx.x % 4;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + g * skh;
  const T* vb = v + b * svb + g * svh;
  load_rows<T, D>(sQ, qb, sql, q0, BQ, Lq);

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  float m_i = -INFINITY, l_i = 0.f;

  const int nk = (Lk + BK - 1) / BK;
  // causal: key tiles past the tile's last query row are fully masked
  const int kt_end = causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with sK/sV/sP
    load_rows<T, D>(sK, kb, skl, k0, BK, Lk);
    load_rows<T, D>(sV, vb, svl, k0, BK, Lk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        sP[r * LS + c] = visible(q0 + r, k0 + c, Lk, causal) ? s[i][j] * scale : -INFINITY;
      }
    __syncthreads();

    {  // online softmax over this tile's 64 columns of row srow
      float* row = sP + srow * LS + spart * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i, mx);
      float corr = 1.f, sum = 0.f;
      if (m_new == -INFINITY) {  // nothing visible yet in this row
#pragma unroll
        for (int c = 0; c < 16; ++c) row[c] = 0.f;
      } else {
        corr = expf(m_i - m_new);
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float p = expf(row[c] - m_new);
          row[c] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_i = l_i * corr + sum;
      m_i = m_new;
      if (spart == 0) sCorr[srow] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = sCorr[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= cr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * LS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  if (spart == 0) {
    sM[srow] = m_i;
    sL[srow] = l_i;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qpos = q0 + r;
    if (qpos >= Lq) continue;
    const float l = sL[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = o + (((long long)b * Lq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Lq + qpos] = sM[r] + logf(l);
  }
}

namespace sm90 {

constexpr int FWD_BQ = 64;      // query rows of a cell: one warpgroup's wgmma M
constexpr int FWD_BK = 64;      // key rows of a K/V chunk
constexpr int FWD_STAGES = 4;   // chunks in the K/V ring: a whole head up to Lk = 256

template <int D>
struct FwdSmem {
  static constexpr int CHUNK = Layout<D>::bytes(FWD_BK);  // one chunk of K (or V)
  static constexpr int QTILE = Layout<D>::bytes(FWD_BQ);
  static constexpr int K = 0, V = FWD_STAGES * CHUNK, Q = 2 * FWD_STAGES * CHUNK;
  static constexpr int TILES = Q + CONSUMERS * 2 * QTILE;  // two Q slots a warpgroup
  static constexpr int BARRIERS = 2 * FWD_STAGES + 4 * CONSUMERS;
  static constexpr size_t BYTES = TILES + BARRIERS * 8 + 1024;  // + the alignment of the tiles
};

// Blocks per SM asked of ptxas: two at D <= 64 (98 KB of shared memory
// each at D = 64), one at D = 128 (194 KB).
template <int D>
struct FwdOccupancy {
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
};

// K/V chunks the query tile t sees
__device__ __forceinline__ int fwd_chunks(int t, int Lk, int causal) {
  const int end = causal ? min(Lk, (t + 1) * FWD_BQ) : Lk;
  return (end + FWD_BK - 1) / FWD_BK;
}

// One chunk of NK keys (NK = 64, or 16/32/48 for a ragged last chunk) for
// the warpgroup's 64 query rows from q0: S = Q K^T, the online softmax on
// the accumulator (m, l: the thread's rows gid and gid + 8, m in log2
// units, l the thread's share of the row sum), O += P V.
template <int D, int NK>
__device__ __forceinline__ void fwd_chunk(float (&o)[D / 2], float (&m)[2], float (&l)[2],
                                          uint32_t sq, uint32_t sk, uint32_t sv, int q0, int k0,
                                          int Lk, int causal, float sl2) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  float s[NK / 2];
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) s[i] = 0.f;
  hold(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<NK>(s, desc_k<D>(sq, FWD_BQ, 0, kk), desc_k<D>(sk, FWD_BK, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait();
  hold(s);

  // mask the diagonal and ragged chunks
  const int qw = q0 + warp * 16;  // this warp's first query row
  if ((causal && k0 + NK - 1 > qw) || k0 + NK > Lk) {
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qw + gid + (e >> 1) * 8, kpos = k0 + j * 8 + tig * 2 + (e & 1);
        if (!visible(qpos, kpos, Lk, causal)) s[4 * j + e] = -INFINITY;
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m[i], mx * sl2);
    const float base = mx == -INFINITY ? 0.f : mx;  // nothing visible yet: p = 0
    const float corr = exp2_fast(m[i] - base);
    m[i] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      s[4 * j + 2 * i] = exp2_fast(fmaf(s[4 * j + 2 * i], sl2, -base));
      s[4 * j + 2 * i + 1] = exp2_fast(fmaf(s[4 * j + 2 * i + 1], sl2, -base));
      sum += s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
    }
    l[i] = l[i] * corr + sum;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * i] *= corr;
      o[4 * j + 2 * i + 1] *= corr;
    }
  }

  // O += P V, P rounded to bf16 (v's dtype) in the registers
  uint32_t pa[NK / 16][4];
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) a_from_acc(pa[kk], s, kk);
  hold(o);
  hold(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) wgmma_rs_tb<D>(o, pa[kk], desc_mn<D>(sv, FWD_BK, kk));
  wgmma_commit();
  wgmma_wait();
  hold(o);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, FwdOccupancy<D>::MIN_BLOCKS)
fwd_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                float* __restrict__ lse, int H, int KV, int Lq, int Lk, int cells_per_block,
                int causal, float scale) {
  static_assert(sizeof(T) == 2, "the bf16 instance");
  using S = FwdSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_fwd[];
  const uint32_t raw = smem_addr(smem_fwd);
  const uint32_t tiles = (raw + S::BARRIERS * 8 + 1023) & ~1023u;
  unsigned char* tiles_p = smem_fwd + (tiles - raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem_fwd);  // [FWD_STAGES]
  uint64_t* kv_empty = kv_full + FWD_STAGES;                   // [FWD_STAGES], streaming only
  uint64_t* q_full = kv_empty + FWD_STAGES;                    // [CONSUMERS][2]
  uint64_t* q_empty = q_full + 2 * CONSUMERS;                  // [CONSUMERS][2]

  const int g = blockIdx.y, b = blockIdx.z;
  const int rep = H / KV;
  const int cell0 = blockIdx.x * cells_per_block;
  const int cell_end = min(rep * ((Lq + FWD_BQ - 1) / FWD_BQ), cell0 + cells_per_block);
  const int rounds = (cell_end - cell0 + CONSUMERS - 1) / CONSUMERS;
  const int nkv = (Lk + FWD_BK - 1) / FWD_BK;
  const bool resident = nkv <= FWD_STAGES;

  if (threadIdx.x == 0) {
    for (int i = 0; i < FWD_STAGES; ++i) {
      bar_init(&kv_full[i], 1);
      bar_init(&kv_empty[i], CONSUMERS * 4);  // lane 0 of every consumer warp
    }
    for (int i = 0; i < 2 * CONSUMERS; ++i) {
      bar_init(&q_full[i], 1);
      bar_init(&q_empty[i], 1);
    }
    bar_init_fence();
  }
  __syncthreads();

  // cell c of the head: query tile c / rep of member c % rep; round i gives
  // warpgroup w the cell cell0 + i * CONSUMERS + w
  auto round_chunks = [&](int i) {  // the chunks a streamed round walks
    int n = 0;
    for (int w = 0; w < CONSUMERS; ++w) {
      const int c = cell0 + i * CONSUMERS + w;
      if (c < cell_end) n = max(n, fwd_chunks(c / rep, Lk, causal));
    }
    return n;
  };

  if (threadIdx.x / 32 == PRODUCER_WARP) {
    if (threadIdx.x % 32 == 0) {
      int n = 0;  // chunks streamed so far
      for (int i = 0; i < rounds; ++i) {
        for (int w = 0; w < CONSUMERS; ++w) {
          const int c = cell0 + i * CONSUMERS + w;
          if (c >= cell_end) continue;
          const int slot = w * 2 + (i & 1);
          bar_wait(&q_empty[slot], ((i >> 1) & 1) ^ 1);
          bar_arrive_tx(&q_full[slot], S::QTILE);
          load_tile<D>(tiles + S::Q + slot * S::QTILE, &tq, &q_full[slot], FWD_BQ,
                       g * rep + c % rep, (c / rep) * FWD_BQ, b);
        }
        const int nk = resident ? (i == 0 ? nkv : 0) : round_chunks(i);
        for (int kc = 0; kc < nk; ++kc, ++n) {
          const int st = resident ? kc : n % FWD_STAGES;
          if (!resident) bar_wait(&kv_empty[st], ((n / FWD_STAGES) & 1) ^ 1);
          bar_arrive_tx(&kv_full[st], 2 * S::CHUNK);
          load_tile<D>(tiles + S::K + st * S::CHUNK, &tk, &kv_full[st], FWD_BK, g, kc * FWD_BK, b);
          load_tile<D>(tiles + S::V + st * S::CHUNK, &tv, &kv_full[st], FWD_BK, g, kc * FWD_BK, b);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const float sl2 = scale * LOG2E;
  int n = 0;  // chunks streamed so far
  for (int i = 0; i < rounds; ++i) {
    const int c = cell0 + i * CONSUMERS + wg;
    const bool mine = c < cell_end;
    const int slot = wg * 2 + (i & 1);
    const uint32_t sq = tiles + S::Q + slot * S::QTILE;
    const int t = mine ? c / rep : 0, h = g * rep + c % rep, q0 = t * FWD_BQ;
    const int nk = mine ? fwd_chunks(t, Lk, causal) : 0;
    const int walk = resident ? nk : round_chunks(i);

    float o[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    if (mine) bar_wait(&q_full[slot], (i >> 1) & 1);
    for (int kc = 0; kc < walk; ++kc) {
      const int st = resident ? kc : n % FWD_STAGES;
      bar_wait(&kv_full[st], resident ? 0 : (n / FWD_STAGES) & 1);
      if (kc < nk) {
        const int k0 = kc * FWD_BK;
        const uint32_t sk = tiles + S::K + st * S::CHUNK, sv = tiles + S::V + st * S::CHUNK;
        switch ((min(FWD_BK, Lk - k0) + 15) / 16) {
          case 1: fwd_chunk<D, 16>(o, m, l, sq, sk, sv, q0, k0, Lk, causal, sl2); break;
          case 2: fwd_chunk<D, 32>(o, m, l, sq, sk, sv, q0, k0, Lk, causal, sl2); break;
          case 3: fwd_chunk<D, 48>(o, m, l, sq, sk, sv, q0, k0, Lk, causal, sl2); break;
          default: fwd_chunk<D, 64>(o, m, l, sq, sk, sv, q0, k0, Lk, causal, sl2); break;
        }
      }
      if (!resident) {
        __syncwarp();
        if (lane == 0) bar_arrive(&kv_empty[st]);
        ++n;
      }
    }
    if (!mine) continue;

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    // O into the cell's Q slot (its last reader, S = Q K^T, is done), in
    // the layout the Q tile came in, then out by TMA
    unsigned char* so = tiles_p + (sq - tiles);
    const int row = warp * 16 + gid;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(so + swizzled<D>(FWD_BQ, row, col)) =
          pack_bf16(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(so + swizzled<D>(FWD_BQ, row + 8, col)) =
          pack_bf16(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]);
    }
    if (lse != nullptr && tig == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = q0 + row + 8 * r;
        if (qpos < Lq) lse[((long long)b * H + h) * Lq + qpos] = (m[r] + log2f(l[r])) * LN2;
      }
    }
    fence_async_smem();
    warpgroup_sync(wg);
    if (threadIdx.x % 128 == 0) {
      store_tile<D>(&to, sq, FWD_BQ, h, q0, b);
      tma_store_commit();
      tma_store_wait();
      bar_arrive(&q_empty[slot]);
    }
  }
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H, int KV,
        int Lq, int Lk, long long sqb, long long sql, long long sqh, long long skb, long long skl,
        long long skh, long long svb, long long svl, long long svh, int causal, float scale,
        void* stream) {
  CUtensorMap tq, tk, tv, to;
  int err = encode<D>(&tq, q, B, Lq, H, sqb, sql, sqh, FWD_BQ);
  if (!err) err = encode<D>(&tk, k, B, Lk, KV, skb, skl, skh, FWD_BK);
  if (!err) err = encode<D>(&tv, v, B, Lk, KV, svb, svl, svh, FWD_BK);
  if (!err)
    err = encode<D>(&to, o, B, Lq, H, (long long)Lq * H * D, (long long)H * D, D, FWD_BQ);
  if (err) return err;
  auto kernel = fwd_kernel_sm90<bf16, D>;
  constexpr size_t smem = FwdSmem<D>::BYTES;
  static const int per_sm = resident_blocks(kernel, smem);
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  cudaError_t set = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (set != cudaSuccess) return (int)set;
  const int cells = (H / KV) * ((Lq + FWD_BQ - 1) / FWD_BQ);
  const int per_block = cells_per_block(cells, B * KV, sm_count() * per_sm);
  const dim3 grid((cells + per_block - 1) / per_block, KV, B);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(tq, tk, tv, to, lse, H, KV, Lq, Lk,
                                                         per_block, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace flash

// q [B, Lq, H, D], k/v [B, Lk, KV, D] (strided; head_dim contiguous; for
// bf16 the batch/seq/head strides and the base are 16-byte aligned, as TMA
// needs, see ops/flash.py); o contiguous [B, Lq, H, D] in the input dtype;
// lse contiguous fp32 [B, H, Lq], or null for the no-lse variant.  Returns
// the launch status (or a tensor-map error, flash_sm90.cuh).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         int dtype, int B, int H, int KV, int Lq, int Lk, int head_dim,
                         long long sqb, long long sql, long long sqh, long long skb,
                         long long skl, long long skh, long long svb, long long svl,
                         long long svh, int causal, float scale, void* stream) {
  using namespace flash;
  if (dtype == FLASH_DTYPE_BF16) {
    FLASH_HEAD_DIM(head_dim, {
      return sm90::fwd<D>(q, k, v, o, lse, B, H, KV, Lq, Lk, sqb, sql, sqh, skb, skl, skh, svb,
                          svl, svh, causal, scale, stream);
    });
  } else if (dtype == FLASH_DTYPE_F32) {
    const dim3 grid((Lq + BQ - 1) / BQ, H, B);
    FLASH_HEAD_DIM(head_dim, {
      constexpr int LD = Tile<D>::LD;
      const size_t smem = sizeof(float) * (BQ * LD + 2 * BK * LD + BQ * LS + 3 * BQ);
      return launch(fwd_kernel<float, D>, grid, smem, stream, (const float*)q, (const float*)k,
                    (const float*)v, (float*)o, lse, H, KV, Lq, Lk, sqb, sql, sqh, skb, skl,
                    skh, svb, svl, svh, causal, scale);
    });
  }
  return (int)cudaErrorInvalidValue;
}
