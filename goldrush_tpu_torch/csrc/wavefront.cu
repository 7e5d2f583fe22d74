// wave_adjacency (K23a) and wave_rounds (K23b): the wavefront consume of
// one window of reads (goldrush_tpu/path/wavefront.py:159,
// build_wave_consume), the opt-in alternative to the consume scan.
//
// wave_adjacency replaces the window's overlap adjacency
// (wavefront.py:281-345).  Every valid frame of the insert grid is keyed by
// its conflict key (the rank, or the direct filter's slot & (2^24 - 1)),
// its fingerprint (the low 15 bits of the seed's hash at the frame's plain
// position f * insert_stride) and its read's order; a pair of reads counts
// once per (key, fingerprint) group in which the two are consecutive
// distinct orders.  The JAX function sorts all keys of the window; any
// grouping by (key, fingerprint) gives the same counts, so here:
//   1. adj_keys: one CTA per (read, tile) stages the read's codes as kernel
//      A does (seed_hash.cuh), hashes each frame's fingerprint, writes the
//      frame's 64-bit key (or kSentinel64 for an invalid frame) and counts
//      it into its partition, a hash of (key, fingerprint) over `parts`;
//   2. adj_offsets: one CTA turns the counts into each partition's slice of
//      the bucket array: its keys, or the next power of two of them when
//      they are more than a CTA sorts in shared memory (`cap`);
//   3. adj_scatter: every key goes to a free place of its slice;
//   4. adj_pairs: one CTA per partition sorts its slice (bitonic, in shared
//      memory, or in place in the slice) and adds each adjacent pair of a
//      group with distinct orders to counts[hi * B + lo], one atomic per
//      distinct pair of a warp.
// Bound: the grid (B * H * T * F int64) and the codes read once, the
// [B, B] counts written; its hashes' integer operations are fewer
// (chip_smoke.py counts both).  At the bench window (B = 256, T = 20, h =
// 3, F = 1,000: 15.4 M keys) the keys and buckets cross memory four times,
// ~0.5 GB.
//
// wave_rounds replaces the round loop (wavefront.py:491-726) as one
// cooperative launch per window: a persistent grid of one CTA per SM, as
// the consume kernel (consume.cu), every CTA keeping the round's per-read
// bookkeeping over the window itself, computed identically from the same
// global inputs: pending and stale flags and committed lengths in shared
// memory, the reservations' prefix sums, the rotation horizon, the
// conflict test against the adjacency (as bits, built once per launch)
// and the silver rotation.  Each round:
//   1. the pending stale reads are probed: kernel B's tile code on (read,
//      tile) pairs over the CTAs, through the bracket view of both tables
//      under each read's id ceiling (BracketWord, the template parameter of
//      probe_vote_tile), a grid barrier, then kernel C on each read by one
//      warp of the grid (read_outcome), which writes the read's row, and a
//      grid barrier;
//   2-4. the zone, drops, candidates and conflicts, per CTA;
//   5. phase A's commits under the horizon insert (insert_max's rule into
//      both tables: or_bits | id into the id table and INV_BASE - id into
//      the side table, atomicMax); the zone's committable reads are
//      rechecked at full resolution (as in 1, on the insert grid), then
//      phase B's commits insert;
//   6. stale marking, the rotation (a grid-stride reset of both tables)
//      and the reopening of drops past it.
// The tables are read through L2 (other CTAs write them); a probe, insert
// or reset that follows a write of the tables first crosses a grid barrier
// (two inserts need none: atomicMax commutes).  A window that needs more
// than B * (max_paths + 2) rounds, or whose ids would reach INV_BASE, stops
// and counts a fault, which the engine raises on.
// Bound: the bytes of every round's work (each probed tile's grid entries
// and words of both tables, each insert's window and two atomics per
// entry, each reset's tables); its cost is latency: a round is a chain of
// grid barriers, block scans and kernel C's sequential passes.
#include <cooperative_groups.h>

#include <algorithm>

#include "classify.cuh"
#include "probe_vote.cuh"
#include "seed_hash.cuh"

namespace cg = cooperative_groups;

namespace gr {

constexpr int kFpBits = 15;              // wavefront.FP_BITS
constexpr uint32_t kInvBase = 1u << 28;  // wavefront.INV_BASE
constexpr int kAdjMin = 6;               // wavefront.ADJ_MIN
constexpr int kAdjThreads = 256;
// warps of each CTA that run kernel C on the probed reads
constexpr int kWaveWarps = 4;

// ---------------------------------------------------------------- K23a

// The partition of a (conflict key, fingerprint) group among `parts`.
__device__ __forceinline__ uint32_t group_part(uint64_t group,
                                               uint32_t parts) {
  return __umulhi(
      static_cast<uint32_t>((group * 0x9E3779B97F4A7C15ull) >> 32), parts);
}

// The slice a partition of n keys takes: n, or the next power of two of
// them where it sorts in global memory (more than `cap`).
__host__ __device__ inline long long slice_size(int n, int cap) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  return n2 > cap ? n2 : n;
}

// grid (B * T): CTA b * T + t keys tile t of read b.
__global__ void __launch_bounds__(kAdjThreads) adj_keys_kernel(
    const int64_t* __restrict__ grid, int H, int T, int F, int S, int TL,
    const uint8_t* __restrict__ codes, int64_t L, const Family f,
    int64_t limit, int direct, int ob, uint32_t parts,
    unsigned long long* __restrict__ keys, int* __restrict__ part_count) {
  extern __shared__ ulonglong2 smem[];
  const int b = blockIdx.x / T, t = blockIdx.x % T;
  // frame j of the tile reads right partials up to j * S + h - 1
  const int m = TL + f.h - 1;
  const Stage st(smem, f, m);
  stage(f, codes + static_cast<int64_t>(b) * L, L,
        static_cast<int64_t>(t) * TL, m, S, st);
  const int64_t TF = static_cast<int64_t>(T) * F;
  for (int j = threadIdx.x; j < F; j += blockDim.x) {
    const int p = j * S;
    const ulonglong2 left = left_at(f, st, p);
    for (int s = 0; s < H; ++s) {
      const int64_t e =
          (static_cast<int64_t>(b) * H + s) * TF + static_cast<int64_t>(t) * F +
          j;
      const int64_t g = grid[e];
      unsigned long long key = kSentinel64;
      if (g < limit) {
        const uint64_t fp = canon(st, left, p, s) & ((1u << kFpBits) - 1u);
        const uint64_t conf = direct ? static_cast<uint64_t>(g) & 0xFFFFFFull
                                     : static_cast<uint64_t>(g);
        const uint64_t group = (conf << kFpBits) | fp;
        key = (group << ob) | static_cast<uint64_t>(b);
        atomicAdd(part_count + group_part(group, parts), 1);
      }
      keys[e] = key;
    }
  }
}

// one CTA: each partition's slice offset (part_off [parts + 1]) and its
// fill cursor.
__global__ void __launch_bounds__(1024) adj_offsets_kernel(
    const int* __restrict__ part_count, uint32_t parts, int cap,
    long long* __restrict__ part_off, unsigned long long* __restrict__ cursor) {
  __shared__ unsigned long long scratch[1024];
  unsigned long long carry = 0;
  for (uint32_t base = 0; base < parts; base += blockDim.x) {
    const uint32_t p = base + threadIdx.x;
    const unsigned long long size =
        p < parts ? static_cast<unsigned long long>(
                        slice_size(part_count[p], cap))
                  : 0ull;
    const unsigned long long ex =
        block_exclusive_scan(size, 0ull, scratch, AddOp{});
    if (p < parts) {
      part_off[p] = static_cast<long long>(carry + ex);
      cursor[p] = carry + ex;
    }
    carry += scratch[blockDim.x - 1];
  }
  if (threadIdx.x == 0) part_off[parts] = static_cast<long long>(carry);
}

__global__ void adj_scatter_kernel(const unsigned long long* __restrict__ keys,
                                   int64_t n, int ob, uint32_t parts,
                                   unsigned long long* __restrict__ cursor,
                                   unsigned long long* __restrict__ buckets) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const unsigned long long k = keys[e];
    if (k == kSentinel64) continue;
    buckets[atomicAdd(cursor + group_part(k >> ob, parts), 1ull)] = k;
  }
}

// grid (parts): CTA p sorts partition p and counts its pairs.
__global__ void __launch_bounds__(kAdjThreads) adj_pairs_kernel(
    const int* __restrict__ part_count, const long long* __restrict__ part_off,
    int cap, int ob, int B, unsigned long long* buckets,
    int* __restrict__ cnt) {
  unsigned long long* sk = reinterpret_cast<unsigned long long*>(gr_smem);
  const int n = part_count[blockIdx.x];
  if (n < 2) return;
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  unsigned long long* a = buckets + part_off[blockIdx.x];
  if (n2 <= cap) {
    for (int i = threadIdx.x; i < n2; i += blockDim.x)
      sk[i] = i < n ? a[i] : kSentinel64;
    a = sk;
  } else {
    for (int i = n + threadIdx.x; i < n2; i += blockDim.x) a[i] = kSentinel64;
  }
  __syncthreads();
  block_bitonic_sort(a, n2);
  const unsigned long long mask = (1ull << ob) - 1ull;
  const int lane = threadIdx.x & 31;
  // every lane of a warp runs every round (the match below)
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int idx = -1;
    if (i >= 1 && i < n) {
      const unsigned long long k0 = a[i - 1], k1 = a[i];
      const int o0 = static_cast<int>(k0 & mask);
      const int o1 = static_cast<int>(k1 & mask);
      if ((k0 >> ob) == (k1 >> ob) && o0 != o1)
        idx = max(o0, o1) * B + min(o0, o1);
    }
    const unsigned peers = __match_any_sync(kFull, idx);
    if (idx >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(cnt + idx, __popc(peers));
  }
}

// ---------------------------------------------------------------- K23b

// The bracket view (wavefront.py:213-231 compressed, :252-270 direct): the
// latest id p of an entry is visible under the read's ceiling when 0 < p
// <= ceil, else the earliest, INV_BASE - side, when side >= INV_BASE -
// ceil; the direct word keeps its high bits beside the visible id, a real
// rank reads PRESENT | id.  Unsigned 32-bit arithmetic, as the JAX view's.
struct BracketWord {
  const uint32_t* side;
  uint32_t ceil;

  template <bool kFused>
  __device__ __forceinline__ uint32_t get(const uint32_t* words, int ranked,
                                          int64_t limit, int64_t x) const {
    if (ranked && x >= limit) return 0u;
    const uint32_t w = load<kFused>(words + x), c = load<kFused>(side + x);
    const uint32_t p = ranked ? w : w & kIdMask;
    const uint32_t early = c > 0u && c >= kInvBase - ceil ? kInvBase - c : 0u;
    const uint32_t idv = p > 0u && p <= ceil ? p : early;
    return ranked ? kPresent | idv : (w & ~kIdMask) | idv;
  }
};

struct WaveArgs {
  uint32_t* table;  // the id table: direct words or rank-indexed ids
  uint32_t* side;   // the side table, the same shape
  int64_t alloc;
  int ranked;
  int64_t limit;     // entries below it are real (the sentinel)
  uint32_t or_bits;  // an inserted entry's bits beside its id
  const int64_t* grid_q;  // [B, Hq, T * Fq], the query tier
  const bool* ok_q;
  int Hq, Fq;
  const int64_t* grid_i;  // [B, Hi, T * Fi], the insert grid
  const bool* ok_i;
  int Hi, Fi;
  const int32_t* n_tiles;   // [B]
  const int64_t* full_len;  // [B]
  const int32_t* adj;       // [B, B] wave_adjacency's counts
  int B, T, K;
  int vote_min_q, x_q, bits_q, vote_min_f, x_f, bits_f;
  int u_min, a_max, TL, bs, S, rech_on, silver, cbuf, warp_bytes;
  int64_t target, max_paths;
  int64_t* scal;      // [4] id reservations, bases, path index, done
  int64_t* rows;      // [B, 8]
  int64_t* counters;  // [6] wavefront.WAVE_COUNTS
  // scratch: per read its vote buffer (consume.cu's layout), tile_min and
  // its row of adjacency bits
  unsigned long long* sums;  // [B, 3, T]
  int32_t* vals;             // [B, 3T + 2TK]
  bool* binit;               // [B, T]
  int64_t* tmin;             // [B]
  uint32_t* adj_bits;        // [B, ceil(B / 32)]
  size_t state_off;          // the per-read state in dynamic shared memory
};

struct Tier {
  const int64_t* grid;
  const bool* ok;
  int H, F, vote_min, threshold, bits;
};

// per-read flags: kept across rounds (pending, stale) and per round
enum : uint8_t {
  kPend = 1,
  kStale = 2,
  kZone = 4,
  kDrop = 8,
  kCand = 16,
  kCommit = 32,
  kAllowA = 64,
  kAllowB = 128
};

// Inclusive prefix sums over i < B of v(i), handed to out(i, sum) by the
// thread that owns i (i = threadIdx.x + k * blockDim.x, as in every loop
// over reads here); returns the total.  Every thread of the CTA calls it;
// it ends with a barrier.
template <typename V, typename O>
__device__ long long block_cumsum(int B, V v, O out,
                                  unsigned long long* scratch) {
  unsigned long long carry = 0;
  for (int base = 0; base < B; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const unsigned long long x =
        i < B ? static_cast<unsigned long long>(v(i)) : 0ull;
    const unsigned long long ex =
        block_exclusive_scan(x, 0ull, scratch, AddOp{});
    if (i < B) out(i, static_cast<long long>(carry + ex + x));
    carry += scratch[blockDim.x - 1];
  }
  __syncthreads();
  return static_cast<long long>(carry);
}

// How many i < B satisfy pred; every thread calls it.
template <typename P>
__device__ int block_count(int B, P pred) {
  int c = 0;
  for (int base = 0; base < B; base += blockDim.x) {
    const int i = base + threadIdx.x;
    c += __syncthreads_count(i < B && pred(i));
  }
  return c;
}

// The least i < B satisfying pred, or B; every thread calls it.
template <typename P>
__device__ int block_first(int B, P pred, int* slot) {
  __syncthreads();
  if (threadIdx.x == 0) *slot = B;
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += blockDim.x)
    if (pred(i)) atomicMin(slot, i);
  __syncthreads();
  const int r = *slot;
  __syncthreads();
  return r;
}

// The reads satisfying pred, in order, into list; returns their number.
template <typename P>
__device__ int block_compact(int B, P pred, int32_t* list,
                             unsigned long long* scratch) {
  return static_cast<int>(block_cumsum(
      B, [&](int i) { return pred(i) ? 1 : 0; },
      [&](int i, long long incl) {
        if (pred(i)) list[incl - 1] = i;
      },
      scratch));
}

// Probe the n reads of `list` with `tier` through the bracket view under
// their ceilings and classify them: their rows (and, for the query tier,
// tile_min) are written.  Every thread of every CTA calls it; it ends with
// a grid barrier.
__device__ void probe_rows(const WaveArgs& a, const Tier& tier,
                           const int32_t* list, int n, const uint32_t* ceil,
                           bool query, cg::grid_group& grid) {
  const int T = a.T, K = a.K;
  const int64_t TF = static_cast<int64_t>(T) * tier.F;
  const int64_t vb = 3 * T + 2 * T * K;
  for (int64_t u = blockIdx.x; u < static_cast<int64_t>(n) * T;
       u += gridDim.x) {
    const int r = list[u / T], t = static_cast<int>(u % T);
    int32_t* curr = a.vals + r * vb;
    unsigned long long* q = a.sums + static_cast<int64_t>(r) * 3 * T;
    probe_vote_tile<true>(
        a.table, tier.grid + static_cast<int64_t>(r) * tier.H * TF, a.ranked,
        a.limit, tier.ok + static_cast<int64_t>(r) * TF, tier.H, T, tier.F,
        K, tier.vote_min, tier.threshold, tier.bits, t, 0, curr, curr + T,
        curr + 3 * T, curr + 3 * T + T * K,
        a.binit + static_cast<int64_t>(r) * T, curr + 2 * T, q, q + T,
        q + 2 * T, BracketWord{a.side, ceil[r]});
    __syncthreads();
  }
  grid.sync();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = min(kWaveWarps, static_cast<int>(blockDim.x >> 5));
  if (warp < warps) {
    for (int j = blockIdx.x * warps + warp; j < n; j += gridDim.x * warps) {
      const int r = list[j];
      const Outcome o = read_outcome(
          a.sums + static_cast<int64_t>(r) * 3 * T, a.vals + r * vb,
          a.n_tiles[r], T, K, tier.threshold, a.u_min, a.a_max, a.cbuf,
          gr_smem + warp * a.warp_bytes, lane);
      if (lane == 0) {
        int64_t* row = a.rows + static_cast<int64_t>(r) * 8;
        row[0] = o.dec;
        row[1] = o.ts;
        row[2] = o.te;
        row[3] = o.na;
        row[4] = o.q;
        row[5] = o.h;
        row[6] = o.m;
        row[7] = o.ov;
        if (query) a.tmin[r] = o.tmin;
      }
    }
  }
  grid.sync();
}

// A read's commit geometry (wavefront.py:578-587): the bases it adds and
// its tiles lo..hi.
struct Geo {
  int64_t rec;
  int lo, hi;
};

__device__ __forceinline__ int64_t row_at(const WaveArgs& a, int i, int c) {
  return __ldcg(a.rows + static_cast<int64_t>(i) * 8 + c);
}

__device__ __forceinline__ Geo geometry(const WaveArgs& a, int i) {
  const int64_t dec = row_at(a, i, 0), ts = row_at(a, i, 1),
                te = row_at(a, i, 2), n = a.n_tiles[i], L = a.full_len[i];
  const int64_t l_trim = te == n - 1 ? L - ts * a.TL : (te - ts + 1) * a.TL;
  return Geo{dec == 1 ? L : dec == 2 ? l_trim : 0,
             dec == 1 ? 0 : static_cast<int>(ts),
             dec == 1 ? static_cast<int>(n - 1) : static_cast<int>(te)};
}

// The scatter-max insert of the n reads of `list` (wavefront.py:456-489):
// every real entry of tiles lo..hi of each read's insert grid raises the id
// table to or_bits | id and the side table to INV_BASE - id, ids from
// ceil + 1.  Every thread of every CTA calls it.
__device__ void insert_rows(const WaveArgs& a, const int32_t* list, int n,
                            const uint32_t* ceil) {
  const int64_t TF = static_cast<int64_t>(a.T) * a.Fi;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x,
                step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int j = 0; j < n; ++j) {
    const int r = list[j];
    const Geo g = geometry(a, r);
    const int last = min(g.hi, a.T - 1);
    if (last < g.lo) continue;
    const int64_t window = static_cast<int64_t>(last - g.lo + 1) * a.Fi;
    const uint32_t base = ceil[r] + 1u;
    const bool trimmed = row_at(a, r, 0) == 2;
    const int64_t* grid = a.grid_i + static_cast<int64_t>(r) * a.Hi * TF;
    for (int64_t e = start; e < window * a.Hi; e += step) {
      const int64_t col = static_cast<int64_t>(g.lo) * a.Fi + e % window;
      const int64_t key = grid[(e / window) * TF + col];
      if (key < 0 || key >= a.limit) continue;
      const uint32_t m = static_cast<uint32_t>(col / a.Fi - g.lo) / a.bs;
      const uint32_t b = static_cast<uint32_t>(a.bs);
      const uint32_t id = base + (trimmed ? (m * b + 1u) / b : m);
      atomicMax(reinterpret_cast<int*>(a.table) + key,
                static_cast<int>(a.or_bits | id));
      atomicMax(reinterpret_cast<int*>(a.side) + key,
                static_cast<int>(kInvBase - id));
    }
  }
}

// The silver rotation's reset over the grid: the id table forgets its ids
// (the direct words keep PRESENT), the side table empties.
__device__ void reset_tables(const WaveArgs& a) {
  int4* w = reinterpret_cast<int4*>(a.table);
  int4* c = reinterpret_cast<int4*>(a.side);
  const int4 zero = make_int4(0, 0, 0, 0);
  const int p = static_cast<int>(kPresent);
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < a.alloc / 4; j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (a.ranked) {
      w[j] = zero;
    } else {
      const int4 v = __ldcg(w + j);
      w[j] = make_int4(v.x & p, v.y & p, v.z & p, v.w & p);
    }
    c[j] = zero;
  }
}

__global__ void __launch_bounds__(kThreads, 1) wave_kernel(const WaveArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned long long scan[kThreads];
  __shared__ int slot;
  __shared__ long long cum_at[2];
  const int B = a.B, W = (B + 31) >> 5, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // per read: flags, committed length, id ceiling; a list of reads; the
  // unresolved reads' bits
  unsigned char* st = gr_smem + a.state_off;
  uint8_t* fl = st;
  int64_t* clen = reinterpret_cast<int64_t*>(st + ((B + 15) & ~15));
  uint32_t* ceil = reinterpret_cast<uint32_t*>(clen + B);
  int32_t* list = reinterpret_cast<int32_t*>(ceil + B);
  uint32_t* unres = reinterpret_cast<uint32_t*>(list + B);
  const Tier tq{a.grid_q, a.ok_q, a.Hq, a.Fq, a.vote_min_q, a.x_q, a.bits_q};
  const Tier tf{a.grid_i, a.ok_i, a.Hi, a.Fi, a.vote_min_f, a.x_f, a.bits_f};
  const int64_t ids0 = a.scal[0], bases0 = a.scal[1];
  int64_t path_idx = a.scal[2], done = a.scal[3];
  const int64_t target_eff = a.silver ? a.target : (1ll << 62);
  const int64_t gtid = static_cast<int64_t>(blockIdx.x) * blockDim.x + tid;
  const int64_t gstep = static_cast<int64_t>(gridDim.x) * blockDim.x;

  // rows start at zero; the adjacency as bits, one warp per word
  for (int64_t j = gtid; j < static_cast<int64_t>(B) * 8; j += gstep)
    a.rows[j] = 0;
  for (int64_t j = gtid; j < B; j += gstep) a.tmin[j] = 0;
  for (int64_t u = gtid >> 5; u < static_cast<int64_t>(B) * W;
       u += gstep >> 5) {
    const int i = static_cast<int>(u / W);
    const int j = static_cast<int>(u % W) * 32 + lane;
    const unsigned bits = __ballot_sync(
        kFull, j < B && a.adj[static_cast<int64_t>(i) * B + j] >= kAdjMin);
    if (lane == 0) a.adj_bits[u] = bits;
  }
  for (int i = tid; i < B; i += blockDim.x) {
    fl[i] = (done == 0 ? kPend : 0) | kStale;
    clen[i] = 0;
  }
  grid.sync();

  auto maxb = [&](int i) -> int64_t {
    const int64_t L = a.full_len[i];
    return L > 0 ? 1 + L / (static_cast<int64_t>(a.TL) * a.bs) : 0;
  };
  const int64_t cap = static_cast<int64_t>(B) * (a.max_paths + 2);
  int rot_pos = -1;
  int dirty = 0;  // 1: inserts, 2: a reset since the last grid barrier
  int64_t n_rounds = 0, n_class = 0, n_rech = 0, n_commit = 0, n_rot = 0;
  int64_t fault = 0;
  for (;;) {
    if (block_count(B, [&](int i) { return (fl[i] & kPend) != 0; }) == 0)
      break;
    if (n_rounds >= cap) {
      fault = 1;
      break;
    }
    ++n_rounds;
    // read-order id reservations and each read's id ceiling
    const int64_t base0 = rot_pos < 0 ? bases0 : 0;
    const int64_t ids_base = rot_pos < 0 ? ids0 : 0;
    const long long resv = block_cumsum(
        B, [&](int i) -> long long { return i > rot_pos ? maxb(i) : 0; },
        [&](int i, long long incl) {
          ceil[i] = static_cast<uint32_t>(
              ids_base + incl - (i > rot_pos ? maxb(i) : 0));
        },
        scan);
    if (ids_base + resv >= kInvBase) {
      fault = 1;
      break;
    }
    // 1. classify the reads whose view an earlier commit changed
    const int nw = block_compact(
        B,
        [&](int i) { return (fl[i] & (kPend | kStale)) == (kPend | kStale); },
        list, scan);
    if (nw > 0) {
      if (dirty) grid.sync();
      dirty = 0;
      probe_rows(a, tq, list, nw, ceil, true, grid);
      n_class += nw;
    }
    // 2-4. zone, drops, candidates
    for (int i = tid; i < B; i += blockDim.x) {
      uint8_t f = fl[i];
      if ((f & (kPend | kStale)) == (kPend | kStale)) f &= ~kStale;
      if (f & kPend) {
        const int64_t dec = row_at(a, i, 0);
        const bool zone =
            a.rech_on &&
            recheck_zone(dec, row_at(a, i, 3), a.n_tiles[i], row_at(a, i, 1),
                         row_at(a, i, 2), __ldcg(a.tmin + i), a.S, a.x_f,
                         a.a_max);
        if (zone) f |= kZone;
        if (dec == 0 && !zone) f |= kDrop;
        if (dec > 0 || zone) f |= kCand;
      }
      fl[i] = f;
    }
    __syncthreads();
    for (int w = warp; w < W; w += blockDim.x >> 5) {
      const int j = w * 32 + lane;
      const unsigned bits = __ballot_sync(
          kFull, j < B && (fl[j] & (kPend | kDrop)) == kPend);
      if (lane == 0) unres[w] = bits;
    }
    __syncthreads();
    // a candidate waits while an earlier unresolved read overlaps it
    for (int i = tid; i < B; i += blockDim.x) {
      if (!(fl[i] & kCand)) continue;
      bool confl = false;
      for (int w = 0; w < W; ++w)
        confl |= (__ldcg(a.adj_bits + static_cast<int64_t>(i) * W + w) &
                  unres[w]) != 0u;
      if (!confl) fl[i] |= kCommit;
    }
    __syncthreads();

    // 5-7. the two phases' commits under the rotation horizon: pess(i) =
    // base0 + the in-path committed and potential bases through i; the
    // first active read always may
    auto horizon = [&](auto commit, auto act, uint8_t bit) -> int {
      const int first = block_first(B, act, &slot);
      block_cumsum(
          B,
          [&](int i) -> long long {
            if (i <= rot_pos) return 0;
            return clen[i] + (commit(i) ? geometry(a, i).rec
                              : act(i)  ? a.full_len[i]
                                        : 0);
          },
          [&](int i, long long incl) {
            if (commit(i) && (base0 + incl <= target_eff || i == first) &&
                done == 0)
              fl[i] |= bit;
          },
          scan);
      return first;
    };
    auto commit_pass = [&](uint8_t bit) {
      const int n = block_compact(
          B, [&](int i) { return (fl[i] & bit) != 0; }, list, scan);
      if (n > 0) {
        if (dirty == 2) grid.sync();
        insert_rows(a, list, n, ceil);
        dirty = 1;
      }
      for (int i = tid; i < B; i += blockDim.x)
        if (fl[i] & bit) clen[i] = geometry(a, i).rec;
      __syncthreads();
    };
    // phase A: the commits outside the zone
    const int fa = horizon(
        [&](int i) {
          return (fl[i] & (kCommit | kZone)) == kCommit && row_at(a, i, 0) > 0;
        },
        [&](int i) { return (fl[i] & (kPend | kDrop)) == kPend; }, kAllowA);
    commit_pass(kAllowA);
    // phase B: the zone's committable reads rechecked at full resolution
    // against the updated tables, then their commits
    if (a.rech_on) {
      const int nrc = block_compact(
          B,
          [&](int i) {
            return (fl[i] & (kZone | kCommit)) == (kZone | kCommit);
          },
          list, scan);
      if (nrc > 0) {
        if (dirty) grid.sync();
        dirty = 0;
        probe_rows(a, tf, list, nrc, ceil, false, grid);
        n_rech += nrc;
      }
    }
    for (int i = tid; i < B; i += blockDim.x)
      if ((fl[i] & kCommit) && row_at(a, i, 0) == 0) fl[i] |= kDrop;
    __syncthreads();
    const int fb = horizon(
        [&](int i) {
          return (fl[i] & (kCommit | kZone)) == (kCommit | kZone) &&
                 row_at(a, i, 0) > 0;
        },
        [&](int i) {
          return (fl[i] & (kPend | kDrop | kAllowA)) == kPend;
        },
        kAllowB);
    commit_pass(kAllowB);

    // commits make every later pending read stale
    const int first_commit = block_first(
        B, [&](int i) { return (fl[i] & (kAllowA | kAllowB)) != 0; }, &slot);
    n_commit += block_count(
        B, [&](int i) { return (fl[i] & (kAllowA | kAllowB)) != 0; });
    for (int i = tid; i < B; i += blockDim.x)
      if ((fl[i] & kPend) && i > first_commit) fl[i] |= kStale;
    __syncthreads();
    // the silver rotation: the first active read of a phase that commits
    // past the target
    bool do_reset = false;
    if (a.silver) {
      const bool on_a = fa < B && (fl[fa] & kAllowA);
      const bool on_b = fb < B && (fl[fb] & kAllowB);
      block_cumsum(
          B, [&](int i) -> long long { return i > rot_pos ? clen[i] : 0; },
          [&](int i, long long incl) {
            if (i == fa) cum_at[0] = incl;
            if (i == fb) cum_at[1] = incl;
          },
          scan);
      const bool fire = (on_a && base0 + cum_at[0] > target_eff) ||
                        (on_b && base0 + cum_at[1] > target_eff);
      if (fire) {
        ++path_idx;
        if (a.max_paths < path_idx)
          done = 1;
        else
          do_reset = true;
        rot_pos = min(on_a ? fa : B, on_b ? fb : B);
      }
    }
    if (do_reset) {
      if (dirty) grid.sync();
      reset_tables(a);
      dirty = 2;
      ++n_rot;
    }
    // 8. finalize; a rotation makes every read stale and reopens the drops
    // past it
    for (int i = tid; i < B; i += blockDim.x) {
      const uint8_t f = fl[i];
      bool pend = (f & kPend) && !(f & (kDrop | kAllowA | kAllowB)) &&
                  done == 0;
      if (do_reset && i > rot_pos && !pend && clen[i] == 0) pend = true;
      fl[i] = (pend ? kPend : 0) | ((f & kStale) || do_reset ? kStale : 0);
    }
    __syncthreads();
  }
  const long long sum_maxb = block_cumsum(
      B, [&](int i) -> long long { return i > rot_pos ? maxb(i) : 0; },
      [](int, long long) {}, scan);
  const long long sum_clen = block_cumsum(
      B, [&](int i) -> long long { return i > rot_pos ? clen[i] : 0; },
      [](int, long long) {}, scan);
  // every CTA read scal before it is overwritten
  grid.sync();
  if (blockIdx.x == 0 && tid == 0) {
    a.scal[0] = (rot_pos < 0 ? ids0 : 0) + sum_maxb;
    a.scal[1] = (rot_pos < 0 ? bases0 : 0) + sum_clen;
    a.scal[2] = path_idx;
    a.scal[3] = done;
    a.counters[0] += n_rounds;
    a.counters[1] += n_class;
    a.counters[2] += n_rech;
    a.counters[3] += n_commit;
    a.counters[4] += n_rot;
    a.counters[5] += fault;
  }
}

inline int bit_length(int v) {
  int b = 0;
  while (v >> b) ++b;
  return b;
}

}  // namespace gr

extern "C" {

// grid [B, H, T * F] int64 (F * S == TL); codes uint8 [B, L]; cnt int32
// [B, B], zeroed; part_count int32 [parts], zeroed; part_off int64
// [parts + 1]; cursor [parts]; keys [B * H * T * F]; buckets [2 * B * H *
// T * F].
int gr_wave_adjacency(const int64_t* grid, int B, int H, int T, int F, int S,
                      int TL, const uint8_t* codes, int64_t L,
                      const uint64_t* fam_table, int h, int k, int half,
                      int nl, int nr, int pad, int64_t limit, int direct,
                      int parts, int cap, unsigned long long* keys,
                      int* part_count, long long* part_off,
                      unsigned long long* cursor,
                      unsigned long long* buckets, int* cnt,
                      cudaStream_t stream) {
  using gr::kAdjThreads;
  if (B < 0 || B > (1 << 13) || H != h || H < 1 || T < 1 || S < 1 ||
      F * S != TL || TL < k + h - 1 || L < 1 || limit <= 0 ||
      limit >= (1ll << 31) || parts < 1 || (parts & (parts - 1)) ||
      cap < 2 || (cap & (cap - 1)) ||
      static_cast<size_t>(cap) * 8 > gr::kMaxSmem)
    return cudaErrorInvalidValue;
  if (B == 0) return gr::kNoLaunch;
  const int ob = std::max(gr::bit_length(B - 1), 1);
  const gr::Family f{h, k, half, nl, nr, pad, fam_table};
  const size_t smem = gr::stage_bytes(f, TL + h - 1);
  cudaError_t err = gr::allow_smem(gr::adj_keys_kernel, smem);
  if (err != cudaSuccess) return err;
  gr::adj_keys_kernel<<<B * T, kAdjThreads, smem, stream>>>(
      grid, H, T, F, S, TL, codes, L, f, limit, direct, ob,
      static_cast<uint32_t>(parts), keys, part_count);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gr::adj_offsets_kernel<<<1, 1024, 0, stream>>>(
      part_count, static_cast<uint32_t>(parts), cap, part_off, cursor);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(B) * H * T * F;
  gr::adj_scatter_kernel<<<static_cast<unsigned>(
                               std::min<int64_t>((n + 255) / 256, 1 << 16)),
                           256, 0, stream>>>(keys, n, ob,
                                             static_cast<uint32_t>(parts),
                                             cursor, buckets);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem_pairs = static_cast<size_t>(cap) * 8;
  if ((err = gr::allow_smem(gr::adj_pairs_kernel, smem_pairs)) != cudaSuccess)
    return err;
  gr::adj_pairs_kernel<<<parts, kAdjThreads, smem_pairs, stream>>>(
      part_count, part_off, cap, ob, B, buckets, cnt);
  return cudaGetLastError();
}

int gr_wave_rounds(uint32_t* table, uint32_t* side, int64_t alloc, int ranked,
                   int64_t limit, uint32_t or_bits, const int64_t* grid_q,
                   const bool* ok_q, int Hq, int Fq, const int64_t* grid_i,
                   const bool* ok_i, int Hi, int Fi, const int32_t* n_tiles,
                   const int64_t* full_len, const int32_t* adj, int B, int T,
                   int K, int vote_min_q, int x_q, int vote_min_f, int x_f,
                   int u_min, int a_max, int TL, int bs, int S, int rech_on,
                   int silver, int64_t target, int64_t max_paths,
                   int64_t* scal, int64_t* rows, int64_t* counters,
                   unsigned long long* sums, int32_t* vals, bool* binit,
                   int64_t* tmin, uint32_t* adj_bits, cudaStream_t stream) {
  using gr::kThreads;
  const int bits_q = gr::table_bits(Hq * Fq), bits_f = gr::table_bits(Hi * Fi);
  if (B < 0 || T < 1 || K < 1 || Hq < 1 || Hi < 1 || Hq > gr::kMaxH ||
      Hi > gr::kMaxH || K > Hq * Fq || bits_q > 14 ||
      (rech_on && (K > Hi * Fi || bits_f > 14)) || alloc % 4 || bs < 1 ||
      TL < 1 || limit <= 0 || limit >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(table) % 16 ||
      reinterpret_cast<uintptr_t>(side) % 16)
    return cudaErrorInvalidValue;
  if (B == 0) return gr::kNoLaunch;
  // kernel C's per-warp buffer, as the consume kernel sizes it
  int t2 = 1;
  while (t2 < T) t2 <<= 1;
  const int chunk = (T < 32 ? T : 32) * K;
  const int cbuf = t2 > chunk ? t2 : chunk;
  const int warp_bytes = (8 * (((T + 1) & ~1) + cbuf) + 15) & ~15;
  size_t work = static_cast<size_t>(gr::kWaveWarps) * warp_bytes;
  for (int bits : {bits_q, rech_on ? bits_f : 1})
    work = std::max(work, ((static_cast<size_t>(1) << bits) + kThreads) *
                              sizeof(unsigned long long));
  work = (work + 15) & ~static_cast<size_t>(15);
  const size_t state = ((B + 15) & ~15) + static_cast<size_t>(B) * 16 +
                       4 * static_cast<size_t>((B + 31) / 32);
  const size_t smem = work + state;
  if (smem > gr::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = gr::allow_smem(gr::wave_kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, gr::wave_kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  gr::WaveArgs a{table, side, alloc, ranked, limit, or_bits, grid_q, ok_q,
                 Hq, Fq, grid_i, ok_i, Hi, Fi, n_tiles, full_len, adj, B, T,
                 K, vote_min_q, x_q, bits_q, vote_min_f, x_f, bits_f, u_min,
                 a_max, TL, bs, S, rech_on, silver, cbuf, warp_bytes, target,
                 max_paths, scal, rows, counters, sums, vals, binit, tmin,
                 adj_bits, work};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gr::wave_kernel),
                                    dim3(sms), dim3(kThreads), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
