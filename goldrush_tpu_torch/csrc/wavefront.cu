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
// grouping by (key, fingerprint) gives the same counts.  It replaces a
// design that wrote every frame's key to a 123 MB array with a global
// atomic each, scattered the keys with another, and bitonic-sorted each of
// 8,192 partitions (2.42-2.48 ms a bench window on an H100, 64x its bound,
// 1.31 ms of it the sorts; a homopolymer window's partitions of millions of
// keys sorted in global memory, ~1.5 s).  Here, with no global atomic per
// key and no key array between the hashing passes:
//   1. count: each CTA (about two an SM) hashes its tiles' frames as kernel
//      A does (seed_hash.cuh) and counts their keys per bucket (256 ranges
//      of consecutive partitions, a partition a hash of the group) in
//      shared memory, then writes one row of counts;
//   2. scan: the (bucket, CTA) offsets: each CTA's run in every bucket;
//   3. scatter: the CTAs hash again and write each round of keys (a tile's
//      frames and seeds, up to kRoundKeys) bucket by bucket
//      (staged_write), so that a bucket's keys of a round leave as one
//      run; written a key at a time, the keys cost twice as much;
//   4. split: a CTA per bucket splits its slice into its partitions'
//      (about ADJ_KEYS_PER_PART keys each), the same way;
//   5. group: a CTA per partition groups its keys by (key, fingerprint) in
//      a shared-memory table with each group's least and greatest orders,
//      the first order found between them and whether another is.  In a
//      bench window 87% of groups hold one order and pair with nothing; a
//      group of two orders is one pair and one of three two, counted by
//      the key that claimed the group; only the keys of groups of four or
//      more orders (~3% of the keys) are sorted, and each adjacent pair of
//      distinct orders counts.  A partition past the shared-memory
//      capacity (a heavy group: homopolymers, a repeated read) takes its
//      distinct keys; one with more than half the capacity of distinct keys
//      sorts its slice in global memory: any partition, exactly.
//   Pairs add to counts[hi * B + lo], one atomic per distinct pair of a
//   warp.
// Bound: the grid (B * H * T * F int64) and the codes read once, the
// [B, B] counts written; its hashes' integer operations are fewer
// (chip_smoke.py counts both): 0.0384 ms at a bench window (B = 256, T =
// 20, h = 3, F = 1,000: 15.3 M keys).  The design hashes twice and moves
// the keys through memory twice (~0.5 GB in all); its time is those
// passes and the partitions' latency (tools/torch_port_wave_parts.py
// splits it).
//
// wave_rounds replaces the round loop (wavefront.py:491-726) as one
// cooperative launch per window: a persistent grid of as many CTAs as the
// card holds at once (CTAs an SM by the occupancy, times the SMs), as the
// consume kernel (consume.cu), every CTA keeping the round's per-read
// bookkeeping over the window itself, computed identically from the same
// global inputs: pending and stale flags and committed lengths in shared
// memory, the reservations' prefix sums (warp scans: three barriers for
// each blockDim.x reads), the rotation horizon, the conflict test against
// the adjacency (as bits, built once per launch) and the silver rotation.
// Each round:
//   1. the pending stale reads are probed through the bracket view of both
//      tables under each read's id ceiling (BracketWord, the view parameter
//      of kernel B's tile code): a tile of at most 2^kWarpBits votes (the
//      query tier: one probed seed at a frame stride) is a warp's
//      (probe_vote_warp, its vote table in the warp's shared memory), a
//      larger one (the recheck tier: every seed at full resolution) a
//      CTA's (probe_vote_tile); a grid barrier, then kernel C on each read
//      by every warp of the grid (read_outcome), which writes the read's
//      row, and a grid barrier;
//   2-4. the zone, drops, candidates and conflicts, per CTA;
//   5. phase A's commits under the horizon insert (insert_max's rule into
//      both tables: or_bits | id into the id table and INV_BASE - id into
//      the side table, atomicMax): the commits' entries (read of the list,
//      seed, entry of its window) are one range of 32-bit indices that
//      every thread of the grid takes in turn; the zone's committable
//      reads are rechecked at full resolution (as in 1, on the insert
//      grid), then phase B's commits insert;
//   6. stale marking, the rotation (a grid-stride reset of both tables)
//      and the reopening of drops past it.
// The tables are read through L2 (other CTAs write them); a probe, insert
// or reset that follows a write of the tables first crosses a grid barrier
// (two inserts need none: atomicMax commutes).  Both tables come as one
// bank view (common.cuh SideBanks: under the engine's model axis a data
// row's id table and side table, banked alike over its devices; a bank on
// another card is peer memory, and the barriers after a table store then
// start with a system-scope fence, tables_barrier, as consume.cu's do).
// The kernel is a template on the view: tables of one bank run the
// FlatSide instantiation, the addressing they had before banks.  A window
// that needs more than B * (max_paths + 2) rounds, or whose ids would reach
// INV_BASE, stops and counts a fault, which the engine raises on.
// Each CTA keeps the per-read state (flags, committed lengths, ceilings, a
// read list, the unresolved bits: ~16.6 B a read) and the commit pass's
// insert index (12 B a read) in its dynamic shared memory; a window whose
// two parts would not fit beside the work region (past 7,910 reads in the
// bench's cells) keeps both in a global scratch instead, one slice a CTA
// (the kSpill instantiation; the grid is then at most the slices).  Kernel
// C's buffer (one a warp: its rows and sort keys, 8 B a tile and more) is
// a warp's region of the work region while the 16 of a CTA fit; reads of
// 1,024 tiles or more at K = 32 run C on as many warps of a CTA as have a
// buffer (7-14: a window of such reads holds at most 8,192 / 1,024 reads
// and the mesh's padding, so the grid's warps still outnumber its reads),
// and the warps' probe regions then keep only a warp tile's table.
// Bound: the bytes of every round's work (each probed tile's grid entries
// and words of both tables, each insert's window and two atomics per
// entry, each reset's tables).  The words and the atomics are random 4-byte
// accesses to tables of hundreds of MB, each a 32-byte sector: at a bench
// window ~25 M sector reads for the recheck tier's probes and ~24 M
// atomics for the inserts, which set most of the launch's time.
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

// ---------------------------------------------------------------- K23a

constexpr int kAdjThreads = 512;    // the count's and the scatter's CTAs
constexpr int kGroupThreads = 512;  // a partition's CTA
constexpr int kGroupPer = 8;        // keys a group thread holds (cap)
constexpr int kMaxParts = 1 << 12;  // a CTA's counters (count, split)
// the most reads of a window (wavefront.MAX_ADJ_READS): a group's entry
// holds a read order in 14 bits, and its least and greatest in 16
constexpr int kMaxAdjReads = 1 << 14;
// keys of a staged round: up to this many of a tile's frames and seeds in
// the scatter (rounds of blockDim.x frames), this many in the split
constexpr int kRoundKeys = 4096;

// The partition of a (conflict key, fingerprint) group among `parts`.
__device__ __forceinline__ uint32_t group_part(uint64_t group,
                                               uint32_t parts) {
  return __umulhi(
      static_cast<uint32_t>((group * 0x9E3779B97F4A7C15ull) >> 32), parts);
}

// A slot of a table of 2^bits entries inside a partition.
__device__ __forceinline__ uint32_t slot_hash(uint64_t x, int bits) {
  return static_cast<uint32_t>((x * 0xD6E8FEB86659FD93ull) >> (64 - bits));
}

struct AdjArgs {
  const int64_t* grid;  // [B, H, T * F]
  const uint8_t* codes;
  int64_t L, limit;
  Family f;
  int B, H, T, F, S, TL, direct, ob, units;
  uint32_t parts;  // partitions; 2^shift of them make a bucket
  int shift;
};

// A partition's index, and its bucket's, from its group's key.
__device__ __forceinline__ uint32_t key_part(unsigned long long key, int ob,
                                             uint32_t parts) {
  return group_part(key >> ob, parts);
}

// Add one key to counters[i] (kPlace false) or place it at the position
// that cursor counters[i] hands out (kPlace true), with shared-memory
// atomics: a warp whose valid keys share one counter (a homopolymer's)
// takes their places with one.  Every lane of the warp calls it.
template <bool kPlace>
__device__ __forceinline__ void count_or_place(
    int* counters, bool valid, uint32_t i, unsigned long long key,
    unsigned long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const unsigned vm = __ballot_sync(kFull, valid);
  if (vm == 0u) return;
  const int lead = __ffs(vm) - 1;
  const uint32_t li = __shfl_sync(kFull, i, lead);
  if (__all_sync(kFull, !valid || i == li)) {
    int at = 0;
    if (lane == lead) at = atomicAdd(counters + i, __popc(vm));
    if constexpr (kPlace) {
      at = __shfl_sync(kFull, at, lead);
      if (valid) out[at + __popc(vm & ((1u << lane) - 1u))] = key;
    }
  } else if (valid) {
    const int at = atomicAdd(counters + i, 1);
    if constexpr (kPlace) out[at] = key;
  }
}

// Exclusive prefix sums of the nc counters c[0..nc) into ls and tc (either
// may be c: each thread reads its run before it writes it), each thread a
// run of consecutive counters, the runs' sums by a warp scan and one over
// the warps (wsum, 32 ints); returns the total.  Every thread of the CTA
// calls it; it ends with a barrier.
__device__ int counters_scan(const int* c, int nc, int* ls, int* tc,
                             int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = static_cast<int>(blockDim.x >> 5);
  const int per = (nc + blockDim.x - 1) / blockDim.x;
  const int i0 = min(nc, static_cast<int>(threadIdx.x) * per);
  const int i1 = min(nc, i0 + per);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += c[i];
  int inc = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += v;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  int pre = inc - sum + (warp ? wsum[warp - 1] : 0);
  for (int i = i0; i < i1; ++i) {
    const int v = c[i];
    ls[i] = tc[i] = pre;
    pre += v;
  }
  const int total = wsum[nw - 1];
  __syncthreads();
  return total;
}

// A CTA's round of keys written to their counters' runs: kbuf holds `per`
// keys a thread (kbuf[r * blockDim.x + tid], kSentinel64 where none), and
// which(key) is a key's counter, < nc.  The round's keys are counted by
// counter (th: zero on entry and on exit), placed counter by counter in
// `sorted` (per * blockDim.x keys) through the counters' starts (ls, tc),
// then written to out from each counter's cursor cur[c] on, which
// advances: consecutive threads write consecutive keys of a run, so that
// a counter's keys of the round go out together, not one sector each.
// Every thread of the CTA calls it; it starts and ends with a barrier.
template <typename Which>
__device__ void staged_write(const unsigned long long* kbuf, int per,
                             Which which, int nc, int* th, int* ls, int* tc,
                             int* cur, unsigned long long* sorted, int* wsum,
                             unsigned long long* __restrict__ out) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int r = 0; r < per; ++r) {
    const unsigned long long k = kbuf[r * blockDim.x + tid];
    const bool valid = k != kSentinel64;
    count_or_place<false>(th, valid, valid ? which(k) : 0u, k, nullptr);
  }
  __syncthreads();
  const int total = counters_scan(th, nc, ls, tc, wsum);
  for (int r = 0; r < per; ++r) {
    const unsigned long long k = kbuf[r * blockDim.x + tid];
    const bool valid = k != kSentinel64;
    count_or_place<true>(tc, valid, valid ? which(k) : 0u, k, sorted);
  }
  __syncthreads();
  for (int i = tid; i < total; i += blockDim.x) {
    const unsigned long long k = sorted[i];
    const uint32_t c = which(k);
    out[cur[c] + i - ls[c]] = k;
  }
  __syncthreads();
  for (int i = tid; i < nc; i += blockDim.x) {
    cur[i] += th[i];
    th[i] = 0;
  }
  __syncthreads();
}

// The key of frame j (< F when `in`) of a staged tile of read b under seed
// s, from the frame's left partials and the tile's grid row g_t, or
// kSentinel64 for an invalid frame.
__device__ __forceinline__ unsigned long long frame_key(
    const AdjArgs& a, const Stage& st, const int64_t* g_t, int64_t TF,
    ulonglong2 left, int j, int s, int b, bool in) {
  const int64_t g = in ? g_t[s * TF + j] : a.limit;
  if (g >= a.limit) return kSentinel64;
  const uint64_t fp = canon(st, left, j * a.S, s) & ((1u << kFpBits) - 1u);
  const uint64_t conf = a.direct ? static_cast<uint64_t>(g) & 0xFFFFFFull
                                 : static_cast<uint64_t>(g);
  return (((conf << kFpBits) | fp) << a.ob) | static_cast<uint64_t>(b);
}

// grid (C): CTA c keys the window's tiles u in [c * units, (c + 1) *
// units) (read u / T, tile u % T), staged and hashed as kernel A does
// (seed_hash.cuh).  The count (kScatter false) counts each valid frame's
// key into its bucket (its partition >> shift) in shared memory and writes
// its row of counts pcount[c * nb + b]; the scatter (kScatter true), once
// the scan has turned that row into its offsets inside each bucket's
// slice, writes each round of its keys (a tile's frames and seeds, up to
// kRoundKeys) to `keys` a bucket's run at a time (staged_write).
template <bool kScatter>
__global__ void __launch_bounds__(kAdjThreads) adj_keys_kernel(
    const AdjArgs a, int* __restrict__ pcount, const int* __restrict__ boff,
    unsigned long long* __restrict__ keys) {
  __shared__ int wsum[32];
  const int m = a.TL + a.f.h - 1;
  const Stage st(reinterpret_cast<ulonglong2*>(gr_smem), a.f, m);
  const int nb = static_cast<int>(a.parts >> a.shift);
  // the bucket counters (th, and for the scatter ls, tc, cur), then the
  // scatter's round of keys and their placement
  int* th = reinterpret_cast<int*>(gr_smem + ((stage_bytes(a.f, m) + 15) &
                                              ~static_cast<size_t>(15)));
  int* ls = th + nb;
  int* tc = ls + nb;
  int* cur = tc + nb;
  unsigned long long* kbuf = reinterpret_cast<unsigned long long*>(
      cur + ((nb + 1) & ~1));
  // frame rounds a staged round holds (a tile's, if they fit)
  const int fr = max(1, kRoundKeys / (a.H * static_cast<int>(blockDim.x)));
  unsigned long long* sorted = kbuf + fr * a.H * blockDim.x;
  int* row = pcount + static_cast<int64_t>(blockIdx.x) * nb;
  for (int p = threadIdx.x; p < nb; p += blockDim.x) {
    th[p] = 0;
    if constexpr (kScatter) cur[p] = boff[p] + row[p];
  }
  const auto bucket = [&](unsigned long long k) {
    return key_part(k, a.ob, a.parts) >> a.shift;
  };
  const int64_t TF = static_cast<int64_t>(a.T) * a.F;
  const int u1 = min(a.B * a.T, static_cast<int>(blockIdx.x + 1) * a.units);
  for (int u = blockIdx.x * a.units; u < u1; ++u) {
    const int b = u / a.T, t = u % a.T;
    stage(a.f, a.codes + static_cast<int64_t>(b) * a.L, a.L,
          static_cast<int64_t>(t) * a.TL, m, a.S, st);
    const int64_t* g_t = a.grid + static_cast<int64_t>(b) * a.H * TF +
                         static_cast<int64_t>(t) * a.F;
    // every lane of a warp runs every round (the warp collectives)
    int held = 0;  // frame rounds in kbuf
    for (int j0 = 0; j0 < a.F; j0 += blockDim.x) {
      const int j = j0 + threadIdx.x;
      const bool in = j < a.F;
      const ulonglong2 left =
          in ? left_at(a.f, st, j * a.S) : make_ulonglong2(0ull, 0ull);
      for (int s = 0; s < a.H; ++s) {
        const unsigned long long key =
            frame_key(a, st, g_t, TF, left, j, s, b, in);
        if constexpr (kScatter) {
          kbuf[(held * a.H + s) * blockDim.x + threadIdx.x] = key;
        } else {
          const bool valid = key != kSentinel64;
          count_or_place<false>(th, valid, valid ? bucket(key) : 0u, key,
                                nullptr);
        }
      }
      if constexpr (kScatter) {
        if (++held == fr || j0 + static_cast<int>(blockDim.x) >= a.F) {
          staged_write(kbuf, held * a.H, bucket, nb, th, ls, tc, cur, sorted,
                       wsum, keys);
          held = 0;
        }
      }
    }
    __syncthreads();  // the next tile restages
  }
  if constexpr (!kScatter) {
    for (int p = threadIdx.x; p < nb; p += blockDim.x) row[p] = th[p];
  }
}

// grid (nb): CTA b splits bucket b's slice of `keys` into its 2^shift
// partitions' slices of `buckets`: a count of each partition's keys and
// their offsets (part_off, from the bucket's offset boff[b]), then a round
// of kRoundKeys keys at a time, a partition's run at a time
// (staged_write); part_off[parts] is the window's valid keys.
__global__ void __launch_bounds__(kAdjThreads) adj_split_kernel(
    const int* __restrict__ boff, uint32_t parts, int shift, int ob,
    const unsigned long long* __restrict__ keys,
    int* __restrict__ part_off, unsigned long long* __restrict__ buckets) {
  __shared__ int wsum[32];
  const int np = 1 << shift, off = boff[blockIdx.x];
  const int n = boff[blockIdx.x + 1] - off;
  int* th = reinterpret_cast<int*>(gr_smem);
  int* ls = th + np;
  int* tc = ls + np;
  int* cur = tc + np;
  unsigned long long* kbuf =
      reinterpret_cast<unsigned long long*>(cur + ((np + 1) & ~1));
  const int per = max(1, kRoundKeys / static_cast<int>(blockDim.x));
  unsigned long long* sorted = kbuf + per * blockDim.x;
  const unsigned long long* slice = keys + off;
  const uint32_t low = static_cast<uint32_t>(np - 1);
  const auto part = [&](unsigned long long k) {
    return key_part(k, ob, parts) & low;
  };
  for (int i = threadIdx.x; i < np; i += blockDim.x) th[i] = 0;
  __syncthreads();
  // every lane of a warp runs every round (the warp collectives)
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const unsigned long long k = i < n ? slice[i] : 0ull;
    count_or_place<false>(th, i < n, part(k), k, nullptr);
  }
  __syncthreads();
  counters_scan(th, np, ls, cur, wsum);
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    cur[i] += off;
    part_off[blockIdx.x * np + i] = cur[i];
    th[i] = 0;
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0)
    part_off[parts] = off + n;
  for (int i0 = 0; i0 < n; i0 += per * blockDim.x) {
    for (int r = 0; r < per; ++r) {
      const int i = i0 + r * blockDim.x + threadIdx.x;
      kbuf[r * blockDim.x + threadIdx.x] = i < n ? slice[i] : kSentinel64;
    }
    staged_write(kbuf, per, part, np, th, ls, tc, cur, sorted, wsum,
                 buckets);
  }
}

// grid (ceil(nb / 32)) x 1,024 threads: column b of pcount (its CTAs'
// counts) becomes each CTA's offset inside bucket b, boff[b] the bucket's
// keys.  Thread (x, y) = (tid % 32, tid / 32) takes column 32 * blockIdx.x
// + x over the y-th of 32 runs of CTAs.
__global__ void __launch_bounds__(1024) adj_scan_cols_kernel(
    int* __restrict__ pcount, int C, uint32_t nb, int* __restrict__ boff) {
  __shared__ int run[32][33];
  const int x = threadIdx.x & 31, y = threadIdx.x >> 5;
  const uint32_t p = blockIdx.x * 32 + x;
  const int per = (C + 31) / 32, c0 = min(C, y * per), c1 = min(C, c0 + per);
  int* col = pcount + p;
  int sum = 0;
  if (p < nb)
    for (int c = c0; c < c1; ++c) sum += col[static_cast<int64_t>(c) * nb];
  run[y][x] = sum;
  __syncthreads();
  int pre = 0;
  for (int i = 0; i < y; ++i) pre += run[i][x];
  if (p >= nb) return;
  if (y == 31) boff[p] = pre + sum;
  for (int c = c0; c < c1; ++c) {
    const int v = col[static_cast<int64_t>(c) * nb];
    col[static_cast<int64_t>(c) * nb] = pre;
    pre += v;
  }
}

// One CTA of 1,024 threads: boff [nb + 1] from the buckets' keys to their
// slices' offsets, in place; boff[nb] the window's valid keys.
__global__ void __launch_bounds__(1024) adj_scan_parts_kernel(
    int* __restrict__ boff, int nb) {
  __shared__ int wsum[32];
  const int total = counters_scan(boff, nb, boff, boff, wsum);
  if (threadIdx.x == 0) boff[nb] = total;
}

// Each adjacent pair of the sorted keys a[0..n) in one group with distinct
// orders adds one to cnt[hi * B + lo], one atomic per distinct pair of a
// warp.  Every thread of the CTA calls it.
__device__ void adjacent_pairs(const unsigned long long* a, int64_t n,
                               int ob, int B, int* __restrict__ cnt) {
  const unsigned long long mask = (1ull << ob) - 1ull;
  const int lane = threadIdx.x & 31;
  // every lane of a warp runs every round (the match below)
  for (int64_t base = 0; base < n; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
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

// Ascending sort of a[0..n) in place by one CTA: a bitonic network over the
// next power of two whose first comparator of every merge mirrors its
// block, so that every comparator keeps the smaller key at the lower index
// and the virtual keys past n (the largest) never move.  Ends with a
// barrier.
__device__ void block_sort_global(unsigned long long* a, int64_t n) {
  int64_t n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int64_t k = 2; k <= n2; k <<= 1) {
    for (int64_t j = k >> 1; j > 0; j >>= 1) {
      for (int64_t q = threadIdx.x; q < n2 / 2; q += blockDim.x) {
        const int64_t lo = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int64_t hi =
            j == k >> 1 ? (lo | (k - 1)) - (lo & (k - 1)) : lo + j;
        if (hi < n) {
          const unsigned long long x = a[lo], y = a[hi];
          if (y < x) {
            a[lo] = y;
            a[hi] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The distinct keys of a slice of n keys into A, through an open-addressing
// set D of 2^bits entries; returns their number, or -1 past half of D (the
// set is then abandoned).  Every thread of the CTA calls it; it ends with a
// barrier.
__device__ int distinct_keys(const unsigned long long* slice, int n,
                             int bits, unsigned long long* A,
                             unsigned long long* D, int* fill, int* over) {
  const int size = 1 << bits, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < size; i += blockDim.x) D[i] = kSentinel64;
  if (threadIdx.x == 0) *fill = *over = 0;
  __syncthreads();
  volatile int* stop = over;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const unsigned long long k = i < n ? slice[i] : kSentinel64;
    // a warp's repeats of one key insert once
    const unsigned peers = __match_any_sync(kFull, k);
    if (k != kSentinel64 && lane == __ffs(peers) - 1) {
      for (uint32_t h = slot_hash(k, bits); !*stop;
           h = (h + 1u) & static_cast<uint32_t>(size - 1)) {
        unsigned long long cur =
            reinterpret_cast<volatile unsigned long long*>(D)[h];
        if (cur == kSentinel64) {
          cur = atomicCAS(D + h, kSentinel64, k);
          if (cur == kSentinel64) {
            if (atomicAdd(fill, 1) >= size / 2) *stop = 1;
            break;
          }
        }
        if (cur == k) break;
      }
    }
  }
  __syncthreads();
  if (*over) return -1;
  __syncthreads();
  if (threadIdx.x == 0) *fill = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += blockDim.x)
    if (D[i] != kSentinel64) A[atomicAdd(fill, 1)] = D[i];
  __syncthreads();
  return *fill;
}

// grid (parts): CTA p counts the pairs of partition p's groups.  Its keys
// (at most cap; past cap, its distinct keys, at most cap / 2) go into
// shared memory, where a table of their (conflict key, fingerprint)
// groups, keyed by the first key that claims each, marks the groups that
// hold two or more read orders.  Only those groups' keys are sorted, and
// each adjacent pair of distinct orders in one group is a pair.  A
// partition with more distinct keys sorts its slice in global memory.
__global__ void __launch_bounds__(kGroupThreads) adj_group_kernel(
    const int* __restrict__ part_off, int cap, int ob, int B,
    unsigned long long* buckets, int* __restrict__ cnt) {
  __shared__ int fill, over;
  unsigned long long* A = reinterpret_cast<unsigned long long*>(gr_smem);
  // the group table and the orders' range, 2n <= 2^gb <= 2 cap entries
  // each; then the sorted keys
  uint32_t* G = reinterpret_cast<uint32_t*>(A + cap);
  uint32_t* mm = G + 2 * cap;
  unsigned long long* M = A + cap;
  const int off = part_off[blockIdx.x];
  const int np = part_off[blockIdx.x + 1] - off;
  if (np < 2) return;
  unsigned long long* slice = buckets + off;
  const int tid = threadIdx.x;
  // 1. the keys
  int n = np;
  if (np <= cap) {
    for (int i = tid; i < np; i += blockDim.x) A[i] = slice[i];
  } else {
    int bits = 1;
    while ((1 << bits) < cap) ++bits;
    n = distinct_keys(slice, np, bits, A, M, &fill, &over);
    if (n < 0) {
      block_sort_global(slice, np);
      adjacent_pairs(slice, np, ob, B, cnt);
      return;
    }
  }
  __syncthreads();
  // 2. the group table: a group's entry holds the key that claimed it
  // (its index + 1, bits 0-15), the first order found strictly between the
  // group's least and greatest (bits 16-29: B <= kMaxAdjReads), whether
  // one is (bit 31) and whether another is (bit 30); mm the least and
  // greatest orders (16 bits each)
  const unsigned long long omask = (1ull << ob) - 1ull;
  const int lane = tid & 31;
  int gb = 1;
  while ((1 << gb) < 2 * n) ++gb;
  const uint32_t gmask = (1u << gb) - 1u;
  for (int i = tid; i <= static_cast<int>(gmask); i += blockDim.x) {
    G[i] = 0u;
    mm[i] = 0xFFFF0000u;
  }
  __syncthreads();
  uint32_t slot[kGroupPer];
#pragma unroll
  for (int r = 0; r < kGroupPer; ++r) {
    const int i = tid + r * kGroupThreads;
    slot[r] = 0u;
    if (i >= n) continue;
    const unsigned long long grp = A[i] >> ob;
    uint32_t h = slot_hash(grp, gb);
    for (;; h = (h + 1u) & gmask) {
      uint32_t e = reinterpret_cast<volatile uint32_t*>(G)[h];
      if (e == 0u) {
        e = atomicCAS(G + h, 0u, static_cast<uint32_t>(i) + 1u);
        if (e == 0u) break;
      }
      if ((A[(e & 0xFFFFu) - 1u] >> ob) == grp) break;
    }
    slot[r] = h;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kGroupPer; ++r) {
    if (tid + r * kGroupThreads >= n) continue;
    const uint32_t o = static_cast<uint32_t>(A[tid + r * kGroupThreads] & omask);
    uint32_t cur = reinterpret_cast<volatile uint32_t*>(mm)[slot[r]];
    for (;;) {
      const uint32_t want =
          (min(cur >> 16, o) << 16) | max(cur & 0xFFFFu, o);
      if (want == cur) break;
      const uint32_t seen = atomicCAS(mm + slot[r], cur, want);
      if (seen == cur) break;
      cur = seen;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kGroupPer; ++r) {
    if (tid + r * kGroupThreads >= n) continue;
    const uint32_t o = static_cast<uint32_t>(A[tid + r * kGroupThreads] & omask);
    const uint32_t v = mm[slot[r]];
    if ((v >> 16) >= o || o >= (v & 0xFFFFu)) continue;
    uint32_t cur = reinterpret_cast<volatile uint32_t*>(G)[slot[r]];
    for (;;) {
      const uint32_t want = !(cur >> 31) ? cur | 0x80000000u | (o << 16)
                            : ((cur >> 16) & 0x3FFFu) != o ? cur | 0x40000000u
                                                           : cur;
      if (want == cur) break;
      const uint32_t seen = atomicCAS(G + slot[r], cur, want);
      if (seen == cur) break;
      cur = seen;
    }
  }
  __syncthreads();
  // a group of two orders is one pair and one of three two pairs, which
  // the key that claimed it counts; the keys of a group of four or more
  // orders are sorted
  unsigned many = 0u;
  int pair[kGroupPer], pair2[kGroupPer];
#pragma unroll
  for (int r = 0; r < kGroupPer; ++r) {
    const int i = tid + r * kGroupThreads;
    pair[r] = pair2[r] = -1;
    if (i >= n) continue;
    const uint32_t v = mm[slot[r]], lo = v >> 16, hi = v & 0xFFFFu;
    if (lo == hi) continue;
    const uint32_t e = G[slot[r]], mid = (e >> 16) & 0x3FFFu;
    if ((e >> 30) & 1u) {
      many |= 1u << r;
    } else if ((e & 0xFFFFu) - 1u == static_cast<uint32_t>(i)) {
      pair[r] = static_cast<int>((e >> 31) ? mid : hi) * B +
                static_cast<int>(lo);
      if (e >> 31) pair2[r] = static_cast<int>(hi) * B + static_cast<int>(mid);
    }
  }
  if (tid == 0) fill = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kGroupPer; ++r) {
    for (const int p : {pair[r], pair2[r]}) {
      const unsigned peers = __match_any_sync(kFull, p);
      if (p >= 0 && lane == __ffs(peers) - 1) atomicAdd(cnt + p, __popc(peers));
    }
  }
  // 3. the keys of groups of four or more orders, sorted
#pragma unroll
  for (int r = 0; r < kGroupPer; ++r)
    if ((many >> r) & 1u) M[atomicAdd(&fill, 1)] = A[tid + r * kGroupThreads];
  __syncthreads();
  const int m = fill;
  if (m < 2) return;
  int m2 = 1;
  while (m2 < m) m2 <<= 1;
  for (int i = m + tid; i < m2; i += blockDim.x) M[i] = kSentinel64;
  __syncthreads();
  if (m2 <= static_cast<int>(blockDim.x))
    block_bitonic_sort_small(M, m2);
  else
    block_bitonic_sort(M, m2);
  // 4. their pairs
  adjacent_pairs(M, m, ob, B, cnt);
}

// ---------------------------------------------------------------- K23b

// The bracket view (wavefront.py:213-231 compressed, :252-270 direct): the
// latest id p of an entry is visible under the read's ceiling when 0 < p
// <= ceil, else the earliest, INV_BASE - side, when side >= INV_BASE -
// ceil; the direct word keeps its high bits beside the visible id, a real
// rank reads PRESENT | id.  Unsigned 32-bit arithmetic, as the JAX view's.
// Both tables are read through their view `Tab` (common.cuh FlatSide, or
// SideBanks).
template <typename Tab>
struct BracketWord {
  Tab tab;
  uint32_t ceil;

  template <bool kFused>
  __device__ __forceinline__ uint32_t get(int ranked, int64_t limit,
                                          int64_t x) const {
    if (ranked && x >= limit) return 0u;
    uint32_t *pw, *ps;
    tab.entries(x, &pw, &ps);
    const uint32_t w = load<kFused>(pw), c = load<kFused>(ps);
    const uint32_t p = ranked ? w : w & kIdMask;
    const uint32_t early = c > 0u && c >= kInvBase - ceil ? kInvBase - c : 0u;
    const uint32_t idv = p > 0u && p <= ceil ? p : early;
    return ranked ? kPresent | idv : (w & ~kIdMask) | idv;
  }
};

// a CTA of the rounds, and CTAs an SM (its registers: C's passes)
constexpr int kWaveThreads = 512;
constexpr int kWaveBlocks = 1;
// the static shared memory the rounds' kernel may take (wavefront.py
// WAVE_STATIC_SMEM; its own arrays and probe_vote_tile's, ~1.6 KB): the
// dynamic region takes at most kMaxSmem less this
constexpr size_t kWaveStatic = 2048;

struct WaveArgs {
  // the id table (direct words or rank-indexed ids) and the side table,
  // banked alike
  SideBanks tabs;
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
  int u_min, a_max, TL, bs, S, rech_on, silver, cbuf;
  int warp_q, warp_f;  // the tier's tiles probed one per warp
  int warp_bytes;      // each warp's region for a warp tile's table
  // kernel C runs on the first c_warps warps of a CTA, each with a buffer
  // of c_bytes: every warp, its buffer its probe region, while the 16
  // buffers fit in shared memory; fewer for reads of ~1,024 tiles or more
  int c_warps, c_bytes;
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
  // kSpill: each CTA's insert index and per-read state in its slice of
  // spill (spill_stride bytes, the state at spill_state), not in shared
  // memory
  unsigned char* spill;
  size_t spill_stride, spill_state;
};

struct Tier {
  const int64_t* grid;
  const bool* ok;
  int H, F, vote_min, threshold, bits, warp;
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
// over reads here); returns the total.  A warp scan by shuffles, then one
// over the warps' totals (`scratch`, 32 values): three barriers for each
// blockDim.x reads.  Every thread of the CTA calls it; it ends with a
// barrier.
template <typename V, typename O>
__device__ long long block_cumsum(int B, V v, O out, long long* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = static_cast<int>(blockDim.x >> 5);
  long long carry = 0;
  for (int base = 0; base < B; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const long long x = i < B ? static_cast<long long>(v(i)) : 0ll;
    long long inc = x;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) scratch[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      long long w = lane < nw ? scratch[lane] : 0ll;
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      scratch[lane] = w;
    }
    __syncthreads();
    if (i < B) out(i, carry + (warp ? scratch[warp - 1] : 0ll) + inc);
    carry += scratch[nw - 1];
    __syncthreads();
  }
  return carry;
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
                             long long* scratch) {
  return static_cast<int>(block_cumsum(
      B, [&](int i) { return pred(i) ? 1 : 0; },
      [&](int i, long long incl) {
        if (pred(i)) list[incl - 1] = i;
      },
      scratch));
}

// Probe the n reads of `list` with `tier` through the bracket view under
// their ceilings and classify them: their rows (and, for the query tier,
// tile_min) are written.  A tile is a warp's (tier.warp: probe_vote_warp
// in the warp's region) or a CTA's (probe_vote_tile); kernel C then runs
// on every warp of the grid, a read each.  Every thread of every CTA calls
// it; it ends with a grid barrier.
template <typename Tab>
__device__ void probe_rows(const WaveArgs& a, const Tier& tier,
                           const int32_t* list, int n, const uint32_t* ceil,
                           bool query, cg::grid_group& grid) {
  const int T = a.T, K = a.K;
  const int64_t TF = static_cast<int64_t>(T) * tier.F;
  const int64_t vb = 3 * T + 2 * T * K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = static_cast<int>(blockDim.x >> 5);
  const int64_t units = static_cast<int64_t>(n) * T;
  unsigned char* own = gr_smem + static_cast<size_t>(warp) * a.warp_bytes;
  const bool by_warp = tier.warp != 0;
  const int64_t step = by_warp ? static_cast<int64_t>(gridDim.x) * warps
                               : static_cast<int64_t>(gridDim.x);
  for (int64_t u = by_warp ? static_cast<int64_t>(blockIdx.x) * warps + warp
                           : static_cast<int64_t>(blockIdx.x);
       u < units; u += step) {
    const int r = list[u / T], t = static_cast<int>(u % T);
    int32_t* curr = a.vals + r * vb;
    unsigned long long* q = a.sums + static_cast<int64_t>(r) * 3 * T;
    const int64_t* g = tier.grid + static_cast<int64_t>(r) * tier.H * TF;
    const bool* ok = tier.ok + static_cast<int64_t>(r) * TF;
    bool* bi = a.binit + static_cast<int64_t>(r) * T;
    const BracketWord<Tab> view{side_view_of<Tab>(a.tabs), ceil[r]};
    if (by_warp) {
      probe_vote_warp(view, g, a.ranked, a.limit, ok, tier.H, T, tier.F, K,
                      tier.vote_min, tier.threshold, tier.bits, t, 0, curr,
                      curr + T, curr + 3 * T, curr + 3 * T + T * K, bi,
                      curr + 2 * T, q, q + T, q + 2 * T,
                      reinterpret_cast<unsigned long long*>(own));
    } else {
      probe_vote_tile<true>(view, g, a.ranked, a.limit, ok, tier.H, T,
                            tier.F, K, tier.vote_min, tier.threshold,
                            tier.bits, t, 0, curr, curr + T, curr + 3 * T,
                            curr + 3 * T + T * K, bi, curr + 2 * T, q, q + T,
                            q + 2 * T);
      __syncthreads();
    }
  }
  grid.sync();
  unsigned char* cown = gr_smem + static_cast<size_t>(warp) * a.c_bytes;
  for (int j = blockIdx.x * a.c_warps + warp; warp < a.c_warps && j < n;
       j += gridDim.x * a.c_warps) {
    const int r = list[j];
    const Outcome o = read_outcome(
        a.sums + static_cast<int64_t>(r) * 3 * T, a.vals + r * vb,
        a.n_tiles[r], T, K, tier.threshold, a.u_min, a.a_max, a.cbuf, cown,
        lane);
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
// ceil + 1.  The reads' entries are one range of 32-bit indices, read j's
// from ends[j - 1]: its seeds' windows one after another.  Every CTA puts
// the prefix of the windows' sizes and each read's first tile, trim flag
// and window in its shared memory (`meta`, 3n words), so that every thread
// of the grid takes indices of every read.  Every thread of every CTA
// calls it; it ends with a barrier.
template <typename Tab>
__device__ void insert_rows(const WaveArgs& a, const int32_t* list, int n,
                            const uint32_t* ceil, uint32_t* meta,
                            long long* scan) {
  uint32_t* ends = meta;
  uint32_t* lo_tr = meta + n;  // first tile, bit 31 the trim flag
  uint32_t* win = meta + 2 * n;
  const uint32_t Fi = static_cast<uint32_t>(a.Fi);
  const uint32_t total = static_cast<uint32_t>(block_cumsum(
      n,
      [&](int j) -> long long {
        const int r = list[j];
        const Geo g = geometry(a, r);
        const int last = min(g.hi, a.T - 1);
        const uint32_t w =
            last < g.lo ? 0u : static_cast<uint32_t>(last - g.lo + 1) * Fi;
        lo_tr[j] = static_cast<uint32_t>(max(g.lo, 0)) |
                   (row_at(a, r, 0) == 2 ? 0x80000000u : 0u);
        win[j] = w;
        return static_cast<long long>(w) * a.Hi;
      },
      [&](int j, long long incl) { ends[j] = static_cast<uint32_t>(incl); },
      scan));
  const uint32_t TF = static_cast<uint32_t>(a.T) * Fi;
  const uint32_t b = static_cast<uint32_t>(a.bs);
  const Tab tab = side_view_of<Tab>(a.tabs);
  const uint32_t step = gridDim.x * blockDim.x;
  for (uint32_t e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += step) {
    int j = 0;
    for (int hi = n - 1; j < hi;) {
      const int mid = (j + hi) >> 1;
      if (ends[mid] > e) hi = mid;
      else j = mid + 1;
    }
    const uint32_t rem = e - (j ? ends[j - 1] : 0u), w = win[j];
    const uint32_t s = rem / w, col = rem - s * w;
    const uint32_t lo = lo_tr[j] & 0x7FFFFFFFu;
    const int r = list[j];
    const int64_t key =
        a.grid_i[(static_cast<int64_t>(r) * a.Hi + s) * TF + lo * Fi + col];
    if (key < 0 || key >= a.limit) continue;
    const uint32_t m = col / Fi / b;
    const uint32_t id =
        ceil[r] + 1u + ((lo_tr[j] >> 31) ? (m * b + 1u) / b : m);
    uint32_t *pw, *ps;
    tab.entries(key, &pw, &ps);
    atomicMax(reinterpret_cast<int*>(pw), static_cast<int>(a.or_bits | id));
    atomicMax(reinterpret_cast<int*>(ps), static_cast<int>(kInvBase - id));
  }
  __syncthreads();
}

// The silver rotation's reset of one bank of `len` entries of both tables
// over the grid: the id table forgets its ids (the direct words keep
// PRESENT), the side table empties.  16-byte stores, then the bank's last
// len % 4 entries one by one.
__device__ void reset_bank(uint32_t* table, uint32_t* side, int64_t len,
                           int ranked) {
  int4* w = reinterpret_cast<int4*>(table);
  int4* c = reinterpret_cast<int4*>(side);
  const int4 zero = make_int4(0, 0, 0, 0);
  const int p = static_cast<int>(kPresent);
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = start; j < len / 4; j += step) {
    if (ranked) {
      w[j] = zero;
    } else {
      const int4 v = __ldcg(w + j);
      w[j] = make_int4(v.x & p, v.y & p, v.z & p, v.w & p);
    }
    c[j] = zero;
  }
  for (int64_t j = len / 4 * 4 + start; j < len; j += step) {
    table[j] = ranked ? 0u : __ldcg(table + j) & kPresent;
    side[j] = 0u;
  }
}

// The reset of every bank of both tables.
template <typename Tab>
__device__ void reset_tables(const WaveArgs& a) {
  const SideBanks& t = a.tabs;
  if constexpr (std::is_same<Tab, FlatSide>::value) {
    reset_bank(t.ids.table[0], t.side[0], t.ids.bank_len, a.ranked);
  } else {
#pragma unroll
    for (int b = 0; b < kMaxBanks; ++b)
      if (b < t.ids.n)
        reset_bank(t.ids.table[b], t.side[b], t.ids.bank_len, a.ranked);
  }
}

// A grid barrier after stores to the tables, before any CTA reads or
// writes them again: with a bank in another card's memory, fenced at
// system scope first (consume.cu's filter_barrier).
template <typename Tab>
__device__ __forceinline__ void tables_barrier(const WaveArgs& a,
                                               cg::grid_group& grid) {
  if constexpr (!std::is_same<Tab, FlatSide>::value) {
    if (a.tabs.ids.remote) __threadfence_system();
  }
  grid.sync();
}

// The kernel, on the tables' view `Tab` (common.cuh with_side_view: the
// FlatSide of one bank, or the SideBanks).
template <typename Tab, bool kSpill>
__global__ void __launch_bounds__(kWaveThreads, kWaveBlocks)
    wave_kernel(const WaveArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ long long scan[32];
  __shared__ int slot;
  __shared__ long long cum_at[2];
  const int B = a.B, W = (B + 31) >> 5, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // per read: flags, committed length, id ceiling; a list of reads; the
  // unresolved reads' bits
  unsigned char* const spill =
      kSpill ? a.spill + blockIdx.x * a.spill_stride : nullptr;
  uint32_t* const meta =
      reinterpret_cast<uint32_t*>(kSpill ? spill : gr_smem);
  unsigned char* st = kSpill ? spill + a.spill_state : gr_smem + a.state_off;
  uint8_t* fl = st;
  int64_t* clen = reinterpret_cast<int64_t*>(st + ((B + 15) & ~15));
  uint32_t* ceil = reinterpret_cast<uint32_t*>(clen + B);
  int32_t* list = reinterpret_cast<int32_t*>(ceil + B);
  uint32_t* unres = reinterpret_cast<uint32_t*>(list + B);
  const Tier tq{a.grid_q, a.ok_q,  a.Hq,     a.Fq,
                a.vote_min_q, a.x_q, a.bits_q, a.warp_q};
  const Tier tf{a.grid_i, a.ok_i,  a.Hi,     a.Fi,
                a.vote_min_f, a.x_f, a.bits_f, a.warp_f};
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
      if (dirty) tables_barrier<Tab>(a, grid);
      dirty = 0;
      probe_rows<Tab>(a, tq, list, nw, ceil, true, grid);
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
        if (dirty == 2) tables_barrier<Tab>(a, grid);
        insert_rows<Tab>(a, list, n, ceil, meta, scan);
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
        if (dirty) tables_barrier<Tab>(a, grid);
        dirty = 0;
        probe_rows<Tab>(a, tf, list, nrc, ceil, false, grid);
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
      if (dirty) tables_barrier<Tab>(a, grid);
      reset_tables<Tab>(a);
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
  // every CTA read scal before it is overwritten (and the tables' last
  // stores are fenced)
  tables_barrier<Tab>(a, grid);
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

// Let a kernel take `bytes` of dynamic shared memory beside its static
// (allow_smem's 48 KB leaves no room for the static).
template <typename Kern>
cudaError_t opt_in_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline int bit_length(int v) {
  int b = 0;
  while (v >> b) ++b;
  return b;
}

}  // namespace gr

extern "C" {

// grid [B, H, T * F] int64 (F * S == TL); codes uint8 [B, L]; `parts`
// partitions in nb = parts >> shift buckets; the count's and the scatter's
// CTAs take `units` tiles each (C = ceil(B * T / units)); pcount int32 [C,
// nb]; boff int32 [nb + 1]; part_off int32 [parts + 1]; keys and buckets
// int64 [B * H * T * F] (< 2^31); cnt int32 [B, B], zeroed.
int gr_wave_adjacency(const int64_t* grid, int B, int H, int T, int F, int S,
                      int TL, const uint8_t* codes, int64_t L,
                      const uint64_t* fam_table, int h, int k, int half,
                      int nl, int nr, int pad, int64_t limit, int direct,
                      int parts, int shift, int units, int cap, int* pcount,
                      int* boff, int* part_off, unsigned long long* keys,
                      unsigned long long* buckets, int* cnt,
                      cudaStream_t stream) {
  if (B < 0 || B > gr::kMaxAdjReads || H != h || H < 1 || T < 1 || S < 1 ||
      F * S != TL || TL < k + h - 1 || L < 1 || limit <= 0 ||
      limit >= (1ll << 31) || parts < 1 || parts > (1 << 20) ||
      (parts & (parts - 1)) || shift < 0 || (1 << shift) > parts ||
      (parts >> shift) > gr::kMaxParts || (1 << shift) > gr::kMaxParts ||
      units < 1 || cap < 64 || cap > gr::kGroupPer * gr::kGroupThreads ||
      (cap & (cap - 1)) ||
      static_cast<int64_t>(B) * H * T * F >= (1ll << 31))
    return cudaErrorInvalidValue;
  if (B == 0) return gr::kNoLaunch;
  const int ob = std::max(gr::bit_length(B - 1), 1);
  const gr::Family f{h, k, half, nl, nr, pad, fam_table};
  const gr::AdjArgs a{grid, codes, L, limit, f, B, H, T, F, S, TL, direct,
                      ob, units, static_cast<uint32_t>(parts), shift};
  const int C = (B * T + units - 1) / units, nb = parts >> shift;
  // the keys kernels: the staged tile, the bucket counters, a round of
  // keys and their placement; the split: its counters and a round
  const int fr = std::max(1, gr::kRoundKeys / (H * gr::kAdjThreads));
  const size_t smem =
      ((gr::stage_bytes(f, TL + h - 1) + 15) & ~static_cast<size_t>(15)) +
      sizeof(int) * 4 * static_cast<size_t>((nb + 1) & ~1) +
      2 * sizeof(unsigned long long) * fr * H * gr::kAdjThreads;
  const size_t smem_split =
      sizeof(int) * 4 * static_cast<size_t>(((1 << shift) + 1) & ~1) +
      2 * sizeof(unsigned long long) *
          std::max(gr::kRoundKeys, gr::kAdjThreads);
  const size_t smem_group = 24 * static_cast<size_t>(cap);
  if (smem > gr::kMaxSmem || smem_split > gr::kMaxSmem)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = gr::opt_in_smem(gr::adj_keys_kernel<false>, smem)) !=
          cudaSuccess ||
      (err = gr::opt_in_smem(gr::adj_keys_kernel<true>, smem)) !=
          cudaSuccess ||
      (err = gr::opt_in_smem(gr::adj_split_kernel, smem_split)) !=
          cudaSuccess ||
      (err = gr::opt_in_smem(gr::adj_group_kernel, smem_group)) !=
          cudaSuccess)
    return err;
  gr::adj_keys_kernel<false><<<C, gr::kAdjThreads, smem, stream>>>(
      a, pcount, boff, keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gr::adj_scan_cols_kernel<<<(nb + 31) / 32, 1024, 0, stream>>>(
      pcount, C, static_cast<uint32_t>(nb), boff);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gr::adj_scan_parts_kernel<<<1, 1024, 0, stream>>>(boff, nb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gr::adj_keys_kernel<true><<<C, gr::kAdjThreads, smem, stream>>>(
      a, pcount, boff, keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gr::adj_split_kernel<<<nb, gr::kAdjThreads, smem_split, stream>>>(
      boff, static_cast<uint32_t>(parts), shift, ob, keys, part_off, buckets);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gr::adj_group_kernel<<<parts, gr::kGroupThreads, smem_group, stream>>>(
      part_off, cap, ob, B, buckets, cnt);
  return cudaGetLastError();
}

// table/side/n_banks/bank_len/remote: the id table's and the side table's
// bank view (common.cuh make_side_banks), every bank 16-byte aligned; a
// bank of any length (its last len % 4 entries reset one by one).  spill:
// spill_ctas slices of the insert index and the per-read state (16-byte
// aligned; path/wavefront.py rounds_smem gives a slice's bytes), which a
// window whose state does not fit in shared memory takes; the grid is
// then at most spill_ctas CTAs.
int gr_wave_rounds(void* const* table, void* const* side, int n_banks,
                   int64_t bank_len, int remote, int ranked,
                   int64_t limit, uint32_t or_bits, const int64_t* grid_q,
                   const bool* ok_q, int Hq, int Fq, const int64_t* grid_i,
                   const bool* ok_i, int Hi, int Fi, const int32_t* n_tiles,
                   const int64_t* full_len, const int32_t* adj, int B, int T,
                   int K, int vote_min_q, int x_q, int vote_min_f, int x_f,
                   int u_min, int a_max, int TL, int bs, int S, int rech_on,
                   int silver, int64_t target, int64_t max_paths,
                   int64_t* scal, int64_t* rows, int64_t* counters,
                   unsigned long long* sums, int32_t* vals, bool* binit,
                   int64_t* tmin, uint32_t* adj_bits, unsigned char* spill,
                   int64_t spill_ctas, cudaStream_t stream) {
  using gr::kWaveThreads;
  const int bits_q = gr::table_bits(Hq * Fq), bits_f = gr::table_bits(Hi * Fi);
  gr::SideBanks tabs;
  if (!gr::make_side_banks(table, side, n_banks, bank_len, remote, &tabs))
    return cudaErrorInvalidValue;
  for (int j = 0; j < n_banks; ++j)
    if (reinterpret_cast<uintptr_t>(tabs.ids.table[j]) % 16 ||
        reinterpret_cast<uintptr_t>(tabs.side[j]) % 16)
      return cudaErrorInvalidValue;
  if (B < 0 || T < 1 || K < 1 || Hq < 1 || Hi < 1 || Hq > gr::kMaxH ||
      Hi > gr::kMaxH || K > Hq * Fq || bits_q > 14 ||
      (rech_on && (K > Hi * Fi || bits_f > 14)) || bs < 1 || TL < 1 ||
      limit <= 0 || limit >= (1ll << 31) ||
      static_cast<int64_t>(B) * Hi * T * Fi >= (1ll << 31))
    return cudaErrorInvalidValue;
  if (B == 0) return gr::kNoLaunch;
  // a tier of at most 2^kWarpBits votes a tile probes a tile per warp
  const int warp_q = bits_q <= gr::kWarpBits;
  const int warp_f = rech_on && bits_f <= gr::kWarpBits;
  // each warp's region: kernel C's buffer, as the consume kernel sizes it,
  // or a warp tile's vote table and candidates
  const auto align16 = [](size_t v) {
    return (v + 15) & ~static_cast<size_t>(15);
  };
  int t2 = 1;
  while (t2 < T) t2 <<= 1;
  const int chunk = (T < 32 ? T : 32) * K;
  const int cbuf = t2 > chunk ? t2 : chunk;
  const size_t c_bytes =
      align16(8 * (((T + 1) & ~1) + static_cast<size_t>(cbuf)));
  size_t probe_bytes = 0;
  if (warp_q)
    probe_bytes = std::max(probe_bytes, static_cast<size_t>(16) << bits_q);
  if (warp_f)
    probe_bytes = std::max(probe_bytes, static_cast<size_t>(16) << bits_f);
  probe_bytes = align16(probe_bytes);
  // a CTA tile's table and candidates
  size_t tile = 0;
  for (int bits : {warp_q ? 1 : bits_q, warp_f || !rech_on ? 1 : bits_f})
    tile = std::max(tile, ((static_cast<size_t>(1) << bits) + kWaveThreads) *
                              sizeof(unsigned long long));
  tile = align16(tile);
  // the commit pass's insert index (3 words a read), which shares the
  // work region, and the per-read state
  const size_t index = align16(12 * static_cast<size_t>(B));
  const size_t state = ((B + 15) & ~15) + static_cast<size_t>(B) * 16 +
                       4 * static_cast<size_t>((B + 31) / 32);
  // the work region of C on `cw` warps: the warps' regions (one stride for
  // C's buffer and the probe's table while all 16 warps run C), or a CTA
  // tile's
  constexpr int kWarps = kWaveThreads / 32;
  const size_t budget = gr::kMaxSmem - gr::kWaveStatic;
  const auto work_of = [&](int cw) {
    return cw == kWarps ? std::max(kWarps * std::max(c_bytes, probe_bytes),
                                   tile)
                        : std::max({kWarps * probe_bytes, tile,
                                    cw * c_bytes});
  };
  // C on every warp while the work region fits; else on the most warps
  // whose buffers fit beside the index and the state, or, failing that,
  // alone
  int c_warps = kWarps;
  if (work_of(kWarps) > budget) {
    c_warps = 0;
    for (int cw = kWarps - 1; cw >= 1 && !c_warps; --cw)
      if (std::max(work_of(cw), index) + state <= budget) c_warps = cw;
    for (int cw = kWarps - 1; cw >= 1 && !c_warps; --cw)
      if (work_of(cw) <= budget) c_warps = cw;
    if (!c_warps) return cudaErrorInvalidValue;
  }
  // the index and the state beside the work region while they fit, else
  // in a slice of spill a CTA
  const size_t work = work_of(c_warps);
  const bool spilled = std::max(work, index) + state > budget;
  const size_t smem = spilled ? work : std::max(work, index) + state;
  if (smem > budget || (spilled && (spill == nullptr ||
                                          spill_ctas < 1)))
    return cudaErrorInvalidValue;
  const size_t warp_bytes =
      c_warps == kWarps ? std::max(c_bytes, probe_bytes) : probe_bytes;
  cudaError_t err;
  int dev = 0, sms = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  gr::WaveArgs a{tabs, ranked, limit, or_bits, grid_q, ok_q,
                 Hq, Fq, grid_i, ok_i, Hi, Fi, n_tiles, full_len, adj, B, T,
                 K, vote_min_q, x_q, bits_q, vote_min_f, x_f, bits_f, u_min,
                 a_max, TL, bs, S, rech_on, silver, cbuf, warp_q, warp_f,
                 static_cast<int>(warp_bytes), c_warps,
                 static_cast<int>(c_warps == kWarps ? warp_bytes : c_bytes),
                 target, max_paths, scal, rows,
                 counters, sums, vals, binit, tmin, adj_bits,
                 std::max(work, index), spill,
                 index + ((state + 15) & ~static_cast<size_t>(15)), index};
  return gr::with_side_view(tabs, [&](auto tab) {
    const auto kernel = spilled ? gr::wave_kernel<decltype(tab), true>
                                : gr::wave_kernel<decltype(tab), false>;
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    if (attr.sharedSizeBytes > gr::kWaveStatic) return cudaErrorInvalidValue;
    if ((e = gr::opt_in_smem(kernel, smem)) != cudaSuccess) return e;
    int per_sm = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kWaveThreads, smem)) != cudaSuccess)
      return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    int64_t grid = static_cast<int64_t>(sms) * per_sm;
    if (spilled) grid = std::min(grid, spill_ctas);
    void* args[] = {&a};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(static_cast<unsigned>(grid)),
                                    dim3(kWaveThreads), args, smem, stream);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  });
}

}  // extern "C"
