// The two inserts' device code: kernel D (the exact reservoir insert,
// launched alone by insert_sorted.cu, whose note gives its design and
// bound) and insert_max (the throughput mode's max-id-wins insert,
// insert_max.cu; below), run as they are by the fused consume kernel
// (consume.cu), which also stages insert_max's keys of a probed read.
//
// Kernel D in three steps, every CTA of a cooperative grid taking part:
//   1. scatter_window: each CTA reads its own slice of the recruit's window
//      once and sends every real key's entry (key << 16 | tile) to the
//      bucket of the CTA that owns the key (part_of), through global memory
//      that stays in L2;
//   2. (a grid barrier)
//   3. owner_sort: each owner sorts its bucket in shared memory (an owner
//      past `cap` entries re-reads the window and keeps its distinct
//      entries, or, past cap / 2 of those, all of them in a slice of the
//      spill buffer, and sorts there); owner_apply walks each key's run.
// The batch entry (at the end) runs the same steps over every recruit of a
// classified batch, each CTA owning several keys' buckets in turn.
#pragma once

#include "common.cuh"

namespace gr {

// the most owners (CTAs) a key partition has: one shared counter each
constexpr int kMaxParts = 512;

// The CTA (of `parts`) that owns key k (mibf.py insert_part): a hash of
// its low 32 bits, so keys that differ only at or above bit 32 (ranks of a
// filter with more than 2^32 present slots) may share a CTA, which tells
// them apart by the whole key.
__device__ __forceinline__ uint32_t part_of(int64_t k, uint32_t parts) {
  return __umulhi(static_cast<uint32_t>(k) * 0x9E3779B1u, parts);
}

// A recruit's window for kernel D: the entries of tiles t0..t1-1 of every
// seed row of its insert grid [H, TF] (F frames a tile), keys below `limit`
// real.  With kRankMap the grid holds the slots of a compressed filter of
// `size` slots, and each entry's key is its slot's rank in the frozen
// presence structure (compressed.py bitrank and supers, n_super
// superblocks), read as the entry is: an absent slot, or one at or past
// `size` (an invalid frame), takes the sentinel rank `limit`
// (goldrush_tpu/mibf/compressed.py:352-354, compressed.rank_grid).
template <bool kRankMap>
struct WindowOf {
  const int64_t* slots;
  int H;
  int64_t TF;
  int F, t0, t1;
  int64_t limit;
  const unsigned long long* bitrank = nullptr;
  const unsigned long long* supers = nullptr;
  int n_super = 1;
  int64_t size = 0;

  __device__ int64_t size_of() const {
    return t1 > t0 ? static_cast<int64_t>(H) * (t1 - t0) * F : 0;
  }
  // window entry e: seed e / cols, column t0 * F + e % cols
  __device__ int64_t column(int64_t e) const {
    const int64_t cols = static_cast<int64_t>(t1 - t0) * F;
    return static_cast<int64_t>(t0) * F + e % cols;
  }
  __device__ int64_t key(int64_t e) const {
    const int64_t cols = static_cast<int64_t>(t1 - t0) * F;
    const int64_t x = slots[(e / cols) * TF + column(e)];
    if constexpr (kRankMap) {
      if (x < 0 || x >= size) return limit;
      const uint64_t s = static_cast<uint64_t>(x) >> 32;
      return rank_in(bitrank[x >> 5], static_cast<unsigned>(x & 31),
                     supers[s < static_cast<uint64_t>(n_super)
                                ? s : n_super - 1],
                     limit);
    }
    return x;
  }
  __device__ bool real(int64_t key) const { return key >= 0 && key < limit; }
  // the sort entry of entry e, whose key is `key` (insert_entry)
  __device__ uint64_t entry(int64_t e, int64_t key) const;
};
using Window = WindowOf<false>;

// Kernel D's sort entry of a real key (below 2^48, which the wrappers
// check) at tile t: key << 16 | t.  A key's entries sort by tile, so by its
// block m = (t - lo) / bs, whatever lo the decision picks later.
__device__ __forceinline__ uint64_t insert_entry(int64_t key, int64_t col,
                                                 int F) {
  return (static_cast<uint64_t>(key) << 16) | static_cast<uint64_t>(col / F);
}

template <bool kRankMap>
__device__ __forceinline__ uint64_t WindowOf<kRankMap>::entry(
    int64_t e, int64_t key) const {
  return insert_entry(key, column(e), F);
}

// The slice of a window's W entries that CTA `rank` of `n` reads:
// [rank * per, (rank + 1) * per) clipped to W, per = ceil(W / n)
// (consume.py scatter_slices).
__device__ __forceinline__ void slice_of(int64_t W, int rank, int n,
                                         int64_t& lo, int64_t& hi) {
  const int64_t per = (W + n - 1) / n;
  lo = min64(W, rank * per);
  hi = min64(W, lo + per);
}

// Step 1 for CTA `rank` of `n`, every thread calling it: the real entries
// of its slice go to their owners' buckets, owner p's entries at
// bucket[p * cap + j] for j < cap, count[p] counting all of them (a bucket
// that overflows is re-read by its owner).  The CTA counts its entries per
// owner in shared memory, then reserves each owner's run with one global
// atomic.  The window's grid is read-only for the launch.  At most kParts
// owners (parts <= kParts).
template <int kParts = kMaxParts, typename Win>
__device__ inline void scatter_window(const Win& w, int rank, int n,
                                      uint32_t parts, int cap,
                                      unsigned* __restrict__ count,
                                      unsigned long long* __restrict__ bucket) {
  __shared__ unsigned s_cnt[kParts];
  __shared__ unsigned s_base[kParts];
  int64_t lo, hi;
  slice_of(w.size_of(), rank, n, lo, hi);
  for (int p = threadIdx.x; p < static_cast<int>(parts); p += blockDim.x)
    s_cnt[p] = 0;
  __syncthreads();
  // the same trip count in every thread: the barriers below are uniform
  for (int64_t base = lo; base < hi; base += blockDim.x) {
    const int64_t e = base + threadIdx.x;
    bool own = false;
    uint32_t p = 0, r = 0;
    uint64_t entry = 0;
    if (e < hi) {
      const int64_t key = w.key(e);
      if (w.real(key)) {
        own = true;
        p = part_of(key, parts);
        entry = w.entry(e, key);
        r = atomicAdd(&s_cnt[p], 1u);
      }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < static_cast<int>(parts); q += blockDim.x) {
      const unsigned c = s_cnt[q];
      if (c) {
        s_base[q] = atomicAdd(count + q, c);
        s_cnt[q] = 0;
      }
    }
    __syncthreads();
    if (own) {
      const unsigned j = s_base[p] + r;
      if (j < static_cast<unsigned>(cap))
        bucket[static_cast<int64_t>(p) * cap + j] = entry;
    }
  }
}

// An owner past its bucket re-reads the window and keeps each distinct
// entry once in a hash set in sbuf (`cap` entries): repeated k-mers make
// many entries of few (key, tile) pairs, and a repeated pair changes
// nothing (the reservoir rule skips a repeated block).  Up to cap / 2
// distinct entries it compacts them into `out` (cap / 2 entries), copies
// them back to sbuf's front and returns their number; past that, -1.
// Every thread calls it.
template <typename Win>
__device__ inline int owner_distinct(const Win& w, uint32_t part,
                                     uint32_t parts, int cap, uint64_t* sbuf,
                                     uint64_t* out) {
  __shared__ int s_distinct, s_packed;
  for (int i = threadIdx.x; i < cap; i += blockDim.x) sbuf[i] = kSentinel64;
  if (threadIdx.x == 0) s_distinct = s_packed = 0;
  __syncthreads();
  const int64_t W = w.size_of();
  const unsigned mask = static_cast<unsigned>(cap) - 1u;
  for (int64_t e = threadIdx.x; e < W; e += blockDim.x) {
    if (*static_cast<volatile int*>(&s_distinct) > cap / 2) break;
    const int64_t key = w.key(e);
    if (!w.real(key) || part_of(key, parts) != part) continue;
    const uint64_t ent = w.entry(e, key);
    unsigned h = static_cast<unsigned>((ent * 0x9E3779B97F4A7C15ull) >> 40);
    for (;; h = (h + 1u) & mask) {
      const unsigned long long was = atomicCAS(
          reinterpret_cast<unsigned long long*>(sbuf + (h & mask)),
          kSentinel64, static_cast<unsigned long long>(ent));
      if (was == kSentinel64) {
        atomicAdd(&s_distinct, 1);
        break;
      }
      if (was == ent) break;
    }
  }
  __syncthreads();
  const int d = s_distinct;
  if (d > cap / 2) return -1;
  for (int i = threadIdx.x; i < cap; i += blockDim.x)
    if (sbuf[i] != kSentinel64) out[atomicAdd(&s_packed, 1)] = sbuf[i];
  __syncthreads();
  for (int i = threadIdx.x; i < d; i += blockDim.x) sbuf[i] = out[i];
  __syncthreads();
  return d;
}

// Step 3's sort for owner `part` of `parts`, every thread calling it after
// the grid barrier that follows step 1: its count (which it clears for the
// next use of the bucket) and its entries, sorted, in `sbuf` (`cap`
// shared-memory entries, a power of two, with `out` cap / 2 more); past
// `cap`, owner_distinct's distinct entries there, or past cap / 2 distinct
// ones, all entries in a power-of-two slice of `spill_data` allocated
// through `spill_count`, into which it re-reads the window.  Returns the
// entries; *n_out their number.  Bucket and count were written by other
// CTAs: read through L2.
template <typename Win>
__device__ inline uint64_t* owner_sort(const Win& w, uint32_t part,
                                       uint32_t parts, int cap,
                                       unsigned* count,
                                       const unsigned long long* bucket,
                                       uint64_t* sbuf, uint64_t* out,
                                       unsigned long long* spill_count,
                                       uint64_t* spill_data, int* n_out) {
  __shared__ int s_n, s_fill;
  __shared__ uint64_t* s_spill;
  __syncthreads();
  if (threadIdx.x == 0) {
    s_n = static_cast<int>(__ldcg(count + part));
    count[part] = 0;
  }
  __syncthreads();
  int n = s_n;
  if (n > cap) {
    const int d = owner_distinct(w, part, parts, cap, sbuf, out);
    if (d >= 0) n = d;
  }
  *n_out = n;
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  uint64_t* buf = sbuf;
  if (n2 > cap) {
    if (threadIdx.x == 0) {
      s_fill = 0;
      s_spill = spill_data +
                atomicAdd(spill_count, static_cast<unsigned long long>(n2));
    }
    __syncthreads();
    buf = s_spill;
    const int64_t W = w.size_of();
    for (int64_t e = threadIdx.x; e < W; e += blockDim.x) {
      const int64_t key = w.key(e);
      if (w.real(key) && part_of(key, parts) == part)
        buf[atomicAdd(&s_fill, 1)] = w.entry(e, key);
    }
  } else if (s_n <= cap) {
    const unsigned long long* src = bucket + static_cast<int64_t>(part) * cap;
    for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = __ldcg(src + i);
  }
  for (int i = n + threadIdx.x; i < n2; i += blockDim.x) buf[i] = kSentinel64;
  __syncthreads();
  if (n2 <= static_cast<int>(blockDim.x)) {
    block_bitonic_sort_small(buf, n2);
  } else {
    block_bitonic_sort(buf, n2);
  }
  return buf;
}

// Whether sorted entry i opens its key's run.
__device__ __forceinline__ bool run_start(const uint64_t* buf, int i) {
  return i == 0 || (buf[i - 1] >> 16) != (buf[i] >> 16);
}

// The counter of each run's key, read ahead into before[i] at the run's
// first entry (the fused kernel does it while the read's decision is being
// made; no other CTA writes an owner's keys).  Every thread calls it.
template <typename Filt>
__device__ inline void owner_prefetch(const uint64_t* buf, int n,
                                      const Filt filt, uint32_t* before) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (run_start(buf, i))
      before[i] = __ldcg(filt.count(static_cast<int64_t>(buf[i] >> 16)));
}

// Step 3's reservoir rule over the sorted entries: one thread per distinct
// key walks its run, keeps the tiles lo..last, skips a repeated block m =
// (t - lo) / bs, and writes counts[key] once and the word at most once: the
// j-th distinct block (j from 1) sees cnt = counts[key] + j (u32) and
// accepts iff (u32(key) ^ id_m) % max(cnt, 1) == cnt - 1; the last
// accepting block's id wins: the key's entry becomes (old & keep) |
// or_bits | id (keep == 0, the engine's inserts: the old entry is not
// read).  `before` holds owner_prefetch's counters, or is null (then read
// here, through L2).  The table and counters are reached through the
// filter's view (common.cuh FlatTable or Banks).  Every thread calls it.
template <typename Filt>
__device__ inline void owner_apply(const Filt filt, const uint64_t* buf,
                                   int n, const uint32_t* before, int lo,
                                   int last, uint32_t base, int trimmed,
                                   int bs, uint32_t or_bits, uint32_t keep) {
  const uint32_t b = static_cast<uint32_t>(bs);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!run_start(buf, i)) continue;
    const int64_t key = static_cast<int64_t>(buf[i] >> 16);
    uint32_t cnt0 = 0, j = 0, id_won = 0, prev_m = 0xFFFFFFFFu;
    bool won = false;
    for (int k = i; k < n && buf[k] >> 16 == static_cast<uint64_t>(key);
         ++k) {
      const int t = static_cast<int>(buf[k] & 0xFFFFu);
      if (t < lo || t > last) continue;
      const uint32_t m = static_cast<uint32_t>(t - lo) / b;
      if (m == prev_m) continue;
      if (j == 0) cnt0 = before ? before[i] : __ldcg(filt.count(key));
      prev_m = m;
      const uint32_t id = base + (trimmed ? (m * b + 1u) / b : m);
      const uint32_t cnt = cnt0 + ++j;
      // the accept rule keys on the key's low 32 bits, as the JAX
      // package's u32(rank) ^ id does
      if ((static_cast<uint32_t>(key) ^ id) % (cnt ? cnt : 1u) == cnt - 1u) {
        won = true;
        id_won = id;
      }
    }
    if (j == 0) continue;
    *filt.count(key) = cnt0 + j;
    if (won)
      *filt.word(key) = (keep ? *filt.word(key) & keep : 0u) | or_bits |
                        id_won;
  }
}

// insert_max (K15): every real key of a recruit's tiles lo..last raises
// its table entry (through the filter's view) to or_bits | its block id,
// by a reduction whose result is unused (red.global.max, device scope:
// only the launching card's threads write the banks during a launch, also
// a bank in peer memory, where it needs native peer atomics, kernels.py
// require_peer).  Max commutes, so neither the order of the reductions nor
// the split of the window over threads changes the table.
//
// A seed's tiles lo..last are one contiguous span of L = nw * F int64 keys
// at g + s * TF + lo * F, so the window is H spans, entry e = s * L + c
// (span column c).  A thread takes one entry at a time: its span and its
// block, c / (F * bs), are two multiply-highs (Div32), with no division
// per entry; the design it replaces spent three 64-bit divisions or
// modulos per entry.  On an H100 (tools/torch_port_insert_max_variants.py)
// two keys a thread by 16-byte loads over a CTA's slice of the spans was
// slower alone and inside the consume kernel: fewer threads wait on the
// same loads.

// n / d for n < 2^31 and d >= 1: the multiply-high of n by floor((2^32 -
// 1) / d) falls short of n / d by less than n (1 + 1/d) / 2^32 <= 1, so it
// is floor(n / d) or one less, and one compare corrects it.
struct Div32 {
  uint32_t d, m;

  __device__ explicit Div32(uint32_t d_) : d(d_), m(0xFFFFFFFFu / d_) {}
  __device__ __forceinline__ uint32_t operator()(uint32_t n) const {
    const uint32_t q = __umulhi(n, m);
    return q + (n - q * d >= d ? 1u : 0u);
  }
};

// A recruit's window of H spans of L keys (L * H < 2^31, which the
// wrappers check) and its block ids: a key at span column c (from tile lo)
// of tiles of F keys takes or_bits | base + m, or base + (m * bs + 1) / bs
// when trimmed, m = (c / F) / bs = c / (F * bs); (m * bs + 1) / bs is m + 1
// at bs = 1 and m above.
struct MaxWindow {
  uint32_t L, W;   // a span's keys; all keys, H * L
  Div32 span, block;
  uint32_t first;  // or_bits | base (+ 1 when trimmed at bs = 1)

  __device__ MaxWindow(int H, int tiles, int F, int bs, uint32_t base,
                       bool trimmed, uint32_t or_bits)
      : L(static_cast<uint32_t>(tiles) * static_cast<uint32_t>(F)),
        W(L * static_cast<uint32_t>(H)),
        span(L > 0 ? L : 1u),
        block(static_cast<uint32_t>(F) * static_cast<uint32_t>(bs)),
        first(or_bits | (base + (trimmed && bs == 1 ? 1u : 0u))) {}
  // entry e's seed and span column
  __device__ __forceinline__ void at(uint32_t e, uint32_t& s,
                                     uint32_t& c) const {
    s = span(e);
    c = e - s * L;
  }
  __device__ __forceinline__ uint32_t value(uint32_t c) const {
    return first + block(c);
  }
};

// A key below `limit` raises its entry to v.  The table's words hold no
// saturation bit and ids stay below 2^30 (the wrappers check), so v and
// every entry are non-negative int32 and the signed maximum is the JAX
// package's uint32 scatter-max.
template <typename Words>
__device__ __forceinline__ void raise_max(const Words filt, int64_t key,
                                          int64_t limit, uint32_t v) {
  if (key < 0 || key >= limit) return;
  asm volatile("red.relaxed.gpu.global.max.s32 [%0], %1;" ::"l"(
                   __cvta_generic_to_global(filt.word(key))),
               "r"(v)
               : "memory");
}

// insert_max of tiles lo..last of a read's insert grid g [H, TF] (F frames
// a tile), loaded as it goes: thread j of `threads` takes entries j, j +
// threads, ...  The standalone launch (insert_max.cu: one entry a thread)
// and the consume kernel's inserts that were not staged (the whole grid)
// run it.
template <typename Words>
__device__ __forceinline__ void insert_max_loaded(
    const Words filt, const int64_t* __restrict__ g, int64_t TF, int F,
    int H, int lo, int last, int64_t limit, uint32_t or_bits, uint32_t base,
    bool trimmed, int bs, uint32_t j, uint32_t threads) {
  if (last < lo) return;
  const MaxWindow w(H, last - lo + 1, F, bs, base, trimmed, or_bits);
  const int64_t* g0 = g + static_cast<int64_t>(lo) * F;
  for (uint32_t e = j; e < w.W; e += threads) {
    uint32_t s, c;
    w.at(e, s, c);
    raise_max(filt, __ldg(g0 + s * TF + c), limit, w.value(c));
  }
}

// Whether a read of nt tiles stages in n CTAs of `cap` keys each: its
// whole window of tiles 0..nt-1 cut by slice_of, ceil(W / n) <= cap
// (consume.py stage_fits).
__device__ __forceinline__ bool stage_fits(int H, int nt, int F, int n,
                                           int cap) {
  const int64_t W = static_cast<int64_t>(H) * nt * F;
  return cap > 0 && nt > 0 && W <= static_cast<int64_t>(n) * cap;
}

// The consume kernel's staging of a probed read, while its decision is
// made: CTA `rank` of `n` copies its slice (slice_of) of the read's window
// of tiles 0..nt-1 into stage[] (shared memory), in slice order.  Every
// thread calls it; the caller's barrier publishes it.
__device__ __forceinline__ void stage_max_slice(
    const int64_t* __restrict__ g, int64_t TF, int F, int H, int nt,
    int rank, int n, int64_t* stage) {
  const MaxWindow w(H, nt, F, 1, 0u, false, 0u);
  int64_t e0, e1;
  slice_of(w.W, rank, n, e0, e1);
  for (uint32_t j = threadIdx.x; j < e1 - e0; j += blockDim.x) {
    uint32_t s, c;
    w.at(static_cast<uint32_t>(e0) + j, s, c);
    stage[j] = __ldg(g + s * TF + c);
  }
}

// insert_max of tiles lo..last from the staged slices (lo >= 0, last <
// nt): CTA `rank` of `n` raises its staged keys whose span columns lie in
// the range.  Every thread calls it.
template <typename Words>
__device__ __forceinline__ void insert_max_staged(
    const Words filt, const int64_t* stage, int F, int H, int nt, int lo,
    int last, int64_t limit, uint32_t or_bits, uint32_t base, bool trimmed,
    int bs, int rank, int n) {
  if (last < lo) return;
  const MaxWindow w(H, nt, F, bs, base, trimmed, or_bits);
  const uint32_t a = static_cast<uint32_t>(lo) * F;   // the range's columns
  const uint32_t b = static_cast<uint32_t>(last + 1) * F;
  int64_t e0, e1;
  slice_of(w.W, rank, n, e0, e1);
  for (uint32_t j = threadIdx.x; j < e1 - e0; j += blockDim.x) {
    uint32_t s, c;
    w.at(static_cast<uint32_t>(e0) + j, s, c);
    if (c >= a && c < b) raise_max(filt, stage[j], limit, w.value(c - a));
  }
}

// Kernel D over a classified batch (insert_batch, insert_sorted.cu): the
// recruits of train_step's batch in one launch.  Read i of the batch
// inserts its tiles lo..last (batch_read), block m = (t - lo) / bs taking
// the id base_i + m, or base_i + (m * bs + 1) / bs when trimmed.  A key's
// result depends only on its own occurrences in order, and train_step
// inserts read after read, each read's blocks in order: so the batch is
// exact when a key's entries sort by (read, tile).  A batch entry is
// key << shift | read << tile_bits | tile, shift = tile_bits + read_bits
// (the wrapper picks the bits, and cuts the batch into chunks of reads
// whose order field fits beside the keys, launched in batch order).

// the most reads of a launch (their tiles and ids staged in shared memory)
// and the most owners of its keys
constexpr int kBatchReads = 1024;
constexpr int kBatchParts = 1024;

// Read i's insert (train_step's scan, goldrush_tpu/parallel/mesh.py:
// 86-108): decision 1 (whole) tiles 0..n_t - 1, 2 (trimmed) ts..te, 0
// nothing; then the first max_blocks blocks (insert_read's limit) of the
// tiles below T.  x = lo, y = last (last < lo: nothing), z = the base id,
// w = trimmed.  n_t = len / tile_length.
__device__ __forceinline__ int4 batch_read(int dec, int ts, int te, int len,
                                           int tile_length, int max_blocks,
                                           int bs, int T, uint32_t base) {
  int lo = 1, hi = 0;
  if (dec == 1) {
    lo = 0;
    hi = len / tile_length - 1;
  } else if (dec == 2) {
    lo = ts;
    hi = te;
  }
  const int64_t cap = static_cast<int64_t>(lo) +
                      static_cast<int64_t>(max_blocks) * bs - 1;
  const int last = static_cast<int>(
      min64(min64(hi, cap), static_cast<int64_t>(T) - 1));
  return make_int4(lo, last, static_cast<int>(base), dec == 2 ? 1 : 0);
}

// A batch's window: every entry of its slot grid [n, H, T * F] (n * H * T
// * F < 2^31, which the wrapper checks), entry e of read e / (H * T * F)
// at column e % (T * F), real iff its tile lies in the read's lo..last
// (`reads`, batch_read's) and its key below `limit`.
struct BatchWindow {
  const int64_t* slots;
  const int4* reads;
  uint32_t W, HTF, TF;
  Div32 per_read, per_row, per_tile;
  int64_t limit;
  int tile_bits, shift;

  __device__ BatchWindow(const int64_t* slots_, const int4* reads_, int n,
                         int H, int T, int F, int64_t limit_, int tile_bits_,
                         int shift_)
      : slots(slots_), reads(reads_),
        W(static_cast<uint32_t>(n) * H * T * F),
        HTF(static_cast<uint32_t>(H) * T * F),
        TF(static_cast<uint32_t>(T) * F), per_read(HTF), per_row(TF),
        per_tile(static_cast<uint32_t>(F)), limit(limit_),
        tile_bits(tile_bits_), shift(shift_) {}
  __device__ int64_t size_of() const { return W; }
  // entry e's read and tile
  __device__ __forceinline__ void at(int64_t e, uint32_t& i,
                                     uint32_t& t) const {
    const uint32_t u = static_cast<uint32_t>(e);
    i = per_read(u);
    const uint32_t r = u - i * HTF;
    t = per_tile(r - per_row(r) * TF);
  }
  __device__ int64_t key(int64_t e) const {
    uint32_t i, t;
    at(e, i, t);
    const int4 rd = reads[i];
    if (static_cast<int>(t) < rd.x || static_cast<int>(t) > rd.y)
      return limit;
    return __ldg(slots + e);
  }
  __device__ bool real(int64_t key) const { return key >= 0 && key < limit; }
  __device__ uint64_t entry(int64_t e, int64_t key) const {
    uint32_t i, t;
    at(e, i, t);
    return (static_cast<uint64_t>(key) << shift) |
           (static_cast<uint64_t>(i) << tile_bits) | t;
  }
};

// The reservoir rule for one key of a batch, its `n` entries' order fields
// (read << tile_bits | tile) given by ord(k) in ascending order: each
// distinct (read, block) bumps the u32 counter, cnt, and accepts iff
// (u32(key) ^ id) % max(cnt, 1) == cnt - 1, the word then becoming (word &
// keep) | or_bits | id, as the blocks of train_step's reads insert one
// after another; counts[key] is written once and the word at most once.
template <typename Filt, typename Ord>
__device__ __forceinline__ void apply_key(const Filt filt, int64_t key, int n,
                                          Ord ord, const int4* reads,
                                          int tile_bits, uint32_t bs,
                                          uint32_t or_bits, uint32_t keep) {
  uint32_t cnt = __ldcg(filt.count(key)), word = 0;
  uint32_t prev_r = 0xFFFFFFFFu, prev_m = 0xFFFFFFFFu;
  bool won = false;
  for (int k = 0; k < n; ++k) {
    const uint32_t o = ord(k);
    const uint32_t r = o >> tile_bits;
    const int t = static_cast<int>(o & ((1u << tile_bits) - 1u));
    const int4 rd = reads[r];
    const uint32_t m = static_cast<uint32_t>(t - rd.x) / bs;
    if (r == prev_r && m == prev_m) continue;
    prev_r = r;
    prev_m = m;
    const uint32_t id = static_cast<uint32_t>(rd.z) +
                        (rd.w ? (m * bs + 1u) / bs : m);
    ++cnt;
    // the accept rule keys on the key's low 32 bits, as the JAX package's
    // u32(slot) ^ id does
    if ((static_cast<uint32_t>(key) ^ id) % (cnt ? cnt : 1u) == cnt - 1u) {
      if (!won && keep) word = *filt.word(key);
      word = (word & keep) | or_bits | id;
      won = true;
    }
  }
  *filt.count(key) = cnt;
  if (won) *filt.word(key) = word;
}

// apply_key over an owner's sorted batch entries (owner_sort's), one
// thread per distinct key.  Every thread calls it.
template <typename Filt>
__device__ inline void owner_apply_batch(const Filt filt, const uint64_t* buf,
                                         int n, const int4* reads, int shift,
                                         int tile_bits, int bs,
                                         uint32_t or_bits, uint32_t keep) {
  const uint64_t order_mask = (1ull << shift) - 1ull;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint64_t kk = buf[i] >> shift;
    if (i > 0 && buf[i - 1] >> shift == kk) continue;
    int len = 1;
    while (i + len < n && buf[i + len] >> shift == kk) ++len;
    apply_key(filt, static_cast<int64_t>(kk), len,
              [&](int k) {
                return static_cast<uint32_t>(buf[i + k] & order_mask);
              },
              reads, tile_bits, static_cast<uint32_t>(bs), or_bits, keep);
  }
}

// An owner's batch entries grouped by key without sorting them all: nearly
// every key of a batch occurs once (3.64 M distinct keys in the bench
// batch's 3.84 M entries), and a sort of an owner's ~5,800 entries in
// shared memory took 0.57 of the launch's 0.96 ms on an H100
// (tools/torch_port_insert_batch_variants.py).  The owner's `n` <= cap
// entries (its bucket in global memory, written by other CTAs) go into an
// open-addressing table of `cap` keys in shared memory with a count and
// the first entry's order field each; the second and later entries of a
// key, and then each such key's first, go to a list of at most cap / 2,
// which alone is sorted, by (table slot, order field).  A key of one entry
// is applied from the table, one thread a slot; a key of several from its
// sorted run.  Returns false, with nothing applied, when the list
// overflows (the caller then sorts the whole bucket).  smem: cap u64 keys,
// cap u32 counts, cap u32 order fields, cap / 2 u64 list entries.  Every
// thread calls it.
template <typename Filt>
__device__ inline bool owner_group_batch(const Filt filt,
                                         const unsigned long long* bucket,
                                         int n, int cap, unsigned char* smem,
                                         const int4* reads, int shift,
                                         int tile_bits, int bs,
                                         uint32_t or_bits, uint32_t keep) {
  __shared__ int s_multi;
  uint64_t* hkey = reinterpret_cast<uint64_t*>(smem);
  uint32_t* hcnt = reinterpret_cast<uint32_t*>(hkey + cap);
  uint32_t* hord = hcnt + cap;
  uint64_t* multi = reinterpret_cast<uint64_t*>(hord + cap);
  const int max_multi = cap / 2;
  const uint32_t mask = static_cast<uint32_t>(cap) - 1u;
  const uint64_t order_mask = (1ull << shift) - 1ull;
  for (int h = threadIdx.x; h < cap; h += blockDim.x) {
    hkey[h] = kSentinel64;
    hcnt[h] = 0;
  }
  if (threadIdx.x == 0) s_multi = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint64_t e = __ldcg(bucket + i);
    const uint64_t key = e >> shift;
    uint32_t h = static_cast<uint32_t>((key * 0x9E3779B97F4A7C15ull) >> 40) &
                 mask;
    for (;; h = (h + 1u) & mask) {
      const unsigned long long was = atomicCAS(
          reinterpret_cast<unsigned long long*>(hkey + h), kSentinel64,
          static_cast<unsigned long long>(key));
      if (was == kSentinel64 || was == key) break;
    }
    const uint32_t o = static_cast<uint32_t>(e & order_mask);
    if (atomicAdd(hcnt + h, 1u) == 0) {
      hord[h] = o;
    } else {
      const int m = atomicAdd(&s_multi, 1);
      if (m < max_multi) multi[m] = (static_cast<uint64_t>(h) << 32) | o;
    }
  }
  __syncthreads();
  for (int h = threadIdx.x; h < cap; h += blockDim.x) {
    if (hcnt[h] > 1) {
      const int m = atomicAdd(&s_multi, 1);
      if (m < max_multi)
        multi[m] = (static_cast<uint64_t>(h) << 32) | hord[h];
    }
  }
  __syncthreads();
  const int n_multi = s_multi;
  if (n_multi > max_multi) return false;
  const uint32_t b = static_cast<uint32_t>(bs);
  for (int h = threadIdx.x; h < cap; h += blockDim.x) {
    if (hcnt[h] == 1) {
      const uint32_t o = hord[h];
      apply_key(filt, static_cast<int64_t>(hkey[h]), 1,
                [&](int) { return o; }, reads, tile_bits, b, or_bits, keep);
    }
  }
  int n2 = 1;
  while (n2 < n_multi) n2 <<= 1;
  for (int i = n_multi + threadIdx.x; i < n2; i += blockDim.x)
    multi[i] = kSentinel64;
  __syncthreads();
  if (n_multi > 0) {
    if (n2 <= static_cast<int>(blockDim.x)) {
      block_bitonic_sort_small(multi, n2);
    } else {
      block_bitonic_sort(multi, n2);
    }
  }
  for (int i = threadIdx.x; i < n_multi; i += blockDim.x) {
    const uint64_t slot = multi[i] >> 32;
    if (i > 0 && multi[i - 1] >> 32 == slot) continue;
    int len = 1;
    while (i + len < n_multi && multi[i + len] >> 32 == slot) ++len;
    apply_key(filt, static_cast<int64_t>(hkey[slot]), len,
              [&](int k) { return static_cast<uint32_t>(multi[i + k]); },
              reads, tile_bits, b, or_bits, keep);
  }
  return true;
}

}  // namespace gr
