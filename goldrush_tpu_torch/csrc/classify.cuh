// Kernel C: per-read tile classification and recruit decision (its device
// code; the standalone kernels are classify.cu, the fused consume kernel
// consume.cu).
//
// Replaces classify_batch (goldrush_tpu/path/classify.py:77-429).  The JAX
// version recasts the reference's order-dependent loops as lax.scans over
// the tile axis plus cummax interval painting, because a TPU wants [B]-wide
// vectors.  Here one warp per read runs the loops in the reference's order,
// as transcribed in goldrush_tpu/path/oracle.py: the 8 smoothing passes
// (goldrush_path.cpp:628-888), find_longest_stretch (:195-233), eval_flanks
// (:341-527) and the decision (:943-1081).  Only the inner loops go wide:
//   - the read's working ids/bools rows live in shared memory and are
//     written out once at the end (with the 9 log_tile_states traces when
//     trace buffers are given);
//   - passes 1-2 look a tile's candidates up in the [B, T, K] top-K table of
//     probe_and_vote with one ballot over K lanes (the last match wins, as
//     in the reference); the table is staged into shared memory by chunks
//     of tiles with coalesced loads, so a step is a shared-memory read;
//   - pass 7 sorts its distinct (id << 32 | tile) keys by a warp bitonic
//     sort in shared memory (any correct sort gives the reference's order);
//   - passes 5 and 10 take each run's first tile from a running max of the
//     runs' opening edges, 32 tiles at a time by shuffles with a carry
//     across chunks: the blockwise cummax of tools/probe_pallas.py:98 and
//     the cummax painting of the JAX version (classify.py:189, :319); the
//     lane of each closing edge then fills or clears its run;
//   - flank_top2 counts each window position's id with one lane each;
//   - the other passes are sequential scans run by lane 0.
// The consume kernel's runner (kStaged, with its CTA's candidate masks)
// runs passes 1-4, the longest stretch and the flank top-2 of a read of up
// to 32 tiles across the lanes instead, a tile a lane (reconcile_runs,
// neighbor_fill_scan, flank_top2_lanes); C's own kernel and the wavefront
// keep the walks.
// Several reads share a CTA (one warp each), a single read runs one warp.
// gr_row_cummax launches the warp cummax alone on [R, T] rows, so that it
// can be held against torch.cummax.
//
// Bound.  Bytes: the read's T curr_ids, T*K candidate ids and counts and
// ~8*T bytes of outputs (~5.4 KB per read at T = 20, K = 32: 0.17 MB at
// B = 32, ~0.05 us).  The passes are a few hundred dependent
// shared-memory steps per read, so a launch is latency-bound: one chunk
// load from L2 or DRAM, then the sequential scans.
#pragma once

#include <climits>

#include "common.cuh"

namespace gr {

// reads (one warp each) per CTA
constexpr int kWarps = 4;
// tile_min of a read without in-read tiles (engine_util.NO_TILE)
constexpr int64_t kNoTile = 1 << 30;
// the most dynamic shared memory one block may use on Hopper
constexpr size_t kMaxSmem = 232448;

struct Read {
  int32_t* id;         // [T] working ids (shared memory)
  int32_t* bv;         // [T] working bools (shared memory)
  const int32_t* ci;   // [T, K] candidate ids (global)
  const int32_t* cc;   // [T, K] candidate counts (global)
  int32_t* sci;        // [CH, K] staged candidate ids (shared memory)
  int32_t* scc;        // [CH, K] staged candidate counts
  int n, T, K, CH, lane;
  // the CTA's candidate masks (kStaged, or null): bit x of mcol[i] says
  // tile i's candidates hold tile x's initial id, of scol[i] that one of
  // them with a count over the threshold does
  const uint32_t* mcol;
  const uint32_t* scol;
};

__device__ __forceinline__ bool adj(int32_t a, int32_t b) {
  // a == b, a == b + 1 or a == b - 1 (b - 1 unreachable for b == 0)
  return a == b || a == b + 1 || (b != 0 && a == b - 1);
}

// the rows as the reference logs them after a pass; every lane calls it,
// and lane 0's next pass starts after the whole copy
__device__ inline void trace(const Read& r, int32_t* ids_tr, int32_t* bools_tr,
                      int pass) {
  __syncwarp();
  if (ids_tr == nullptr) return;
  for (int t = r.lane; t < r.T; t += 32) {
    ids_tr[pass * r.T + t] = r.id[t];
    bools_tr[pass * r.T + t] = r.bv[t];
  }
  __syncwarp();
}

// stage the candidates of tiles [lo, hi) into shared memory; a read whose
// whole table its CTA staged already (kStaged) has nothing to stage
template <bool kFused, bool kStaged = false>
__device__ void stage(const Read& r, int lo, int hi) {
  __syncwarp();
  if constexpr (kStaged) return;
  const int m = (hi - lo) * r.K;
  const int64_t off = static_cast<int64_t>(lo) * r.K;
  for (int j = r.lane; j < m; j += 32) {
    r.sci[j] = load_ro<kFused>(r.ci + off + j);
    r.scc[j] = load_ro<kFused>(r.cc + off + j);
  }
  __syncwarp();
}

// pass 1/2 step: tile i takes prev when its candidate table holds it, with
// the count of the last matching candidate (staged from tile lo).  Every
// lane calls it and gets the tile's new id; lane 0 writes the rows.
__device__ inline int32_t reconcile(const Read& r, int i, int lo, int32_t prev,
                             int threshold) {
  const int32_t cur = r.id[i];
  if (cur == prev) return cur;
  const int32_t* ci = r.sci + (i - lo) * r.K;
  const int32_t* cc = r.scc + (i - lo) * r.K;
  int best = -1;
  for (int kb = 0; kb < r.K; kb += 32) {
    const int k = kb + r.lane;
    const unsigned hit =
        __ballot_sync(kFull, k < r.K && cc[k] > 0 && ci[k] == prev);
    if (hit) best = kb + 31 - __clz(hit);
  }
  if (best < 0) return cur;
  if (r.lane == 0) {
    r.id[i] = prev;
    r.bv[i] = cc[best] > threshold;
  }
  return prev;
}

// pass 1 (forward, :646-661) or pass 2 (backward, :667-682), staging the
// candidates chunk by chunk in the pass's direction
template <bool kFused, bool kStaged = false>
__device__ void reconcile_pass(const Read& r, bool backward, int threshold,
                               int& lo, int& hi) {
  const int n = r.n;
  __syncwarp();
  int32_t prev = backward ? r.id[n - 1] : r.id[0];
  for (int s = 1; s < n; ++s) {
    const int i = backward ? n - 1 - s : s;
    if (i < lo || i >= hi) {
      lo = backward ? max(0, i + 1 - r.CH) : i;
      hi = backward ? i + 1 : min(n, i + r.CH);
      stage<kFused, kStaged>(r, lo, hi);
    }
    prev = reconcile(r, i, lo, prev, threshold);
  }
}

// pass 3/4 step on tile c's id and bool, between neighbours p and n
// (goldrush_path.cpp:688-734; neighbor_fill's branches as selects: the
// first three set the bool, the last, taken only when they are not, copies
// the left neighbour)
__device__ __forceinline__ void fill_step(int32_t pi, int32_t pa,
                                          int32_t& ci, int32_t& ca,
                                          int32_t ni, int32_t na) {
  const bool l = pa != 0, r = na != 0;
  const bool set = ((ci == pi) & l) | ((ci == ni) & r) |
                   ((ci == pi + 1) & l) | ((ci == ni + 1) & r) |
                   ((pi != 0) & (ci == pi - 1) & l) |
                   ((ni != 0) & (ci == ni - 1) & r);
  const bool copy = !ca & !set & (pi == ni) & l & r;
  ci = copy ? pi : ci;
  ca = ca ? ca : set ? 1 : copy ? pa : ca;
}

// The masks of reconcile_runs for a read of at most 32 tiles, built by
// every thread of its CTA from the staged initial ids `curr_id` [T] and
// candidates [T, K]; the caller orders them before C with a CTA barrier.
// A tile's candidates hold distinct ids, so at most one matches.
__device__ inline void candidate_masks(const int32_t* curr_id,
                                       const int32_t* ci, const int32_t* cc,
                                       int n, int K, int threshold,
                                       uint32_t* mcol, uint32_t* scol) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) mcol[i] = scol[i] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < n * K; j += blockDim.x) {
    const int32_t c = cc[j];
    if (c <= 0) continue;
    const int32_t v = ci[j];
    uint32_t m = 0;
    for (int x = 0; x < n; ++x) m |= static_cast<uint32_t>(curr_id[x] == v) << x;
    if (m == 0) continue;
    atomicOr(&mcol[j / K], m);
    if (c > threshold) atomicOr(&scol[j / K], m);
  }
}

// Pass 1 (forward) or 2 (backward) of a read of at most 32 tiles, lane t
// holding tile t.  The sequential scan keeps a value `prev` (always some
// tile's initial id) until a tile neither holds it nor has it among its
// candidates: that tile starts a new run with its own value.  So each
// tile's "next break" (the nearest tile past it, in the scan's direction,
// that would end a run of its value) is a bit scan of two masks (equal
// values, __match_any_sync; candidate holders, the source's row of the
// candidate masks), the chain of run starts follows the breaks from the
// scan's first tile, and every tile of a run that does not hold the run's
// value takes it, and the bool of its matching candidate.  `src[t]` (a
// register) is the tile whose initial id tile t holds.  Every lane calls
// it; the rows are read from and written to shared memory.
__device__ inline void reconcile_runs(const Read& r, bool backward,
                                      int& src) {
  const int n = r.n, t = r.lane;
  const bool in = t < n;
  const unsigned valid = n >= 32 ? kFull : (1u << n) - 1u;
  __syncwarp();
  const int32_t v = in ? r.id[t] : 0;
  const int32_t b = in ? r.bv[t] : 0;
  const uint32_t mc = in ? r.mcol[t] : 0u, sc = in ? r.scol[t] : 0u;
  // row[x] bit j = tile j's candidates hold tile x's initial id
  uint32_t row = 0;
  for (int x = 0; x < n; ++x) {
    const unsigned m = __ballot_sync(kFull, (mc >> x) & 1u);
    if (t == x) row = m;
  }
  const uint32_t cont = (__match_any_sync(kFull, v) |
                         __shfl_sync(kFull, row, src)) & valid;
  const unsigned beyond = backward ? (1u << t) - 1u
                          : t >= 31 ? 0u : ~0u << (t + 1);
  const unsigned brk = ~cont & beyond & valid;
  const int next = brk ? (backward ? 31 - __clz(brk) : __ffs(brk) - 1)
                       : (backward ? -1 : n);
  unsigned starts = 0;
  for (int s = backward ? n - 1 : 0; s >= 0 && s < n;
       s = __shfl_sync(kFull, next, s))
    starts |= 1u << s;
  // the start of my run: the nearest start at or before me in the scan
  const int rs = backward
      ? __ffs(starts & ~((1u << t) - 1u)) - 1
      : 31 - __clz(starts & (t >= 31 ? kFull : (2u << t) - 1u));
  const int32_t vr = __shfl_sync(kFull, v, rs & 31);
  const int sr = __shfl_sync(kFull, src, rs & 31);
  __syncwarp();
  if (in && rs != t && v != vr) {
    r.id[t] = vr;
    r.bv[t] = (sc >> sr) & 1u;
    src = sr;
  } else if (in) {
    r.bv[t] = b;
  }
  __syncwarp();
}

// Passes 3-4 of a read of at most 32 tiles, lane t holding tile t.  A
// tile whose bool is set keeps it; one whose bool is clear sees its
// visited neighbour's updated bool (0 or 1) and its other neighbour and its
// own id as they were: a neighbour's id changes only in fill_step's last
// branch, which needs this tile's bool set.  So each tile is a map of
// that one bit to its new bool, and a scan composes the maps (the forward
// scan from tile 0's bool, the backward one from tile n-1's).  Every lane
// calls it.
__device__ inline void neighbor_fill_scan(const Read& r) {
  const int n = r.n, t = r.lane;
  for (int pass = 0; pass < 2; ++pass) {
    const bool back = pass == 1;
    __syncwarp();
    const bool in = t < n;
    const int32_t ci = in ? r.id[t] : 0, ca = in ? r.bv[t] : 0;
    const int32_t li = __shfl_up_sync(kFull, ci, 1);
    const int32_t la = __shfl_up_sync(kFull, ca, 1);
    const int32_t ri = __shfl_down_sync(kFull, ci, 1);
    const int32_t ra = __shfl_down_sync(kFull, ca, 1);
    const bool work = t >= 1 && t <= n - 2;
    // my bool as a map of the visited neighbour's: bit x = bool after x
    unsigned map = 2u;    // identity
    if (work) {
      unsigned m = 0;
      for (int x = 0; x < 2; ++x) {
        int32_t id = ci, bv = ca;
        if (back) fill_step(li, la, id, bv, ri, x);
        else fill_step(li, x, id, bv, ri, ra);
        m |= static_cast<unsigned>(bv != 0) << x;
      }
      map = m;
    } else if (t == (back ? n - 1 : 0)) {
      map = ca ? 3u : 0u;   // the scan's first tile: a constant
    }
    // compose from the scan's first tile: mine after the ones before
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned g = back ? __shfl_down_sync(kFull, map, o)
                              : __shfl_up_sync(kFull, map, o);
      const bool has = back ? t + o < 32 : t >= o;
      if (has) map = (map >> (g & 1u) & 1u) | ((map >> (g >> 1 & 1u) & 1u) << 1);
    }
    // the visited neighbour's bool: its composed map, a constant
    const unsigned seen = back ? __shfl_down_sync(kFull, map, 1)
                               : __shfl_up_sync(kFull, map, 1);
    __syncwarp();
    if (work) {
      int32_t id = ci, bv = ca;
      if (back) fill_step(li, la, id, bv, ri, static_cast<int32_t>(seen & 1u));
      else fill_step(li, static_cast<int32_t>(seen & 1u), id, bv, ri, ra);
      r.id[t] = id;
      r.bv[t] = bv;
    }
  }
  __syncwarp();
}

// Running max of one value per lane, lane 0 first, seeded by `carry`;
// every lane calls it and gets its own prefix.
__device__ __forceinline__ int warp_cummax(int v, int carry, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, x);
  }
  return max(v, carry);
}

// The runs of passes 5 and 10: maximal runs of tiles whose bool is `val`,
// closed at a tile i in 1..n-2 (bool != val after == val).  The lane of
// the closing tile calls run(a, i - 1), where a is the last opening edge
// (bool == val after != val, at a tile in 1..n-2) before i, or 0: the
// sequential scan's `start`.  A chunk's edges are read before any of its
// runs is written, and a run lies below its closing tile, so no later
// chunk reads what a run writes; runs are disjoint.  Every lane calls it.
template <typename Run>
__device__ void close_runs(const Read& r, bool val, Run run) {
  const int n = r.n;
  int carry = 0;
  for (int base = 1; base < n - 1; base += 32) {
    const int i = base + r.lane;
    bool open = false, close = false;
    if (i < n - 1) {
      const bool in = (r.bv[i] != 0) == val, prev = (r.bv[i - 1] != 0) == val;
      open = in && !prev;
      close = !in && prev;
    }
    const int start = warp_cummax(open ? i : 0, carry, r.lane);
    carry = __shfl_sync(kFull, start, 31);
    __syncwarp();
    if (close) run(start, i - 1);
    __syncwarp();
  }
}

// pass 3/4 step (goldrush_path.cpp:688-734)
__device__ inline void neighbor_fill(const Read& r, int i) {
  if (r.bv[i]) return;
  int32_t ci = r.id[i], ca = 0;
  fill_step(r.id[i - 1], r.bv[i - 1], ci, ca, r.id[i + 1], r.bv[i + 1]);
  r.id[i] = ci;
  r.bv[i] = ca;
}

// ascending bitonic sort of a[0, m) by one warp, padded to a power of two:
// up to 32 keys in registers (one per lane, by shuffles), more in shared
// memory
__device__ inline void warp_bitonic_sort(long long* a, int m, int lane) {
  __syncwarp();  // the keys were written by other lanes
  if (m <= 32) {
    long long x = lane < m ? a[lane] : LLONG_MAX;
    for (int k = 2; k <= 32; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        const long long y = __shfl_xor_sync(kFull, x, j);
        // the lower lane of an ascending pair keeps the min, and so on
        x = ((lane & j) == 0) == ((lane & k) == 0) ? min(x, y) : max(x, y);
      }
    }
    if (lane < m) a[lane] = x;
    __syncwarp();
    return;
  }
  int n2 = 1;
  while (n2 < m) n2 <<= 1;
  for (int i = m + lane; i < n2; i += 32) a[i] = LLONG_MAX;
  __syncwarp();
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < n2; i += 32) {
        const int p = i ^ j;
        if (p > i) {
          const long long x = a[i], y = a[p];
          if ((i & k) == 0 ? x > y : x < y) {
            a[i] = y;
            a[p] = x;
          }
        }
      }
      __syncwarp();
    }
  }
}

template <bool kFused, bool kStaged = false>
__device__ void smooth(const Read& r, int threshold, long long* keys,
                       int32_t* ids_tr, int32_t* bools_tr) {
  const int n = r.n;
  const bool lead = r.lane == 0;
  int32_t* id = r.id;
  int32_t* bv = r.bv;
  const bool on = n >= 3;
  // passes 1-2: ID reconciliation forward, then backward; a read whose
  // table fits one chunk is staged once for both
  int lo = 0, hi = 0;
  // a read of at most 32 tiles whose CTA built the candidate masks runs
  // passes 1-4 across the lanes (kStaged)
  const bool lanes = kStaged && r.mcol != nullptr && n <= 32;
  int src = r.lane;
  if (on && lanes) {
    reconcile_runs(r, false, src);
  } else if (on) {
    hi = min(n, r.CH);
    stage<kFused, kStaged>(r, lo, hi);
    reconcile_pass<kFused, kStaged>(r, false, threshold, lo, hi);
  }
  trace(r, ids_tr, bools_tr, 1);
  if (on && lanes) {
    reconcile_runs(r, true, src);
  } else if (on) {
    reconcile_pass<kFused, kStaged>(r, true, threshold, lo, hi);
  }
  trace(r, ids_tr, bools_tr, 2);
  // pass 3/4: neighbour fill forward then backward (:688-734)
  if (on && lanes) {
    neighbor_fill_scan(r);
  } else if (on && lead) {
    for (int i = 1; i < n - 1; ++i) neighbor_fill(r, i);
    for (int i = n - 2; i > 0; --i) neighbor_fill(r, i);
  }
  trace(r, ids_tr, bools_tr, 3);
  // pass 5: hole fill between compatible flanks (:739-766).  The holes are
  // disjoint, each fill only touches its own hole, and the flanks it reads
  // are no hole's, so filling each hole as its closing edge is found
  // equals collecting them all first.
  if (on) {
    close_runs(r, false, [&](int a, int e) {
      if (a == 0) return;
      const int32_t left = id[a - 1];
      if (adj(left, id[e + 1]))
        for (int j = a; j <= e; ++j) { bv[j] = 1; id[j] = left; }
    });
  }
  trace(r, ids_tr, bools_tr, 4);
  // pass 6: lone-tile suppression forward then backward (:771-792).  A
  // scan step reads its visited neighbour live, but that neighbour was
  // cleared only if this tile was 0 (its own unvisited neighbour), and a
  // 0 tile does nothing: so each scan equals one step over all tiles at
  // once, on the row before it
  if (on) {
    for (int scan = 0; scan < 2; ++scan) {
      for (int base = 2; base < n - 2; base += 32) {
        const int i = base + r.lane;
        const bool lone = i < n - 2 && bv[i] && !bv[i - 1] && !bv[i + 1];
        __syncwarp();
        if (lone) bv[i] = 0;
        __syncwarp();
      }
    }
  }
  trace(r, ids_tr, bools_tr, 5);
  // pass 7: gap bridging by ID in ascending-ID order (:799-822); the
  // member lists come from the assignment before any bridging, the id
  // carried into a gap is re-read from the live ids
  if (on) {
    int m = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + r.lane;
      const bool a = i < n && bv[i];
      const unsigned mask = __ballot_sync(kFull, a);
      if (a)
        keys[m + __popc(mask & ((1u << r.lane) - 1u))] =
            (static_cast<long long>(id[i]) << 32) | i;
      m += __popc(mask);
    }
    warp_bitonic_sort(keys, m, r.lane);
    if (lead) {
      for (int e = 1; e < m; ++e) {
        if ((keys[e] >> 32) != (keys[e - 1] >> 32)) continue;
        const int prev_idx = static_cast<int>(keys[e - 1] & 0xFFFFFFFF);
        const int curr_idx = static_cast<int>(keys[e] & 0xFFFFFFFF);
        if (curr_idx > prev_idx + 1) {
          const int32_t pid = id[prev_idx];
          for (int j = prev_idx + 1; j <= curr_idx; ++j) id[j] = pid;
        }
      }
    }
  }
  trace(r, ids_tr, bools_tr, 6);
  if (on) {
    // pass 8: end-tile fix (:827-838)
    if (lead && adj(id[n - 1], id[n - 2])) bv[n - 1] = 1;
    if (lead && adj(id[0], id[1])) bv[0] = 1;
    // pass 9: non-contiguous-ID suppression (:840-850) on tiles 1..n-2,
    // across the lanes: ids are not written here, so the live row is the
    // reference's snapshot, and no bool is read
    for (int i = 1 + r.lane; i < n - 1; i += 32)
      if (!adj(id[i], id[i + 1]) && !adj(id[i], id[i - 1])) bv[i] = 0;
  }
  trace(r, ids_tr, bools_tr, 7);
  // pass 10: short-run suppression <= 5 (:856-877); zeroing a run as its
  // closing edge is found equals collecting the runs first
  if (on) {
    close_runs(r, true, [&](int a, int e) {
      if (e - a + 1 <= 5)
        for (int j = a; j <= e; ++j) bv[j] = 0;
    });
  }
  trace(r, ids_tr, bools_tr, 8);
}

// (count, id) as one key whose max is count desc then id asc (ids compared
// as int32, as the reference does)
__device__ __forceinline__ unsigned long long top_key(int c, int32_t id) {
  return (static_cast<unsigned long long>(c) << 32) |
         (0xFFFFFFFFu - (static_cast<uint32_t>(id) ^ 0x80000000u));
}

__device__ __forceinline__ int32_t key_id(unsigned long long k) {
  return static_cast<int32_t>((0xFFFFFFFFu - static_cast<uint32_t>(k)) ^
                              0x80000000u);
}

__device__ __forceinline__ unsigned long long warp_max64(
    unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(kFull, v, o);
    v = x > v ? x : v;
  }
  return v;
}

// top-2 (count, id) of ids[lo, hi) by count desc then id asc: one lane per
// position counts its id over the window.  Every lane calls it.
struct Top2 { int c1, i1, c2, i2; };

__device__ inline Top2 flank_top2(const int32_t* id, int lo, int hi, int lane) {
  unsigned long long k1 = 0, k2 = 0;
  for (int p = lo + lane; p < hi; p += 32) {
    int c = 0;
    for (int q = lo; q < hi; ++q) c += id[q] == id[p];
    const unsigned long long k = top_key(c, id[p]);
    k1 = k > k1 ? k : k1;
  }
  k1 = warp_max64(k1);
  const int32_t i1 = k1 ? key_id(k1) : 0;
  for (int p = lo + lane; p < hi; p += 32) {
    if (id[p] == i1) continue;
    int c = 0;
    for (int q = lo; q < hi; ++q) c += id[q] == id[p];
    const unsigned long long k = top_key(c, id[p]);
    k2 = k > k2 ? k : k2;
  }
  k2 = warp_max64(k2);
  return Top2{static_cast<int>(k1 >> 32), i1, static_cast<int>(k2 >> 32),
              k2 ? key_id(k2) : 0};
}

// flank_top2 of a window of at most 32 tiles, a position a lane: each
// position's count is its __match_any_sync group's size, and the top two
// (count desc, then id asc as int32) come from a max and a min reduction
// each.  Every lane calls it.
__device__ inline Top2 flank_top2_lanes(const int32_t* id, int lo, int hi,
                                        int lane) {
  const int p = lo + lane;
  const bool has = p < hi;
  const int32_t v = has ? id[p] : 0;
  // a lane outside the window matches no other lane
  const unsigned long long key =
      has ? static_cast<unsigned long long>(static_cast<uint32_t>(v))
          : (1ull << 40) | static_cast<unsigned>(lane);
  const unsigned peers = __match_any_sync(kFull, key);
  const unsigned c = has ? __popc(peers) : 0u;
  const unsigned ord = static_cast<uint32_t>(v) ^ 0x80000000u;
  const unsigned c1 = __reduce_max_sync(kFull, c);
  const unsigned o1 =
      __reduce_min_sync(kFull, has && c == c1 ? ord : 0xFFFFFFFFu);
  const int32_t i1 = c1 ? static_cast<int32_t>(o1 ^ 0x80000000u) : 0;
  const unsigned c_2 = has && v != i1 ? c : 0u;
  const unsigned c2 = __reduce_max_sync(kFull, c_2);
  const unsigned o2 =
      __reduce_min_sync(kFull, c_2 && c_2 == c2 ? ord : 0xFFFFFFFFu);
  return Top2{static_cast<int>(c1), i1, static_cast<int>(c2),
              c2 ? static_cast<int32_t>(o2 ^ 0x80000000u) : 0};
}

__device__ __forceinline__ bool good_pair(const Top2& f) {
  // MIN_IDS_IN_FLANK = 2: one id twice, or two adjacent ids > 3 together
  return f.c1 >= 2 ||
         (f.c2 > 0 && f.c1 + f.c2 > 3 && (f.i1 == f.i2 + 1 || f.i2 == f.i1 + 1));
}

// The outcome of one read's classification.
struct Decision {
  int decision, trim_start, trim_end, num_assigned;
};

// One read of kernel C, run by all 32 lanes of one warp, every lane
// returning the outcome.  `curr_id` [T] and `cand_ids`/`cand_counts`
// [T, K] are the read's rows of the vote table; `base` is the warp's
// shared memory: the id and bool rows (T padded to even), then `buf`
// 8-byte entries shared by the candidate staging and pass 7's sort keys.
// The smoothed rows go to `ids`/`bools` [T] and the traces to
// `ids_tr`/`bools_tr` [9, T] where given.  In the fused consume kernel
// (kFused) the vote table, written by other CTAs of the launch, is read
// through L2; or its CTA has staged the whole table into shared memory
// first (kStaged: `curr_id` and the candidates point there, and the
// passes read them in place; with candidate_masks' `mcol` and `scol`, a
// read of at most 32 tiles runs passes 1-4 across the lanes).
template <bool kFused, bool kStaged = false>
__device__ Decision classify_read(const int32_t* curr_id,
                                  const int32_t* cand_ids,
                                  const int32_t* cand_counts, int n_tiles,
                                  int T, int K, int threshold, int u_min,
                                  int a_max, int buf, unsigned char* base,
                                  int lane, int32_t* ids, int32_t* bools,
                                  int32_t* ids_tr, int32_t* bools_tr,
                                  const uint32_t* mcol = nullptr,
                                  const uint32_t* scol = nullptr) {
  const int Tp = (T + 1) & ~1;
  int32_t* id = reinterpret_cast<int32_t*>(base);
  int32_t* bv = id + Tp;
  long long* keys = reinterpret_cast<long long*>(bv + Tp);
  const int CH = kStaged ? T : buf / K;
  int32_t* sci = kStaged ? const_cast<int32_t*>(cand_ids)
                         : reinterpret_cast<int32_t*>(keys);
  int32_t* scc = kStaged ? const_cast<int32_t*>(cand_counts) : sci + CH * K;
  // tile counts past the grid cannot occur on the engine's path (reads are
  // capped at the bucket); clamping keeps every access inside the rows
  const Read r{id, bv, cand_ids, cand_counts, sci, scc,
               min(max(n_tiles, 0), T), T, K, CH, lane, mcol, scol};
  const int n = r.n;
  // initial assignment: top candidate count over the threshold (:637)
  for (int t = lane; t < T; t += 32) {
    const bool in = t < n;
    const int32_t c0 =
        load_src<kFused, kStaged>(r.cc + static_cast<int64_t>(t) * K);
    id[t] = in ? load_src<kFused, kStaged>(curr_id + t) : 0;
    bv[t] = in && c0 > 0 && c0 > threshold;
  }
  trace(r, ids_tr, bools_tr, 0);
  smooth<kFused, kStaged>(r, threshold, keys, ids_tr, bools_tr);
  int na = 0;
  for (int t = lane; t < n; t += 32) na += bv[t];
  for (int o = 16; o > 0; o >>= 1) na += __shfl_xor_sync(kFull, na, o);

  // find_longest_stretch (:195-233), read-only, so every lane runs it;
  // the lanes' read (kStaged, at most 32 tiles) reads the bools from one
  // ballot's bits rather than shared memory
  const bool lanes = kStaged && mcol != nullptr && n <= 32;
  const unsigned bits = __ballot_sync(kFull, lanes && lane < n && bv[lane]);
  int start = 0, end = 0, ls = 0, le = 0, cur = 0, longest = 0;
  for (int i = 1; i < n - 1; ++i) {
    const int bi = lanes ? static_cast<int>(bits >> i & 1u) : bv[i];
    const int bp = lanes ? static_cast<int>(bits >> (i - 1) & 1u) : bv[i - 1];
    if (!bi && bp) {
      start = i;
      cur = 1;
    } else if (!bi && bi == bp && i + 1 != n - 1) {
      ++cur;
    } else if (bi && bi != bp) {
      end = i - 1;
      if (longest < cur) { longest = cur; ls = start; le = end; }
    } else if (i + 1 == n - 1 && end < start) {
      end = i;
      ++cur;
      if (longest < cur) { longest = cur; ls = start; le = end; }
    }
  }

  // eval_flanks (:341-527); the branches are warp-uniform.  A window
  // holds at most 14 tiles: the lanes' read takes flank_top2_lanes
  auto top2 = [&](int lo, int hi) {
    return lanes ? flank_top2_lanes(id, lo, hi, lane)
                 : flank_top2(id, lo, hi, lane);
  };
  int ts = ls != 0 ? ls - 1 : ls;
  int te = le + 1;
  bool good;
  if (n < 15) {
    const bool gl = ts == 0 || (ls > 0 && good_pair(top2(0, ls)));
    const bool gr_ =
        te == n - 1 || (n > le + 1 && good_pair(top2(le + 1, n)));
    good = gl && gr_;
  } else {
    good = false;
    if (ls - 5 >= 1) {
      good = good_pair(top2(ls - 5, ls));
    } else {
      good = true;
      ts = 0;
    }
    if (le + 5 < n - 1) {
      good = good_pair(top2(le + 1, le + 6)) || good;
    } else {
      good = true;
      te = n - 1;
    }
  }

  // decision (process_read :968-1081) and the rows
  if (ids != nullptr) {
    for (int t = lane; t < T; t += 32) {
      ids[t] = id[t];
      bools[t] = bv[t];
    }
  }
  const bool whole = n - na >= u_min && na <= a_max;
  const bool trimmed = !whole && na != n && good;
  return Decision{whole ? 1 : (trimmed ? 2 : 0), ts, te, na};
}

// A read's row: decision, trim start and end, tiles assigned, queries,
// hits, misses, overflow; and its minimum in-read top count.
struct Outcome {
  int64_t dec, ts, te, na, q, h, m, ov, tmin;
};

// Kernel C on one read's vote buffer, written by kernel B's tiles in the
// fused kernels (consume.cu, wavefront.cu) and read through L2, or staged
// by the CTA into shared memory first (kStaged), run by one warp: `sums`
// [3, T] per-tile queries, hits and misses; `vals` [3T + 2TK] curr_id,
// top_count, overflow [T] each, then the candidates' ids and counts
// [T, K].  Every lane gets the outcome.  `mcol`, `scol`: classify_read's.
template <bool kStaged = false>
__device__ inline Outcome read_outcome(const unsigned long long* sums,
                                       const int32_t* vals, int n_t, int T,
                                       int K, int threshold, int u_min,
                                       int a_max, int cbuf,
                                       unsigned char* base, int lane,
                                       const uint32_t* mcol = nullptr,
                                       const uint32_t* scol = nullptr) {
  const int32_t* top = vals + T;
  const int32_t* over = top + T;
  const int32_t* cid = over + T;
  const int32_t* ccnt = cid + T * K;
  const Decision d = classify_read<true, kStaged>(
      vals, cid, ccnt, n_t, T, K, threshold, u_min, a_max, cbuf, base, lane,
      nullptr, nullptr, nullptr, nullptr, mcol, scol);
  unsigned long long sq = 0, sh = 0, sm = 0;
  long long so = 0, tmin = kNoTile;
  for (int t = lane; t < T; t += 32) {
    sq += load_src<true, kStaged>(sums + t);
    sh += load_src<true, kStaged>(sums + T + t);
    sm += load_src<true, kStaged>(sums + 2 * T + t);
    so += load_src<true, kStaged>(over + t);
    if (t < n_t)
      tmin = min(tmin,
                 static_cast<long long>(load_src<true, kStaged>(top + t)));
  }
  for (int o = 16; o > 0; o >>= 1) {
    sq += __shfl_xor_sync(kFull, sq, o);
    sh += __shfl_xor_sync(kFull, sh, o);
    sm += __shfl_xor_sync(kFull, sm, o);
    so += __shfl_xor_sync(kFull, so, o);
    tmin = min(tmin, __shfl_xor_sync(kFull, tmin, o));
  }
  return Outcome{d.decision, d.trim_start, d.trim_end, d.num_assigned,
                 static_cast<int64_t>(sq), static_cast<int64_t>(sh),
                 static_cast<int64_t>(sm), so, tmin};
}

// The trim recheck's boundary-zone predicate (K18, the port's
// engine_util.recheck_zone), shared by the consume and wavefront kernels:
// every trim; a partial assignment with an unassigned stretch of at least
// 3 tiles or near the whole-read boundary; a full assignment whose weakest
// tile, in full-vote units, is within 2x of the assignment gate.
// tile_min * stride wraps in int32, as the JAX package computes it.
__host__ __device__ inline bool recheck_zone(int64_t dec, int64_t na,
                                             int64_t n_tiles, int64_t ts,
                                             int64_t te, int64_t tile_min,
                                             int stride, int threshold,
                                             int a_max) {
  const int32_t scaled = static_cast<int32_t>(
      static_cast<uint32_t>(tile_min) * static_cast<uint32_t>(stride));
  const bool weak = scaled < 2 * threshold;
  const int64_t stretch = te - ts - 1;
  const bool partial =
      na > 0 && na < n_tiles && (stretch >= 3 || na <= a_max + 2);
  return partial || dec == 2 || (na >= n_tiles && weak);
}

}  // namespace gr
