// Kernel C: per-read tile classification and recruit decision.
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
// Several reads share a CTA (one warp each), a single read runs one warp.
// gr_row_cummax launches the warp cummax alone on [R, T] rows, so that it
// can be held against torch.cummax.
//
// Bound.  Bytes: the read's T curr_ids, T*K candidate ids and counts and
// ~8*T bytes of outputs (~5.4 KB per read at T = 20, K = 32: 0.17 MB at
// B = 32, ~0.05 us).  The passes are a few hundred dependent
// shared-memory steps per read, so a launch is latency-bound: one chunk
// load from L2 or DRAM, then the sequential scans.
#include <climits>

#include "common.cuh"

namespace gr {

// reads (one warp each) per CTA
constexpr int kWarps = 4;
// the most dynamic shared memory one block may use on Hopper
constexpr size_t kMaxSmem = 232448;

extern __shared__ __align__(16) unsigned char gr_smem[];

struct Read {
  int32_t* id;         // [T] working ids (shared memory)
  int32_t* bv;         // [T] working bools (shared memory)
  const int32_t* ci;   // [T, K] candidate ids (global)
  const int32_t* cc;   // [T, K] candidate counts (global)
  int32_t* sci;        // [CH, K] staged candidate ids (shared memory)
  int32_t* scc;        // [CH, K] staged candidate counts
  int n, T, K, CH, lane;
};

__device__ __forceinline__ bool adj(int32_t a, int32_t b) {
  // a == b, a == b + 1 or a == b - 1 (b - 1 unreachable for b == 0)
  return a == b || a == b + 1 || (b != 0 && a == b - 1);
}

// the rows as the reference logs them after a pass; every lane calls it,
// and lane 0's next pass starts after the whole copy
__device__ void trace(const Read& r, int32_t* ids_tr, int32_t* bools_tr,
                      int pass) {
  __syncwarp();
  if (ids_tr == nullptr) return;
  for (int t = r.lane; t < r.T; t += 32) {
    ids_tr[pass * r.T + t] = r.id[t];
    bools_tr[pass * r.T + t] = r.bv[t];
  }
  __syncwarp();
}

// stage the candidates of tiles [lo, hi) into shared memory
__device__ void stage(const Read& r, int lo, int hi) {
  __syncwarp();
  const int m = (hi - lo) * r.K;
  const int64_t off = static_cast<int64_t>(lo) * r.K;
  for (int j = r.lane; j < m; j += 32) {
    r.sci[j] = r.ci[off + j];
    r.scc[j] = r.cc[off + j];
  }
  __syncwarp();
}

// pass 1/2 step: tile i takes prev when its candidate table holds it, with
// the count of the last matching candidate (staged from tile lo).  Every
// lane calls it and gets the tile's new id; lane 0 writes the rows.
__device__ int32_t reconcile(const Read& r, int i, int lo, int32_t prev,
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
      stage(r, lo, hi);
    }
    prev = reconcile(r, i, lo, prev, threshold);
  }
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
__device__ void neighbor_fill(const Read& r, int i) {
  if (r.bv[i]) return;
  const int32_t ci = r.id[i], pi = r.id[i - 1], ni = r.id[i + 1];
  const int32_t pa = r.bv[i - 1], na = r.bv[i + 1];
  if ((ci == pi && pa) || (ci == ni && na)) {
    r.bv[i] = 1;
  } else if ((ci == pi + 1 && pa) || (ci == ni + 1 && na)) {
    r.bv[i] = 1;
  } else if ((pi && ci == pi - 1 && pa) || (ni && ci == ni - 1 && na)) {
    r.bv[i] = 1;
  } else if (pi == ni && pa && na) {
    r.bv[i] = pa;
    r.id[i] = pi;
  }
}

// ascending bitonic sort of a[0, m) by one warp, padded to a power of two:
// up to 32 keys in registers (one per lane, by shuffles), more in shared
// memory
__device__ void warp_bitonic_sort(long long* a, int m, int lane) {
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
  if (on) {
    hi = min(n, r.CH);
    stage(r, lo, hi);
    reconcile_pass(r, false, threshold, lo, hi);
  }
  trace(r, ids_tr, bools_tr, 1);
  if (on) reconcile_pass(r, true, threshold, lo, hi);
  trace(r, ids_tr, bools_tr, 2);
  // pass 3/4: neighbour fill forward then backward (:688-734)
  if (on && lead) {
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

__device__ Top2 flank_top2(const int32_t* id, int lo, int hi, int lane) {
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

__device__ __forceinline__ bool good_pair(const Top2& f) {
  // MIN_IDS_IN_FLANK = 2: one id twice, or two adjacent ids > 3 together
  return f.c1 >= 2 ||
         (f.c2 > 0 && f.c1 + f.c2 > 3 && (f.i1 == f.i2 + 1 || f.i2 == f.i1 + 1));
}

__global__ void classify_kernel(
    const int32_t* __restrict__ curr_id, const int32_t* __restrict__ cand_ids,
    const int32_t* __restrict__ cand_counts, const int32_t* __restrict__ n_tiles,
    int B, int T, int K, int threshold, int u_min, int a_max, int buf,
    int32_t* __restrict__ decision, int32_t* __restrict__ trim_start,
    int32_t* __restrict__ trim_end, int32_t* __restrict__ num_assigned,
    int32_t* __restrict__ ids, int32_t* __restrict__ bools,
    int32_t* __restrict__ ids_trace, int32_t* __restrict__ bools_trace) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  // per warp: the id and bool rows (T padded to even), then `buf` 8-byte
  // entries shared by the candidate staging and pass 7's sort keys
  const int Tp = (T + 1) & ~1;
  unsigned char* base =
      gr_smem + static_cast<size_t>(warp) * (8 * static_cast<size_t>(Tp) +
                                             8 * static_cast<size_t>(buf));
  int32_t* id = reinterpret_cast<int32_t*>(base);
  int32_t* bv = id + Tp;
  long long* keys = reinterpret_cast<long long*>(bv + Tp);
  const int64_t row = static_cast<int64_t>(b) * T;
  const int CH = buf / K;
  // tile counts past the grid cannot occur on the engine's path (reads are
  // capped at the bucket); clamping keeps every access inside the rows
  const Read r{id, bv, cand_ids + row * K, cand_counts + row * K,
               reinterpret_cast<int32_t*>(keys),
               reinterpret_cast<int32_t*>(keys) + CH * K,
               min(max(n_tiles[b], 0), T), T, K, CH, lane};
  const int n = r.n;
  int32_t* ids_tr = ids_trace ? ids_trace + row * 9 : nullptr;
  int32_t* bools_tr = bools_trace ? bools_trace + row * 9 : nullptr;
  // initial assignment: top candidate count over the threshold (:637)
  for (int t = lane; t < T; t += 32) {
    const bool in = t < n;
    const int32_t c0 = r.cc[static_cast<int64_t>(t) * K];
    id[t] = in ? curr_id[row + t] : 0;
    bv[t] = in && c0 > 0 && c0 > threshold;
  }
  trace(r, ids_tr, bools_tr, 0);
  smooth(r, threshold, keys, ids_tr, bools_tr);
  int na = 0;
  for (int t = lane; t < n; t += 32) na += bv[t];
  for (int o = 16; o > 0; o >>= 1) na += __shfl_xor_sync(kFull, na, o);

  // find_longest_stretch (:195-233), read-only, so every lane runs it
  int start = 0, end = 0, ls = 0, le = 0, cur = 0, longest = 0;
  for (int i = 1; i < n - 1; ++i) {
    const int bi = bv[i], bp = bv[i - 1];
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

  // eval_flanks (:341-527); the branches are warp-uniform
  int ts = ls != 0 ? ls - 1 : ls;
  int te = le + 1;
  bool good;
  if (n < 15) {
    const bool gl =
        ts == 0 || (ls > 0 && good_pair(flank_top2(id, 0, ls, lane)));
    const bool gr_ =
        te == n - 1 ||
        (n > le + 1 && good_pair(flank_top2(id, le + 1, n, lane)));
    good = gl && gr_;
  } else {
    good = false;
    if (ls - 5 >= 1) {
      good = good_pair(flank_top2(id, ls - 5, ls, lane));
    } else {
      good = true;
      ts = 0;
    }
    if (le + 5 < n - 1) {
      good = good_pair(flank_top2(id, le + 1, le + 6, lane)) || good;
    } else {
      good = true;
      te = n - 1;
    }
  }

  // decision (process_read :968-1081) and the rows
  for (int t = lane; t < T; t += 32) {
    ids[row + t] = id[t];
    bools[row + t] = bv[t];
  }
  if (lane == 0) {
    const bool whole = n - na >= u_min && na <= a_max;
    const bool trimmed = !whole && na != n && good;
    decision[b] = whole ? 1 : (trimmed ? 2 : 0);
    trim_start[b] = ts;
    trim_end[b] = te;
    num_assigned[b] = na;
  }
}

__global__ void row_cummax_kernel(const int32_t* __restrict__ x, int R,
                                  int T, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp
  const int64_t off = static_cast<int64_t>(row) * T;
  int carry = INT_MIN;
  for (int base = 0; base < T; base += 32) {
    const int t = base + lane;
    const int m = warp_cummax(t < T ? x[off + t] : INT_MIN, carry, lane);
    if (t < T) out[off + t] = m;
    carry = __shfl_sync(kFull, m, 31);
  }
}

}  // namespace gr

extern "C" int gr_classify(
    const int32_t* curr_id, const int32_t* cand_ids, const int32_t* cand_counts,
    const int32_t* n_tiles, int B, int T, int K, int threshold, int u_min,
    int a_max, int32_t* decision, int32_t* trim_start, int32_t* trim_end,
    int32_t* num_assigned, int32_t* ids, int32_t* bools, int32_t* ids_trace,
    int32_t* bools_trace, cudaStream_t stream) {
  // per warp (one read): the id and bool rows, and a buffer of 8-byte
  // entries that stages the candidates of up to 32 tiles at a time, then
  // holds pass 7's sort keys (up to next_pow2(T))
  int t2 = 1;
  while (t2 < T) t2 <<= 1;
  const int chunk = (T < 32 ? T : 32) * K;
  const int buf = t2 > chunk ? t2 : chunk;
  const size_t per_warp = 8 * static_cast<size_t>(((T + 1) & ~1) + buf);
  if (K < 1 || T < 0 || B < 0 || per_warp > gr::kMaxSmem)
    return cudaErrorInvalidValue;
  if (B == 0) return gr::kNoLaunch;
  int warps = B < gr::kWarps ? B : gr::kWarps;
  while (warps * per_warp > gr::kMaxSmem) --warps;
  const size_t smem = warps * per_warp;
  cudaError_t err = gr::allow_smem(gr::classify_kernel, smem);
  if (err != cudaSuccess) return err;
  gr::classify_kernel<<<(B + warps - 1) / warps, 32 * warps, smem, stream>>>(
      curr_id, cand_ids, cand_counts, n_tiles, B, T, K, threshold, u_min,
      a_max, buf, decision, trim_start, trim_end, num_assigned, ids, bools,
      ids_trace, bools_trace);
  return cudaGetLastError();
}

extern "C" int gr_row_cummax(const int32_t* x, int R, int T, int32_t* out,
                             cudaStream_t stream) {
  if (R < 0 || T < 0) return cudaErrorInvalidValue;
  if (R == 0 || T == 0) return gr::kNoLaunch;
  gr::row_cummax_kernel<<<(R + gr::kWarps - 1) / gr::kWarps, 32 * gr::kWarps,
                          0, stream>>>(x, R, T, out);
  return cudaGetLastError();
}
