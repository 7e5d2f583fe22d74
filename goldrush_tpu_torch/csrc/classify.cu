// Kernel C: per-read tile classification and recruit decision.
//
// Replaces classify_batch (goldrush_tpu/path/classify.py:77-429).  The JAX
// version recasts the reference's order-dependent loops as lax.scans over
// the tile axis plus cummax interval painting, because a TPU wants [B]-wide
// vectors.  Here one thread per read runs the loops as the reference wrote
// them, transcribed in goldrush_tpu/path/oracle.py: the 8 smoothing passes
// (goldrush_path.cpp:628-888), find_longest_stretch (:195-233), eval_flanks
// (:341-527) and the decision (:943-1081).  Candidate lookups read the
// [B, T, K] top-K table of probe_and_vote.  With trace buffers the thread
// also writes the ids/bools after each of the 9 log_tile_states sites.
//
// Bound.  A few hundred integer operations per tile with no reuse across
// reads; at B = 32 and T = 20 the kernel is one partly filled warp, so it
// is launch-latency-bound.  The working ids/bools rows are the output rows
// themselves, and the gap-bridging pass sorts its (id, tile) keys in a
// per-read scratch row by heap sort (O(T log T), no shared memory).
#include "common.cuh"

namespace gr {

struct Read {
  int32_t* id;         // [T] working ids (the ids output row)
  int32_t* bv;         // [T] working bools (the bools output row)
  const int32_t* ci;   // [T, K] candidate ids
  const int32_t* cc;   // [T, K] candidate counts
  int n, T, K;
};

__device__ __forceinline__ bool adj(int32_t a, int32_t b) {
  // a == b, a == b + 1 or a == b - 1 (b - 1 unreachable for b == 0)
  return a == b || a == b + 1 || (b != 0 && a == b - 1);
}

__device__ void trace(const Read& r, int32_t* ids_tr, int32_t* bools_tr,
                      int pass) {
  if (ids_tr == nullptr) return;
  for (int t = 0; t < r.T; ++t) {
    ids_tr[pass * r.T + t] = r.id[t];
    bools_tr[pass * r.T + t] = r.bv[t];
  }
}

// pass 1/2 step: tile i takes prev_id when its candidate table holds it
__device__ void reconcile(const Read& r, int i, int32_t prev, int threshold) {
  if (r.id[i] == prev) return;
  for (int k = 0; k < r.K; ++k) {
    const int32_t c = r.cc[i * r.K + k];
    if (c > 0 && r.ci[i * r.K + k] == prev) {
      r.id[i] = prev;
      r.bv[i] = c > threshold;
    }
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

__device__ void heap_sort(int64_t* a, int m) {
  for (int start = m / 2 - 1, end = m;;) {
    int root;
    if (start >= 0) {
      root = start--;
    } else {
      if (--end <= 0) return;
      const int64_t x = a[0]; a[0] = a[end]; a[end] = x;
      root = 0;
    }
    for (int child; (child = 2 * root + 1) < end; root = child) {
      if (child + 1 < end && a[child + 1] > a[child]) ++child;
      if (a[root] >= a[child]) break;
      const int64_t x = a[root]; a[root] = a[child]; a[child] = x;
    }
  }
}

__device__ void smooth(const Read& r, int threshold, int64_t* scratch,
                       int32_t* ids_tr, int32_t* bools_tr) {
  const int n = r.n;
  int32_t* id = r.id;
  int32_t* bv = r.bv;
  const bool on = n >= 3;
  // pass 1: forward ID reconciliation (:646-661)
  if (on) for (int i = 1; i < n; ++i) reconcile(r, i, id[i - 1], threshold);
  trace(r, ids_tr, bools_tr, 1);
  // pass 2: backward (:667-682)
  if (on) for (int i = n - 2; i >= 0; --i) reconcile(r, i, id[i + 1], threshold);
  trace(r, ids_tr, bools_tr, 2);
  // pass 3/4: neighbour fill forward then backward (:688-734)
  if (on) {
    for (int i = 1; i < n - 1; ++i) neighbor_fill(r, i);
    for (int i = n - 2; i > 0; --i) neighbor_fill(r, i);
  }
  trace(r, ids_tr, bools_tr, 3);
  // pass 5: hole fill between compatible flanks (:739-766).  The holes are
  // disjoint and each fill only touches its own hole, so filling each hole
  // as its closing edge is found equals collecting them all first.
  if (on) {
    int start = 0;
    for (int i = 1; i < n - 1; ++i) {
      if (!bv[i] && bv[i - 1]) {
        start = i;
      } else if (bv[i] && !bv[i - 1]) {
        const int a = start, e = i - 1;
        if (a == 0 || e == n - 1) continue;
        const int32_t left = id[a - 1], right = id[e + 1];
        if (adj(left, right))
          for (int j = a; j <= e; ++j) { bv[j] = 1; id[j] = left; }
      }
    }
  }
  trace(r, ids_tr, bools_tr, 4);
  // pass 6: lone-tile suppression forward then backward (:771-792)
  if (on) {
    for (int i = 2; i < n - 2; ++i)
      if (bv[i] && !bv[i - 1] && !bv[i + 1]) bv[i] = 0;
    for (int i = n - 3; i > 1; --i)
      if (bv[i] && !bv[i - 1] && !bv[i + 1]) bv[i] = 0;
  }
  trace(r, ids_tr, bools_tr, 5);
  // pass 7: gap bridging by ID in ascending-ID order (:799-822); the
  // member lists come from the assignment before any bridging, the id
  // carried into a gap is re-read from the live ids
  if (on) {
    int m = 0;
    for (int i = 0; i < n; ++i)
      if (bv[i]) scratch[m++] = (static_cast<int64_t>(id[i]) << 32) | i;
    heap_sort(scratch, m);
    for (int e = 1; e < m; ++e) {
      if ((scratch[e] >> 32) != (scratch[e - 1] >> 32)) continue;
      const int prev_idx = static_cast<int>(scratch[e - 1] & 0xFFFFFFFF);
      const int curr_idx = static_cast<int>(scratch[e] & 0xFFFFFFFF);
      if (curr_idx > prev_idx + 1) {
        const int32_t pid = id[prev_idx];
        for (int j = prev_idx + 1; j <= curr_idx; ++j) id[j] = pid;
      }
    }
  }
  trace(r, ids_tr, bools_tr, 6);
  if (on) {
    // pass 8: end-tile fix (:827-838)
    if (adj(id[n - 1], id[n - 2])) bv[n - 1] = 1;
    if (adj(id[0], id[1])) bv[0] = 1;
    // pass 9: non-contiguous-ID suppression (:840-850); ids are not
    // written here, so the live row is the reference's snapshot
    for (int i = 1; i < n - 1; ++i)
      if (!adj(id[i], id[i + 1]) && !adj(id[i], id[i - 1])) bv[i] = 0;
  }
  trace(r, ids_tr, bools_tr, 7);
  // pass 10: short-run suppression <= 5 (:856-877); zeroing a run as its
  // closing edge is found equals collecting the runs first
  if (on) {
    int start = 0;
    for (int i = 1; i < n - 1; ++i) {
      if (bv[i] && !bv[i - 1]) {
        start = i;
      } else if (!bv[i] && bv[i - 1]) {
        if (i - 1 - start + 1 <= 5)
          for (int j = start; j <= i - 1; ++j) bv[j] = 0;
      }
    }
  }
  trace(r, ids_tr, bools_tr, 8);
}

// top-2 (count, id) of ids[lo, hi) by count desc then id asc
struct Top2 { int c1, i1, c2, i2; };

__device__ Top2 flank_top2(const int32_t* id, int lo, int hi) {
  Top2 r{0, 0, 0, 0};
  for (int p = lo; p < hi; ++p) {
    int c = 0;
    for (int q = lo; q < hi; ++q) c += id[q] == id[p];
    if (c > r.c1 || (c == r.c1 && id[p] < r.i1)) { r.c1 = c; r.i1 = id[p]; }
  }
  for (int p = lo; p < hi; ++p) {
    if (id[p] == r.i1) continue;
    int c = 0;
    for (int q = lo; q < hi; ++q) c += id[q] == id[p];
    if (c > r.c2 || (c == r.c2 && id[p] < r.i2)) { r.c2 = c; r.i2 = id[p]; }
  }
  return r;
}

__device__ __forceinline__ bool good_pair(const Top2& f) {
  // MIN_IDS_IN_FLANK = 2: one id twice, or two adjacent ids > 3 together
  return f.c1 >= 2 ||
         (f.c2 > 0 && f.c1 + f.c2 > 3 && (f.i1 == f.i2 + 1 || f.i2 == f.i1 + 1));
}

__global__ void classify_kernel(
    const int32_t* __restrict__ curr_id, const int32_t* __restrict__ cand_ids,
    const int32_t* __restrict__ cand_counts, const int32_t* __restrict__ n_tiles,
    int B, int T, int K, int threshold, int u_min, int a_max,
    int32_t* __restrict__ decision, int32_t* __restrict__ trim_start,
    int32_t* __restrict__ trim_end, int32_t* __restrict__ num_assigned,
    int32_t* __restrict__ ids, int32_t* __restrict__ bools,
    int64_t* __restrict__ scratch, int32_t* __restrict__ ids_trace,
    int32_t* __restrict__ bools_trace) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t row = static_cast<int64_t>(b) * T;
  // tile counts past the grid cannot occur on the engine's path (reads are
  // capped at the bucket); clamping keeps every access inside the rows
  const Read r{ids + row, bools + row, cand_ids + row * K,
               cand_counts + row * K, min(max(n_tiles[b], 0), T), T, K};
  const int n = r.n;
  int32_t* ids_tr = ids_trace ? ids_trace + row * 9 : nullptr;
  int32_t* bools_tr = bools_trace ? bools_trace + row * 9 : nullptr;
  // initial assignment: top candidate count over the threshold (:637)
  for (int t = 0; t < T; ++t) {
    const bool in = t < n;
    const int32_t c0 = r.cc[t * K];
    r.id[t] = in ? curr_id[row + t] : 0;
    r.bv[t] = in && c0 > 0 && c0 > threshold;
  }
  trace(r, ids_tr, bools_tr, 0);
  smooth(r, threshold, scratch + row, ids_tr, bools_tr);
  int na = 0;
  for (int t = 0; t < n; ++t) na += r.bv[t];

  // find_longest_stretch (:195-233)
  int start = 0, end = 0, ls = 0, le = 0, cur = 0, longest = 0;
  for (int i = 1; i < n - 1; ++i) {
    const int bi = r.bv[i], bp = r.bv[i - 1];
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

  // eval_flanks (:341-527)
  int ts = ls != 0 ? ls - 1 : ls;
  int te = le + 1;
  bool good;
  if (n < 15) {
    const bool gl = (ls > 0 && good_pair(flank_top2(r.id, 0, ls))) || ts == 0;
    const bool gr_ = (n > le + 1 && good_pair(flank_top2(r.id, le + 1, n))) ||
                     te == n - 1;
    good = gl && gr_;
  } else {
    good = false;
    if (ls - 5 >= 1) {
      good = good_pair(flank_top2(r.id, ls - 5, ls));
    } else {
      good = true;
      ts = 0;
    }
    if (le + 5 < n - 1) {
      good = good || good_pair(flank_top2(r.id, le + 1, le + 6));
    } else {
      good = true;
      te = n - 1;
    }
  }

  // decision (process_read :968-1081)
  const bool whole = n - na >= u_min && na <= a_max;
  const bool trimmed = !whole && na != n && good;
  decision[b] = whole ? 1 : (trimmed ? 2 : 0);
  trim_start[b] = ts;
  trim_end[b] = te;
  num_assigned[b] = na;
}

}  // namespace gr

extern "C" int gr_classify(
    const int32_t* curr_id, const int32_t* cand_ids, const int32_t* cand_counts,
    const int32_t* n_tiles, int B, int T, int K, int threshold, int u_min,
    int a_max, int32_t* decision, int32_t* trim_start, int32_t* trim_end,
    int32_t* num_assigned, int32_t* ids, int32_t* bools, int64_t* scratch,
    int32_t* ids_trace, int32_t* bools_trace, cudaStream_t stream) {
  if (B == 0) return gr::kNoLaunch;
  const int threads = 32;
  gr::classify_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      curr_id, cand_ids, cand_counts, n_tiles, B, T, K, threshold, u_min,
      a_max, decision, trim_start, trim_end, num_assigned, ids, bools,
      scratch, ids_trace, bools_trace);
  return cudaGetLastError();
}
