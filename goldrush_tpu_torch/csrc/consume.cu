// gr_consume (K9): the in-order consume scan of one batch as one
// cooperative launch, with the trim recheck's zone predicate (K18) and the
// silver rotation's reset (K10/K19) inside it.
//
// Replaces the lax.scan body of the JAX engine's per-batch `consume`
// (goldrush_tpu/path/engine.py:892-1024), recheck_zone
// (goldrush_tpu/path/engine_util.py:10) and reset_ids
// (goldrush_tpu/mibf/mibf.py:686, goldrush_tpu/mibf/compressed.py:559).
// The batch's reads were probed and classified together against the filter
// at batch start (kernels B and C, `rows0`); the scan then takes them in
// order: a read whose verdict may have gone stale re-probes the live filter
// (exact policy: every read after an in-batch change; optimistic policy:
// candidates after a change, and every read after a silver reset), a read
// in the trim recheck's boundary zone re-classifies at full resolution, a
// recruit inserts its blocks (kernel D's reservoir rule, or insert_max
// under the optimistic policy), and a silver path that fills up rotates:
// the filter forgets its ids (and, under the exact policy, its counters).
//
// Design.  A persistent grid of one CTA per SM, launched cooperatively so
// that every CTA is resident and grid barriers are legal:
//   - every CTA walks reads 0..B-1 and keeps the scan's scalars (ids
//     inserted, bases inserted, path index, done, changed, reset seen)
//     itself, computed identically from the same global inputs, so a read
//     that neither probes nor inserts costs no barrier;
//   - a probe (live or recheck) runs kernel B's tile code on tiles
//     blockIdx.x, blockIdx.x + gridDim.x, ... into one of two vote buffers
//     in global memory, then crosses a grid barrier; warp 0 of every CTA
//     then runs kernel C's read code on the buffer, so every CTA has the
//     decision without a second barrier.  Successive probes alternate
//     buffers: a probe's readers have all passed the next probe's barrier
//     before the probe after it writes the same buffer;
//   - an insert under the exact policy is kernel D with its key partition
//     over the CTAs of this grid and no thread-block clusters: each CTA
//     streams the recruit's whole window from L2 and keeps the keys it
//     owns (an overflowing CTA spills into global scratch, whose two
//     allocation counters alternate between inserts so that one can be
//     cleared while the other is in use); under the optimistic policy it
//     is insert_max's atomicMax over a grid-stride loop;
//   - a rotation clears the table (and the counters) in a grid-stride loop;
//   - an insert or a reset leaves the filter dirty: the next probe, insert
//     or reset first crosses a grid barrier;
//   - L1 is not coherent across SMs, so all memory that another CTA of the
//     launch may write (the filter, the vote buffers) is read through L2.
// One CTA per SM, not as many as occupancy allows: each CTA of an exact
// insert streams the whole window, so more CTAs read more, and a grid
// barrier costs more with more CTAs.
//
// Bound.  The bytes a batch must move: per probe its grid row (H * T * F
// int64 entries), frame_ok and one 4-byte word per present frame and seed;
// per insert its window and each distinct key's word and counter; per
// reset the table (and counters) read and written.  At the exact shape a
// live probe is ~0.7 MB, ~0.2 us at 3.35 TB/s; its cost is latency: B's
// gather, a grid barrier and C's sequential passes, one after another.
#include <cooperative_groups.h>

#include <algorithm>
#include <initializer_list>

#include "classify.cuh"
#include "insert.cuh"
#include "probe_vote.cuh"

namespace cg = cooperative_groups;

namespace gr {

// The zone predicate (K18) is recheck_zone in classify.cuh.
struct ConsumeArgs {
  // the filter: the direct words or the rank-indexed ids, and counters,
  // `alloc` entries each
  uint32_t* table;
  uint32_t* counts;
  int64_t alloc;
  int ranked;            // the table is rank-indexed (compressed filter)
  int64_t probe_limit;   // B's sentinel rank (ranked)
  int64_t ins_limit;     // keys below it are real (inserts)
  uint32_t or_bits;      // an inserted entry's bits beside its id
  // the batch: the query grid [B, Hq, T*Fq], the full-resolution insert
  // grid [B, Hi, T*Fi], each with frame_ok
  const int64_t* grid_q;
  const bool* ok_q;
  const int64_t* grid_i;
  const bool* ok_i;
  const int32_t* n_tiles;     // [B]
  const int64_t* full_len;    // [B]
  const int64_t* rows0;       // [B, rows0_cols], the batched verdicts
  int rows0_cols;
  int B, T, K, Hq, Fq, Hi, Fi;
  int vote_min_q, x_q, bits_q;  // the query tier's gates and vote table
  int vote_min_f, x_f, bits_f;  // the recheck's (x_f = cfg.threshold)
  int u_min, a_max, TL, bs, S, cbuf, cap;
  int fast, rech_on, silver;
  int64_t target, max_paths;
  // carried across batches; outputs
  int64_t* scal;       // [4] ids inserted, bases inserted, path index, done
  int64_t* rows;       // [B, 8]
  int64_t* counters;   // [4] live probes, rechecks, inserts, resets
  // scratch: two vote buffers, kernel D's spill (two counters, then data)
  unsigned long long* sums;   // [2, 3, T] per-tile queries, hits, misses
  int32_t* vals;              // [2, 3T + 2TK] curr, top, overflow, cands
  bool* binit;                // [2, T]
  unsigned long long* spill;  // [2 + 2 * Hi * T * Fi] or null
};

// A probe tier: its grid, frame_ok and gates.
struct Tier {
  const int64_t* grid;
  const bool* ok;
  int H, F, vote_min, threshold, bits;
};

// Probe read i against the live filter with `tier` and classify it; the
// k-th probe of the launch uses vote buffer k & 1.  Every thread of every
// CTA calls it and gets the outcome.
__device__ Outcome probe_read(const ConsumeArgs& a, const Tier& tier, int i,
                              int k, int n_t, cg::grid_group& grid,
                              Outcome* sh) {
  const int T = a.T, K = a.K;
  const int64_t TF = static_cast<int64_t>(T) * tier.F;
  unsigned long long* q = a.sums + (k & 1) * 3 * T;
  int32_t* curr = a.vals + (k & 1) * (3 * T + 2 * T * K);
  int32_t* top = curr + T;
  int32_t* over = top + T;
  int32_t* cid = over + T;
  int32_t* ccnt = cid + T * K;
  const int64_t* g = tier.grid + static_cast<int64_t>(i) * tier.H * TF;
  const bool* ok = tier.ok + static_cast<int64_t>(i) * TF;
  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    probe_vote_tile<true>(a.table, g, a.ranked, a.probe_limit, ok, tier.H, T,
                          tier.F, K, tier.vote_min, tier.threshold, tier.bits,
                          t, 0, curr, top, cid, ccnt, a.binit + (k & 1) * T,
                          over, q, q + T, q + 2 * T);
    __syncthreads();
  }
  grid.sync();
  if (threadIdx.x < 32) {
    const Outcome o = read_outcome(q, curr, n_t, T, K, tier.threshold,
                                   a.u_min, a.a_max, a.cbuf, gr_smem,
                                   threadIdx.x);
    if (threadIdx.x == 0) *sh = o;
  }
  __syncthreads();
  return *sh;
}

// Insert read i's tiles lo..hi (ids from `base`) from its full-resolution
// grid row; the k-th insert of the launch spills through counter k & 1.
// Every thread of every CTA calls it.
__device__ void insert_read(const ConsumeArgs& a, int i, int lo, int hi,
                            uint32_t base, bool trimmed, int k) {
  __shared__ int fill;
  const int T = a.T, F = a.Fi, H = a.Hi;
  const int64_t TF = static_cast<int64_t>(T) * F;
  const int64_t* g = a.grid_i + static_cast<int64_t>(i) * H * TF;
  const int last = min(hi, T - 1);
  if (a.fast) {
    if (last < lo) return;
    const int64_t window = static_cast<int64_t>(last - lo + 1) * F;
    const int64_t total = window * H;
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x)
      insert_max_entry(reinterpret_cast<int*>(a.table), g, TF, F,
                       a.ins_limit, a.or_bits, lo, window, e, base, trimmed,
                       a.bs);
    return;
  }
  // the other counter's insert is over (a grid barrier lies between)
  if (threadIdx.x == 0 && blockIdx.x == 0) a.spill[(k + 1) & 1] = 0;
  insert_window<true>(a.table, a.counts, g, H, TF, F, a.ins_limit, a.or_bits,
                      lo, max(0, last - lo + 1) * F, base, trimmed, a.bs,
                      reinterpret_cast<uint64_t*>(gr_smem), a.cap, &fill,
                      a.spill + (k & 1),
                      reinterpret_cast<uint64_t*>(a.spill + 2));
}

// The silver rotation's reset, over the whole grid: forget every id, keep
// presence; under the exact policy zero the counters too.
__device__ void reset_filter(const ConsumeArgs& a) {
  int4* w = reinterpret_cast<int4*>(a.table);
  int4* c = reinterpret_cast<int4*>(a.counts);
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
    if (!a.fast) c[j] = zero;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
consume_kernel(const ConsumeArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Outcome sh;
  const Tier tq{a.grid_q, a.ok_q, a.Hq, a.Fq, a.vote_min_q, a.x_q, a.bits_q};
  const Tier tf{a.grid_i, a.ok_i, a.Hi, a.Fi, a.vote_min_f, a.x_f, a.bits_f};
  int64_t ids_ins = a.scal[0], ins_bases = a.scal[1];
  int64_t path_idx = a.scal[2], done = a.scal[3];
  bool changed = false, reset_seen = false, dirty = false;
  int probes = 0, inserts = 0;
  int64_t n_live = 0, n_rech = 0, n_ins = 0, n_reset = 0;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  for (int i = 0; i < a.B; ++i) {
    const int64_t* r0 = a.rows0 + static_cast<int64_t>(i) * a.rows0_cols;
    Outcome o{r0[0], r0[1], r0[2], r0[3], r0[4], r0[5], r0[6], r0[7],
              a.rech_on ? r0[8] : 0};
    const int n_t = a.n_tiles[i];
    const int64_t L = a.full_len[i];
    // exact: every read after an in-batch change re-probes; optimistic: a
    // batch-time drop stays dropped, and after an in-batch silver reset
    // every later read re-probes
    const bool live =
        (a.fast ? (changed && o.dec != 0) || reset_seen : changed) && !done;
    if (live) {
      if (dirty) grid.sync();
      o = probe_read(a, tq, i, probes++, n_t, grid, &sh);
      dirty = false;
      ++n_live;
    }
    if (a.rech_on && !done &&
        recheck_zone(o.dec, o.na, n_t, o.ts, o.te, o.tmin, a.S, a.x_f,
                     a.a_max)) {
      // boundary zone: re-classify at full resolution, every insert
      // seed, the exact gates
      if (dirty) grid.sync();
      o = probe_read(a, tf, i, probes++, n_t, grid, &sh);
      dirty = false;
      ++n_rech;
    }
    if (done) o.dec = 0;
    int64_t rec_len = 0, blocks = 0;
    int lo = 1, hi = 0;
    if (o.dec == 1) {
      rec_len = L;
      lo = 0;
      hi = n_t - 1;
      blocks = 1 + L / (static_cast<int64_t>(a.TL) * a.bs);
    } else if (o.dec == 2) {
      rec_len = o.te == n_t - 1 ? L - o.ts * a.TL : (o.te - o.ts + 1) * a.TL;
      lo = static_cast<int>(o.ts);
      hi = static_cast<int>(o.te);
      const int64_t d = o.te - o.ts;  // floor division, as Python's
      blocks = 1 + (d >= 0 ? d / a.bs : -((-d + a.bs - 1) / a.bs));
    }
    if (o.dec > 0 && !done) {
      if (dirty) grid.sync();
      insert_read(a, i, lo, hi, static_cast<uint32_t>(ids_ins + 1),
                  o.dec == 2, inserts++);
      dirty = true;
      ++n_ins;
    }
    if (!done) {
      ids_ins += blocks;
      ins_bases += rec_len;
    }
    // silver rotation (goldrush_path.cpp:156-187)
    if (a.silver && o.dec > 0 && a.target < ins_bases && !done) {
      ++path_idx;
      if (a.max_paths < path_idx) {
        done = 1;
      } else {
        if (dirty) grid.sync();
        reset_filter(a);
        dirty = true;
        ids_ins = ins_bases = 0;
        reset_seen = true;
        ++n_reset;
      }
    }
    changed = changed || o.dec > 0;
    if (lead) {
      int64_t* row = a.rows + static_cast<int64_t>(i) * 8;
      row[0] = o.dec;
      row[1] = o.ts;
      row[2] = o.te;
      row[3] = o.na;
      row[4] = o.q;
      row[5] = o.h;
      row[6] = o.m;
      row[7] = o.ov;
    }
  }
  // every CTA read scal before it is overwritten
  grid.sync();
  if (lead) {
    a.scal[0] = ids_ins;
    a.scal[1] = ins_bases;
    a.scal[2] = path_idx;
    a.scal[3] = done;
    a.counters[0] += n_live;
    a.counters[1] += n_rech;
    a.counters[2] += n_ins;
    a.counters[3] += n_reset;
  }
}

// K18 alone over n reads, for holding it against the port's plain
// predicate: rows [n, 6] = (dec, na, n_tiles, ts, te, tile_min).
__global__ void recheck_zone_kernel(const int64_t* __restrict__ rows, int n,
                                    int stride, int threshold, int a_max,
                                    bool* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t* r = rows + static_cast<int64_t>(i) * 6;
  out[i] = recheck_zone(r[0], r[1], r[2], r[3], r[4], r[5], stride,
                        threshold, a_max);
}

}  // namespace gr

extern "C" {

int gr_consume(uint32_t* table, uint32_t* counts, int64_t alloc, int ranked,
               int64_t probe_limit, int64_t ins_limit, uint32_t or_bits,
               const int64_t* grid_q, const bool* ok_q, int Hq, int Fq,
               const int64_t* grid_i, const bool* ok_i, int Hi, int Fi,
               const int32_t* n_tiles, const int64_t* full_len,
               const int64_t* rows0, int rows0_cols, int B, int T, int K,
               int vote_min_q, int x_q, int vote_min_f, int x_f, int u_min,
               int a_max, int TL, int bs, int S, int fast, int rech_on,
               int silver, int64_t target, int64_t max_paths, int cap,
               int64_t* scal, int64_t* rows, int64_t* counters,
               unsigned long long* sums, int32_t* vals, bool* binit,
               unsigned long long* spill, cudaStream_t stream) {
  using gr::kThreads;
  const int bits_q = gr::table_bits(Hq * Fq), bits_f = gr::table_bits(Hi * Fi);
  // the insert grid is probed only by the trim recheck: at an insert
  // stride (no recheck) its tiles may hold fewer frames than K
  if (B < 0 || T < 1 || K < 1 || Hq < 1 || Hi < 1 || Hq > gr::kMaxH ||
      Hi > gr::kMaxH || K > Hq * Fq || bits_q > 14 ||
      (rech_on && (K > Hi * Fi || bits_f > 14)) || alloc % 4 || bs < 1 ||
      TL < 1 || cap < 1 ||
      (cap & (cap - 1)) || rows0_cols < (rech_on ? 9 : 8) ||
      (!fast && spill == nullptr) ||
      reinterpret_cast<uintptr_t>(table) % 16 ||
      reinterpret_cast<uintptr_t>(counts) % 16)
    return cudaErrorInvalidValue;
  if (B == 0) return gr::kNoLaunch;
  // kernel C's per-warp buffer: the candidates of up to 32 tiles at a
  // time, or pass 7's sort keys (classify.cu)
  int t2 = 1;
  while (t2 < T) t2 <<= 1;
  const int chunk = (T < 32 ? T : 32) * K;
  const int cbuf = t2 > chunk ? t2 : chunk;
  size_t smem = 8 * static_cast<size_t>(((T + 1) & ~1) + cbuf);
  for (int bits : {bits_q, rech_on ? bits_f : 1})
    smem = std::max(smem, ((static_cast<size_t>(1) << bits) + kThreads) *
                              sizeof(unsigned long long));
  if (!fast) smem = std::max(smem, static_cast<size_t>(cap) * 8);
  if (smem > gr::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = gr::allow_smem(gr::consume_kernel, smem);
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
           &per_sm, gr::consume_kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  gr::ConsumeArgs a{table, counts, alloc, ranked, probe_limit, ins_limit,
                    or_bits, grid_q, ok_q, grid_i, ok_i, n_tiles, full_len,
                    rows0, rows0_cols, B, T, K, Hq, Fq, Hi, Fi, vote_min_q,
                    x_q, bits_q, vote_min_f, x_f, bits_f, u_min, a_max, TL,
                    bs, S, cbuf, cap, fast, rech_on, silver, target,
                    max_paths, scal, rows, counters, sums, vals, binit,
                    spill};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(gr::consume_kernel), dim3(sms), dim3(kThreads),
      args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int gr_recheck_zone(const int64_t* rows, int n, int stride, int threshold,
                    int a_max, bool* out, cudaStream_t stream) {
  if (n < 0 || stride < 1) return cudaErrorInvalidValue;
  if (n == 0) return gr::kNoLaunch;
  gr::recheck_zone_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      rows, n, stride, threshold, a_max, out);
  return cudaGetLastError();
}

}  // extern "C"
