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
// that every CTA is resident and grid barriers (~1.1 us each on an H100)
// are legal.  Every CTA walks reads 0..B-1 and keeps the scan's scalars
// itself, computed identically from the same global inputs, so a read that
// neither probes nor inserts costs no barrier.  CTAs 0 and 1 are the
// runners: they classify (kernel C); CTAs 2.. own the insert keys.  It
// replaces a design in which a probe gathered its T tiles on T CTAs while
// the rest waited, all CTAs then ran C on one warp each, and an exact
// insert had every CTA stream the recruit's whole window from L2.  Against
// the four costs that design measured:
//   1. the exact insert reads its window once (insert.cuh): each CTA reads
//      a 1/gridDim slice and sends each key's entry to its owner's bucket,
//      a grid barrier, then each owner sorts its bucket and applies the
//      reservoir rule.  A probed read's scatter runs with its probe's
//      gathers, and its owners sort and read their keys' counters while
//      the runner classifies, so after the decision an insert is the
//      owners' writes;
//   2. a probe uses the card: its tiles go to CTAs 2, 3, ... (kernel B's
//      tile code), the exact policy's scatter to the CTAs without a tile
//      (to all of them for a recruit that is not probed, or when tiles
//      take more than half the owners), and under the trim recheck a live
//      read's full-resolution tiles are gathered beside its query tiles
//      against the same filter (the recheck reads it before any write),
//      so a read in the boundary zone costs one round, not two;
//   3. C once per probe, on a runner only, from shared memory: the runner's
//      512 threads stage the read's vote table from L2 in one round and
//      mark, for every tile, which tiles' initial ids its candidates hold
//      (candidate_masks); then one warp runs C's passes in place
//      (classify.cuh kStaged), passes 1-4, the longest stretch and the
//      flank top-2, which C's own kernel runs as single-lane walks, across
//      the lanes, a tile a lane (reconcile_runs, neighbor_fill_scan,
//      flank_top2_lanes).  C on one warp took ~17 us, about two thirds of
//      it in those walks.  A read of more than 32 tiles walks as C's own
//      kernel does, and a vote table larger than shared memory is read
//      from L2 as there;
//   4. cheaper barriers: the runner publishes its outcome with a release
//      store of the probe's number beside it, which the other CTAs await
//      with acquire loads (0.40 us, against a grid barrier's 1.1); grid
//      barriers remain only where another CTA reads what was written: the
//      probe's tiles and buckets, and the filter after an insert or reset.
//      Thread-block clusters do not help here: a cooperative launch takes
//      them (CUDA 12.9 on an H100), but a cluster barrier costs 0.64-0.71
//      us, and no step's work lives in one cluster.
// More: the reset is a grid-stride loop; insert_max (insert.cuh) is a
// reduction (red.global.max) per real key, and two of them need no
// barrier between them (max commutes).  Under the optimistic policy each
// owner stages its share of a probed read's full-resolution keys, all of
// its tiles, in shared memory while the runners classify it (the exact
// policy's scatter and sort take that time there), so that once the
// decision arrives an insert is the tile-range test and the reductions; a
// read whose shares exceed `stage_cap` keys, and a recruit that was not
// probed, read their keys at the insert, a key a thread over the grid.
// L1 is not coherent across SMs, so all memory that another CTA
// of the launch writes (the filter, the vote buffers, the buckets, the
// outcomes) is read through L2.  Scratch lives across launches: the
// bucket counters, the spill counters and the outcomes' sequence numbers
// are zero between launches (the kernel clears what it set).
//
// The filter under a mesh (parallel/mesh.py).  The table and counters
// come as a bank view (common.cuh Banks): under the engine's model axis
// each is split by index range into banks, and a bank is a device pointer,
// on this card or in the peer memory of another card of the host.  The
// kernel reads and writes the banks itself, with no collective: the scan
// re-probes the filter after every insert, read by read, inside this one
// launch, so routing those accesses through collectives outside the kernel
// (the mapping of TPU remote copies to NCCL that suits bulk transfers)
// would cost a round trip to the host per probe, thousands a batch.  Every
// store to the filter is followed, before any CTA reads the filter again,
// by a grid barrier (the `dirty` state below), and where a bank is remote
// that barrier starts with a system-scope fence (filter_barrier): a
// barrier's own fence is gpu-scoped, and the CUDA programming guide orders
// writes to peer memory before later accesses only under
// __threadfence_system(); the outcome flags order no filter store (a
// runner publishes a classification, never an insert).  On one card every
// bank is local and the fence is skipped.  The reset runs its grid-stride
// loop once per bank.  The kernel is a template on the view: a filter of
// one bank runs the FlatTable instantiation, the addressing it had before
// banks, and probes and raises entries through the table alone
// (FlatWords).  On an H100 (chip_smoke.py --ab) a uniform one-bank branch
// and the Banks struct on every access cost 3-15% of a probe, and a view
// that carried the counters' pointer into the probes left a batch of 140
// kb reads 20% slower.
//
// Bound.  The bytes a batch must move: per probe its grid row (H * T * F
// int64 entries), frame_ok and one 4-byte word per present frame and seed;
// per insert its window and each distinct key's word and counter; per
// reset the table (and counters) read and written.  At the exact shape a
// live probe is ~0.7 MB, ~0.2 us at 3.35 TB/s; its cost is latency: B's
// gather (two dependent rounds of loads), a grid barrier and C's
// sequential passes, one after another.
#include <cooperative_groups.h>

#include <algorithm>
#include <initializer_list>

#include "classify.cuh"
#include "insert.cuh"
#include "probe_vote.cuh"

namespace cg = cooperative_groups;

namespace gr {

// CTAs 0 and 1 classify the query tier's and the recheck tier's probes
// (consume.py RUNNERS)
constexpr int kRunners = 2;
// int64 words per runner's outcome slot: the probe's number, the Outcome
constexpr int kSlot = 16;

// The zone predicate (K18) is recheck_zone in classify.cuh.
struct ConsumeArgs {
  // the filter: the direct words or the rank-indexed ids, and counters,
  // through their bank view
  Banks banks;
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
  int staged;                   // C reads a vote table staged in smem
  int64_t stage_off;            // its byte offset in dynamic smem
  int64_t target, max_paths;
  // carried across batches; outputs
  int64_t* scal;       // [4] ids inserted, bases inserted, path index, done
  int64_t* rows;       // [B, 8]
  int64_t* counters;   // [4] live probes, rechecks, inserts, resets
  // scratch: a vote buffer per tier (0 query, 1 recheck)
  unsigned long long* sums;   // [2, 3, T] per-tile queries, hits, misses
  int32_t* vals;              // [2, 3T + 2TK] curr, top, overflow, cands
  bool* binit;                // [2, T]
  int64_t* outcome;           // [2, kSlot] the runners' outcomes, zeroed
  // the exact policy's insert: buckets of `parts` owners, two in turn
  uint32_t parts;
  unsigned* bucket_count;     // [2, parts], zeroed
  unsigned long long* bucket;  // [2, parts, cap]
  unsigned long long* spill;  // [2 + 2 * Hi * T * Fi]: two counters, zeroed
  // the optimistic policy's staging: keys an owner holds in shared memory
  // (0: none staged)
  int stage_cap;
};

// A probe tier: its grid, frame_ok and gates.
struct Tier {
  const int64_t* grid;
  const bool* ok;
  int H, F, vote_min, threshold, bits;
};

// Tier k's vote buffer.
__device__ __forceinline__ unsigned long long* tier_sums(const ConsumeArgs& a,
                                                         int k) {
  return a.sums + static_cast<int64_t>(k) * 3 * a.T;
}
__device__ __forceinline__ int32_t* tier_vals(const ConsumeArgs& a, int k) {
  return a.vals + static_cast<int64_t>(k) * (3 * a.T + 2 * a.T * a.K);
}

// Kernel B's tiles of read i for the tiers in use (tier 0 if `q`, tier 1
// if `f`): job j (tier-major, T tiles each) runs on CTA (j + kRunners) %
// gridDim.x (consume.py gather_ctas).  Every thread of every CTA calls it.
template <typename Filt>
__device__ void gather(const ConsumeArgs& a, const Tier* tiers, bool q,
                       bool f, int i) {
  const int T = a.T, K = a.K, G = gridDim.x;
  const int first = q ? 0 : 1;
  const int jobs = (static_cast<int>(q) + static_cast<int>(f)) * T;
  for (int j = (static_cast<int>(blockIdx.x) - kRunners + G) % G; j < jobs;
       j += G) {
    const int k = first + j / T, t = j % T;
    const Tier& tr = tiers[k];
    const int64_t TF = static_cast<int64_t>(T) * tr.F;
    unsigned long long* s = tier_sums(a, k);
    int32_t* curr = tier_vals(a, k);
    probe_vote_tile<true>(
        TableWord<WordsOf<Filt>>{view_of<WordsOf<Filt>>(a.banks)},
        tr.grid + static_cast<int64_t>(i) * tr.H * TF, a.ranked,
        a.probe_limit, tr.ok + static_cast<int64_t>(i) * TF, tr.H, T, tr.F,
        K, tr.vote_min, tr.threshold, tr.bits, t, 0, curr, curr + T,
        curr + 3 * T, curr + 3 * T + T * K, a.binit + k * T, curr + 2 * T, s,
        s + T, s + 2 * T);
    __syncthreads();
  }
}

// Runner k classifies tier k's vote buffer (every thread of the CTA calls
// it) and publishes the outcome under the probe's number `seq`.
__device__ void classify_tier(const ConsumeArgs& a, const Tier& tr, int k,
                              int n_t, int64_t seq, Outcome* sh) {
  const int T = a.T, K = a.K;
  const unsigned long long* s = tier_sums(a, k);
  const int32_t* v = tier_vals(a, k);
  Outcome o;
  if (a.staged) {
    // the sums, the vote values and the candidate masks, after C's rows
    unsigned long long* ss =
        reinterpret_cast<unsigned long long*>(gr_smem + a.stage_off);
    int32_t* sv = reinterpret_cast<int32_t*>(ss + 3 * T);
    uint32_t* mcol = reinterpret_cast<uint32_t*>(sv + 3 * T + 2 * T * K);
    uint32_t* scol = mcol + T;
    const int n = min(max(n_t, 0), T);
    for (int j = threadIdx.x; j < 3 * T; j += blockDim.x) ss[j] = __ldcg(s + j);
    for (int j = threadIdx.x; j < 3 * T + 2 * T * K; j += blockDim.x)
      sv[j] = __ldcg(v + j);
    __syncthreads();
    if (n <= 32) {
      candidate_masks(sv, sv + 3 * T, sv + 3 * T + T * K, n, K, tr.threshold,
                      mcol, scol);
      __syncthreads();
    }
    if (threadIdx.x < 32)
      o = read_outcome<true>(ss, sv, n_t, T, K, tr.threshold, a.u_min,
                             a.a_max, a.cbuf, gr_smem, threadIdx.x,
                             n <= 32 ? mcol : nullptr, scol);
  } else if (threadIdx.x < 32) {
    o = read_outcome<false>(s, v, n_t, T, K, tr.threshold, a.u_min, a.a_max,
                            a.cbuf, gr_smem, threadIdx.x);
  }
  if (threadIdx.x == 0) {
    *sh = o;
    int64_t* slot = a.outcome + k * kSlot;
    const int64_t f[9] = {o.dec, o.ts, o.te, o.na, o.q, o.h, o.m, o.ov,
                          o.tmin};
    for (int j = 0; j < 9; ++j) slot[1 + j] = f[j];
    asm volatile("st.release.gpu.global.s64 [%0], %1;" ::"l"(slot),
                 "l"(seq)
                 : "memory");
  }
}

// Runner k's outcome of the probe numbered `seq`, awaited by one thread.
// A runner publishes within one classification of its barrier: a wait of
// seconds means a fault, and traps rather than hangs the card.
__device__ Outcome await_tier(const ConsumeArgs& a, int k, int64_t seq) {
  const int64_t* slot = a.outcome + k * kSlot;
  int64_t v;
  for (unsigned spins = 0;; ++spins) {
    asm volatile("ld.acquire.gpu.global.s64 %0, [%1];"
                 : "=l"(v)
                 : "l"(slot)
                 : "memory");
    if (v >= seq) break;
    if (spins > (1u << 24)) __trap();
  }
  int64_t f[9];
  for (int j = 0; j < 9; ++j) f[j] = __ldcg(slot + 1 + j);
  return Outcome{f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8]};
}

// The silver rotation's reset of one bank of `n4` 16-byte groups, over
// the whole grid: forget every id, keep presence; under the exact policy
// zero the counters too.
__device__ void reset_bank(uint32_t* table, uint32_t* counts, int64_t n4,
                           int ranked, int fast) {
  int4* w = reinterpret_cast<int4*>(table);
  int4* c = reinterpret_cast<int4*>(counts);
  const int4 zero = make_int4(0, 0, 0, 0);
  const int p = static_cast<int>(kPresent);
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < n4; j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (ranked) {
      w[j] = zero;
    } else {
      const int4 v = __ldcg(w + j);
      w[j] = make_int4(v.x & p, v.y & p, v.z & p, v.w & p);
    }
    if (!fast) c[j] = zero;
  }
}

// The reset of the whole filter, bank by bank.
template <typename Filt>
__device__ void reset_filter(const ConsumeArgs& a) {
  if constexpr (std::is_same<Filt, FlatTable>::value) {
    reset_bank(a.banks.table[0], a.banks.counts[0], a.banks.bank_len / 4,
               a.ranked, a.fast);
  } else {
#pragma unroll
    for (int b = 0; b < kMaxBanks; ++b)
      if (b < a.banks.n)
        reset_bank(a.banks.table[b], a.banks.counts[b], a.banks.bank_len / 4,
                   a.ranked, a.fast);
  }
}

// A grid barrier after stores to the filter, before any CTA reads it
// again: with a bank in another card's memory, fenced at system scope
// first (the note at the top of this file).
template <typename Filt>
__device__ __forceinline__ void filter_barrier(const ConsumeArgs& a,
                                               cg::grid_group& grid) {
  if constexpr (!std::is_same<Filt, FlatTable>::value) {
    if (a.banks.remote) __threadfence_system();
  }
  grid.sync();
}

// insert_max of read i's tiles lo..last (ids from `base`): from the
// owners' staged slices of its nt tiles (`staged`), or read from the
// insert grid by every thread of the grid.  Every thread calls it.
template <typename Filt>
__device__ void insert_max_read(const ConsumeArgs& a, int i, int nt,
                                bool staged, int lo, int last, uint32_t base,
                                bool trimmed) {
  const auto words = view_of<WordsOf<Filt>>(a.banks);
  const int rank = blockIdx.x, n = gridDim.x;
  if (staged && last < nt) {
    if (rank >= kRunners)
      insert_max_staged(words, reinterpret_cast<const int64_t*>(gr_smem),
                        a.Fi, a.Hi, nt, lo, last, a.ins_limit, a.or_bits,
                        base, trimmed, a.bs, rank - kRunners, n - kRunners);
    return;
  }
  const int64_t TF = static_cast<int64_t>(a.T) * a.Fi;
  insert_max_loaded(words, a.grid_i + static_cast<int64_t>(i) * a.Hi * TF,
                    TF, a.Fi, a.Hi, lo, last, a.ins_limit, a.or_bits, base,
                    trimmed, a.bs, rank * blockDim.x + threadIdx.x,
                    n * blockDim.x);
}

// what the filter saw since the last grid barrier
enum Dirty { kClean = 0, kMaxOnly = 1, kWritten = 2 };

// The kernel, on the filter's view `Filt` (common.cuh with_view: the
// FlatTable of one bank, or the Banks), taken from the parameters where
// it is used, as the table's pointer was before banks.
template <typename Filt>
__global__ void __launch_bounds__(kThreads, 1)
consume_kernel(const ConsumeArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Outcome sh[2];
  const Tier tiers[2] = {
      {a.grid_q, a.ok_q, a.Hq, a.Fq, a.vote_min_q, a.x_q, a.bits_q},
      {a.grid_i, a.ok_i, a.Hi, a.Fi, a.vote_min_f, a.x_f, a.bits_f}};
  const int rank = blockIdx.x;
  const bool owner = rank >= kRunners;
  const int n_owners = static_cast<int>(gridDim.x) - kRunners;
  const int64_t TFi = static_cast<int64_t>(a.T) * a.Fi;
  uint64_t* sbuf = reinterpret_cast<uint64_t*>(gr_smem);
  uint32_t* before = reinterpret_cast<uint32_t*>(sbuf + a.cap);
  int64_t ids_ins = a.scal[0], ins_bases = a.scal[1];
  int64_t path_idx = a.scal[2], done = a.scal[3];
  bool changed = false, reset_seen = false;
  int dirty = kClean;
  int64_t probes = 0, scatters = 0;
  int64_t n_live = 0, n_rech = 0, n_ins = 0, n_reset = 0;
  const bool lead = rank == 0 && threadIdx.x == 0;
  for (int i = 0; i < a.B; ++i) {
    const int64_t* r0 = a.rows0 + static_cast<int64_t>(i) * a.rows0_cols;
    Outcome o{r0[0], r0[1], r0[2], r0[3], r0[4], r0[5], r0[6], r0[7],
              a.rech_on ? r0[8] : 0};
    const int n_t = a.n_tiles[i];
    const int nt = min(max(n_t, 0), a.T);
    const int64_t L = a.full_len[i];
    // exact: every read after an in-batch change re-probes; optimistic: a
    // batch-time drop stays dropped, and after an in-batch silver reset
    // every later read re-probes
    const bool live =
        (a.fast ? (changed && o.dec != 0) || reset_seen : changed) && !done;
    // the recheck tier: beside a live probe (its zone is decided after),
    // or alone for a read whose batch-time row is in the zone
    const bool rech =
        a.rech_on && !done &&
        (live || recheck_zone(o.dec, o.na, n_t, o.ts, o.te, o.tmin, a.S,
                              a.x_f, a.a_max));
    const bool probe = live || rech;
    // the exact policy scatters a recruit's window to the key owners: a
    // probed read's whole read (its decision is not made yet), another
    // recruit's tiles
    const bool known = !probe && o.dec > 0 && !done;
    const bool scatter = !a.fast && (probe || known);
    int t0 = 0, t1 = nt;
    if (known) {
      t0 = o.dec == 1 ? 0 : static_cast<int>(o.ts);
      t1 = o.dec == 1 ? nt : min(static_cast<int>(o.te) + 1, a.T);
    }
    const Window w{a.grid_i + static_cast<int64_t>(i) * a.Hi * TFi, a.Hi,
                   TFi, a.Fi, t0, t1, a.ins_limit};
    const int b = static_cast<int>(scatters & 1);
    if (probe) {
      if (dirty != kClean) filter_barrier<Filt>(a, grid);
      gather<Filt>(a, tiers, live, rech, i);
    }
    if (scatter) {
      // the CTAs without a tile job scatter, while they are at least half
      // the grid (consume.py scatter_sources)
      const int jobs =
          probe ? (static_cast<int>(live) + static_cast<int>(rech)) * a.T : 0;
      const int busy =
          2 * jobs <= static_cast<int>(gridDim.x) - kRunners ? jobs : 0;
      const int src = rank < kRunners ? rank
                      : rank < kRunners + busy ? -1
                                               : rank - busy;
      if (src >= 0)
        scatter_window(w, src, gridDim.x - busy, a.parts, a.cap,
                       a.bucket_count + b * a.parts,
                       a.bucket + static_cast<int64_t>(b) * a.parts * a.cap);
    }
    if (probe || scatter) {
      if (dirty != kClean) {
        filter_barrier<Filt>(a, grid);
      } else {
        grid.sync();
      }
      dirty = kClean;
    }
    if (scatter && rank == 0 && threadIdx.x == 0)
      a.spill[(b + 1) & 1] = 0;   // its last user is past this barrier
    const int64_t seq = probe ? ++probes : 0;
    if (probe && rank < kRunners && (rank == 0 ? live : rech))
      classify_tier(a, tiers[rank], rank, n_t, seq, &sh[rank]);
    // the optimistic policy: the owners stage the probed read's keys while
    // the runners classify it (published by the barriers below)
    const bool staged =
        a.fast && probe &&
        stage_fits(a.Hi, nt, a.Fi, n_owners, a.stage_cap);
    if (staged && owner)
      stage_max_slice(a.grid_i + static_cast<int64_t>(i) * a.Hi * TFi, TFi,
                      a.Fi, a.Hi, nt, rank - kRunners, n_owners,
                      reinterpret_cast<int64_t*>(gr_smem));
    int n_own = 0;
    const uint64_t* buf = sbuf;
    if (scatter && owner) {
      buf = owner_sort(w, rank - kRunners, a.parts, a.cap,
                       a.bucket_count + b * a.parts,
                       a.bucket + static_cast<int64_t>(b) * a.parts * a.cap,
                       sbuf, reinterpret_cast<uint64_t*>(before), a.spill + b,
                       reinterpret_cast<uint64_t*>(a.spill + 2), &n_own);
      if (n_own <= a.cap)
        owner_prefetch(buf, n_own, view_of<Filt>(a.banks), before);
    }
    if (probe) {
      if (threadIdx.x == 0) {
        if (live && rank != 0) sh[0] = await_tier(a, 0, seq);
        if (rech && rank != 1) sh[1] = await_tier(a, 1, seq);
      }
      __syncthreads();
      if (live) {
        o = sh[0];
        ++n_live;
      }
      if (rech && recheck_zone(o.dec, o.na, n_t, o.ts, o.te, o.tmin, a.S,
                               a.x_f, a.a_max)) {
        // boundary zone: re-classified at full resolution, every insert
        // seed, the exact gates
        o = sh[1];
        ++n_rech;
      }
      // every thread has read sh before a later probe writes it
      __syncthreads();
    }
    if (scatter) ++scatters;
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
      const int last = min(hi, a.T - 1);
      const uint32_t base = static_cast<uint32_t>(ids_ins + 1);
      if (a.fast) {
        // a reset's stores
        if (dirty == kWritten) filter_barrier<Filt>(a, grid);
        insert_max_read<Filt>(a, i, nt, staged, lo, last, base,
                              o.dec == 2);
        dirty = kMaxOnly;
      } else {
        if (owner)
          owner_apply(view_of<Filt>(a.banks), buf, n_own,
                      n_own <= a.cap ? before : nullptr, lo, last, base,
                      o.dec == 2, a.bs, a.or_bits, 0u);
        dirty = kWritten;
      }
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
        if (dirty != kClean) filter_barrier<Filt>(a, grid);
        reset_filter<Filt>(a);
        dirty = kWritten;
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
  // every CTA read scal and the scratch before they are overwritten
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
    a.outcome[0] = a.outcome[kSlot] = 0;
    if (a.spill) a.spill[0] = a.spill[1] = 0;
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

// table/counts/n_banks/bank_len/remote: the filter's bank view (common.cuh
// make_banks), every bank 16-byte aligned and of a multiple of 4 entries.
// The scratch (consume.py ConsumeScratch): sums/vals/binit a vote buffer
// per tier at this T; outcome int64 [2 * 16], zeroed; under the exact
// policy bucket_count uint32 [2 * parts] and spill's two counters zeroed,
// bucket uint64 [2 * parts * cap], spill's data 2 * Hi * T * Fi entries.
// `parts` must be the SMs less the two runners.  stage_cap: the keys of a
// probed read an owner stages under the optimistic policy (8 bytes each in
// shared memory; 0 stages none).
int gr_consume(void* const* table, void* const* counts, int n_banks,
               int64_t bank_len, int remote, int ranked,
               int64_t probe_limit, int64_t ins_limit, uint32_t or_bits,
               const int64_t* grid_q, const bool* ok_q, int Hq, int Fq,
               const int64_t* grid_i, const bool* ok_i, int Hi, int Fi,
               const int32_t* n_tiles, const int64_t* full_len,
               const int64_t* rows0, int rows0_cols, int B, int T, int K,
               int vote_min_q, int x_q, int vote_min_f, int x_f, int u_min,
               int a_max, int TL, int bs, int S, int fast, int rech_on,
               int silver, int64_t target, int64_t max_paths, int cap,
               int parts, int stage_cap, int64_t* scal, int64_t* rows,
               int64_t* counters,
               unsigned long long* sums, int32_t* vals, bool* binit,
               int64_t* outcome, unsigned* bucket_count,
               unsigned long long* bucket, unsigned long long* spill,
               cudaStream_t stream) {
  using gr::kThreads;
  const int bits_q = gr::table_bits(Hq * Fq), bits_f = gr::table_bits(Hi * Fi);
  gr::Banks banks;
  if (!counts ||
      !gr::make_banks(table, counts, n_banks, bank_len, remote, &banks) ||
      bank_len % 4)
    return cudaErrorInvalidValue;
  for (int j = 0; j < n_banks; ++j)
    if (reinterpret_cast<uintptr_t>(banks.table[j]) % 16 ||
        reinterpret_cast<uintptr_t>(banks.counts[j]) % 16)
      return cudaErrorInvalidValue;
  // the insert grid is probed only by the trim recheck: at an insert
  // stride (no recheck) its tiles may hold fewer frames than K
  if (B < 0 || T < 1 || T >= (1 << 16) || K < 1 || Hq < 1 || Hi < 1 ||
      Hq > gr::kMaxH || Hi > gr::kMaxH || K > Hq * Fq || bits_q > 14 ||
      (rech_on && (K > Hi * Fi || bits_f > 14)) || bs < 1 ||
      TL < 1 || cap < 4 * gr::kThreads || (cap & (cap - 1)) ||
      stage_cap < 0 ||
      rows0_cols < (rech_on ? 9 : 8) || !outcome ||
      // insert_max's window entries and block width are 32-bit
      (fast && (static_cast<int64_t>(T) * Fi * Hi >= (int64_t{1} << 31) ||
                static_cast<int64_t>(Fi) * bs >= (int64_t{1} << 31))) ||
      (!fast && (!spill || !bucket || !bucket_count || parts < 1 ||
                 parts > gr::kMaxParts)))
    return cudaErrorInvalidValue;
  if (B == 0) return gr::kNoLaunch;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if (sms <= gr::kRunners || (!fast && parts != sms - gr::kRunners))
    return cudaErrorInvalidValue;
  // kernel C's per-warp buffer: the candidates of up to 32 tiles at a
  // time, or pass 7's sort keys (classify.cu)
  int t2 = 1;
  while (t2 < T) t2 <<= 1;
  const int chunk = (T < 32 ? T : 32) * K;
  const int cbuf = t2 > chunk ? t2 : chunk;
  const size_t c_bytes = 8 * static_cast<size_t>(((T + 1) & ~1) + cbuf);
  // a runner stages the vote table and two candidate masks a tile beside
  // C's rows when all fit
  const size_t staged_bytes =
      c_bytes + 8 * static_cast<size_t>(3 * T) +
      4 * static_cast<size_t>(3 * T + 2 * T * K + 2 * T);
  const int staged = staged_bytes <= gr::kMaxSmem;
  size_t smem = staged ? staged_bytes : c_bytes;
  for (int bits : {bits_q, rech_on ? bits_f : 1})
    smem = std::max(smem, ((static_cast<size_t>(1) << bits) + kThreads) *
                              sizeof(unsigned long long));
  // an owner's sorted entries and its keys' counters (or half as many
  // entries again while it keeps the distinct ones of an overflow)
  if (!fast) smem = std::max(smem, static_cast<size_t>(cap) * 12);
  // an owner's staged keys of a probed read
  if (fast) smem = std::max(smem, static_cast<size_t>(stage_cap) * 8);
  if (smem > gr::kMaxSmem) return cudaErrorInvalidValue;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  gr::ConsumeArgs a{banks, ranked, probe_limit, ins_limit,
                    or_bits, grid_q, ok_q, grid_i, ok_i, n_tiles, full_len,
                    rows0, rows0_cols, B, T, K, Hq, Fq, Hi, Fi, vote_min_q,
                    x_q, bits_q, vote_min_f, x_f, bits_f, u_min, a_max, TL,
                    bs, S, cbuf, cap, fast, rech_on, silver, staged,
                    static_cast<int64_t>(c_bytes), target, max_paths,
                    scal,
                    rows, counters, sums, vals, binit, outcome,
                    static_cast<uint32_t>(parts), bucket_count, bucket,
                    spill, fast ? stage_cap : 0};
  return gr::with_view(banks, [&](auto filt) {
    const auto kernel = gr::consume_kernel<decltype(filt)>;
    cudaError_t e = gr::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    int per_sm = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&a};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(sms), dim3(kThreads), args, smem,
                                    stream);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  });
}

// Whether card `dev` can reach the memory of card `peer` (can) with native
// atomics (atomics), and if both, peer access from `dev` enabled: what a
// filter with banks on `peer` needs of a kernel launched on `dev`
// (kernels.py peer_attributes).  The current device is kept.
int gr_peer_access(int dev, int peer, int* can, int* atomics) {
  cudaError_t err;
  *can = *atomics = 0;
  if ((err = cudaDeviceCanAccessPeer(can, dev, peer)) != cudaSuccess)
    return err;
  if (!*can) return cudaSuccess;
  if ((err = cudaDeviceGetP2PAttribute(atomics,
                                       cudaDevP2PAttrNativeAtomicSupported,
                                       dev, peer)) != cudaSuccess)
    return err;
  if (!*atomics) return cudaSuccess;
  int cur = 0;
  if ((err = cudaGetDevice(&cur)) != cudaSuccess) return err;
  if ((err = cudaSetDevice(dev)) != cudaSuccess) return err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error it records
    err = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(cur);
  return err != cudaSuccess ? err : back;
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
