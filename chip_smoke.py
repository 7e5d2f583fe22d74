#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (goldrush_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # one card
    python3 chip_smoke.py --ab DIR        # phases 3, 8(a), 9(a) and the
                                          # freeze at scale of an earlier
                                          # tree of the port in DIR, then
                                          # this one's

Phases (one line each; any failure raises, so the exit code is non-zero):
  1. device: require CUDA; print the card and its power limit;
  2. build: compile the kernels of goldrush_tpu_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the slice's shapes (B=32 reads, T=20 tiles of 1000, h=3, K=32, a
     142,368,384-slot filter filled from seeded reads, then frozen into
     the rank-compressed filter; B=1 for the live re-probe), bit for bit
     (every output is an integer), with both times and each kernel's bound (the
     bytes it must move over the card's 3.35 TB/s, or, where counted, its
     32-bit integer operations over the card's integer rate, whichever
     takes longer); kernel A's fill, merge
     and both grids in both slot maps, the fill per 64-read batch and over
     a whole fill pass of the bench's shape (47 batches and the direct
     filter's merge), the merge on the bench filter as the words' first
     write (dirty memory) and as an OR, the freeze (rank_build, one
     launch) of the pass's bitmap against the plain freeze, beside
     torch.cumsum of the words' precomputed popcounts;
     both grids also at a frame stride: the throughput mode's query grid
     (B=64, h=1, S=8), S=2 and S=4 with h=3 and its full-resolution
     insert grid (B=64, h=3), timed, and the grid cases of
     hard_cases.grid_lengths;
     the throughput batch's query grid written by its insert grid's launch
     (build_slot_grids, build_rank_grids) against those two launches and
     the plain versions, bit for bit, timed (`fused_grid`);
     kernel D (the consume kernel's insert launched alone) also on
     recruits whose keys one of its CTAs owns or that repeat one k-mer
     (past a CTA's shared memory), in both filters, and timed on a
     20-tile and a 2-tile trimmed recruit and for its window read alone;
     insert_max (the throughput mode's max-id-wins insert) on the same
     recruits and ids near 2^30 in both filters, timed on the 20-tile and
     the 2-tile recruit beside torch's scatter_reduce_(amax) on the
     20-tile recruit's precomputed keys and values (the library time);
     both inserts also on recruits of insert grids at insert strides 2
     and 8 (kernel A's grids at S, F = TL / S frames per tile), each
     timed on a 20-tile recruit;
     kernels B and C also on the inputs their designs branch on
     (goldrush_tpu_torch/hard_cases.py) at B=32 and B=1, B in both
     filters, and C's warp cummax (row_cummax) against torch.cummax;
     the stages' kernels: minimizer_keys (K20) on 32 x 32,768 codes at
     (k, w) = (15, 10), (40, 250), (32, 1,000), on batches whose windows
     end on its tile edges, one 2^20-wide chunk and rows narrower than
     k + w - 1, beside unfold(1, w, 1).amin(-1) on
     precomputed keys; kmer_count (K21) of 64 x 32,768 reads into a
     2^22+1-slot table and of a homopolymer batch, beside index_add_;
     kmer_query on one 1 Mbp contig row and 40,000 candidate windows of
     width 2k + 2, beside advanced indexing (each library call on
     precomputed slots and held to the kernel), its launch timed alone
     and with the wrapper's valid mask; both also on rows of one k-mer
     and on codes 5 bytes past an aligned address;
     the consume scan (K9, `consume_check`) in exact mode (B=32) and in
     the throughput cell (B=64) with either filter, and exact mode at
     insert stride 8, on batches of the bench dataset's shape that
     rotate a silver path and reach `done`, that insert reads and then
     re-probe reads overlapping them, in which every read after the first
     re-probes, whose homopolymer recruit overflows its key owner's bucket
     and shared memory, of one read (B=1), and of 140 kb reads (T=140: a
     probe's tile jobs wrap past the key owners onto every CTA): rows,
     scal, counters and filter against the plain version, each batch
     timed beside the plain version and its bound, with its live
     re-probes, rechecks, inserts, resets and grid barriers (counted from
     the plain version's steps, for this kernel and the design it
     replaced); inside the kernel one whole-read insert (a batch with one
     recruit and no live read, less the same batch with none) and one
     probe (a batch with one live re-probe, less the same batch with an
     insert instead; and one trim recheck, less a batch of drops); and
     the first 16 (exact) or 8 (throughput) batches of a silver pass over
     the bench reads, in order, timed per batch; in the throughput cell
     also one insert of a probed recruit inside the kernel, its keys
     staged in the owners' shared memory and loaded at the insert
     (`probed_insert_ms`);
  4. end to end, two paths, each with every launch count zeroed just
     before it and read just after:
     exact: goldrush-path (silver M=5, then golden) through the CLI
     entry point on 3,000 x 20 kb reads of a 5 Mbp genome at 5% error
     (bench.py's dataset, seeds 11/12), once with the direct filter and
     once with the rank-compressed one; the fill once per batch, the
     merge once per direct fill pass and never in the compressed filter,
     each grid entry once per grid of its filter, recruits > 0, each
     completed silver path > r*G bases;
     throughput: bench.py's throughput cell (stride 8, one probed seed,
     optimistic staleness, batches of 64; bench.py:173-180) through
     GoldenPathEngine on the same reads, compressed filter then direct;
     in both, the consume kernel, kernel B and kernel C once per batch
     (the batched probe and classify), kernel D and insert_max never
     from the host (their code runs inside the consume kernel), one
     insert in it per recruit, in the throughput cell kernel A's grid
     entry once per batch (both grids from one launch), and its live
     re-probes, trim rechecks,
     inserts and resets printed per pass; every kernel must have
     launched in each path; each run's times, reads/s and peak device
     memory are printed;
  5. digests: the port's silver paths on the 1 Mbp quality-gate dataset,
     with either filter, in exact mode and in the throughput mode, must
     match tests/fixtures/torch_port_digests.json (written by the JAX
     package on the CPU);
  6. pipeline: `goldrush run` (silver -> golden -> polish -> tigmint ->
     ntLink -> targeted polish) through the CLI entry points, every launch
     count zeroed just before and read just after: (a) on
     tests/test_pipeline.py's 60 kb dataset, whose stage files must match
     the JAX package's digests (the fixture's "pipeline" key); (b) on the
     1 Mbp quality-gate dataset with G=1e6, M=3, r=0.75, track_time=1,
     printing each stage's seconds, the final assembly's stats (its total
     within [0.8, 1.8] x G) and the launches of K20 and K21, each of which
     must launch in (a) or (b);
  7. genome scale, the compressed filter past 2^32 slots: (a) the
     fixture's "superblocks" digests (silver and golden paths of the 1 Mbp
     gate dataset at 4,603,242,496 slots, two superblocks: exact with
     slot_map "mod" and "fastrange", the throughput cell with "mod");
     (b) the bench reads with hash_universe=6e9 (56,947,329,536 slots, 14
     superblocks, ~62 GB on the card), slot_map "mod", one silver pass in
     exact mode and one in the throughput cell: supers and pop against a
     plain per-superblock popcount of the bitmap, 2^20+ rank lookups
     against host int64 arithmetic, the first two consume batches against
     consume_batch_plain (on the host), and the sizes, the freeze's kernel
     times against their bounds, reads/s and peak memory printed; every
     launch count zeroed before (a) and read after (b), one freeze a
     run, each timed and its supers and pop held to a plain popcount of
     its bitmap; then the freeze on synthetic bitmaps of 4,603,242,496
     (its first superblock fully set; and 7 slots fewer: a ragged last
     word) and 56,947,329,536 slots (its fourth superblock fully set)
     against the plain freeze superblock by superblock, timed beside its
     bound and torch.cumsum of the words' popcounts; (c) ranks at or
     above 2^32: an all-ones bitmap of 2^32 + 2^26 slots frozen, its rank
     grid, one exact insert and one insert_max against their plain
     versions, and a consume batch of four reads on those ranks in both
     policies against consume_batch_plain; (d) the direct filter at 2^32
     slots and more: (i) the fixture's "direct_2_32" digests (silver and
     golden paths of the gate dataset at 4,603,242,496 slots, 36.8 GB of
     tables: exact with slot_map "fastrange" and "mod", the throughput
     cell with "mod", and that cell banked 1x2 on ["cuda:0"] * 2), every
     launch count zeroed just before and read just after, the direct
     path's kernels launched and the rank kernels not; (ii) at that size
     and at 142,368,384 slots, in each of those three cases, kernel A's
     fill (the bench reads' fill pass into the kernel's and the plain
     version's bitmaps), the merge (the words' first write against the
     chunked plain merge, chunk by chunk), A's query grid, the consume
     kernel (the first bench batch: the entries at its keys snapshotted,
     kernel, snapshot restored, plain version; whole-table checksums) and
     B against their plain versions, each timed beside its bound; (iii)
     goldrush-path through the CLI at G=3e8 (8,542,099,456 slots, 68.3 GB
     of tables), counted on its own: each stage's size, construction and
     fill seconds, reads/s and the peak device memory;
  8. ntCard's sizing and the sampled inserts: (a) ntcard_count (K22)
     against its plain version on the bench reads' batches (2^24 bases a
     launch) at rbits 22 and 27 (3 GiB of counters), counters and each
     seed's F0 equal, timed beside its bounds (the block-table and the
     per-care-offset forms), the plain version and index_add_ on
     precomputed bank indices, and on a homopolymer batch and a batch of
     short reads (the stale tails), counters equal, timed; then, every
     launch count
     zeroed just before and read just after, (b) the engine sized by
     ntCard on the gate dataset, each filter: universe, size, silver and
     golden digests against the fixture's "ntcard" key; (c) the
     fixture's "insert" cases (insert_stride 2 and 8, insert_seeds 2,
     the exact policy at insert_stride 2): silver digests, one insert in
     the consume kernel per recruit; (d) the bench reads' silver pass in
     the throughput cell, compressed filter, sized by ntCard and by the
     closed form: universe, size, occupancy after the fill, ntCard's and
     the fill's seconds, reads/s, peak memory, and ntCard's pass alone,
     its wall time split into the read stream and packing, the launches
     and the F0 histograms.  ntcard_count and every
     kernel of both paths must launch in (b)-(d);
  9. the wavefront consume (K23): (a) wave_adjacency and wave_rounds
     against their plain versions on five windows of 256 reads per filter
     (two of bench reads, a third with a silver rotation inside it, one
     of homopolymer reads, one bench read repeated 256 times), the
     counts, rows, scal, counters and both tables exactly and no fault,
     each timed beside its bound, the plain version and, for the
     adjacency, torch.sort of the window's keys (the record's times: the
     mean over the three windows of bench reads); and wave_rounds on
     windows of 7,910, 7,981 and 8,192 one-tile reads (the fixture's
     "wave_8192" dataset: past 7,910 each CTA's per-read state in a
     global scratch) in the same way, each filter, timed once;
     wave_adjacency on windows of 8,193 and 8,199 of those reads (the
     mesh's padding at 3 and 7 data rows) against its plain version,
     timed; and wave_rounds on a window of each of the largest tile
     buckets (two reads of 1,024, 1,536 and 2,048 tiles of 1,000 at the
     bench cell's tiers, K = 32: kernel C on fewer warps of a CTA), each
     filter, and on the first window of the fixture's "wave_long" dataset
     (direct filter), timed once; then, every launch
     count zeroed just before and read
     just after, (b) bench.py's throughput cell with wavefront=True and
     windows of 256 reads, each filter: assign reads/s, submit and replay
     seconds, rounds per window, commits per round, recruits, the
     recruit-set Jaccard against phase 4's sequential pass (printed, not
     gated), peak memory; the two kernels once per window, the consume
     kernel and the batched B and C never; (c) the fixture's
     "wavefront" digests of the gate dataset, both filters; (d) the
     fixture's "wave_8192" digests: the one-tile reads in windows of
     8,192, both filters, the two kernels once a window; (e) the
     fixture's "wave_long" digests: reads of the 1,024-tile bucket
     (tiles of 256), both filters;
 10. the mesh (parallel/mesh.py: a (data, model) mesh of devices in one
     process, the filter replicated over data rows and banked by index
     range over a row's devices): (a) with 1, 2 and 4 banks on cuda:0, on
     the first bench batch of a filter filled from the bench reads, the
     consume kernel (exact, direct filter; throughput cell, compressed)
     against consume_batch_plain on the unbanked filter (rows, scal,
     counters, the gathered filter), probe_vote, the standalone
     insert_sorted and insert_max and the per-bank presence_merge
     against their plain versions, each bit for bit, with consume's and
     probe_vote's times at each bank count beside the batch's bound (the
     records' banked_err, banked_ms_m1/m2/m4); then, every launch count
     zeroed just before and read just after, (b) the engine on
     device=["cuda:0"] * 4: data-parallel 4x1 exact direct, banked 2x2
     exact and throughput with each filter, on the bench reads (exact:
     silver and golden through the pipeline as phase 4 runs them;
     throughput: the silver pass): every file's sha256 equal to the
     single-card run's of phase 4, every row's replica equal, the
     consume kernel, B and C d times a batch (d data rows), assign
     reads/s beside the single card's; and on the gate dataset each
     run's digests against the fixture and its gathered filter against
     a single-card run's; (c) where the host has two cards or more, the
     banks across real cards (1x2, and 2x2 with four): peer access and
     native atomics printed, (a)'s and (d)'s kernel checks and the gate
     digests, the wavefront's too; on one card it prints "10(c) not run: 1
     card"; (d) the wavefront under the mesh: wave_rounds on the id and
     side tables banked over 1, 2 and 4 banks on cuda:0 against
     wave_window_plain on the unbanked tables, bit for bit, on 9(a)'s
     three windows of bench reads per filter, each timed beside 9(a)'s
     unbanked time and the window's bound; then, every launch count
     zeroed just before and read just after, bench.py's throughput cell
     with wavefront=True on ["cuda:0"] * 4 at 2x2 and 4x1, each filter:
     every file's sha256 equal to 9(b)'s, every row's replica and side
     table equal, wave_rounds d times a window and wave_adjacency once,
     the consume kernel, B and C never, assign reads/s beside 9(b)'s; and
     the gate dataset's "wavefront" digests at 2x2; (e) the fixture's
     "wave_8192_d3" digests on ["cuda:0"] * 3 (windows of 8,192 one-tile
     reads padded to 8,193: the adjacency past 8,192 reads), both
     filters.  `mesh_phase()` runs phase 10 alone from a driver that sets
     WORK.
 11. the state-mutating step (parallel/mesh.py train_step and
     sharded_train_step, the blockwise insert_read of both filters): the
     bench reads filled into the bench-width direct filter by the port's
     pass-1 fill (its words held to the JAX fill's digest); (a) kernel D
     as insert_read runs it (keep = SAT | PRESENT; the compressed filter's
     slot grid mapped to ranks in the launch, keep = SAT) against its
     plain version on 16 recruits, 12 of them over words or ids with SAT
     set beforehand, and a whole recruit timed beside the plain version
     and its bound; D's batch entry (train_step's insert: a classified
     batch in one launch) on the first step's batch and on it with reads
     that share slots, against its plain version, D once a recruit and
     the batch in chunks, timed beside both and its bound; then, every
     launch count zeroed just before and read just after, (b) four
     train_steps of 64 reads at max_blocks 2 and 1 against the fixture's
     "train_step" digests (words, counters, decisions after each step),
     with no host synchronisation inside a step, each step's ms and
     launches (A's grid, B, C and the batch entry once, single-recruit D
     never), and the same steps through sharded_train_step at 1x2 and 2x2
     (banked) and 2x1 (replicated) on ["cuda:0"] * n, every replica and
     the decisions equal to the single card's after each step, the batch
     entry once a data row.  `train_phase()` runs phase 11 alone from a
     driver that sets WORK.
The line before the last is the per-kernel JSON record, the last line
{"ok": true, "device": {...}}.  Imports nothing of JAX.

With --ab DIR it runs phase 3, 8(a) and 9(a) alone (9(a) without its
widest windows, which an earlier tree refuses), the freeze at phase
7's two sizes on synthetic bitmaps and phase 11's first step's insert
and four steps (`train_ab_check`), four times, each in a
process of its own that imports the port from its tree: DIR (for example
a `git archive` of the parent commit, whose kernels' entry points may
differ: only the Python wrappers are called), this checkout, this
checkout, DIR; then it prints each kernel's times side by side (each
run's whole output goes to smoke_work/ab_runs.log).  Every run checks
its tree's kernels against their plain versions.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "smoke_work")
PRESET = "1011011110110111101101"
BENCH = dict(genome=5_000_000, genome_seed=11, n_reads=3_000,
             read_len=20_000, reads_seed=12, err_rate=0.05)
# NVIDIA H100 SXM device memory rate (data sheet) and 32-bit integer rate
# (`checked`), for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 64 * 132 * 1.98e9
FILL_BATCH, FILL_WIDTH = 64, 32_768     # the engine's pass-1 batches here
# bench.py's engine_cfg (bench.py:80-84) and its throughput cell (:173-180)
BENCH_ENGINE = dict(genome_size=5_000_000, kmer_size=22, weight=16,
                    hash_num=3, seed_preset=PRESET, silver_path=True,
                    max_paths=5, min_length=20_000)
THROUGHPUT = dict(frame_stride=8, probe_seeds=1, recheck="optimistic",
                  batch_reads=64)
# the single-card runs' assign reads/s, keyed (cell, filter, stage), from
# phase 4 and 9(b) (cell "wave") (or from phase 10 when it runs alone),
# printed beside the mesh's
RATES: dict = {}
# 9(a)'s wave_rounds times (ms) by window ("{filter}_{window}"), printed
# beside 10(d)'s banked times
WAVE_MS: dict = {}


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def silver_digests(prefix: str) -> dict:
    """{"_i.fq": sha256} of the path files of a silver pass of
    BENCH_ENGINE's paths."""
    return {f"_{i}.fq": sha256_file(f"{prefix}_{i}.fq")
            for i in range(1, BENCH_ENGINE["max_paths"] + 1)
            if os.path.exists(f"{prefix}_{i}.fq")}


def cuda_ms(fn, reps: int, hold: int = 1) -> float:
    """Mean milliseconds per call between CUDA events, after a warm-up.  A
    sleep kernel holds the stream while the calls are enqueued, so a
    kernel shorter than its host-side call is timed on the device and not
    at the host's enqueue rate: a wrapper call takes ~0.02-0.1 ms of host
    time, more on a loaded host, and the sleep lasts ~0.5 ms per call, or
    `hold` times that for a call that launches many kernels."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000 * reps * hold)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def checked(err: int, ms: float, plain_ms: float, nbytes: int,
            ops: int = 0, **extra) -> dict:
    """A kernel's record: its exactness, times, and its bound, the larger
    of the bytes it must move (each input read once, each output written
    once) over the device memory rate and its 32-bit integer operations,
    where counted, over INT_OPS_PER_S: an H100 SM retires 64 integer adds,
    shifts or bitwise operations a clock (CUDA C++ Programming Guide,
    arithmetic instruction throughput, compute capability 9.0), times 132
    SMs and the 1,980 MHz boost clock, 16.7e12 a second.  The other
    kernels do a few integer operations per byte.  No single PyTorch call
    computes any of these functions, so there is no library time."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                library_ms=None, **extra)


def hash_ops(positions: int, hashes: int, n_care: int) -> int:
    """Kernel A's 32-bit integer operations: per position hashed, two XORs
    of 64-bit values per care offset (4); per hash, the seed's rotates,
    XORs and unsigned min of 64-bit values and the slot map's 64 x 64-bit
    multiply-high (16)."""
    return positions * 4 * n_care + hashes * 16


def ntcard_ops(positions: int, hashes: int, n_care: int) -> int:
    """ntcard_count's 32-bit integer operations in the per-care-offset
    form, which maps no slot: per position hashed, two XORs of 64-bit
    values per care offset (4); per hash, the seed's two rotates (4 funnel
    shifts), two XORs (4) and unsigned min (4) of 64-bit values, and the
    bank test (4: a shift and a compare of the high word, twice)."""
    return positions * 4 * n_care + hashes * 16


def ntcard_block_ops(positions: int, lookups: int, hashes: int,
                     rotated: int, sampled: int) -> int:
    """ntcard_count's 32-bit integer operations in the block-table form,
    its cheapest known: per position, two XORs of 64-bit values per block
    lookup (4); per hash, the XORs (2) and unsigned min (1) of the two
    strands' high words and the bank test on the minimum (4), and for the
    `rotated` hashes of seeds s > 0 the two high words' rotates (2 funnel
    shifts); per sampled hash, the low words' rotates (2), XORs (2) and the
    rest of the 64-bit minimum (2)."""
    return positions * 4 * lookups + hashes * 7 + rotated * 2 + sampled * 6


def bench_reads(dev):
    """The bench dataset's shape, made on the card from a seed: a 5 Mbp
    random genome and 3,000 reads of 20 kb sampled from it with 5%
    substitutions (bench.py's sizes).  Returns (genome, reads)."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(BENCH["genome_seed"])
    n, L, G = BENCH["n_reads"], BENCH["read_len"], BENCH["genome"]
    genome = torch.randint(0, 4, (G,), dtype=torch.uint8, device=dev,
                           generator=g)
    starts = torch.randint(0, G - L, (n, 1), device=dev, generator=g)
    return genome, sample_reads(genome, starts, g)


def sample_reads(genome, starts, g):
    """20 kb reads of `genome` from each of `starts` (int64 [n, 1]) with 5%
    substitutions drawn from generator `g`."""
    import torch
    n, L, dev = starts.shape[0], BENCH["read_len"], genome.device
    reads = genome[starts + torch.arange(L, device=dev)]
    subst = torch.rand((n, L), device=dev, generator=g) < BENCH["err_rate"]
    return torch.where(subst, torch.randint(0, 4, (n, L), dtype=torch.uint8,
                                            device=dev, generator=g), reads)


def fill_pass_batches(dev, reads=None) -> list:
    """A fill pass of the bench dataset's shape (`bench_reads`, ~12x
    coverage, as there), in the engine's 47 batches of 64 reads padded to
    32,768 bases."""
    import torch
    if reads is None:
        reads = bench_reads(dev)[1]
    n, L = reads.shape
    batches = []
    for i in range(0, n, FILL_BATCH):
        part = reads[i: i + FILL_BATCH]
        codes = torch.zeros((part.shape[0], FILL_WIDTH), dtype=torch.uint8,
                            device=dev)
        codes[:, :L] = part
        batches.append((codes, torch.full((part.shape[0],), L,
                                          dtype=torch.int32, device=dev)))
    return batches


def vote_bytes(grid, ok, T: int, K: int, limit: int, ranked: bool) -> int:
    """Kernel B: the grid and frame_ok, one 4-byte word per seed of every
    frame that reads the filter (ranked: ranks below the sentinel), and
    the outputs."""
    B, H, _ = grid.shape
    reads = (ok[:, None, :] & (grid < limit)).sum() if ranked else \
        ok.sum() * H
    return (grid.numel() * 8 + ok.numel() + 4 * int(reads)
            + B * T * 13 + 2 * B * T * K * 4 + 3 * B * 8)


def freeze_bytes(size: int) -> int:
    """The freeze (rank_build): the bitmap read once; bitrank (its words
    and the appended one), supers and pop written once."""
    nw = -(-size // 32)
    return 4 * nw + 8 * (nw + 1) + 8 * -(-size // (1 << 32)) + 8


def classify_bytes(B: int, T: int, K: int) -> int:
    """Kernel C: curr_id, the candidate table and n_tiles in; the four
    per-read results and the ids/bools rows out."""
    return B * T * 4 + 2 * B * T * K * 4 + B * 4 + 4 * B * 4 + 2 * B * T * 4


def hard_cases(dev) -> tuple[int, int]:
    """Kernels B and C against their plain versions on the inputs their
    designs branch on (goldrush_tpu_torch/hard_cases.py), at B=32 and B=1: B in
    both filters with vote_min 2 and 0 (a vote_min of 0 makes every
    distinct id a candidate and sends tiles past the CTA's thread count to
    the whole-table sort), C on reads of 0-16 and 20 tiles and on a
    2,048-tile bucket.  Returns their max_abs_err."""
    import numpy as np
    import torch
    from goldrush_tpu_torch import hard_cases as hard
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.path import classify as clf
    T, F, K = 20, 1000, 32
    err_b = 0
    for vote_min in (2, 0):
        params = dm.MibfParams(size=1 << 20, h=3, k=22, spans=(22, 23, 24),
                               tile_length=F, threshold=10, vote_topk=K,
                               vote_min=vote_min)
        g0, o0 = hard.vote_case(None, 32, T, F, 3, K, vote_min, 10, seed=3)
        for ranked in (False, True):
            w, g = hard.vote_words(), g0
            if ranked:
                w = np.append(w & np.uint32(0xBFFFFFFF), np.uint32(0))
                g = np.where(g0 == hard.ABSENT, w.size - 1, g0)
            words = torch.from_numpy(w.view(np.int32).copy()).to(dev)
            grid = torch.from_numpy(g).to(dev)
            ok = torch.from_numpy(o0).to(dev)
            for rows in (slice(0, 32), slice(0, 1), slice(5, 6),
                         slice(31, 32)):
                gg, oo = grid[rows].contiguous(), ok[rows].contiguous()
                err_b = max(err_b, max_abs_err(zip(
                    dm.probe_and_vote(words, gg, oo, params, T, ranked),
                    dm._probe_and_vote_plain(words, gg, oo, params, T,
                                             ranked))))
    err_c = 0
    for n, T2 in (([0, 1, 2, 3, 14, 15, 16, T] * 4, T),
                  ([2048, 5, 1500, 0], 2048)):
        args = [torch.from_numpy(a).to(dev)
                for a in hard.classify_case(n, T2, K, seed=T2)]
        for rows in [slice(0, len(n))] + [slice(i, i + 1) for i in range(4)]:
            a = [x[rows].contiguous() for x in args]
            ck = clf.classify_batch(*a, 10, 5, 1, debug=True)
            cp = clf._classify_plain(a[0], a[2], a[3], a[4], 10, 5, 1, True)
            err_c = max(err_c, max_abs_err(list(zip(ck[0], cp[0]))
                                           + [(ck[1], cp[1]),
                                              (ck[2], cp[2])]))
    say("kernels", kernel="hard_cases", probe_vote_max_abs_err=err_b,
        classify_max_abs_err=err_c)
    return err_b, err_c


def cummax_check(dev) -> dict:
    """C's warp cummax, launched alone (row_cummax), against torch.cummax
    at C's shapes, B=32 and B=1 reads of 20 tiles and 4 of 2,048: rows of
    run starts (a tile's index where a run of bools opens, else 0), as
    passes 5 and 10 give it, and rows of any int32; both timed at 32 x 20,
    where torch.cummax is the plain version and the library call alike.
    Returns its record, keys prefixed `cummax_`."""
    import numpy as np
    import torch
    from goldrush_tpu_torch.path import classify as clf
    rng = np.random.default_rng(4)
    err = 0
    for R, T in ((32, 20), (1, 20), (4, 2048)):
        bv = rng.random((R, T)) < 0.6
        starts = np.where(bv & ~np.roll(bv, 1, axis=1), np.arange(T), 0)
        starts[:, 0] = 0
        for x in (starts, rng.integers(-2**31, 2**31, (R, T))):
            xd = torch.from_numpy(x.astype(np.int32)).to(dev)
            err = max(err, max_abs_err([(clf.row_cummax(xd),
                                         torch.cummax(xd, 1).values)]))
        if R == 32:
            ms = cuda_ms(lambda: clf.row_cummax(xd), 20)
            lib = cuda_ms(lambda: torch.cummax(xd, 1), 20)
            rec = checked(err, ms, lib, 2 * xd.numel() * 4)
    rec.update(max_abs_err=err, library_ms=rec["plain_ms"])
    say("kernels", kernel="row_cummax", shapes="32x20,1x20,4x2048",
        max_abs_err=err, ms=f"{rec['ms']:.4f}",
        library_ms=f"{rec['library_ms']:.4f}",
        bound_ms=f"{rec['bound_ms']:.6f}")
    return {f"cummax_{k}": v for k, v in rec.items()}


def max_abs_err(pairs) -> int:
    """Largest |a - b| over pairs of integer tensors (exactness check)."""
    worst = 0
    for a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        d = (a.long() - b.long()).abs().max().item() if a.numel() else 0
        worst = max(worst, int(d))
    return worst


def hard_recruits(limit: int, T: int, TL: int) -> list:
    """Recruits that kernel D's key partition finds hard, as (grid, lo, hi,
    base, trimmed) on the card: keys all owned by its first CTA, over a
    2-tile window that fits one CTA's shared memory and over the full
    window, which does not; and a repeated k-mer (one key per seed at every
    frame), which puts 20,000 entries into each of up to three CTAs."""
    import numpy as np
    import torch
    from goldrush_tpu_torch.mibf import mibf as dm
    rng = np.random.default_rng(9)
    keys = torch.from_numpy(rng.integers(0, limit, 1_000_000))
    pool = keys[dm.insert_part(keys) == 0]
    one = pool[torch.from_numpy(rng.integers(0, len(pool), (3, T * TL)))]
    homo = torch.from_numpy(
        np.repeat(rng.integers(0, limit, (3, 1)), T * TL, axis=1))
    one, homo = one.to("cuda"), homo.to("cuda")
    return [(one, 4, 5, 21, True), (one, 0, T - 1, 23, False),
            (homo, 0, T - 1, 25, False), (homo, 1, 18, 27, True)]


def stride_recruits(strided: dict, T: int) -> list:
    """Recruits of the insert grids at insert strides (S -> grid [B, h,
    T*TL/S]): a whole one and a trimmed one of each, as (grid, lo, hi,
    base, trimmed)."""
    out = []
    for S, g in strided.items():
        out += [(g[0], 0, T - 1, 31 + S, False), (g[1], 3, 14, 41 + S, True)]
    return out


def insert_phase(state_k, state_p, recruits, timed, params, T, limit,
                 or_bits, label, strided: dict) -> tuple:
    """Kernel D on state_k and its plain version on state_p, both (table,
    counts), recruit after recruit, those of the insert grids at insert
    strides (`strided`: S -> grid, F = TL / S frames per tile) last; then
    both timed on scratch copies for the full recruit of grid `timed` and a
    2-tile trimmed one, the window read alone (key limit 0: every CTA
    streams the window and owns no key), and the full recruit of row 2 of
    each strided grid (ms_s2, ms_s8, ...).  Returns the record of the full
    recruit, whose bound counts the window's grid entries, each distinct
    key's counter read and written, and the words it accepts."""
    import torch
    from goldrush_tpu_torch.mibf import mibf as dm
    recruits = recruits + stride_recruits(strided, T)
    for grid, lo, hi, base, tr in recruits:
        dm.insert_blocks(*state_k, grid, lo, hi, base, tr, params, T, limit,
                         or_bits)
        dm._insert_plain(*state_p, grid, lo, hi, base, tr, params, T, limit,
                         or_bits)
    err = max_abs_err(zip(state_k, state_p))
    k = [t.clone() for t in state_k]
    p = [t.clone() for t in state_k]

    def nbytes_of(g):
        q = [t.clone() for t in state_k]
        dm._insert_plain(*q, g, 0, T - 1, 17, False, params, T, limit,
                         or_bits)
        accepted = int((q[0] != state_k[0]).sum())
        keys = torch.unique(g[g < limit])
        return g.numel() * 8 + keys.numel() * 8 + accepted * 4
    nbytes = nbytes_of(timed)
    extra = {}
    for S, g in strided.items():
        r = checked(0, cuda_ms(lambda: dm.insert_blocks(
            *k, g[2], 0, T - 1, 17, False, params, T, limit, or_bits), 20),
            cuda_ms(lambda: dm._insert_plain(
                *p, g[2], 0, T - 1, 17, False, params, T, limit, or_bits), 3),
            nbytes_of(g[2]))
        extra.update({f"{key}_s{S}": r[key]
                      for key in ("ms", "plain_ms", "bound_ms")})
    times = {}
    for name, lo, hi, tr in (("full", 0, T - 1, False), ("2tile", 4, 5, True)):
        times[name] = (
            cuda_ms(lambda: dm.insert_blocks(*k, timed, lo, hi, 17, tr, params,
                                             T, limit, or_bits), 20),
            cuda_ms(lambda: dm._insert_plain(*p, timed, lo, hi, 17, tr, params,
                                             T, limit, or_bits), 3))
    window = cuda_ms(lambda: dm._insert_cuda(*k, timed, 0, T - 1, 17, False,
                                             params, T, 0, or_bits), 20)
    (ms, pms), (ms2, pms2) = times["full"], times["2tile"]
    say("kernels", kernel="insert_sorted", filter=label,
        recruits=len(recruits), max_abs_err=err, ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}", ms_2tile=f"{ms2:.4f}",
        plain_ms_2tile=f"{pms2:.4f}", window_ms=f"{window:.4f}",
        window_share=f"{window / ms:.4f}",
        **{key: f"{v:.4f}" for key, v in extra.items()})
    return checked(err, ms, pms, nbytes, **extra)


def insert_max_phase(table, recruits, timed, params, T, limit, or_bits,
                     label, strided: dict) -> dict:
    """insert_max on `table` and its plain version on a copy, recruit after
    recruit, those of the insert grids at insert strides (`strided`) last;
    then, on scratch copies, both timed for the full recruit of grid
    `timed` and a 2-tile trimmed one, and for the full recruit of row 2 of
    each strided grid (ms_s2, ms_s8, ...), and torch's scatter_reduce_
    (amax) for the full recruit from its keys and values precomputed (the
    library yardstick, held to the kernel's result).  Returns the full
    recruit's record, whose bound counts the window's grid entries read
    and one 32-byte sector per distinct key written."""
    import torch
    from goldrush_tpu_torch.mibf import mibf as dm
    bs = params.block_size
    recruits = recruits + stride_recruits(strided, T)
    before, plain = table.clone(), table.clone()
    for grid, lo, hi, base, tr in recruits:
        dm.insert_max(table, grid, lo, hi, base, tr, params, T, limit,
                      or_bits)
        dm._insert_max_plain(plain, grid, lo, hi, base, tr, bs, T, limit,
                             or_bits)
    err = max_abs_err([(table, plain)])
    changed = int((table != before).sum())
    del before
    H, TF = timed.shape
    cols = torch.arange(TF, device=timed.device) // (TF // T) // bs
    real = timed < limit
    keys = timed[real]
    vals = (or_bits | (17 + cols)).to(torch.int32).expand(H, -1)[real]
    k, lib = table.clone(), table.clone()
    dm.insert_max(k, timed, 0, T - 1, 17, False, params, T, limit, or_bits)
    lib.scatter_reduce_(0, keys, vals, "amax")
    err = max(err, max_abs_err([(k, lib)]))
    accepted = int((k != table).sum())
    times = {}
    for name, lo, hi, tr in (("full", 0, T - 1, False), ("2tile", 4, 5, True)):
        times[name] = (
            cuda_ms(lambda: dm.insert_max(k, timed, lo, hi, 17, tr, params,
                                          T, limit, or_bits), 20),
            cuda_ms(lambda: dm._insert_max_plain(plain, timed, lo, hi, 17, tr,
                                                 bs, T, limit, or_bits), 3))
    lib_ms = cuda_ms(lambda: lib.scatter_reduce_(0, keys, vals, "amax"), 20)
    (ms, pms), (ms2, pms2) = times["full"], times["2tile"]
    distinct = torch.unique(keys).numel()
    extra = {}
    for S, g in strided.items():
        r = checked(0, cuda_ms(lambda: dm.insert_max(
            k, g[2], 0, T - 1, 17, False, params, T, limit, or_bits), 20),
            cuda_ms(lambda: dm._insert_max_plain(
                plain, g[2], 0, T - 1, 17, False, bs, T, limit, or_bits), 3),
            g[2].numel() * 8 + torch.unique(g[2][g[2] < limit]).numel() * 32)
        extra.update({f"{key}_s{S}": r[key]
                      for key in ("ms", "plain_ms", "bound_ms")})
    say("kernels", kernel="insert_max", filter=label,
        recruits=len(recruits), max_abs_err=err, changed=changed,
        accepted=accepted,
        distinct_keys=distinct, ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
        library_ms=f"{lib_ms:.4f}", ms_2tile=f"{ms2:.4f}",
        plain_ms_2tile=f"{pms2:.4f}",
        **{key: f"{v:.4f}" for key, v in extra.items()})
    if changed == 0 or accepted == 0:
        raise AssertionError(f"insert_max {label}: degenerate check inputs")
    rec = checked(err, ms, pms, timed.numel() * 8 + distinct * 32,
                  ms_2tile=ms2, plain_ms_2tile=pms2, **extra)
    rec["library_ms"] = lib_ms
    return rec


def strided_grids(codes, lengths, params, cs, n_care) -> tuple:
    """Kernel A's slot and rank grid entries at a frame stride against their
    plain versions (the JAX package's sampled routes: the last-tile grid at
    S >= h, the general one below) in both slot maps: the throughput
    mode's query grid (B=64, h=1, S=8), S=2 and S=4 with h=3 at B=32
    (slots a CTA a tile below S = h and a thread a frame from S = h;
    ranks of three seeds a CTA a tile), and the
    full-resolution grid a B=64 throughput batch inserts from (h=3, S=1),
    each timed in the fastrange map; and the grid cases of
    hard_cases.grid_lengths at S=8 with h=1 and S=2 and 4 with h=3.
    Returns the two entries' extra record keys and their max_abs_err."""
    import dataclasses

    import torch
    from goldrush_tpu_torch import hard_cases as hard
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.ops.nthash import build_seed_family
    from goldrush_tpu_torch.ops.seeds import make_seed_pattern
    dev = torch.device("cuda", 0)
    seeds = make_seed_pattern(PRESET, 22, 16, 3)
    fams = {h: build_seed_family(seeds[:h]) for h in (1, 3)}
    T, TL, size = 20, params.tile_length, params.size

    def par(h, S, mode="fastrange"):
        return dataclasses.replace(
            params, h=h, spans=fams[h].spans, frame_stride=S,
            threshold=max(1, params.threshold // S), slot_map=mode,
            vote_min=2 if S == 1 else max(1, 2 // S))

    def both(c, n, h, S, mode, Tg):
        """Both entries on the card and plain: their max_abs_err, and the
        kernel's slots and frame_ok (and ranks and frame_ok)."""
        p = par(h, S, mode)
        sk = dm.build_slot_grid(c, n, fams[h], p, Tg)
        rk = cz.build_rank_grid(cs, c, n, fams[h], p, Tg)
        es = max_abs_err(zip(sk, dm._build_slot_grid_plain(c, n, fams[h], p,
                                                            Tg)))
        er = max_abs_err(zip(rk, cz._build_rank_grid_plain(cs, c, n, fams[h],
                                                            p, Tg)))
        return es, er, sk, rk
    slot_rec, rank_rec = {}, {}
    err_s = err_r = 0
    apart = {}               # (tag, mode) -> the two entries' grids
    for tag, (B, h, S) in {"s8": (64, 1, 8), "s2": (32, 3, 2),
                           "s4": (32, 3, 4),
                           "ins_b64": (64, 3, 1)}.items():
        qc = torch.from_numpy(codes[:B, : T * TL + TL].copy()).to(dev)
        ql = torch.from_numpy(lengths[:B].copy()).to(dev)
        for mode in ("mod", "fastrange"):
            es, er, (slots, ok), ranks = both(qc, ql, h, S, mode, T)
            err_s, err_r = max(err_s, es), max(err_r, er)
            apart[tag, mode] = (slots, ok, *ranks)
        p, fam = par(h, S), fams[h]
        n_ok = int(ok.sum())
        ops = hash_ops(n_ok, n_ok * h, len(fam.care_left)
                       + len(fam.care_right))
        # codes in, slots (ranks) + frame_ok out; the rank entry also
        # gathers each distinct bitrank word once
        nbytes = qc.numel() + ql.numel() * 4 + slots.numel() * 8 + ok.numel()
        words = torch.unique(slots[slots < size] >> 5).numel()
        for rec, fn, plain, extra in (
                (slot_rec, lambda: dm.build_slot_grid(qc, ql, fam, p, T),
                 lambda: dm._build_slot_grid_plain(qc, ql, fam, p, T), 0),
                (rank_rec, lambda: cz.build_rank_grid(cs, qc, ql, fam, p, T),
                 lambda: cz._build_rank_grid_plain(cs, qc, ql, fam, p, T),
                 words * 8)):
            r = checked(0, cuda_ms(fn, 20), cuda_ms(plain, 3),
                        nbytes + extra, ops)
            rec.update({f"{k}_{tag}": r[k]
                        for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
        say("kernels", kernel="seed_hash_grid+rank_grid", stride=S, h=h,
            shape=f"{B}x{h}x{slots.shape[2]}",
            ms=f"{slot_rec['ms_' + tag]:.4f}",
            plain_ms=f"{slot_rec['plain_ms_' + tag]:.4f}",
            bound_ms=f"{slot_rec['bound_ms_' + tag]:.4f}",
            rank_ms=f"{rank_rec['ms_' + tag]:.4f}",
            rank_plain_ms=f"{rank_rec['plain_ms_' + tag]:.4f}",
            rank_bound_ms=f"{rank_rec['bound_ms_' + tag]:.4f}")
    if hasattr(dm, "build_slot_grids"):
        # the throughput batch's query grid (s8) written by its insert
        # grid's launch (ins_b64), against the two separate launches above
        # (the parent's design) bit for bit, and timed
        es, er = fused_grid(qc, ql, fams, par, cs, apart, T, slot_rec,
                            rank_rec, n_care)
        err_s, err_r = max(err_s, es), max(err_r, er)
    cases = hard.grid_lengths(TL, 22)
    for h, S in ((1, 8), (3, 2), (3, 4)):
        for case, (lens, Tc) in cases.items():
            c, n = (torch.from_numpy(a).to(dev) for a in
                    hard.read_batch(lens, Tc * TL + TL, seed=len(case)))
            for mode in ("mod", "fastrange"):
                es, er, *_ = both(c, n, h, S, mode, Tc)
                err_s, err_r = max(err_s, es), max(err_r, er)
    say("kernels", kernel="seed_hash_grid+rank_grid", strides="8,2,4",
        grid_cases=len(cases), max_abs_err=max(err_s, err_r))
    return slot_rec, rank_rec, err_s, err_r


def fused_grid(qc, ql, fams, par, cs, apart, T, slot_rec, rank_rec,
               n_care) -> tuple:
    """Kernel A's insert grid of a throughput batch (B=64, h=3, S=1) with
    its query grid (h=1, S=8) written by the same launch
    (build_slot_grids, build_rank_grids) against the two separate launches
    (`apart`: (tag, mode) -> slots, frame_ok, ranks, frame_ok) and the
    plain versions, in both slot maps; timed in the fastrange map beside
    its bound (the codes in, both grids and frame_oks out, the insert
    grid's hashing; the rank entry also gathers each distinct bitrank word
    once).  Adds ms_fused, plain_ms_fused, bound_ms_fused to both records;
    returns their max_abs_err."""
    import torch
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm

    def plain_s(pi, pq):
        g = dm._build_slot_grid_plain(qc, ql, fams[3], pi, T)
        return (*dm.query_of(*g, pq, pi), *g)

    def plain_r(pi, pq):
        g = cz._build_rank_grid_plain(cs, qc, ql, fams[3], pi, T)
        return (*dm.query_of(*g, pq, pi), *g)
    err_s = err_r = 0
    for mode in ("mod", "fastrange"):
        pq, pi = par(1, 8, mode), par(3, 1, mode)
        two_s = apart["s8", mode][:2] + apart["ins_b64", mode][:2]
        two_r = apart["s8", mode][2:] + apart["ins_b64", mode][2:]
        got_s = dm.build_slot_grids(qc, ql, fams[3], pi, pq, T)
        got_r = cz.build_rank_grids(cs, qc, ql, fams[3], pi, pq, T)
        err_s = max(err_s, max_abs_err(zip(got_s, two_s)),
                    max_abs_err(zip(got_s, plain_s(pi, pq))))
        err_r = max(err_r, max_abs_err(zip(got_r, two_r)),
                    max_abs_err(zip(got_r, plain_r(pi, pq))))
    pq, pi = par(1, 8), par(3, 1)
    q, oq, g, og = got_s
    n_ok = int(og.sum())
    nbytes = (qc.numel() + ql.numel() * 4 + (q.numel() + g.numel()) * 8
              + oq.numel() + og.numel())
    ops = hash_ops(n_ok, n_ok * 3, n_care)
    words = torch.unique(g[g < pi.size] >> 5).numel()
    for rec, fn, plain, extra in (
            (slot_rec, lambda: dm.build_slot_grids(qc, ql, fams[3], pi, pq,
                                                   T),
             lambda: plain_s(pi, pq), 0),
            (rank_rec, lambda: cz.build_rank_grids(cs, qc, ql, fams[3], pi,
                                                   pq, T),
             lambda: plain_r(pi, pq), words * 8)):
        r = checked(0, cuda_ms(fn, 20), cuda_ms(plain, 3), nbytes + extra,
                    ops)
        rec.update({f"{k}_fused": r[k]
                    for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    say("kernels", kernel="seed_hash_grid+rank_grid", fused="s8_in_ins_b64",
        max_abs_err=max(err_s, err_r), ms=f"{slot_rec['ms_fused']:.4f}",
        apart_ms=f"{slot_rec['ms_s8'] + slot_rec['ms_ins_b64']:.4f}",
        insert_grid_ms=f"{slot_rec['ms_ins_b64']:.4f}",
        bound_ms=f"{slot_rec['bound_ms_fused']:.4f}",
        rank_ms=f"{rank_rec['ms_fused']:.4f}",
        rank_apart_ms=f"{rank_rec['ms_s8'] + rank_rec['ms_ins_b64']:.4f}",
        rank_insert_grid_ms=f"{rank_rec['ms_ins_b64']:.4f}",
        rank_bound_ms=f"{rank_rec['bound_ms_fused']:.4f}")
    return err_s, err_r


def minimizer_edges(dev, k: int, w: int) -> int:
    """K20 against its plain version on batches whose windows end on the
    kernel's tile edges (hard_cases.minimizer_tile: two tiles exactly, and
    one window more, the edge rows of minimizer_lengths among them), with
    the codes at a 16-byte-aligned address and 5 bytes past one; the
    largest difference.  An earlier tree without minimizer_tile takes its
    own tile of 2,048 windows."""
    import torch
    from goldrush_tpu_torch import hard_cases as hard
    from goldrush_tpu_torch.ops import minimizers as tmin
    tw = hard.minimizer_tile(k, w)[1] if hasattr(hard, "minimizer_tile") \
        else 2048
    err = 0
    for n_win in (2 * tw, 2 * tw + 1):
        L = n_win + w - 1 + k - 1
        lengths = hard.minimizer_lengths(k, w, L, 12)
        codes, _ = hard.stage_codes(lengths, L, seed=n_win, n_frac=0.01)
        for offset in (0, 5):
            buf = torch.zeros(codes.size + 16, dtype=torch.uint8,
                              device=dev)
            c = buf[offset: offset + codes.size].view(codes.shape)
            c.copy_(torch.from_numpy(codes))
            P = L - k + 1
            err = max(err, max_abs_err(zip(
                tmin.minimizer_keys(c, k, w, P),
                tmin._minimizer_keys_plain(c, k, w, P))))
    return err


def minimizer_check(dev) -> dict:
    """K20 against its plain version at the slice's shapes, bit for bit:
    32 x 32,768 codes (1% N) at (k, w) = (15, 10), (40, 250) and (32,
    1,000), the first rows of each batch as long as the windows branch on
    (shorter than k + w - 1, one window, one tile of 2,048 windows and one
    more, one and two of the kernel's tiles and one more:
    hard_cases.minimizer_lengths); batches whose windows end on the
    kernel's tile edges (2 tiles exactly, and one window more) with codes
    at a 16-byte-aligned address and 5 bytes past one; one 2^20-wide chunk
    (the mapper's position-packing limit) at (15, 10) and (32, 1,000); and
    rows narrower than k + w - 1.  Each 32-row shape is timed beside the
    plain version and the library call, unfold(1, w, 1).amin(-1) on its
    keys precomputed with the sign bit flipped (held to the kernel's
    keys).  Returns the (15, 10) record, the others under suffixed keys."""
    import torch
    from goldrush_tpu_torch import hard_cases as hard
    from goldrush_tpu_torch.ops import minimizers as tmin
    from goldrush_tpu_torch.stages import mapping as tmap
    sign = -(1 << 63)
    W, err, rec = 32_768, 0, {}
    for k, w in ((15, 10), (40, 250), (32, 1000)):
        lengths = hard.minimizer_lengths(k, w, W, 32)
        codes, _ = hard.stage_codes(lengths, W, seed=k + w, n_frac=0.01)
        c = torch.from_numpy(codes).to(dev)
        P = W - k + 1
        keys, hashes = tmin.minimizer_keys(c, k, w, P)
        err = max(err, max_abs_err(zip((keys, hashes),
                                       tmin._minimizer_keys_plain(c, k, w,
                                                                  P))))
        flipped = ((hashes & ~tmin.POS_MASK)
                   | torch.arange(P, device=dev)) ^ sign
        err = max(err, max_abs_err([(flipped.unfold(1, w, 1).amin(-1) ^ sign,
                                     keys)]))
        ms = cuda_ms(lambda: tmin.minimizer_keys(c, k, w, P), 20)
        pms = cuda_ms(lambda: tmin._minimizer_keys_plain(c, k, w, P), 3)
        lib = cuda_ms(lambda: flipped.unfold(1, w, 1).amin(-1), 3)
        # codes in, keys and hashes out; per position both strands' hash,
        # the canonical min and the key (~40 operations), per window the
        # function's least work, about three 64-bit mins (~5 each: a
        # van Herk/Gil-Werman prefix, suffix and their min)
        nw = keys.shape[1]
        r = checked(0, ms, pms, c.numel() + (keys.numel() + hashes.numel())
                    * 8, 32 * (P * 40 + nw * 3 * 5))
        r["library_ms"] = lib
        tag = "" if (k, w) == (15, 10) else f"_k{k}_w{w}"
        rec.update({f"{key}{tag}": r[key] for key in
                    ("ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")})
        say("kernels", kernel="minimizer_keys", shape=f"32x{W}", k=k, w=w,
            ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", library_ms=f"{lib:.4f}",
            bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"])
    for k, w in ((15, 10), (40, 250), (32, 1000)):
        err = max(err, minimizer_edges(dev, k, w))
    L = tmap.MAX_SEQ - 2
    codes, _ = hard.stage_codes([L], L, seed=5)
    c = torch.from_numpy(codes).to(dev)
    for k, w in ((15, 10), (32, 1000)):
        err = max(err, max_abs_err(zip(
            tmin.minimizer_keys(c, k, w, L - k + 1),
            tmin._minimizer_keys_plain(c, k, w, L - k + 1))))
    rec["ms_chunk"] = cuda_ms(lambda: tmin.minimizer_keys(c, 15, 10,
                                                          L - 14), 20)
    short, _ = hard.stage_codes([30, 7, 0, 40], 40, seed=6)
    s = torch.from_numpy(short).to(dev)
    for k, w in ((15, 10), (24, 100), (32, 1000)):
        P = max(40 - k + 1, w)
        err = max(err, max_abs_err(zip(tmin.minimizer_keys(s, k, w, P),
                                       tmin._minimizer_keys_plain(s, k, w,
                                                                  P))))
    rec["max_abs_err"] = err
    say("kernels", kernel="minimizer_keys", chunk=L,
        ms_chunk=f"{rec['ms_chunk']:.4f}", short_rows=4, max_abs_err=err)
    return rec


def kmer_check(dev) -> tuple[dict, dict]:
    """K21 against its plain versions at the slice's shapes, bit for bit:
    the count of 64 x 32,768 reads into a 2^22+1-slot table, then of a
    homopolymer batch (every position adds to one slot), at k = 32 (the
    polish schedule's largest) and at 13 and 24 (targeted polish); the
    query of one 1 Mbp contig row and of 40,000 candidate windows of width
    2k + 2 on the filled table; both also on rows of one k-mer (P = 1) and
    on the candidate windows 5 bytes past a 16-byte-aligned address.
    Timed at k = 32 beside the plain versions and the library calls on
    the slots precomputed: index_add_ for the count, advanced indexing for
    the query (both held to the kernels); the query's launch alone (`ms`,
    as its plain version is timed) and with the wrapper's valid mask
    (`ms_wrapper`).  Returns the count's and the query's records (the
    candidate batch; the contig row under `_contig`)."""
    import numpy as np
    import torch
    from goldrush_tpu_torch import hard_cases as hard
    from goldrush_tpu_torch.stages import polish as tpol
    size = (1 << 22) | 1
    W = 32_768
    codes, lens = hard.stage_codes([W] * 64, W, seed=11)
    homo = np.full((64, W), 2, np.uint8)
    contig, _ = hard.stage_codes([1_000_000], 1_000_000, seed=12)
    one = torch.tensor([1_000_000], device=dev)
    batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(n).to(dev))
               for x, n in ((codes, lens), (homo, lens))]
    err_c = err_q = 0
    for k in (32, 13, 24):
        ck = torch.zeros(size + 1, dtype=torch.int32, device=dev)
        cp = ck.clone()
        for c, n in batches:
            tpol.count_kmers(ck, c, n, k, size)
            tpol._count_kmers_plain(cp, c, n, k, size)
            err_c = max(err_c, max_abs_err([(ck, cp)]))
        cand = [torch.from_numpy(x).to(dev) for x in
                hard.candidate_windows(contig[0], 40_000, k, seed=k)]
        rows = torch.from_numpy(contig).to(dev)
        buf = torch.zeros(cand[0].numel() + 16, dtype=torch.uint8,
                          device=dev)
        shifted = buf[5: 5 + cand[0].numel()].view(cand[0].shape)
        shifted.copy_(cand[0])
        ones = torch.from_numpy(hard.stage_codes(
            np.random.default_rng(k).integers(k - 1, k + 1, 5_000), k,
            seed=k)[0]).to(dev)
        edges = ((shifted, cand[1]),
                 (ones, torch.full((5_000,), k, device=dev)))
        for c, n in edges:
            cp = ck.clone()
            tpol.count_kmers(cp, c, n, k, size)
            tpol._count_kmers_plain(ck, c, n, k, size)
            err_c = max(err_c, max_abs_err([(ck, cp)]))
        for c, n in ((rows, one), cand) + edges:
            err_q = max(err_q, max_abs_err(zip(
                tpol.query_kmers(ck, c, n, k, size),
                (tpol._query_kmers_plain(ck, c, k, size),
                 tpol._valid(n, k, c.shape[1] - k + 1)))))
        if k == 32:
            table, cand32 = ck, cand
    k = 32
    c, n = batches[0]
    slots = tpol._slots_plain(c, k, size).reshape(-1)
    ones = torch.ones_like(slots, dtype=torch.int32)
    lib_t = table.clone()
    scratch = table.clone()
    tpol.count_kmers(scratch, c, n, k, size)
    lib_t.index_add_(0, slots, ones)
    err_c = max(err_c, max_abs_err([(scratch, lib_t)]))
    ms = cuda_ms(lambda: tpol.count_kmers(scratch, c, n, k, size), 20)
    pms = cuda_ms(lambda: tpol._count_kmers_plain(scratch, c, n, k, size), 3)
    lib = cuda_ms(lambda: lib_t.index_add_(0, slots, ones), 20)
    homo_ms = cuda_ms(lambda: tpol.count_kmers(scratch, *batches[1], k,
                                               size), 5)
    distinct = torch.unique(slots).numel()
    # codes and lengths in; each distinct slot read and written once; per
    # position the rolling hash of both strands and the slot's multiply
    # (~50 operations)
    count = checked(err_c, ms, pms, c.numel() + n.numel() * 8
                    + distinct * 8, slots.numel() * 50, ms_homopolymer=homo_ms)
    count["library_ms"] = lib
    say("kernels", kernel="kmer_count", shape=f"64x{W}", k=k, table=size,
        distinct_slots=distinct, max_abs_err=err_c, ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}", library_ms=f"{lib:.4f}",
        ms_homopolymer=f"{homo_ms:.4f}", bound_ms=f"{count['bound_ms']:.4f}",
        bound_by=count["bound_by"])
    query = {}
    for tag, (c, n) in (("", cand32), ("_contig", (rows, one))):
        sl = tpol._slots_plain(c, k, size)
        got = tpol.query_kmers(table, c, n, k, size)[0]
        err_q = max(err_q, max_abs_err([(got, table[sl])]))
        ms = cuda_ms(lambda: tpol._query_kmers_cuda(table, c, k, size), 20)
        ms_wrapper = cuda_ms(lambda: tpol.query_kmers(table, c, n, k, size),
                             20)
        pms = cuda_ms(lambda: tpol._query_kmers_plain(table, c, k, size), 3)
        lib = cuda_ms(lambda: table[sl], 20)
        distinct = torch.unique(sl).numel()
        # codes in, counts out, each distinct slot read once
        r = checked(0, ms, pms, c.numel() + got.numel() * 4 + distinct * 4,
                    sl.numel() * 50, ms_wrapper=ms_wrapper)
        r["library_ms"] = lib
        query.update({f"{key}{tag}": r[key] for key in
                      ("ms", "ms_wrapper", "plain_ms", "bound_ms",
                       "bound_by", "library_ms")})
        say("kernels", kernel="kmer_query", shape="x".join(
            map(str, c.shape)), k=k, ms=f"{ms:.4f}",
            ms_wrapper=f"{ms_wrapper:.4f}", plain_ms=f"{pms:.4f}",
            library_ms=f"{lib:.4f}", bound_ms=f"{r['bound_ms']:.4f}",
            bound_by=r["bound_by"])
    query["max_abs_err"] = err_q
    say("kernels", kernel="kmer_count+kmer_query", ks="32,13,24",
        max_abs_err=max(err_c, err_q))
    return count, query


@contextlib.contextmanager
def plain_steps(spec, grid, grid_ins, limit):
    """Record the steps of consume_batch_plain on one batch by wrapping the
    plain functions it calls: ("live", i), ("recheck", i), ("insert", i,
    lo, hi, keys, accepted) (the window's distinct real keys and, under the
    exact policy, the words it changed) and ("reset",)."""
    import torch
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.path import consume as tcons
    steps = []

    def row_of(t, base):
        return ((t.data_ptr() - base.data_ptr())
                // (base.stride(0) * base.element_size()))

    def probe(table, ranked, g, ok, n_tiles, params, *rest):
        live = params is spec.params
        steps.append(("live" if live else "recheck",
                      row_of(g, grid if live else grid_ins)))
        return orig["probe"](table, ranked, g, ok, n_tiles, params, *rest)

    def window_keys(g, lo, hi, T):
        F = g.shape[1] // T
        win = g[:, lo * F: (min(hi, T - 1) + 1) * F]
        return torch.unique(win[(win >= 0) & (win < limit)])

    def insert(words, counts, g, lo, hi, base, tr, params, T, *rest):
        keys = window_keys(g, lo, hi, T)
        before = words[keys].clone()
        orig["insert"](words, counts, g, lo, hi, base, tr, params, T, *rest)
        steps.append(("insert", row_of(g, grid_ins), lo, hi, keys.numel(),
                      int((words[keys] != before).sum())))

    def insert_max(table, g, lo, hi, base, tr, bs, T, *rest):
        steps.append(("insert", row_of(g, grid_ins), lo, hi,
                      window_keys(g, lo, hi, T).numel(), None))
        orig["insert_max"](table, g, lo, hi, base, tr, bs, T, *rest)

    def reset(mod):
        def call(*args, **kwargs):
            steps.append(("reset",))
            return orig[mod](*args, **kwargs)
        return call

    orig = {"probe": tcons._probe_plain, "insert": dm._insert_plain,
            "insert_max": dm._insert_max_plain, "dm": dm.reset_ids,
            "cz": cz.reset_ids}
    tcons._probe_plain, dm._insert_plain = probe, insert
    dm._insert_max_plain = insert_max
    dm.reset_ids, cz.reset_ids = reset("dm"), reset("cz")
    try:
        yield steps
    finally:
        tcons._probe_plain, dm._insert_plain = orig["probe"], orig["insert"]
        dm._insert_max_plain = orig["insert_max"]
        dm.reset_ids, cz.reset_ids = orig["dm"], orig["cz"]


def consume_bytes(te, inputs, steps, filt, T: int) -> int:
    """The bytes a consume batch must move, from the plain version's steps
    on this run's batch (`plain_steps`): the batched rows in and the rows
    out; per probe (live or recheck) its grid row, frame_ok and one 4-byte
    word per present frame and seed, and its row; per insert its window,
    and each distinct key's counter read and written and each word it
    accepts written (the exact policy, as kernel D's bound counts them) or
    each distinct key's entry read and written (insert_max); per reset the
    table read and written (the counters written under the exact
    policy)."""
    from goldrush_tpu_torch.mibf import compressed as cz
    grid, ok, grid_ins, ok_ins, _, _, rows0 = inputs
    compressed = isinstance(filt, cz.CompressedState)
    table = filt.ids if compressed else filt.words
    limit = filt.sentinel if compressed else te.size
    exact = not te.fast
    F = grid_ins.shape[2] // T             # the insert grid's frames a tile
    nbytes = rows0.numel() * 8 + rows0.shape[0] * 64 + 64
    for step in steps:
        kind = step[0]
        if kind in ("live", "recheck"):
            i = step[1]
            g, o = (grid, ok) if kind == "live" else (grid_ins, ok_ins)
            real = (g[i] < limit) & o[i][None, :] if compressed else \
                o[i][None, :].expand(g.shape[1], -1)
            nbytes += g[i].numel() * 8 + o[i].numel() + 4 * int(real.sum()) \
                + 64
        elif kind == "insert":
            _, i, lo, hi, keys, accepted = step
            nbytes += grid_ins.shape[1] * (min(hi, T - 1) - lo + 1) * F * 8
            nbytes += keys * 8 + (accepted * 4 if exact else 0)
        else:
            nbytes += table.numel() * 4 * (1 if compressed else 2) \
                + (table.numel() * 4 if exact else 0)
    return nbytes


def barrier_counts(steps, fast: bool) -> tuple[int, int]:
    """Grid barriers of one batch, from the plain version's steps
    (`plain_steps`), under this tree's consume kernel and under the design
    it replaced.  This one: a probe round (a live probe, with a recheck
    beside it, or a recheck alone) crosses one barrier after its gathers,
    and one before them if the filter was written since the last barrier;
    an exact insert that was not probed crosses one after its scatter;
    insert_max needs one only after a reset; a reset one after any write;
    one at the end.  The replaced design: each probe one, plus one before
    it, before an insert and before a reset after a write; one at the
    end."""
    new, old = 1, 1
    dirty = 0                     # 0 clean, 1 insert_max only, 2 written
    old_dirty = False
    probed = set()
    for step in steps:
        kind = step[0]
        if kind in ("live", "recheck"):
            old += 1 + old_dirty
            old_dirty = False
            if step[1] not in probed:
                probed.add(step[1])
                new += 1 + (dirty != 0)
                dirty = 0
        elif kind == "insert":
            old += old_dirty
            old_dirty = True
            if fast:
                new += dirty == 2
                dirty = 1
            else:
                new += step[1] not in probed
                dirty = 2
        else:
            old += old_dirty
            old_dirty = True
            new += dirty != 0
            dirty = 2
    return new, old


def timed_consume(te, filt, inputs, rows0, T, dev, want, reps=21,
                  spec=None) -> float:
    """The median device time of one consume launch on `inputs` with
    `rows0`, the filter restored before each launch outside the timed
    span, from scal [0, 0, 1, 0]; its counters must equal `want`."""
    import torch
    from goldrush_tpu_torch.path import consume as tcons
    saved = [t.clone() for t in filt]
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        for t, v in zip(filt, saved):
            t.copy_(v)
        scal = torch.tensor([0, 0, 1, 0], dtype=torch.int64, device=dev)
        ck = tcons.new_counters(dev)
        rows = torch.empty((rows0.shape[0], 8), dtype=torch.int64,
                           device=dev)
        torch.cuda._sleep(1_000_000)
        start.record()
        tcons.consume_batch(spec or te.spec, filt, *inputs[:-1], rows0, scal,
                            rows, ck, T)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    for t, v in zip(filt, saved):
        t.copy_(v)
    if ck.tolist() != want:
        raise AssertionError(f"consume timing batch: counters "
                             f"{ck.tolist()}, expected {want}")
    return sorted(times)[reps // 2]


def quiet_rows(rows0):
    """Batch-time rows that neither probe nor insert: drops, far from the
    recheck zone's weak gate."""
    import torch
    none = torch.zeros_like(rows0)
    if none.shape[1] > 8:
        none[:, 8] = 1_000
    return none


def insert_in_kernel_ms(te, filt, inputs, T, dev) -> tuple:
    """One whole-read insert (T tiles) inside the consume kernel: the
    median time of a batch whose last read recruits and whose other reads
    are batch-time drops, so that no read re-probes, less the median of
    the same batch with no recruit.  Returns (insert ms, the batch's ms
    without the recruit)."""
    import torch
    none = quiet_rows(inputs[-1])
    one = none.clone()
    one[-1, :4] = torch.tensor([1, 0, T - 1, T])
    base = timed_consume(te, filt, inputs, none, T, dev, [0, 0, 0, 0])
    ins = timed_consume(te, filt, inputs, one, T, dev, [0, 0, 1, 0])
    return ins - base, base


def consume_counts_of(te, filt, inputs, rows0, T, dev) -> list:
    """The counters of one consume launch on `inputs` with `rows0` from
    scal [0, 0, 1, 0], the filter restored after it."""
    import torch
    from goldrush_tpu_torch.path import consume as tcons
    saved = [t.clone() for t in filt]
    ck = tcons.new_counters(dev)
    tcons.consume_batch(te.spec, filt, *inputs[:-1], rows0,
                        torch.tensor([0, 0, 1, 0], dtype=torch.int64,
                                     device=dev),
                        torch.empty((rows0.shape[0], 8), dtype=torch.int64,
                                    device=dev), ck, T)
    for t, v in zip(filt, saved):
        t.copy_(v)
    return ck.tolist()


def probed_insert_ms(te, filt, inputs, T, dev) -> dict:
    """One whole-read insert of a probed read inside the consume kernel, on
    a batch of bench reads (rarely overlapping): read B-2 recruits at
    batch time and read B-1, a batch-time recruit, re-probes and recruits
    (one live probe, two inserts), less the same batch whose read B-1 is a
    copy of read B-2 (the same probe, then assigned: one insert).  Under
    the optimistic policy the kernel stages the probed read's keys in its
    owners' shared memory while the runners classify it: "staged" with the
    default budget, "loaded" with none (consume.STAGE_BYTES = 0; a tree
    without staging gives "staged" alone, its only design).  The filter is
    restored around every launch."""
    import torch
    from goldrush_tpu_torch.path import consume as tcons
    B = inputs[-1].shape[0]
    whole = torch.tensor([1, 0, T - 1, T])
    rows = quiet_rows(inputs[-1])
    rows[B - 2, :4] = whole
    rows[B - 1, :4] = whole
    perm = torch.cat([torch.arange(B - 1), torch.tensor([B - 2])]).to(dev)
    twin = [t[perm] for t in inputs[:-1]] + [rows]
    one = list(inputs[:-1]) + [rows]
    budgets = {"staged": getattr(tcons, "STAGE_BYTES", None)}
    if budgets["staged"] is not None:
        budgets["loaded"] = 0
    out = {}
    try:
        for name, budget in budgets.items():
            if budget is not None:
                tcons.STAGE_BYTES = budget
            want = consume_counts_of(te, filt, one, rows, T, dev)
            want_twin = consume_counts_of(te, filt, twin, rows, T, dev)
            if (want[0] != 1 or want[2] != 2 or want_twin[0] != 1
                    or want_twin[2] != 1):
                raise AssertionError(f"probed insert batches: counters "
                                     f"{want}, {want_twin}")
            out[name] = (timed_consume(te, filt, one, rows, T, dev, want)
                         - timed_consume(te, filt, twin, rows, T, dev,
                                         want_twin))
    finally:
        if budgets["staged"] is not None:
            tcons.STAGE_BYTES = budgets["staged"]
    return out


def probe_in_kernel_ms(te, filt, inputs, T, dev) -> dict:
    """One probe inside the consume kernel, on the 'overlap' batch (reads
    500 bases apart) after its read 0 was inserted: a batch whose reads
    B-2 and B-1 are reads 2 and 1, read B-2 recruits at batch time and read
    B-1 is a stale recruit, so read B-1 alone re-probes (and, sitting
    between two inserted reads, is assigned: no insert follows), less the
    same batch in which read B-1 recruits instead (one insert each, no
    probe); under the trim recheck also a batch whose read B-1 alone is a
    batch-time trim (in the zone, re-classified at full resolution, then
    assigned), less the batch of drops.  Returns {"live": ms, "recheck":
    ms or None}."""
    import torch
    from goldrush_tpu_torch.path import consume as tcons
    B = inputs[-1].shape[0]
    whole = torch.tensor([1, 0, T - 1, T])
    # read 0 into the filter (not timed)
    first = quiet_rows(inputs[-1])
    first[0, :4] = whole
    saved = [t.clone() for t in filt]
    tcons.consume_batch(te.spec, filt, *inputs[:-1], first,
                        torch.tensor([0, 0, 1, 0], dtype=torch.int64,
                                     device=dev),
                        torch.empty((B, 8), dtype=torch.int64, device=dev),
                        tcons.new_counters(dev), T)
    perm = torch.cat([torch.arange(3, B), torch.tensor([0, 2, 1])]).to(dev)
    moved = [t[perm] for t in inputs]
    none = quiet_rows(moved[-1])
    one = none.clone()
    one[B - 2, :4] = whole
    one[B - 1, :4] = whole
    other = none.clone()
    other[B - 1, :4] = whole
    out = {"live": timed_consume(te, filt, moved, one, T, dev, [1, 0, 1, 0])
           - timed_consume(te, filt, moved, other, T, dev, [0, 0, 1, 0]),
           "recheck": None}
    if te.rech_on:
        trim = none.clone()
        trim[B - 1, :4] = torch.tensor([2, 0, T - 1, T])
        out["recheck"] = (
            timed_consume(te, filt, moved, trim, T, dev, [0, 1, 0, 0])
            - timed_consume(te, filt, moved, none, T, dev, [0, 0, 0, 0]))
    for t, v in zip(filt, saved):
        t.copy_(v)
    return out


def bench_batches_ms(te, filt, reads, T, dev, n) -> dict:
    """The first `n` batches of a silver pass over the bench reads, in
    order, at bench.py's silver target (M=5, r=0.9 of 5 Mbp): each
    batch's inputs (its grids and the batched B and C against the filter
    as the batch starts), then its consume launch timed alone between
    events.  Returns the mean ms per batch and the scan's counters per
    batch (the kernel's own: this sequence has no plain run)."""
    import dataclasses

    import numpy as np
    import torch
    from goldrush_tpu_torch.path import consume as tcons
    spec = dataclasses.replace(te.spec, target=int(0.9 * BENCH["genome"]),
                               max_paths=5)
    B, L = te.batch_reads, BENCH["read_len"]
    scal = torch.tensor([0, 0, 1, 0], dtype=torch.int64, device=dev)
    ck = tcons.new_counters(dev)
    scratch = tcons.ConsumeScratch() if hasattr(tcons, "ConsumeScratch") \
        else None
    kw = {"scratch": scratch} if scratch is not None else {}
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for b in range(n):
        codes = np.zeros((B, (T + 1) * te.cfg.tile_length), np.uint8)
        codes[:, :L] = reads[b * B:(b + 1) * B].cpu().numpy()
        inputs = te._batch_inputs(codes, np.full(B, L, np.int32),
                                  np.full(B, L, np.int64), T)
        rows = torch.empty((B, 8), dtype=torch.int64, device=dev)
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        start.record()
        tcons.consume_batch(spec, filt, *inputs, scal, rows, ck, T, **kw)
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    per = {k: v / n for k, v in zip(tcons.COUNTS, ck.tolist())}
    return dict(ms=total / n, batches=n, **per)


def long_reads(genome, n: int, length: int, g):
    """`n` reads of `length` bases from the start of `genome`, 10 kb apart,
    with 5% substitutions."""
    import torch
    dev = genome.device
    starts = 10_000 * torch.arange(n, device=dev)[:, None]
    reads = genome[starts + torch.arange(length, device=dev)]
    subst = torch.rand(reads.shape, device=dev, generator=g) < \
        BENCH["err_rate"]
    return torch.where(subst, torch.randint(0, 4, reads.shape,
                                            dtype=torch.uint8, device=dev,
                                            generator=g), reads)


def consume_check(dev) -> dict:
    """K9 against its plain version on the card, bit for bit (rows, scal,
    the counters and the filter), at the main path's shapes: bench.py's
    engine (5 Mbp, h=3, 20-tile reads) in exact mode (B=32) and in the
    throughput cell (B=64, stride 8, one probed seed, trim recheck), each
    with either filter, and exact mode at insert stride 8 (F = 125 frames
    a tile in the insert grid), compressed filter, on a filter filled from
    the bench dataset's reads, and these batches in turn:
      rotate_done: recruits (the silver target cut to 100 kb, M=2) that
        rotate a silver path and then reach `done`;
      overlap: 20 kb reads 500 bases apart, so that every insert is
        followed by live re-probes of overlapping reads (the check that a
        CTA reads what another CTA wrote, through L2);
      all_live: the same reads, each a batch-time recruit, so that every
        read after the first re-probes;
      overflow: a homopolymer read first, whose three keys each take
        20,000 entries in one owner, past its bucket and shared memory;
      single: one read (B = 1);
      long: four 140 kb reads (T = 140), each a batch-time recruit: a
        probe's tile jobs outnumber the owner CTAs and wrap onto the
        runners (T is no multiple of the CTAs).
    Each batch is timed (the filter restored before each launch, outside
    the timed span) beside the plain version and its bound
    (`consume_bytes`); its live re-probes, rechecks, inserts, resets and
    grid barriers (`barrier_counts`) are printed.  Per cell and filter,
    one whole-read insert and one probe (live, and recheck under the trim
    recheck) are timed inside the kernel (`insert_in_kernel_ms`,
    `probe_in_kernel_ms`), and the first batches of a silver pass over the
    bench reads in order (`bench_batches_ms`: 16 exact, 8 throughput).
    Returns the record of the exact and the throughput shape, keyed
    `_throughput`, with the per-case times."""
    import numpy as np
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.path import consume as tcons
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    genome, reads = bench_reads(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    L = BENCH["read_len"]
    overlap = sample_reads(genome, (1_000_000 + 500 * torch.arange(
        64, device=dev))[:, None], g)
    homo = torch.zeros((1, L), dtype=torch.uint8, device=dev)
    longs = long_reads(genome, 4, 140_000, g)
    special = torch.cat([overlap, homo])
    # name: (reads, T, batch-time rows forged as recruits)
    batch_reads = {"rotate_done": (reads[:64], 20, False),
                   "overlap": (overlap, 20, False),
                   "all_live": (overlap, 20, True),
                   "overflow": (torch.cat([homo, reads[64:127]]), 20, False),
                   "single": (reads[127:128], 20, False),
                   "long": (longs, 140, True)}
    cells = (("exact", "direct", {}), ("exact", "compressed", {}),
             ("throughput", "direct", THROUGHPUT),
             ("throughput", "compressed", THROUGHPUT),
             ("exact_is8", "compressed", dict(insert_stride=8)))
    rec, err = {}, 0
    for cell, mode, extra in cells:
        te = GoldenPathEngine(PathConfig(
            **{**BENCH_ENGINE, "max_paths": 2, "ratio": 0.02},
            mibf_mode=mode, **extra), device=dev)
        B = te.batch_reads
        bits = dm.presence_bitmap(te.size, dev)
        for c, n in fill_pass_batches(dev, torch.cat([reads, special])):
            dm.fill_presence_bits(bits, c, n, te.fam_ins, te.size,
                                  te.cfg.slot_map)
        # the long reads as 20 kb pieces (the k-mers across a cut stay out)
        for c, n in fill_pass_batches(dev, longs.reshape(-1, L)):
            dm.fill_presence_bits(bits, c, n, te.fam_ins, te.size,
                                  te.cfg.slot_map)
        if mode == "direct":
            dm.merge_presence(te.state.words, bits, te.size,
                              first_write=True)
        else:
            te.cstate = cz.with_tables(*cz.build_rank(bits, te.size),
                                       te.size)
        del bits
        filt = te.cstate if mode == "compressed" else te.state
        fresh = type(filt)(*(t.clone() for t in filt))
        plain = type(filt)(*(t.clone() for t in filt))
        scal = torch.tensor([0, 0, 1, 0], dtype=torch.int64, device=dev)
        scal_p = scal.clone()
        ck, cp = tcons.new_counters(dev), tcons.new_counters(dev)
        names = list(batch_reads) if cell != "exact_is8" else ["rotate_done"]
        for name in names:
            rd, T, forged = batch_reads[name]
            n_r, Lr = rd.shape
            Bb = min(B, n_r)
            codes = np.zeros((Bb, (T + 1) * te.cfg.tile_length), np.uint8)
            codes[:, :Lr] = rd[:Bb].cpu().numpy()
            lengths = np.full(Bb, Lr, np.int32)
            full = np.full(Bb, Lr, np.int64)
            inputs = list(te._batch_inputs(codes, lengths, full, T))
            if forged:
                rows0 = quiet_rows(inputs[-1])
                rows0[:, :4] = torch.tensor([1, 0, T - 1, T])
                inputs[-1] = rows0
            # every batch starts a fresh silver path
            scal.copy_(torch.tensor([0, 0, 1, 0]))
            scal_p.copy_(scal)
            saved = [t.clone() for t in filt] + [scal.clone(), ck.clone()]
            rows_k = torch.empty((Bb, 8), dtype=torch.int64, device=dev)
            rows_p = torch.empty_like(rows_k)
            before = kernels.CONSUME.launches
            tcons.consume_batch(te.spec, filt, *inputs, scal, rows_k, ck,
                                T)
            launched = kernels.CONSUME.launches - before
            torch.cuda.synchronize()
            t0 = time.time()
            tcons.consume_batch_plain(te.spec, plain, *inputs, scal_p,
                                      rows_p, cp, T)
            torch.cuda.synchronize()
            pms = (time.time() - t0) * 1e3
            # the plain version again, on a copy of the same start, its
            # steps recorded for the bound and the barriers (not timed)
            log_filt = type(filt)(*(t.clone() for t in saved[:-2]))
            with plain_steps(te.spec, inputs[0], inputs[2],
                             filt.sentinel if mode == "compressed"
                             else te.size) as log:
                tcons.consume_batch_plain(
                    te.spec, log_filt, *inputs, saved[-2].clone(),
                    torch.empty_like(rows_p), tcons.new_counters(dev), T)
            del log_filt
            e = max_abs_err([(rows_k, rows_p), (scal, scal_p), (ck, cp)]
                            + list(zip(filt, plain)))
            err = max(err, e)
            steps = {k: sum(1 for x in log if x[0] == k)
                     for k in ("live", "recheck", "insert", "reset")}
            barriers, barriers_before = barrier_counts(log, te.fast)
            # the kernel again from the saved state, each launch timed
            # alone between events
            after = [t.clone() for t in filt] + [scal.clone(), ck.clone()]
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            ms = 0.0
            reps = 3
            for _ in range(reps):
                for t, v in zip(list(filt) + [scal, ck], saved):
                    t.copy_(v)
                torch.cuda._sleep(1_000_000)
                start.record()
                tcons.consume_batch(te.spec, filt, *inputs, scal, rows_k,
                                    ck, T)
                stop.record()
                torch.cuda.synchronize()
                ms += start.elapsed_time(stop) / reps
            err = max(err, max_abs_err(zip(list(filt) + [scal, ck],
                                           after)))
            nbytes = consume_bytes(te, inputs, log, filt, T)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            tag = f"{cell}_{mode}_{name}"
            rec.update({f"ms_{tag}": ms, f"plain_ms_{tag}": pms,
                        f"bound_ms_{tag}": bound})
            say("kernels", kernel="consume", cell=cell, filter=mode,
                batch=name, B=Bb, T=T, launches=launched, max_abs_err=e,
                live=steps["live"], recheck=steps["recheck"],
                insert=steps["insert"], reset=steps["reset"],
                barriers=barriers, barriers_replaced_design=barriers_before,
                scal=scal.tolist(), ms=f"{ms:.4f}", plain_ms=f"{pms:.1f}",
                bound_ms=f"{bound:.5f}")
            if launched != 1:
                raise AssertionError(f"consume launched {launched} times "
                                     "for one batch")
            want = {"rotate_done": steps["reset"] and scal[3] == 1,
                    "overlap": steps["live"] > 0 and steps["insert"] > 0,
                    "all_live": steps["live"] == Bb - 1,
                    "overflow": any(x[:4] == ("insert", 0, 0, 19)
                                    for x in log),
                    "single": Bb == 1,
                    "long": steps["live"] > 0 and steps["insert"] > 0}[name]
            if not want:
                raise AssertionError(f"consume {tag}: the batch did not "
                                     f"make its case: {steps}, "
                                     f"scal {scal.tolist()}")
            if name == "overlap":
                overlap_inputs = inputs
            if name == "rotate_done":
                bench_inputs = inputs
        if cell != "exact_is8":
            # one whole-read insert and one probe inside the kernel, on the
            # overlap batch's reads, from the fresh filter
            for t, v in zip(filt, fresh):
                t.copy_(v)
            ins, idle = insert_in_kernel_ms(te, filt, overlap_inputs, 20,
                                            dev)
            probe = probe_in_kernel_ms(te, filt, overlap_inputs, 20, dev)
            # insert_max of a probed read, staged and loaded
            probed = (probed_insert_ms(te, filt, bench_inputs, 20, dev)
                      if te.fast else {})
            bench = bench_batches_ms(te, filt, reads[200:], 20, dev,
                                     16 if cell == "exact" else 8)
            rec.update({f"ms_insert_{cell}_{mode}": ins,
                        f"ms_no_recruit_{cell}_{mode}": idle,
                        f"ms_probe_{cell}_{mode}": probe["live"],
                        f"ms_bench_{cell}_{mode}": bench["ms"]})
            if probed:
                rec[f"ms_insert_probed_{cell}_{mode}"] = probed["staged"]
                if "loaded" in probed:
                    rec[f"ms_insert_probed_loaded_{cell}_{mode}"] = \
                        probed["loaded"]
                say("kernels", kernel="consume", cell=cell, filter=mode,
                    **{f"insert_in_kernel_ms_probed_{k}": f"{v:.4f}"
                       for k, v in probed.items()})
            if probe["recheck"] is not None:
                rec[f"ms_recheck_{cell}_{mode}"] = probe["recheck"]
            say("kernels", kernel="consume", cell=cell, filter=mode,
                insert_in_kernel_ms=f"{ins:.4f}",
                batch_without_recruit_ms=f"{idle:.4f}",
                probe_in_kernel_ms=f"{probe['live']:.4f}",
                recheck_in_kernel_ms=(f"{probe['recheck']:.4f}"
                                      if probe["recheck"] is not None
                                      else "none"))
            say("kernels", kernel="consume", cell=cell, filter=mode,
                bench_batches=bench["batches"],
                bench_ms_per_batch=f"{bench['ms']:.4f}",
                **{f"{k}_per_batch": f"{bench[k]:.2f}"
                   for k in tcons.COUNTS})
        del te, filt, plain, fresh
        torch.cuda.empty_cache()
    for cell in ("exact", "throughput"):
        tags = [k[3:] for k in rec if k.startswith(f"ms_{cell}_")]
        sfx = "" if cell == "exact" else "_throughput"
        rec[f"ms{sfx}"] = sum(rec[f"ms_{t}"] for t in tags) / len(tags)
        rec[f"plain_ms{sfx}"] = sum(rec[f"plain_ms_{t}"]
                                    for t in tags) / len(tags)
        rec[f"bound_ms{sfx}"] = sum(rec[f"bound_ms_{t}"]
                                    for t in tags) / len(tags)
    rec.update(max_abs_err=err, bound_by="bytes", library_ms=None)
    return rec


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda is not available")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        count=torch.cuda.device_count())
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    return name


def phase_build():
    from goldrush_tpu_torch import kernels
    t0 = time.time()
    so = kernels.build(verbose=True)
    kernels.lib()
    say("build", seconds=f"{time.time() - t0:.2f}",
        library=os.path.relpath(so, REPO))


def freeze_of(cz):
    """The port's freeze on the card without the population's fetch, and
    its plain version: this tree's one launch of rank_build, or, in an
    earlier tree that --ab runs, the four launches of rank_pack, rank_scan's
    two and rank_carry.  Returns two functions of (bits, size) and whether
    the first is this design."""
    if hasattr(cz, "_build_rank_cuda"):
        return cz._build_rank_cuda, cz._build_rank_plain, True

    def four(bits, size):
        bitrank, totals = cz._rank_pack_cuda(bits, size)
        supers, pop = cz._rank_scan_cuda(totals, size)
        cz._rank_carry_cuda(bitrank, totals)
        return bitrank, supers, pop

    def plain(bits, size):
        bitrank, totals = cz._rank_pack_plain(bits, size)
        supers, pop = cz._rank_scan_plain(totals, size)
        cz._rank_carry_plain(bitrank, totals)
        return bitrank, supers, pop
    return four, plain, False


def plain_freeze_err(plain, bits, size: int, got) -> int:
    """The largest difference of a freeze (bitrank, supers, pop on the
    card) from the plain freeze, superblock by superblock (each one's
    words ranked alone, its count the next base): a bitmap of 14
    superblocks would not fit the card twice with the plain version's
    temporaries."""
    bitrank, supers, pop = got
    step = 1 << 27
    nw = bits.numel()
    err, base = 0, 0
    for s, w0 in enumerate(range(0, nw, step)):
        w1 = min(w0 + step, nw)
        part = min(size - 32 * w0, 32 * step)
        br, _, n = plain(bits[w0:w1].contiguous(), part)
        err = max(err, max_abs_err([(bitrank[w0:w1], br[:-1])]),
                  abs(int(supers[s]) - base))
        base += n
        del br
    return max(err, abs(int(pop) - base), abs(int(bitrank[nw])),
               abs(supers.numel() - -(-nw // step)))


def popcount_cumsum(bits):
    """The yardstick of the freeze: each word's popcount as int64, made
    before the timing, for torch.cumsum (no mask, no restart a
    superblock, no packing)."""
    import torch
    from goldrush_tpu_torch.mibf import compressed as cz
    return cz._popcount32_(bits.clone()).to(torch.int64)


def freeze_check(dev, bits, size: int, tag: str, reps: int = 20) -> dict:
    """The freeze of `bits` against the plain freeze, timed (CUDA events,
    without the population's fetch) beside its bound, in this tree and,
    under --ab, in the earlier one; and torch.cumsum of precomputed per-word
    popcounts.  Returns the record's keys, suffixed by `tag`."""
    import torch
    from goldrush_tpu_torch.mibf import compressed as cz
    freeze, plain, this = freeze_of(cz)
    err = plain_freeze_err(plain, bits, size, freeze(bits, size))
    ms = cuda_ms(lambda: freeze(bits, size), reps)
    pops = popcount_cumsum(bits)
    lib = cuda_ms(lambda: torch.cumsum(pops, 0), reps)
    del pops
    bound = freeze_bytes(size) / HBM_BYTES_PER_S * 1e3
    say("kernels", kernel="rank_build" if this else "freeze_4_launches",
        slots=size, words=bits.numel(), max_abs_err=err, ms=f"{ms:.4f}",
        library_ms=f"{lib:.4f}", bound_ms=f"{bound:.4f}",
        bound_share=f"{bound / ms:.3f}")
    return {f"ms_freeze{tag}": ms, f"library_ms{tag}": lib,
            f"bound_ms{tag}": bound, "max_abs_err": err}


def synthetic_bitmap(dev, size: int, full_super: int, seed: int):
    """A bitmap of `size` slots made on the card: a quarter of the bits
    set, superblock `full_super` fully set, bits dirty past size."""
    import torch
    nw = -(-size // 32)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bits = torch.randint(-2**31, 2**31, (nw,), dtype=torch.int32,
                         device=dev, generator=g)
    bits &= torch.randint(-2**31, 2**31, (nw,), dtype=torch.int32,
                          device=dev, generator=g)
    bits[full_super << 27: (full_super + 1) << 27] = -1
    return bits


# the freeze at the genome scale's sizes: phase 7's gate (two superblocks,
# the first fully set) and bench sizings (14, the fourth fully set)
FREEZE_SIZES = ((4_603_242_496, 0), (56_947_329_536, 3))


def freeze_scale_check(dev) -> dict:
    """The freeze on synthetic bitmaps at FREEZE_SIZES (and, for a ragged
    last word, the first size less 7 slots on the same bitmap), each
    against the plain freeze superblock by superblock and timed; the
    records' keys suffixed by the size."""
    import torch
    rec, err = {}, 0
    for size, full in FREEZE_SIZES:
        bits = synthetic_bitmap(dev, size, full, size % 1000)
        got = freeze_check(dev, bits, size, f"_{size}", reps=5)
        if size == FREEZE_SIZES[0][0]:
            got.update(freeze_check(dev, bits, size - 7, f"_{size - 7}",
                                    reps=5))
        err = max(err, got.pop("max_abs_err"))
        rec.update(got)
        del bits
        torch.cuda.empty_cache()
    rec["max_abs_err"] = err
    return rec


def phase_kernels() -> dict:
    """Each kernel vs its plain version at the slice's shapes, the consume
    kernel included."""
    import dataclasses

    import numpy as np
    import torch
    from goldrush_tpu_torch.config import calc_optimal_size
    from goldrush_tpu_torch.io.fastq import encode
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.ops.nthash import build_seed_family, hash_positions
    from goldrush_tpu_torch.ops.seeds import make_seed_pattern
    from goldrush_tpu_torch.path import classify as clf
    from goldrush_tpu_torch.utils import synth

    dev = torch.device("cuda", 0)
    fam = build_seed_family(make_seed_pattern(PRESET, 22, 16, 3))
    size = calc_optimal_size(15_000_000, 1, 0.1)      # G = 5 Mbp universe
    B, T, TL, K = 32, 20, 1000, 32
    params = dm.MibfParams(size=size, h=3, k=22, spans=fam.spans,
                           tile_length=TL, threshold=10, block_size=10,
                           vote_topk=K, vote_min=2)
    genome = synth.random_genome(400_000, seed=7)   # ~3x coverage
    reads = synth.simulate_reads(genome, 64, 20_000, seed=8, err_rate=0.05)
    out = {}

    # --- A, fill entry: one batch of 64 reads x 32,768 positions into a
    # bitmap and its merge, in both slot maps; then a whole fill pass of 47
    # batches and the direct filter's merge -------------------------------
    codes = np.zeros((FILL_BATCH, FILL_WIDTH), np.uint8)
    lengths = np.zeros(FILL_BATCH, np.int32)
    for i, (_, seq, _) in enumerate(reads):
        codes[i, :len(seq)] = encode(seq)
        lengths[i] = len(seq)
    codes_d = torch.from_numpy(codes).to(dev)
    lengths_d = torch.from_numpy(lengths).to(dev)
    st_k = dm.init_state(params, dev)
    st_p = dm.init_state(params, dev)
    err = err_merge = 0
    fill_args = (codes_d, lengths_d, fam, size)
    for mode in ("mod", "fastrange"):     # the fastrange filter stays for D, B
        st_k.words.zero_()
        st_p.words.zero_()
        bk = dm.fill_presence_bits(dm.presence_bitmap(size, dev), *fill_args,
                                   mode)
        bp = dm._fill_bits_plain(dm.presence_bitmap(size, dev), *fill_args,
                                 mode)
        err = max(err, max_abs_err([(bk, bp)]))
        # the merge on the same bits; then the plain fill and merge
        dm.merge_presence(st_k.words, bk, size)
        dm._merge_plain(st_p.words, bk, size)
        err_merge = max(err_merge, max_abs_err([(st_k.words, st_p.words)]))
        dm._merge_plain(st_p.words.zero_(), bp, size)
        err = max(err, max_abs_err([(st_k.words, st_p.words)]))
    present = int((st_k.words != 0).sum())
    ms = cuda_ms(lambda: dm.fill_presence_bits(bk, *fill_args, "fastrange"),
                 20)
    pms = cuda_ms(lambda: dm._fill_bits_plain(bk, *fill_args, "fastrange"), 3)
    written = int((bk != 0).sum())        # bitmap words it sets
    n_care = len(fam.care_left) + len(fam.care_right)
    ln = lengths.astype(np.int64)
    frames = [int(np.maximum(ln - span + 1, 0).sum()) for span in fam.spans]
    batches = fill_pass_batches(dev)
    pass_words = torch.empty(params.alloc, dtype=torch.int32, device=dev)

    def words_merge(words, bits):
        """The direct filter's words from a pass's bitmap, as the engine
        writes them: one first write."""
        return dm.merge_presence(words, bits, size, first_write=True)

    def fill_pass():
        b = dm.presence_bitmap(size, dev)
        for c, n in batches:
            dm.fill_presence_bits(b, c, n, fam, size, "fastrange")
        words_merge(pass_words, b)
        return b
    pass_bits = fill_pass()
    ms_pass = cuda_ms(fill_pass, 3, hold=40)
    # codes and lengths in, each bitmap word set (from a zeroed one) out
    out["seed_hash_fill"] = checked(
        err, ms, pms, int(ln.sum()) + ln.size * 4 + written * 4,
        hash_ops(frames[0], sum(frames), n_care), ms_fill_pass=ms_pass,
        fill_pass_batches=len(batches))
    say("kernels", kernel="seed_hash_fill", shape="64x32768x3",
        present_slots=present, max_abs_err=err, ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}",
        bound_ms=f"{out['seed_hash_fill']['bound_ms']:.4f}",
        fill_pass_ms=f"{ms_pass:.4f}", fill_pass_batches=len(batches))
    # the merge of the pass's bitmap: as an OR into words holding every
    # bit, and as the direct filter's first write into dirty words
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    w0 = torch.randint(-2**31, 2**31, (params.alloc,), dtype=torch.int32,
                       device=dev, generator=g)
    mk = dm.merge_presence(w0.clone(), pass_bits, size)
    mp = dm._merge_plain(w0.clone(), pass_bits, size)
    err_merge = max(err_merge, max_abs_err([(mk, mp)]))
    ms_or = cuda_ms(lambda: dm.merge_presence(mk, pass_bits, size), 20)
    pms_or = cuda_ms(lambda: dm._merge_plain(mp, pass_bits, size), 3)
    set_slots = int((pass_words != 0).sum())
    ms_words = cuda_ms(lambda: words_merge(mk, pass_bits), 20)
    # the bitmap in; the OR reads and writes each set slot's word
    or_bytes = pass_bits.numel() * 4 + set_slots * 8
    rec = dict(ms_or=ms_or, plain_ms_or=pms_or,
               bound_ms_or=or_bytes / HBM_BYTES_PER_S * 1e3,
               ms_words_merge=ms_words)
    fk = dm.merge_presence(w0.clone(), pass_bits, size, first_write=True)
    fp = dm._merge_plain(w0.clone(), pass_bits, size, first_write=True)
    err_merge = max(err_merge, max_abs_err([(fk, fp), (fk, pass_words)]))
    pms = cuda_ms(lambda: dm._merge_plain(fp, pass_bits, size, True), 3)
    del fk, fp
    # the bitmap in, every word of the allocation out
    out["presence_merge"] = checked(
        err_merge, ms_words, pms, pass_bits.numel() * 4 + params.alloc * 4,
        **rec)
    say("kernels", kernel="presence_merge", slots=size,
        set_slots=set_slots, max_abs_err=err_merge,
        ms=f"{out['presence_merge']['ms']:.4f}",
        plain_ms=f"{out['presence_merge']['plain_ms']:.4f}",
        bound_ms=f"{out['presence_merge']['bound_ms']:.4f}",
        ms_or=f"{ms_or:.4f}", plain_ms_or=f"{pms_or:.4f}",
        bound_ms_or=f"{rec['bound_ms_or']:.4f}")
    del w0, mk, mp, batches

    # --- A, grid entry: B=32, T=20, both slot maps ------------------------
    qc = torch.from_numpy(codes[:B, : T * TL + TL].copy()).to(dev)
    ql = torch.from_numpy(lengths[:B].copy()).to(dev)
    err = 0
    for mode in ("mod", "fastrange"):
        par = dataclasses.replace(params, slot_map=mode)
        slots, ok = dm.build_slot_grid(qc, ql, fam, par, T)
        pg = dm.tile_slot_grid(hash_positions(qc, fam, T * TL), ql, par, T)
        err = max(err, max_abs_err([(slots, pg[0]), (ok, pg[1])]))
    ms = cuda_ms(lambda: dm.build_slot_grid(qc, ql, fam, params, T), 20)
    pms = cuda_ms(lambda: dm.tile_slot_grid(hash_positions(qc, fam, T * TL),
                                            ql, params, T), 3)
    n_ok = int(ok.sum())
    out["seed_hash_grid"] = checked(
        err, ms, pms, qc.numel() + ql.numel() * 4 + slots.numel() * 8
        + ok.numel(), hash_ops(n_ok, n_ok * fam.h, n_care))
    say("kernels", kernel="seed_hash_grid", shape=f"{B}x3x{T * TL}",
        max_abs_err=err, ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
        bound_ms=f"{out['seed_hash_grid']['bound_ms']:.4f}")

    # --- D: insert 8 recruits (whole, trimmed, repeated slots), then the
    # recruits its key partition finds hard, then recruits of insert grids
    # at insert strides 2 and 8 (kernel A's slot grid at S) ---------------
    ins_params = {S: dataclasses.replace(params, frame_stride=S)
                  for S in (2, 8)}
    strided = {S: dm.build_slot_grid(qc, ql, fam, p, T)[0]
               for S, p in ins_params.items()}
    plan = [(0, T - 1, 1, False), (0, T - 1, 3, False), (3, 14, 5, True),
            (0, T - 1, 7, False), (5, 5, 9, True), (0, T - 1, 11, False),
            (2, 17, 13, True), (0, T - 1, 15, False)]
    out["insert_sorted"] = insert_phase(
        st_k, st_p, [(slots[i], *p) for i, p in enumerate(plan)]
        + hard_recruits(size, T, TL), slots[8], params, T, size,
        dm.PRESENT_BIT, "direct", strided)
    # --- insert_max (throughput mode): D's recruits, then ids near 2^30 ---
    # (grid row, lo, hi, base, trimmed)
    max_plan = [(i, *p) for i, p in enumerate(plan)] + [
        (10, 0, T - 1, dm.ID_MASK - 40, True),
        (11, 2, 17, dm.ID_MASK - 20, False)]
    out["insert_max"] = insert_max_phase(
        st_k.words.clone(), [(slots[i], *p) for i, *p in max_plan]
        + hard_recruits(size, T, TL),
        slots[8], params, T, size, dm.PRESENT_BIT, "direct", strided)

    # --- B: probe + vote, B=32 and the B=1 live re-probe ----------------
    vk = dm.probe_and_vote(st_k.words, slots, ok, params, T)
    vp = dm._probe_and_vote_plain(st_k.words, slots, ok, params, T)
    err = max_abs_err(zip(vk, vp))
    v1k = dm.probe_and_vote(st_k.words, slots[9:10], ok[9:10], params, T)
    v1p = dm._probe_and_vote_plain(st_k.words, slots[9:10], ok[9:10],
                                   params, T)
    err = max(err, max_abs_err(zip(v1k, v1p)))
    ms = cuda_ms(lambda: dm.probe_and_vote(st_k.words, slots, ok, params, T),
                 20)
    pms = cuda_ms(lambda: dm._probe_and_vote_plain(st_k.words, slots, ok,
                                                   params, T), 3)
    ms1 = cuda_ms(lambda: dm.probe_and_vote(
        st_k.words, slots[9:10], ok[9:10], params, T), 20)
    pms1 = cuda_ms(lambda: dm._probe_and_vote_plain(
        st_k.words, slots[9:10], ok[9:10], params, T), 3)
    out["probe_vote"] = checked(
        err, ms, pms, vote_bytes(slots, ok, T, K, size, False), ms_b1=ms1,
        plain_ms_b1=pms1, bound_ms_b1=vote_bytes(
            slots[9:10], ok[9:10], T, K, size, False) / HBM_BYTES_PER_S * 1e3)
    voted = int((vk.top_count > 0).sum())
    say("kernels", kernel="probe_vote", shape=f"{B}x{T}x{K}",
        tiles_with_votes=voted, max_abs_err=err, ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}", ms_b1=f"{ms1:.4f}", plain_ms_b1=f"{pms1:.4f}",
        bound_ms=f"{out['probe_vote']['bound_ms']:.4f}",
        bound_ms_b1=f"{out['probe_vote']['bound_ms_b1']:.6f}")

    # --- C: classify with debug traces ----------------------------------
    n_t = (ql // TL).int()
    ck = clf.classify_batch(vk.curr_id, vk.top_count, vk.cand_ids,
                            vk.cand_counts, n_t, 10, 5, 1, debug=True)
    cp = clf._classify_plain(vk.curr_id, vk.cand_ids, vk.cand_counts, n_t,
                             10, 5, 1, True)
    err = max_abs_err(list(zip(ck[0], cp[0])) + [(ck[1], cp[1]),
                                                 (ck[2], cp[2])])
    ms = cuda_ms(lambda: clf.classify_batch(
        vk.curr_id, vk.top_count, vk.cand_ids, vk.cand_counts, n_t, 10, 5, 1),
        20)
    pms = cuda_ms(lambda: clf._classify_plain(
        vk.curr_id, vk.cand_ids, vk.cand_counts, n_t, 10, 5, 1, False), 3)
    # the live re-probe's classify: one read
    v1 = [x[9:10].contiguous() for x in (vk.curr_id, vk.top_count,
                                         vk.cand_ids, vk.cand_counts, n_t)]
    c1k = clf.classify_batch(*v1, 10, 5, 1)
    err = max(err, max_abs_err(zip(c1k, clf._classify_plain(
        v1[0], v1[2], v1[3], v1[4], 10, 5, 1, False))))
    ms1 = cuda_ms(lambda: clf.classify_batch(*v1, 10, 5, 1), 20)
    pms1 = cuda_ms(lambda: clf._classify_plain(v1[0], v1[2], v1[3], v1[4],
                                               10, 5, 1, False), 3)
    out["classify"] = checked(
        err, ms, pms, classify_bytes(B, T, K), ms_b1=ms1, plain_ms_b1=pms1,
        bound_ms_b1=classify_bytes(1, T, K) / HBM_BYTES_PER_S * 1e3)
    decisions = np.bincount(ck[0].decision.cpu().numpy(), minlength=3)
    say("kernels", kernel="classify", shape=f"{B}x{T}x{K}",
        decisions=decisions.tolist(), max_abs_err=err, ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}", ms_b1=f"{ms1:.4f}", plain_ms_b1=f"{pms1:.4f}",
        bound_ms=f"{out['classify']['bound_ms']:.6f}",
        bound_ms_b1=f"{out['classify']['bound_ms_b1']:.6f}")
    # --- the rank-compressed filter: the freeze from the pass's bitmap,
    # A's rank grid, D and B on ranks ------------------------------------
    freeze, plain, this = freeze_of(cz)
    got = freeze(pass_bits, size)
    want = plain(pass_bits, size)
    err = max(max_abs_err([(got[0], want[0]), (got[1], want[1])]),
              abs(int(got[2]) - want[2]))
    ms = cuda_ms(lambda: freeze(pass_bits, size), 20)
    pms = cuda_ms(lambda: plain(pass_bits, size), 3)
    pops = popcount_cumsum(pass_bits)
    lib = cuda_ms(lambda: torch.cumsum(pops, 0), 20)
    out["rank_build"] = checked(err, ms, pms, freeze_bytes(size))
    out["rank_build"]["library_ms"] = lib
    say("kernels", kernel="rank_build" if this else "freeze_4_launches",
        slots=size, present=int(got[2]), max_abs_err=err, ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}", library_ms=f"{lib:.4f}",
        bound_ms=f"{out['rank_build']['bound_ms']:.4f}")
    del pass_words, pass_bits, got, want, pops
    # the filter of the grid's batch, frozen (freeze: its words' bits packed
    # by plain torch ops, then rank_build); the plain rank map
    cs_k = cz.freeze(st_k.words, size)
    err = 0
    for mode in ("mod", "fastrange"):     # the fastrange grid stays for D, B
        par = dataclasses.replace(params, slot_map=mode)
        pg = dm.tile_slot_grid(hash_positions(qc, fam, T * TL), ql, par, T)
        want = (cz.rank_grid(cs_k, pg[0], size), pg[1])
        got = cz.build_rank_grid(cs_k, qc, ql, fam, par, T)
        err = max(err, max_abs_err(zip(got, want)))
    ranks = got[0]
    ms = cuda_ms(lambda: cz.build_rank_grid(cs_k, qc, ql, fam, params, T), 20)
    pms = cuda_ms(lambda: cz.rank_grid(cs_k, dm.tile_slot_grid(
        hash_positions(qc, fam, T * TL), ql, params, T)[0], size), 3)
    # codes in, ranks + frame_ok out, each distinct bitrank word gathered
    # once
    words_read = torch.unique(slots[slots < size] >> 5).numel()
    out["seed_hash_rank_grid"] = checked(
        err, ms, pms, qc.numel() + ql.numel() * 4 + ranks.numel() * 8
        + ok.numel() + words_read * 8, hash_ops(n_ok, n_ok * fam.h, n_care))
    ranked = int((ranks < cs_k.sentinel).sum())
    say("kernels", kernel="seed_hash_rank_grid", shape=f"{B}x3x{T * TL}",
        present=ranked, max_abs_err=err, ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}",
        bound_ms=f"{out['seed_hash_rank_grid']['bound_ms']:.4f}")
    cs_p = cz.CompressedState(cs_k.bitrank, cs_k.supers, cs_k.ids.clone(),
                              cs_k.counts.clone())
    strided = {S: cz.build_rank_grid(cs_k, qc, ql, fam, p, T)[0]
               for S, p in ins_params.items()}
    err = insert_phase(
        (cs_k.ids, cs_k.counts), (cs_p.ids, cs_p.counts),
        [(ranks[i], *p) for i, p in enumerate(plan)]
        + hard_recruits(cs_k.sentinel, T, TL), ranks[8], params, T,
        cs_k.sentinel, 0, "compressed", strided)["max_abs_err"]
    rec = insert_max_phase(
        cs_k.ids.clone(), [(ranks[i], *p) for i, *p in max_plan]
        + hard_recruits(cs_k.sentinel, T, TL), ranks[8], params, T,
        cs_k.sentinel, 0, "compressed", strided)
    del strided
    out["insert_max"].update(
        max_abs_err=max(out["insert_max"]["max_abs_err"],
                        rec["max_abs_err"]),
        ms_compressed=rec["ms"], plain_ms_compressed=rec["plain_ms"],
        library_ms_compressed=rec["library_ms"],
        bound_ms_compressed=rec["bound_ms"])
    srec, rrec, err_s, err_r = strided_grids(codes, lengths, params, cs_k,
                                             n_care)
    out["seed_hash_grid"].update(srec)
    out["seed_hash_rank_grid"].update(rrec)
    for name, e in (("seed_hash_grid", err_s),
                    ("seed_hash_rank_grid", err_r)):
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)
    vk = cz.probe_and_vote(cs_k, ranks, ok, params, T)
    vp = dm._probe_and_vote_plain(cs_k.ids, ranks, ok, params, T, True)
    v1k = cz.probe_and_vote(cs_k, ranks[9:10], ok[9:10], params, T)
    v1p = dm._probe_and_vote_plain(cs_k.ids, ranks[9:10], ok[9:10], params,
                                   T, True)
    err_b = max_abs_err(list(zip(vk, vp)) + list(zip(v1k, v1p)))
    ms = cuda_ms(lambda: cz.probe_and_vote(cs_k, ranks, ok, params, T), 20)
    pms = cuda_ms(lambda: dm._probe_and_vote_plain(cs_k.ids, ranks, ok,
                                                   params, T, True), 3)
    ms1 = cuda_ms(lambda: cz.probe_and_vote(cs_k, ranks[9:10], ok[9:10],
                                            params, T), 20)
    out["probe_vote"].update(ms_compressed=ms, ms_b1_compressed=ms1)
    bound = vote_bytes(ranks, ok, T, K, cs_k.sentinel, True) * 1e3 / \
        HBM_BYTES_PER_S
    say("kernels", kernel="probe_vote", filter="compressed",
        tiles_with_votes=int((vk.top_count > 0).sum()), max_abs_err=err_b,
        ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", ms_b1=f"{ms1:.4f}",
        bound_ms=f"{bound:.4f}")
    hard_b, hard_c = hard_cases(dev)
    out["classify"].update(cummax_check(dev))
    out["minimizer_keys"] = minimizer_check(dev)
    out["kmer_count"], out["kmer_query"] = kmer_check(dev)
    del cs_k, cs_p, st_k, st_p
    torch.cuda.empty_cache()
    out["consume"] = consume_check(dev)
    err_cummax = out["classify"].get("cummax_max_abs_err", 0)
    out["insert_sorted"]["max_abs_err"] = max(
        out["insert_sorted"]["max_abs_err"], err)
    out["probe_vote"]["max_abs_err"] = max(out["probe_vote"]["max_abs_err"],
                                           err_b, hard_b)
    out["classify"]["max_abs_err"] = max(out["classify"]["max_abs_err"],
                                         hard_c, err_cummax)
    bad = {k: v["max_abs_err"] for k, v in out.items()
           if v["max_abs_err"] != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    if present == 0 or voted == 0 or decisions.sum() != B or ranked == 0:
        raise AssertionError("kernel check inputs are degenerate")
    return out


def make_reads(path: str, genome: int, genome_seed: int, n_reads: int,
               read_len: int, reads_seed: int, err_rate: float,
               indel_frac: float = 0.0, phred: int = 20) -> None:
    from goldrush_tpu_torch.utils import synth
    g = synth.random_genome(genome, seed=genome_seed)
    reads = synth.simulate_reads(g, n_reads, read_len, seed=reads_seed,
                                 err_rate=err_rate, indel_frac=indel_frac,
                                 phred=phred)
    synth.write_fastq(path, reads)


def phase_e2e() -> dict:
    """goldrush-path through the CLI entry point at the bench scale, with
    the direct and then the rank-compressed filter; every kernel's launch
    count is read after both, and each filter's after its own run.  The
    calls of the fill's and the grids' wrappers are counted apart from the
    kernels' launches: the fill must launch once per batch, the merge once
    per direct fill pass (one per stage run) and never in the compressed
    filter, the slot grid once per grid of the direct filter and the rank
    grid once per grid of the compressed one."""
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    t0 = time.time()
    reads = os.path.join(WORK, "bench_reads")
    make_reads(reads + ".fq", **BENCH)
    say("e2e", dataset="5Mbp/3000x20kb/5%err",
        synth_s=f"{time.time() - t0:.1f}")
    wrappers = {(dm, "fill_presence_bits"): "seed_hash_fill",
                (dm, "merge_presence"): "presence_merge",
                (dm, "build_slot_grid"): "seed_hash_grid",
                (cz, "build_rank_grid"): "seed_hash_rank_grid"}
    calls = dict.fromkeys(wrappers.values(), 0)
    wrapped = {key: getattr(*key) for key in wrappers}

    def counted(key):
        def call(*args, **kwargs):
            calls[wrappers[key]] += 1
            return wrapped[key](*args, **kwargs)
        return call
    for key in wrappers:
        setattr(*key, counted(key))
    try:
        launches, per_filter = drive_bench(reads, calls)
    finally:
        for (mod, name), fn in wrapped.items():
            setattr(mod, name, fn)
    for mode, (got, called, passes) in per_filter.items():
        want = dict(called)
        if mode == "direct":
            want.update(presence_merge=passes, seed_hash_rank_grid=0)
        else:
            want.update(presence_merge=0, seed_hash_grid=0,
                        rank_build=passes)
        if any(got[k] != n or called.get(k, n) != n
               for k, n in want.items()):
            raise AssertionError(f"{mode}: launches {got} for wrapper calls "
                                 f"{called} over {passes} fill passes")
        say("e2e", filter=mode, fill_batches=called["seed_hash_fill"],
            fill_passes=passes, grids=called["seed_hash_grid"]
            + called["seed_hash_rank_grid"])
    return launches


def consume_counts_of_passes():
    """Wrap GoldenPathEngine.assign so that every pass appends its engine's
    consume counts (live re-probes, trim rechecks, inserts, resets) and
    batches to the returned list; returns (list, undo)."""
    from goldrush_tpu_torch.path.engine import GoldenPathEngine as Engine
    passes, assign = [], Engine.assign

    def counted(self, path):
        assign(self, path)
        passes.append(dict(self.consume_counts,
                           batches=self.stats.num_batches))
    Engine.assign = counted
    return passes, lambda: setattr(Engine, "assign", assign)


def check_consume_launches(tag: str, got: dict, host: dict,
                           passes: list, recruits: int) -> None:
    """The main path's launches of one run: the consume kernel once per
    batch, kernels B and C once per batch (the batched probe and classify
    only), kernel D and insert_max never from the host (their code runs
    inside the consume kernel), and one insert in the kernel per
    recruit."""
    batches = sum(p["batches"] for p in passes)
    inserts = sum(p["insert"] for p in passes)
    if (got["consume"] != batches or got["probe_vote"] != batches
            or got["classify"] != batches or any(host.values())
            or inserts != recruits or recruits <= 0):
        raise AssertionError(f"{tag}: launches {got}, host inserts {host}, "
                             f"passes {passes}, {recruits} recruits")


def drive_bench(reads: str, calls: dict) -> tuple[dict, dict]:
    """Both filters' silver and golden stages on the bench reads: the
    kernels' launch counts over both, and for each filter its launches,
    its counted wrapper calls and its number of fill passes (stage
    runs)."""
    from goldrush_tpu_torch import kernels
    inserts = (kernels.INSERT_SORTED, kernels.INSERT_MAX)
    for k in kernels.ALL + inserts:
        k.launches = 0
    recruits = 0
    per_filter = {}
    passes, undo = consume_counts_of_passes()
    try:
        for mode in ("direct", "compressed"):
            recruits += drive_filter(reads, calls, mode, per_filter, passes)
    finally:
        undo()
    launches = {k.name: k.launches for k in kernels.ALL}
    say("e2e", launches=json.dumps(launches).replace(" ", ""))
    if any(k.launches for k in kernels.STAGES):
        raise AssertionError("goldrush-path launched a later stage's kernel")
    launches = {k.name: k.launches for k in kernels.PATH}
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"exact path: kernels never launched {missing}")
    check_consume_launches("exact path", launches,
                           {k.name: k.launches for k in inserts}, passes,
                           recruits)
    return launches, per_filter


def drive_filter(reads: str, calls: dict, mode: str, per_filter: dict,
                 passes: list) -> int:
    """One filter's silver and golden stages through the CLI (see
    drive_bench); returns their recruits."""
    import torch
    from goldrush_tpu_torch import cli, kernels
    from goldrush_tpu_torch.io import fastq
    recruits = 0
    before = {k.name: k.launches for k in kernels.PATH}
    called0 = dict(calls)
    n_pass = len(passes)
    outdir = os.path.join(WORK, f"bench_{mode}")
    argv = ["goldrush-path", f"reads={reads}", "G=5000000", "device=cuda",
            f"mibf_mode={mode}", f"prefix={outdir}", "dev=1"]
    cmd, cfg, extra = cli.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    out = cli.run(cmd, cfg, extra)
    wall = time.time() - t1
    peak = torch.cuda.max_memory_allocated()
    for (stage, st), counts in zip(out["stats"].items(), passes[n_pass:]):
        rate = st.num_reads / max(st.wall_assign_s, 1e-9)
        RATES[("exact", mode, stage)] = rate
        say("e2e", filter=mode, stage=stage,
            fill_s=f"{st.wall_fill_s:.3f}",
            assign_s=f"{st.wall_assign_s:.3f}",
            submit_s=f"{st.wall_submit_s:.3f}",
            replay_s=f"{st.wall_replay_s:.3f}",
            reads=st.num_reads, recruits=st.recruits,
            reads_per_s=f"{rate:.2f}", paths_completed=st.paths_completed,
            **{f"consume_{k}": v for k, v in counts.items()})
        recruits += st.recruits
    per_filter[mode] = (
        {k.name: k.launches - before[k.name] for k in kernels.PATH},
        {k: n - called0[k] for k, n in calls.items()},
        len(out["stats"]))
    silver = out["stats"]["silver"]
    if silver.recruits <= 0 or out["stats"]["golden"].recruits <= 0:
        raise AssertionError(f"{mode}: no recruits")
    target = cfg.r * cfg.G
    for i in range(1, silver.paths_completed + 1):
        p = os.path.join(outdir, f"{cfg.silver_prefix()}_{i}.fq")
        bases = sum(len(r.seq) for r in fastq.read_records(p))
        if bases <= target:
            raise AssertionError(f"{mode} silver path {i}: {bases} <= "
                                 f"r*G {target}")
    golden = sum(len(r.seq) for r in fastq.read_records(
        os.path.join(outdir, out["golden"])))
    if golden <= 0:
        raise AssertionError(f"{mode}: empty golden path")
    say("e2e", filter=mode, wall_s=f"{wall:.2f}", max_memory_allocated=peak,
        silver_paths_ok=silver.paths_completed, golden_bases=golden)
    return recruits


def phase_throughput() -> dict:
    """bench.py's throughput cell at full width on the bench reads (written
    by phase_e2e): GoldenPathEngine(device="cuda") with bench.py's
    engine_cfg and its throughput settings, compressed filter then direct,
    every launch count zeroed just before and read just after.  The consume
    kernel must launch once per batch, kernels B and C once per batch (the
    batched probe and classify), kernel D and insert_max never from the
    host, kernel A's grid entry of the filter once per batch (its query
    grid written by the insert grid's launch), and every kernel of the
    path must launch; each pass prints the consume kernel's live
    re-probes, trim rechecks, inserts and resets.  Returns the launch
    counts."""
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.io import fastq
    from goldrush_tpu_torch.path.engine import GoldenPathEngine as Engine
    reads = os.path.join(WORK, "bench_reads.fq")
    inserts = (kernels.INSERT_SORTED, kernels.INSERT_MAX)
    for k in kernels.ALL + inserts:
        k.launches = 0
    passes, undo = consume_counts_of_passes()
    try:
        for mode in ("compressed", "direct"):
            before = {k.name: k.launches for k in kernels.PATH}
            n_pass = len(passes)
            prefix = os.path.join(WORK, f"throughput_{mode}")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            eng = Engine(PathConfig(input=reads, prefix_file=prefix,
                                    mibf_mode=mode, **BENCH_ENGINE,
                                    **THROUGHPUT), device="cuda")
            st = eng.run()
            wall = time.time() - t0
            got = {k.name: k.launches - before[k.name]
                   for k in kernels.PATH}
            c = eng.consume_counts
            RATES[("throughput", mode, "silver")] = \
                st.num_reads / max(st.wall_assign_s, 1e-9)
            say("throughput", filter=mode, fill_s=f"{st.wall_fill_s:.3f}",
                assign_s=f"{st.wall_assign_s:.3f}",
                submit_s=f"{st.wall_submit_s:.3f}",
                replay_s=f"{st.wall_replay_s:.3f}", reads=st.num_reads,
                recruits=st.recruits,
                reads_per_s=f"{st.num_reads / max(st.wall_assign_s, 1e-9):.2f}",
                batches=st.num_batches, consume_launches=got["consume"],
                live_probes=c["live"], recheck_probes=c["recheck"],
                inserts=c["insert"], resets=c["reset"],
                paths_completed=st.paths_completed, wall_s=f"{wall:.2f}",
                max_memory_allocated=torch.cuda.max_memory_allocated())
            check_consume_launches(f"throughput {mode}", got,
                                   {k.name: k.launches for k in inserts},
                                   passes[n_pass:], st.recruits)
            # kernel A: one launch a batch writes both grids (the query
            # grid inside the insert grid)
            grid = "seed_hash_rank_grid" if mode == "compressed" \
                else "seed_hash_grid"
            if not eng.fuse_q or got[grid] != st.num_batches:
                raise AssertionError(f"throughput {mode}: {got[grid]} "
                                     f"launches of {grid} for "
                                     f"{st.num_batches} batches")
            target = eng.cfg.ratio * eng.cfg.genome_size
            for i in range(1, st.paths_completed + 1):
                bases = sum(len(r.seq) for r in
                            fastq.read_records(f"{prefix}_{i}.fq"))
                if bases <= target:
                    raise AssertionError(f"throughput {mode} silver path {i}:"
                                         f" {bases} <= r*G {target}")
            del eng                     # its filter must not count in the next
    finally:
        undo()
    launches = {k.name: k.launches for k in kernels.ALL}
    say("throughput", launches=json.dumps(launches).replace(" ", ""))
    if any(k.launches for k in kernels.STAGES):
        raise AssertionError("goldrush-path launched a later stage's kernel")
    launches = {k.name: k.launches for k in kernels.PATH}
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"throughput path: kernels never launched "
                             f"{missing}")
    return launches


def phase_digests() -> None:
    """Silver digests of the port on the card vs the JAX package's, in
    exact mode and in the throughput mode."""
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    with open(os.path.join(REPO, "tests", "fixtures",
                           "torch_port_digests.json")) as f:
        fx = json.load(f)
    ds = {k: v for k, v in fx["dataset"].items() if k != "sha256"}
    fq = os.path.join(WORK, "qgate.fq")
    make_reads(fq, **ds)
    if sha256_file(fq) != fx["dataset"]["sha256"]:
        raise AssertionError("synth did not regenerate the gate dataset")
    tp = fx["throughput"]
    for cell, mode, want, extra in (
            ("exact", "direct", fx, {}),
            ("exact", "compressed", fx["compressed"], {}),
            ("throughput", "direct", tp["direct"], tp["engine"]),
            ("throughput", "compressed", tp["compressed"], tp["engine"])):
        prefix = os.path.join(WORK, f"qgate_{cell}_{mode}")
        t0 = time.time()
        st = GoldenPathEngine(PathConfig(input=fq, prefix_file=prefix,
                                         mibf_mode=mode, **fx["engine"],
                                         **extra), device="cuda").run()
        got = {str(i): sha256_file(f"{prefix}_{i}.fq")
               for i in range(1, fx["engine"]["max_paths"] + 1)
               if os.path.exists(f"{prefix}_{i}.fq")}
        say("digests", cell=cell, filter=mode, files=len(got),
            recruits=st.recruits, seconds=f"{time.time() - t0:.1f}",
            match=got == want["silver"])
        if got != want["silver"] or st.recruits != want["recruits"]:
            raise AssertionError(f"{cell} {mode} silver digests differ: {got}"
                                 f" ({st.recruits} recruits) vs {want}")


def run_cli(argv: list[str]) -> dict:
    """One pipeline command through the CLI's entry points; its result
    with the wall seconds under "wall_s"."""
    import torch
    from goldrush_tpu_torch import cli
    cmd, cfg, extra = cli.parse_args(argv)
    t0 = time.time()
    out = cli.run(cmd, cfg, extra)
    torch.cuda.synchronize()
    out["wall_s"] = time.time() - t0
    out["cfg"] = cfg
    return out


def phase_pipeline() -> dict:
    """`goldrush run` on the card through cli.parse_args / cli.run, every
    launch count zeroed just before and read just after:
    (a) digests: tests/test_pipeline.py's 60 kb dataset and configuration
        (from the fixture's "pipeline" key); the sha256 of the polished,
        tigmint, ntLink (and its .gaps.json) and final files must equal the
        JAX package's;
    (b) scale: the 1 Mbp quality-gate dataset of phase 5 with G=1e6, M=3,
        r=0.75, track_time=1; each stage's seconds, the final
        assembly_stats and the new kernels' launches are printed, and the
        assembly's total must lie within [0.8, 1.8] x G.
    Every kernel of the stages after the golden path must launch in (a) or
    (b).  Returns the launch counts of every kernel over both."""
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import stage_filenames
    with open(os.path.join(REPO, "tests", "fixtures",
                           "torch_port_digests.json")) as f:
        fx = json.load(f)["pipeline"]
    ds = {k: v for k, v in fx["dataset"].items() if k != "sha256"}
    reads = os.path.join(WORK, "pipe_reads")
    make_reads(reads + ".fq", **ds)
    if sha256_file(reads + ".fq") != fx["dataset"]["sha256"]:
        raise AssertionError("synth did not regenerate the pipeline dataset")
    for k in kernels.ALL:
        k.launches = 0
    out = run_cli(["run", f"reads={reads}", "device=cuda",
                   f"prefix={os.path.join(WORK, 'pipe')}"]
                  + [f"{k}={int(v) if isinstance(v, bool) else v}"
                     for k, v in fx["config"].items()])
    files = stage_filenames(out["cfg"])
    path = os.path.join(WORK, "pipe")
    got = {s: sha256_file(os.path.join(path, files[s]))
           for s in ("polished", "tigmint", "ntlink", "final")}
    got["gaps"] = sha256_file(os.path.join(path, files["ntlink"]
                                           + ".gaps.json"))
    small = {k.name: k.launches for k in kernels.STAGES}
    say("pipeline", run="a", dataset="60kb/300x4kb/1%err",
        wall_s=f"{out['wall_s']:.2f}", stats=json.dumps(
            out["assembly_stats"]).replace(" ", ""), match=got == fx["files"],
        launches=json.dumps(small).replace(" ", ""))
    if got != fx["files"] or out["assembly_stats"] != fx["assembly_stats"]:
        raise AssertionError(f"pipeline digests differ: {got} vs "
                             f"{fx['files']}")
    for k in kernels.STAGES:
        k.launches = 0
    out = run_cli(["run", f"reads={os.path.join(WORK, 'qgate')}", "G=1e6",
                   "M=3", "r=0.75", "track_time=1", "device=cuda",
                   f"prefix={os.path.join(WORK, 'scale')}"])
    big = {k.name: k.launches for k in kernels.STAGES}
    for stage, sec in out["seconds"].items():
        say("pipeline", run="b", stage=stage.replace(" ", "_"),
            seconds=f"{sec:.2f}")
    st = out["assembly_stats"]
    G = out["cfg"].G
    say("pipeline", run="b", dataset="1Mbp/600x20kb/5%err",
        wall_s=f"{out['wall_s']:.2f}",
        stats=json.dumps(st).replace(" ", ""),
        launches=json.dumps(big).replace(" ", ""))
    if not 0.8 * G <= st["total"] <= 1.8 * G:
        raise AssertionError(f"final assembly total {st['total']} outside "
                             f"[0.8, 1.8] x G")
    missing = [k for k in small if small[k] + big[k] <= 0]
    if missing:
        raise AssertionError(f"pipeline: kernels never launched {missing}")
    launches = {k.name: k.launches for k in kernels.ALL}
    launches.update({k: small[k] + big[k] for k in small})
    return launches


GENOME_UNIVERSE = 6_000_000_000      # 56,947,329,536 slots, 14 superblocks
HIGH_SLOTS = (1 << 32) + (1 << 26)   # phase 7(c)'s all-ones filter


def plain_popcount_supers(bits, size: int):
    """The plain per-superblock popcount of a presence bitmap on the card,
    one superblock (2^27 words, 512 MB) at a time: (the exclusive prefix of
    the superblocks' counts, their sum), both int64 on the host."""
    import torch
    from goldrush_tpu_torch.mibf import compressed as cz
    words = 1 << (cz.SUPER_BITS - 5)
    counts = []
    for w0 in range(0, bits.shape[0], words):
        chunk = bits[w0: w0 + words].clone()
        if w0 + words >= bits.shape[0] and size % 32:
            chunk[-1] &= (1 << (size % 32)) - 1
        counts.append(int(cz._popcount32_(chunk).sum(dtype=torch.int64)))
        del chunk
    prefix = [sum(counts[:s]) for s in range(len(counts))]
    return prefix, sum(counts)


def host_ranks(slots, words, supers, size: int, sentinel: int):
    """Ranks of int64 slots in numpy int64 arithmetic on the host, from
    each slot's bitrank word (`words`, bitrank[slot >> 5] as int64) and the
    superblock bases: the rank of a present slot, the sentinel for absent
    and invalid ones."""
    import numpy as np
    ok = (slots >= 0) & (slots < size)
    e = words.view(np.uint64)
    bit = (slots & 31).astype(np.uint64)
    bits = e & np.uint64(0xFFFFFFFF)
    present = ok & (((bits >> bit) & np.uint64(1)) == 1)
    below = bits & ((np.uint64(1) << bit) - np.uint64(1))
    pc = np.zeros(below.shape, np.int64)
    for j in range(32):
        pc += ((below >> np.uint64(j)) & np.uint64(1)).astype(np.int64)
    sup = supers[np.clip(slots >> 32, 0, supers.shape[0] - 1)]
    rank = sup + (e >> np.uint64(32)).astype(np.int64) + pc
    return np.where(present, rank, sentinel)


def silver_golden(fq: str, prefix: str, engine: dict, extra: dict,
                  sizing: bool = False, device="cuda") -> dict:
    """The port's silver paths on `fq` and its golden path over their
    concatenation, as tools/torch_port_digests.py's silver_golden records
    them (with `sizing`, also the silver engine's universe and size), on
    `device` (a mesh's devices when `extra` asks for one)."""
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine as Engine
    eng = Engine(PathConfig(input=fq, prefix_file=prefix, **engine, **extra),
                 device=device)
    size = {"universe": eng.universe, "size": eng.size} if sizing else {}
    st = eng.run()
    del eng
    silver = {}
    with open(prefix + "_all.fq", "wb") as cat:
        for i in range(1, engine["max_paths"] + 1):
            p = f"{prefix}_{i}.fq"
            if os.path.exists(p):
                silver[str(i)] = sha256_file(p)
                with open(p, "rb") as f:
                    cat.write(f.read())
    gold = Engine(PathConfig(
        input=prefix + "_all.fq", prefix_file=prefix + "_golden",
        **{**engine, "silver_path": False, "min_length": 0}, **extra),
        device=device).run()
    return {**size, "recruits": st.recruits,
            "paths_completed": st.paths_completed, "silver": silver,
            "golden": sha256_file(prefix + "_golden.fa"),
            "golden_recruits": gold.recruits}


def genome_digests(fx: dict) -> dict:
    """7(a): the port's silver and golden paths on the 1 Mbp gate dataset
    (written by phase 5) at 4,603,242,496 slots, in the fixture's three
    "superblocks" cases, against the JAX package's digests; each freeze's
    supers and pop against a plain popcount of its bitmap.  Returns the
    freeze's least time in each case."""
    sb = fx["superblocks"]
    fq = os.path.join(WORK, "qgate.fq")
    rec = {}
    for tag, case in sb["cases"].items():
        t0 = time.time()
        with FreezeProbe() as fp:
            got = silver_golden(fq, os.path.join(WORK, f"super_{tag}"),
                                fx["engine"], {**sb["engine"], **case})
        say("genome", part="a", case=tag, files=len(got["silver"]) + 1,
            recruits=got["recruits"], golden_recruits=got["golden_recruits"],
            seconds=f"{time.time() - t0:.1f}", match=got == sb[tag],
            supers=fp.got[0], pop=fp.got[1],
            rank_build_ms=",".join(f"{v:.4f}" for v in fp.ms))
        if got != sb[tag] or len(fp.ms) != 2:
            raise AssertionError(f"superblocks {tag}: {got} vs {sb[tag]}, "
                                 f"{len(fp.ms)} freezes")
        rec[f"ms_gate_{tag}"] = min(fp.ms)
    return rec


class FreezeProbe:
    """Wraps the freeze (rank_build's launch) while engines fill: the
    plain per-superblock popcount of the bitmap before the kernel reads
    it, the supers and pop the launch returns, and its time between CUDA
    events (the launch and its scratch's zero-fill; not the population's
    fetch), for each call; any difference raises when the probe closes."""

    def __init__(self):
        from goldrush_tpu_torch.mibf import compressed as cz
        self.cz, self.real = cz, cz._build_rank_cuda
        self.ms, self.got, self.plain = [], None, None
        self.check_s = 0.0

    def __call__(self, bits, size):
        import torch
        t0 = time.time()
        self.plain = plain_popcount_supers(bits, size)
        self.check_s += time.time() - t0
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.real(bits, size)
        stop.record()
        torch.cuda.synchronize()
        self.ms.append(start.elapsed_time(stop))
        self.got = (out[1].tolist(), int(out[2]))
        if self.got != tuple(self.plain):
            raise AssertionError(f"freeze at {size} slots: supers/pop "
                                 f"{self.got} vs the bitmap's {self.plain}")
        return out

    def __enter__(self):
        self.cz._build_rank_cuda = self
        return self

    def __exit__(self, *exc):
        self.cz._build_rank_cuda = self.real


class ConsumeProbe:
    """Wraps the engine's consume_batch: the first `n` batches of a pass
    also run consume_batch_plain on host copies of their inputs, from host
    tables that start as the fresh filter's (zeros); each batch's rows,
    scal and counters, and after the n-th the whole id and counter tables,
    must equal.  The seconds the checks take are kept apart."""

    def __init__(self, n: int = 2):
        from goldrush_tpu_torch.path import engine as em
        self.em, self.n, self.real = em, n, em.consume_batch
        self.batches, self.check_s, self.host = 0, 0.0, None
        self.plain_s = self.compare_s = 0.0

    def call(self, spec, state, *args, **kw):
        import torch
        from goldrush_tpu_torch.mibf import compressed as cz
        from goldrush_tpu_torch.path import consume as tcons
        if self.batches >= self.n:
            return self.real(spec, state, *args, **kw)
        t0 = time.time()
        *inputs, scal, rows, counters, T = args
        if self.host is None:
            self.host = cz.CompressedState(
                torch.empty(0, dtype=torch.int64),
                torch.empty(0, dtype=torch.int64),
                torch.zeros(state.ids.shape, dtype=torch.int32),
                torch.zeros(state.counts.shape, dtype=torch.int32))
            self.scal, self.counters = scal.cpu(), counters.cpu()
        host_in = [t.cpu() for t in inputs]
        rows_p = torch.empty(rows.shape, dtype=torch.int64)
        self.check_s += time.time() - t0
        self.real(spec, state, *args, **kw)
        t0 = time.time()
        tcons.consume_batch_plain(spec, self.host, *host_in, self.scal,
                                  rows_p, self.counters, T)
        self.plain_s += time.time() - t0
        self.batches += 1
        same = (torch.equal(rows.cpu(), rows_p)
                and torch.equal(scal.cpu(), self.scal)
                and torch.equal(counters.cpu(), self.counters))
        if same and self.batches == self.n:
            t1 = time.time()
            same = (tables_equal(state.ids, self.host.ids)
                    and tables_equal(state.counts, self.host.counts))
            self.host = None
            self.compare_s = time.time() - t1
        self.check_s += time.time() - t0
        if not same:
            raise AssertionError(f"consume batch {self.batches} differs "
                                 "from consume_batch_plain")

    def __enter__(self):
        self.em.consume_batch = self.call
        return self

    def __exit__(self, *exc):
        self.em.consume_batch = self.real
        self.host = None


def rank_lookup_check(eng, reads: str) -> int:
    """2^20+ rank lookups through kernel A's rank grid: 9 reads of the
    engine's input `reads` (present slots) and 9 random ones (absent slots;
    four of them short, so frames are invalid), 18 x 3 seeds x 20,000
    frames, against host int64 arithmetic on bitrank and supers.  Every
    superblock must hold present and absent lookups and the sentinel must
    appear.  The grid is also timed at this filter's size.  The check's
    launches are not counted.  Returns the number of lookups, the grid's
    ms and its bound (codes in, ranks and frame_ok out, each distinct
    bitrank word and superblock base gathered once)."""
    import numpy as np
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.io import fastq
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    dev = torch.device("cuda", 0)
    T, TL = 20, eng.cfg.tile_length
    codes = np.zeros((18, T * TL + TL), np.uint8)
    for i, r in enumerate(fastq.read_records(reads)):
        if i == 9:
            break
        codes[i, : min(len(r.seq), T * TL)] = \
            fastq.encode(r.seq)[: T * TL]
    rng = np.random.default_rng(31)
    codes[9:, : T * TL] = rng.integers(0, 4, (9, T * TL), dtype=np.uint8)
    lengths = np.full(18, T * TL, np.int32)
    lengths[14:] = [999, 5_500, 12_345, 1_000]
    codes, lengths = torch.from_numpy(codes).to(dev), \
        torch.from_numpy(lengths).to(dev)
    p, cs = eng.params_full, eng.cstate
    before = kernels.SEED_HASH_RANK_GRID.launches
    ranks, ok = cz.build_rank_grid(cs, codes, lengths, eng.fam_ins, p, T)
    ms = cuda_ms(lambda: cz.build_rank_grid(cs, codes, lengths, eng.fam_ins,
                                            p, T), 20)
    kernels.SEED_HASH_RANK_GRID.launches = before
    slots, ok_p = dm._build_slot_grid_plain(codes, lengths, eng.fam_ins, p,
                                            T)
    # the words gathered on the card, the arithmetic on the host
    nw = cs.bitrank.shape[0] - 1
    words = cs.bitrank[torch.where(slots < p.size, slots >> 5, nw)]
    sl, got = slots.cpu().numpy(), ranks.cpu().numpy()
    sup = cs.supers.cpu().numpy()
    want = host_ranks(sl, words.cpu().numpy(), sup, p.size, cs.sentinel)
    present = want != cs.sentinel
    cover = [(int((present & (sl >> 32 == s)).sum()),
              int((~present & (sl >> 32 == s) & (sl < p.size)).sum()))
             for s in range(sup.shape[0])]
    if (not np.array_equal(got, want) or not torch.equal(ok.cpu(), ok_p.cpu())
            or any(a == 0 or b == 0 for a, b in cover)
            or not (got == cs.sentinel).any()):
        raise AssertionError(f"rank grid at {p.size} slots: "
                             f"{int((got != want).sum())} lookups differ, "
                             f"cover {cover}")
    real = sl[sl < p.size]
    nbytes = (codes.numel() + lengths.numel() * 4 + got.size * 8 + ok.numel()
              + np.unique(real >> 5).size * 8 + sup.size * 8)
    return got.size, ms, nbytes / HBM_BYTES_PER_S * 1e3


def genome_bench() -> dict:
    """7(b): the bench reads (written by phase 4) through GoldenPathEngine
    with the compressed filter sized for a ~2 Gbp genome
    (hash_universe=6e9: 56,947,329,536 slots, 14 superblocks, slot_map
    "mod"), one silver pass in exact mode and one in the throughput cell.
    Checks the freeze's supers and pop against a plain popcount of the
    bitmap, 2^20+ rank lookups against host arithmetic and the first two
    consume batches against consume_batch_plain; prints the sizes, times,
    reads/s and peak memory (the times less the checks').  Returns the
    freeze kernels' times and bounds, keyed by kernel."""
    import torch
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.path.engine import GoldenPathEngine as Engine
    reads = os.path.join(WORK, "bench_reads.fq")
    rec = {}
    for cell, extra in (("exact", {}), ("throughput", THROUGHPUT)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        eng = Engine(PathConfig(input=reads,
                                prefix_file=os.path.join(WORK, f"g_{cell}"),
                                mibf_mode="compressed", slot_map="mod",
                                hash_universe=GENOME_UNIVERSE,
                                **BENCH_ENGINE, **extra), device="cuda")
        init_s = time.time() - t0
        with FreezeProbe() as fp, ConsumeProbe(2) as cp:
            st = eng.run()
        cs = eng.cstate
        supers = cs.supers.tolist()
        if (len(fp.ms) != 1 or supers != fp.plain[0] or len(supers) != 14
                or cp.batches != 2):
            raise AssertionError(f"{cell}: supers/pop {fp.got} vs the "
                                 f"bitmap's {fp.plain}, {cp.batches} "
                                 "batches checked")
        lookups, grid_ms, grid_bound = rank_lookup_check(eng, reads)
        net = st.wall_assign_s - cp.check_s
        bound = freeze_bytes(eng.size) / HBM_BYTES_PER_S * 1e3
        say("genome", part="b", cell=cell, size=eng.size,
            n_super=len(supers), pop=fp.got[1], alloc=cs.ids.numel(),
            init_s=f"{init_s:.3f}",
            fill_s=f"{st.wall_fill_s - fp.check_s:.3f}",
            fill_stream_s=f"{st.wall_fill_stream_s:.3f}",
            freeze_s=f"{st.wall_freeze_s - fp.check_s:.3f}",
            freeze_check_s=f"{fp.check_s:.3f}",
            rank_build_ms=f"{fp.ms[0]:.4f}", rank_build_bound_ms=f"{bound:.4f}",
            assign_s=f"{st.wall_assign_s:.3f}",
            consume_check_s=f"{cp.check_s:.3f}",
            consume_plain_s=f"{cp.plain_s:.3f}",
            table_compare_s=f"{cp.compare_s:.3f}",
            reads=st.num_reads, recruits=st.recruits,
            reads_per_s=f"{st.num_reads / max(net, 1e-9):.2f}",
            paths_completed=st.paths_completed, rank_lookups=lookups,
            rank_grid_ms=f"{grid_ms:.4f}",
            rank_grid_bound_ms=f"{grid_bound:.4f}",
            max_memory_allocated=st.device_peak_bytes)
        if st.recruits <= 0 or not 0 < st.device_peak_bytes < 80e9:
            raise AssertionError(f"{cell}: {st.recruits} recruits, peak "
                                 f"{st.device_peak_bytes}")
        rec.setdefault("rank_build", {}).update({
            f"ms_genome_{cell}": fp.ms[0], f"bound_ms_genome_{cell}": bound})
        rec.setdefault("seed_hash_rank_grid", {}).update({
            f"ms_genome_{cell}": grid_ms,
            f"bound_ms_genome_{cell}": grid_bound})
        del eng, cs
        gc_cuda()
    return rec


def tables_equal(dev_t, host_t) -> bool:
    """Whether a table on the card equals one on the host, 2^24 entries at
    a time: the same number of nonzero entries, and the card's values at
    the host's nonzero positions (the tables of a fresh filter are zero but
    for the few entries inserts wrote, and a filter-sized copy to the host
    takes ~13 s per table)."""
    import torch
    step = 1 << 24     # the card's temporaries stay below 0.2 GB
    for a in range(0, dev_t.shape[0], step):
        h = host_t[a: a + step]
        d = dev_t[a: a + step]
        idx = torch.nonzero(h).flatten()
        if (int(torch.count_nonzero(d)) != idx.numel()
                or not torch.equal(d[idx.to(d.device)].cpu(), h[idx])):
            return False
    return True


def table_sum(t) -> int:
    """The int64 sum of a filter-sized int32 table, 2^28 entries at a time
    (a whole-table sum would widen it to int64 first: 35 GB here)."""
    import torch
    step = 1 << 28
    return sum(int(t[a: a + step].sum(dtype=torch.int64))
               for a in range(0, t.shape[0], step))


def gc_cuda() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def genome_high_ranks() -> None:
    """7(c): ranks at or above 2^32, which 7(b)'s reads never reach.  An
    all-ones bitmap of 2^32 + 2^26 slots (pop > 2^32, ~35 GB of tables)
    frozen by the kernels and by the plain versions; kernel A's rank grid
    against its plain version (every slot present: rank = slot); kernel D
    and insert_max on a recruit grid of ranks above 2^32, with pairs of
    keys 2^32 apart (equal low 32 bits), against their plain versions on
    host tables; then the consume kernel on four of the rank grid's reads
    (`high_rank_consume`)."""
    import numpy as np
    import torch
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.ops.nthash import build_seed_family
    from goldrush_tpu_torch.ops.seeds import make_seed_pattern
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    size = HIGH_SLOTS
    bits = torch.full((size // 32,), -1, dtype=torch.int32, device=dev)
    bitrank, supers, pop = cz.build_rank(bits, size)
    bp, sp, pop_p = cz._build_rank_plain(bits, size)
    if (not torch.equal(bitrank, bp) or not torch.equal(supers, sp)
            or pop != pop_p or pop != size or supers.tolist() != [0, 1 << 32]):
        raise AssertionError(f"all-ones freeze: pop {pop} / {pop_p}, supers "
                             f"{supers.tolist()} / {sp.tolist()}")
    del bits, bp, sp
    cs = cz.with_tables(bitrank, supers, pop, size)
    fam = build_seed_family(make_seed_pattern(PRESET, 22, 16, 3))
    T, TL = 20, 1000
    params = dm.MibfParams(size=size, h=3, k=22, spans=fam.spans,
                           tile_length=TL, threshold=10, block_size=10,
                           vote_topk=32, slot_map="mod")
    g = torch.Generator(device=dev)
    g.manual_seed(41)
    codes = torch.randint(0, 4, (32, T * TL + TL), dtype=torch.uint8,
                          device=dev, generator=g)
    lengths = torch.full((32,), T * TL, dtype=torch.int32, device=dev)
    ranks, ok = cz.build_rank_grid(cs, codes, lengths, fam, params, T)
    want, ok_p = cz._build_rank_grid_plain(cs, codes, lengths, fam, params, T)
    slots, _ = dm._build_slot_grid_plain(codes, lengths, fam, params, T)
    high = int((ranks >= 1 << 32).sum())
    if (not torch.equal(ranks, want) or not torch.equal(ok, ok_p)
            or not torch.equal(ranks, torch.where(ok[:, None], slots,
                                                  cs.sentinel))
            or high == 0):
        raise AssertionError(f"rank grid at ranks >= 2^32: {high} high "
                             f"ranks, {int((ranks != want).sum())} differ")
    # a recruit's grid [3, T*TL] of ranks: most above 2^32, and keys r and
    # r + 2^32 side by side, some repeated, some sentinels
    F = TL
    gen = torch.Generator().manual_seed(43)
    low = torch.randint(0, 1 << 26, (3, T * F // 2), generator=gen)
    grid = torch.stack([low + (1 << 32), low], dim=2).reshape(3, T * F)
    grid[:, ::97] = grid[:, :1]
    grid[:, 5::101] = cs.sentinel
    grid[1] = torch.where(torch.rand(T * F, generator=gen) < 0.5,
                          torch.randint(1 << 32, size, (T * F,),
                                        generator=gen), grid[1])
    grid_d = grid.to(dev)
    keys = torch.unique(grid[grid < cs.sentinel])
    keys_d = keys.to(dev)
    host_ids = torch.zeros(cs.ids.shape, dtype=torch.int32)
    host_counts = torch.zeros(cs.counts.shape, dtype=torch.int32)
    times = {}
    for lo, hi, base, trimmed in ((0, T - 1, 1, False), (3, 14, 50, True),
                                  (0, T - 1, 90, False)):
        t0 = time.time()
        dm.insert_blocks(cs.ids, cs.counts, grid_d, lo, hi, base, trimmed,
                         params, T, cs.sentinel, 0)
        torch.cuda.synchronize()
        times.setdefault("insert_sorted_s", time.time() - t0)
        dm._insert_plain(host_ids, host_counts, grid, lo, hi, base, trimmed,
                         params, T, cs.sentinel, 0)
    same = (torch.equal(cs.ids[keys_d].cpu(), host_ids[keys])
            and torch.equal(cs.counts[keys_d].cpu(), host_counts[keys])
            and table_sum(cs.ids) == int(host_ids[keys].long().sum())
            and table_sum(cs.counts) == int(host_counts[keys].long().sum()))
    accepted = int((host_ids[keys[keys >= 1 << 32]] != 0).sum())
    cs.ids.zero_()
    host_ids = torch.zeros(cs.ids.shape, dtype=torch.int32)
    t0 = time.time()
    dm.insert_max(cs.ids, grid_d, 0, T - 1, 1_000, False, params, T,
                  cs.sentinel, 0)
    torch.cuda.synchronize()
    times["insert_max_s"] = time.time() - t0
    dm._insert_max_plain(host_ids, grid, 0, T - 1, 1_000, False,
                         params.block_size, T, cs.sentinel, 0)
    same_max = (torch.equal(cs.ids[keys_d].cpu(), host_ids[keys])
                and table_sum(cs.ids) == int(host_ids[keys].long().sum()))
    say("genome", part="c", size=size, pop=pop, alloc=cs.ids.numel(),
        high_ranks_in_grid=high, keys=keys.numel(),
        keys_above_2_32=int((keys >= 1 << 32).sum()),
        accepted_above_2_32=accepted, insert_sorted_ok=same,
        insert_max_ok=same_max,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        **{k: f"{v:.4f}" for k, v in times.items()})
    if not (same and same_max and accepted > 0):
        raise AssertionError("inserts at ranks >= 2^32 differ from their "
                             "plain versions")
    del host_ids, host_counts
    high_rank_consume(cs, params, ranks[:4], ok[:4], T, dev)
    del cs, bitrank, supers
    gc_cuda()


def high_rank_consume(cs, params, ranks, ok, T: int, dev) -> None:
    """7(c) through the consume kernel: a batch of four reads on rank grids
    above 2^32 (the all-ones filter: rank = slot), each a batch-time
    recruit, so that read 0 inserts and reads 1-3 re-probe and insert, in
    both policies, against consume_batch_plain on host tables: rows,
    scal, counters and both tables."""
    import torch
    from goldrush_tpu_torch.path import consume as tcons
    B = ranks.shape[0]
    rows0 = torch.zeros((B, 8), dtype=torch.int64, device=dev)
    rows0[:, :4] = torch.tensor([1, 0, T - 1, T])
    n_tiles = torch.full((B,), T, dtype=torch.int32, device=dev)
    full = torch.full((B,), T * params.tile_length, dtype=torch.int64,
                      device=dev)
    inputs = (ranks, ok, ranks, ok, n_tiles, full, rows0)
    for fast in (False, True):
        spec = tcons.ConsumeSpec(
            params=params, params_full=params, params_ins=params,
            unassigned_min=5, assigned_max=1, fast=fast, rech_on=False,
            silver=False, target=0, max_paths=0)
        cs.ids.zero_()
        cs.counts.zero_()
        host = type(cs)(torch.empty(0, dtype=torch.int64),
                        torch.empty(0, dtype=torch.int64),
                        torch.zeros(cs.ids.shape, dtype=torch.int32),
                        torch.zeros(cs.counts.shape, dtype=torch.int32))
        scal = torch.tensor([0, 0, 1, 0], dtype=torch.int64, device=dev)
        scal_p = scal.cpu()
        ck, cp = tcons.new_counters(dev), tcons.new_counters("cpu")
        rows = torch.empty((B, 8), dtype=torch.int64, device=dev)
        rows_p = torch.empty((B, 8), dtype=torch.int64)
        tcons.consume_batch(spec, cs, *inputs, scal, rows, ck, T)
        torch.cuda.synchronize()
        tcons.consume_batch_plain(spec, host, *(t.cpu() for t in inputs),
                                  scal_p, rows_p, cp, T)
        same = (torch.equal(rows.cpu(), rows_p)
                and torch.equal(scal.cpu(), scal_p)
                and torch.equal(ck.cpu(), cp)
                and tables_equal(cs.ids, host.ids)
                and tables_equal(cs.counts, host.counts))
        say("genome", part="c", kernel="consume", fast=int(fast),
            counters=ck.tolist(), rows_dec=rows[:, 0].tolist(), same=same)
        if not same or ck[0] == 0 or ck[2] < 2:
            raise AssertionError(f"consume at ranks >= 2^32 (fast={fast}): "
                                 f"same={same}, counters {ck.tolist()}")
        del host
    cs.ids.zero_()
    cs.counts.zero_()


def phase_genome() -> dict:
    """Phase 7, the genome scale: (a) the "superblocks" digests, (b) the
    bench reads at 56,947,329,536 slots in both cells, every launch count
    zeroed just before (a) and read just after (b), (c) ranks at or above
    2^32.  Every kernel of the compressed path must launch in (a) and
    (b), the freeze once an engine run (one data row); then the freeze on
    synthetic bitmaps at both sizes (`freeze_scale_check`).  Returns the
    launch counts and the freeze's records."""
    import torch
    from goldrush_tpu_torch import kernels
    gc_cuda()
    with open(os.path.join(REPO, "tests", "fixtures",
                           "torch_port_digests.json")) as f:
        fx = json.load(f)
    say("genome", allocated_before=torch.cuda.memory_allocated())
    for k in kernels.ALL + (kernels.INSERT_SORTED, kernels.INSERT_MAX):
        k.launches = 0
    gate = genome_digests(fx)
    freeze = genome_bench()
    freeze["rank_build"].update(gate)
    launches = {k.name: k.launches for k in kernels.ALL}
    say("genome", launches=json.dumps(launches).replace(" ", ""))
    compressed = ("seed_hash_fill", "seed_hash_rank_grid", "rank_build",
                  "probe_vote", "classify", "consume")
    missing = [k for k in compressed if launches[k] <= 0]
    # three cases of silver and golden runs, then two silver runs
    if (missing or launches["presence_merge"] or launches["seed_hash_grid"]
            or launches["rank_build"] != 8):
        raise AssertionError(f"genome path: launches {launches}")
    rec = freeze_scale_check(torch.device("cuda", 0))
    err = rec.pop("max_abs_err")
    freeze["rank_build"].update(rec)
    if err:
        raise AssertionError(f"the freeze at scale: max_abs_err {err}")
    genome_high_ranks()
    return launches, freeze


# phase 7(d): the direct filter at the fixture's "direct_2_32" size
# (4,603,242,496 slots) beside the bench sizing's 142,368,384, in these
# cells, and the largest closed-form sizing one card holds: goldrush-path
# at G = 3e8, 8,542,099,456 slots, 68.3 GB of tables
D232_CASES = (("exact_fastrange", dict(slot_map="fastrange")),
              ("exact_mod", dict(slot_map="mod")),
              ("throughput_mod", dict(THROUGHPUT, slot_map="mod")))
D232_KERNELS = ("seed_hash_fill", "presence_merge", "seed_hash_grid",
                "probe_vote", "consume")
CAPACITY_G = 300_000_000


def chunked_err(a, b, step: int = 1 << 24) -> int:
    """max_abs_err of two equal-length 1-D tensors, `step` entries at a
    time (a filter-sized difference in int64 would not fit the card)."""
    if a.shape != b.shape:
        raise AssertionError(f"shapes {a.shape} vs {b.shape}")
    return max((max_abs_err([(a[i: i + step], b[i: i + step])])
                for i in range(0, a.shape[0], step)), default=0)


def direct_2_32_digests(fx: dict) -> None:
    """7(d)(i): the port's silver and golden paths on the 1 Mbp gate
    dataset (written by phase 5) with the direct filter at 4,603,242,496
    slots, in the fixture's three "direct_2_32" cases on one card and the
    throughput case banked 1x2 on ["cuda:0"] * 2, against the JAX
    package's digests, universes and sizes."""
    import torch
    d = fx["direct_2_32"]
    fq = gate_fastq(fx)
    runs = [(tag, case, "single", "cuda", {})
            for tag, case in d["cases"].items()]
    runs.append(("throughput_mod", d["cases"]["throughput_mod"], "1x2",
                 ["cuda:0"] * 2, dict(devices=2, model_shards=2)))
    for tag, case, layout, device, mesh in runs:
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        got = silver_golden(fq, os.path.join(WORK, f"d232_{layout}_{tag}"),
                            fx["engine"], {**d["engine"], **case, **mesh},
                            sizing=True, device=device)
        say("genome", part="d(i)", case=tag, layout=layout, size=got["size"],
            files=len(got["silver"]) + 1, recruits=got["recruits"],
            golden_recruits=got["golden_recruits"],
            seconds=f"{time.time() - t0:.1f}",
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            match=got == d[tag])
        if got != d[tag]:
            raise AssertionError(f"direct_2_32 {tag} {layout}: {got} vs "
                                 f"{d[tag]}")


def merge_chunks_err(words, bits, size: int, step: int = 1 << 28):
    """The first-write merge in `words` (the whole allocation) against the
    chunked plain merge, one chunk of `step` slots at a time into a buffer
    of its own (no second table): the largest difference, and the plain
    merge's seconds over the whole table."""
    import torch
    from goldrush_tpu_torch.mibf import mibf as dm
    buf = torch.empty(step, dtype=torch.int32, device=words.device)
    err, plain_s = 0, 0.0
    for a in range(0, words.shape[0], step):
        b = min(a + step, words.shape[0])
        n = max(0, min(size, b) - a)
        out = buf[: b - a]
        torch.cuda.synchronize()
        t0 = time.time()
        dm._merge_plain(out, bits[a // 32: a // 32 + -(-n // 32)], n,
                        first_write=True)
        torch.cuda.synchronize()
        plain_s += time.time() - t0
        err = max(err, chunked_err(words[a:b], out))
    return err, plain_s


def consume_at_size(te, inputs, T: int, dev, reps: int = 5) -> dict:
    """The consume kernel on one batch against consume_batch_plain on the
    same table, with no second table: the entries at the batch's grid keys
    snapshotted, the kernel run (and timed, the entries restored before
    each launch), its entries read, the snapshot restored, the plain
    version run and its entries read; rows, scal, counters and entries
    must equal, and whole-table checksums show that neither changed any
    other entry.  The batch must not rotate a silver path (a reset writes
    every entry).  Returns the record's numbers."""
    import torch
    from goldrush_tpu_torch.path import consume as tcons
    filt, size = te.state, te.size
    grid, _, grid_ins = inputs[:3]
    keys = torch.unique(torch.cat([grid.flatten(), grid_ins.flatten()]))
    keys = keys[keys < size]
    snap = [t[keys] for t in filt]
    sums0 = [table_sum(t) for t in filt]

    def launch():
        scal = torch.tensor([0, 0, 1, 0], dtype=torch.int64, device=dev)
        ck = tcons.new_counters(dev)
        rows = torch.empty((grid.shape[0], 8), dtype=torch.int64, device=dev)
        return scal, ck, rows
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        for t, v in zip(filt, snap):
            t[keys] = v
        scal, ck, rows = launch()
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        start.record()
        tcons.consume_batch(te.spec, filt, *inputs, scal, rows, ck, T)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    got = [t[keys] for t in filt]
    sums_k = [table_sum(t) for t in filt]
    for t, v in zip(filt, snap):
        t[keys] = v
    scal_p, cp, rows_p = launch()
    with plain_steps(te.spec, grid, grid_ins, size) as log:
        t0 = time.time()
        tcons.consume_batch_plain(te.spec, filt, *inputs, scal_p, rows_p, cp,
                                  T)
        torch.cuda.synchronize()
        pms = (time.time() - t0) * 1e3
    want = [t[keys] for t in filt]
    sums_p = [table_sum(t) for t in filt]
    err = max_abs_err([(rows, rows_p), (scal, scal_p), (ck, cp)]
                      + list(zip(got, want)))
    moved = [int(g.long().sum() - v.long().sum()) for g, v in zip(got, snap)]
    steps = {k: sum(1 for x in log if x[0] == k)
             for k in ("live", "recheck", "insert", "reset")}
    if (err or sums_k != sums_p
            or [a - b for a, b in zip(sums_k, sums0)] != moved
            or steps["reset"] or not steps["insert"]):
        raise AssertionError(f"consume at {size} slots: err {err}, sums "
                             f"{sums0} -> {sums_k} / {sums_p}, moved {moved}"
                             f", steps {steps}")
    nbytes = consume_bytes(te, inputs, log, filt, T)
    return dict(err=err, ms=sorted(times)[reps // 2], plain_ms=pms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, keys=keys.numel(),
                **steps)


def direct_size_check(dev, reads, universe, tag: str) -> dict:
    """7(d)(ii) at one size (`universe`: None for bench.py's engine,
    142,368,384 slots): per case of D232_CASES an engine's direct filter,
    and on it each kernel of the path against its plain version, timed:
    A's fill of the bench reads' fill pass (47 batches) into two bitmaps
    (the kernel's, the plain version's; the first batch timed), the
    first-write merge of the kernel's bitmap into the engine's words
    against the chunked plain merge (`merge_chunks_err`), A's query grid
    of the first bench batch (T=20), the consume kernel on that batch
    (`consume_at_size`) and B on its grid against the table the batch's
    inserts left.  Returns {kernel: {key: value}} with keys suffixed
    `{tag}_{case}`."""
    import numpy as np
    import torch
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.path.engine import GoldenPathEngine as Engine
    rec = {k: {} for k in D232_KERNELS}
    batches = fill_pass_batches(dev, reads)
    T, L = 20, BENCH["read_len"]
    for case, extra in D232_CASES:
        gc_cuda()
        te = Engine(PathConfig(**BENCH_ENGINE, mibf_mode="direct",
                               hash_universe=universe, **extra), device=dev)
        size, mode, fam = te.size, te.cfg.slot_map, te.fam_ins
        sfx = f"{tag}_{case}"
        out = {}
        # A's fill: the kernel's bitmap and the plain version's
        bk = dm.presence_bitmap(size, dev)
        bp = dm.presence_bitmap(size, dev)
        for c, n in batches:
            dm.fill_presence_bits(bk, c, n, fam, size, mode)
            dm._fill_bits_plain(bp, c, n, fam, size, mode)
        err = chunked_err(bk, bp)
        c0, n0 = batches[0]
        bp.zero_()
        dm.fill_presence_bits(bp, c0, n0, fam, size, mode)
        written = int(torch.count_nonzero(bp))
        ms = cuda_ms(lambda: dm.fill_presence_bits(bp, c0, n0, fam, size,
                                                   mode), 20)
        pms = cuda_ms(lambda: dm._fill_bits_plain(bp, c0, n0, fam, size,
                                                  mode), 3)
        del bp
        ln = n0.long()
        frames = [int(torch.clamp(ln - span + 1, min=0).sum())
                  for span in fam.spans]
        n_care = len(fam.care_left) + len(fam.care_right)
        out["seed_hash_fill"] = checked(
            err, ms, pms, c0.numel() + n0.numel() * 4 + written * 4,
            hash_ops(frames[0], sum(frames), n_care))
        # the merge: the first write of the engine's words, every entry
        words = te.state.words
        dm.merge_presence(words, bk, size, first_write=True)
        err, plain_s = merge_chunks_err(words, bk, size)
        ms = cuda_ms(lambda: dm.merge_presence(words, bk, size,
                                               first_write=True), 5)
        out["presence_merge"] = checked(
            err, ms, plain_s * 1e3, bk.numel() * 4 + words.numel() * 4)
        del bk
        # A's query grid of the first bench batch
        B = te.batch_reads
        codes = np.zeros((B, (T + 1) * te.cfg.tile_length), np.uint8)
        codes[:, :L] = reads[:B].cpu().numpy()
        qc = torch.from_numpy(codes).to(dev)
        ql = torch.full((B,), L, dtype=torch.int32, device=dev)
        p = te.params
        slots, ok = dm.build_slot_grid(qc, ql, te.fam_q, p, T)
        ps, pok = dm._build_slot_grid_plain(qc, ql, te.fam_q, p, T)
        err = max_abs_err([(slots, ps), (ok, pok)])
        ms = cuda_ms(lambda: dm.build_slot_grid(qc, ql, te.fam_q, p, T), 20)
        pms = cuda_ms(lambda: dm._build_slot_grid_plain(qc, ql, te.fam_q, p,
                                                        T), 3)
        n_ok = int(ok.sum())
        care_q = len(te.fam_q.care_left) + len(te.fam_q.care_right)
        out["seed_hash_grid"] = checked(
            err, ms, pms, qc.numel() + ql.numel() * 4 + slots.numel() * 8
            + ok.numel(), hash_ops(n_ok, n_ok * te.fam_q.h, care_q))
        del ps, pok
        # the consume kernel on the first bench batch
        inputs = te._batch_inputs(codes, np.full(B, L, np.int32),
                                  np.full(B, L, np.int64), T)
        c = consume_at_size(te, inputs, T, dev)
        out["consume"] = checked(c["err"], c["ms"], c["plain_ms"], 0)
        out["consume"]["bound_ms"] = c["bound_ms"]
        # B on the table the batch's inserts left
        vk = dm.probe_and_vote(words, slots, ok, p, T)
        vp = dm._probe_and_vote_plain(words, slots, ok, p, T)
        err = max_abs_err(zip(vk, vp))
        ms = cuda_ms(lambda: dm.probe_and_vote(words, slots, ok, p, T), 20)
        pms = cuda_ms(lambda: dm._probe_and_vote_plain(words, slots, ok, p,
                                                       T), 3)
        out["probe_vote"] = checked(
            err, ms, pms, vote_bytes(slots, ok, T, p.vote_topk, size,
                                     False))
        hits = int(vk.hits.sum())
        say("genome", part="d(ii)", case=case, size=size,
            alloc=words.numel(), batch=f"{B}x{T}", keys=c["keys"],
            live=c["live"], insert=c["insert"], recheck=c["recheck"],
            hits=hits, **{f"{k}_{f}": (f"{v[f]:.4f}" if f != "max_abs_err"
                                       else v[f])
                          for k, v in out.items()
                          for f in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms")})
        bad = {k: v["max_abs_err"] for k, v in out.items()
               if v["max_abs_err"]}
        if bad or hits == 0:
            raise AssertionError(f"7(d)(ii) {case} at {size} slots: "
                                 f"errors {bad}, {hits} hits")
        for k, v in out.items():
            rec[k].update({f"{f}_{sfx}": v[f] for f in
                           ("ms", "plain_ms", "bound_ms")})
        del te, words, slots, ok, vk, vp, inputs
    gc_cuda()
    return rec


def direct_capacity() -> dict:
    """7(d)(iii): goldrush-path through the CLI on the bench reads (written
    by phase 4) at G = 3e8 with the default direct filter in exact mode
    and no hash_universe: 8,542,099,456 slots, 68.3 GB of tables, the
    largest closed-form sizing one card holds.  Prints each stage's size,
    construction and fill seconds, the silver assign's reads/s and the
    peak device memory; returns the launch counts of the run (zeroed just
    before it)."""
    import torch
    from goldrush_tpu_torch import kernels, pipeline
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    made = []

    def make(pc, device):
        # the engine's size and construction time only: holding the engine
        # would keep the silver stage's tables while the golden stage's come
        t0 = time.time()
        eng = GoldenPathEngine(pc, device=device)
        made.append((eng.size, time.time() - t0))
        return eng
    for k in kernels.ALL + (kernels.INSERT_SORTED, kernels.INSERT_MAX):
        k.launches = 0
    pipeline.GoldenPathEngine = make
    try:
        out = run_cli(["goldrush-path",
                       f"reads={os.path.join(WORK, 'bench_reads')}",
                       f"G={CAPACITY_G}", "device=cuda",
                       f"prefix={os.path.join(WORK, 'capacity')}", "dev=1"])
    finally:
        pipeline.GoldenPathEngine = GoldenPathEngine
    launches = {k.name: k.launches for k in kernels.ALL}
    peak = torch.cuda.max_memory_allocated()
    for (stage, st), (size, init_s) in zip(out["stats"].items(), made):
        say("genome", part="d(iii)", stage=stage, size=size,
            alloc_bytes=8 * (-(-(size + 1) // 1024) * 1024),
            init_s=f"{init_s:.3f}", fill_s=f"{st.wall_fill_s:.3f}",
            assign_s=f"{st.wall_assign_s:.3f}", reads=st.num_reads,
            recruits=st.recruits,
            reads_per_s=f"{st.num_reads / max(st.wall_assign_s, 1e-9):.2f}")
    say("genome", part="d(iii)", wall_s=f"{out['wall_s']:.2f}",
        max_memory_allocated=peak,
        launches=json.dumps(launches).replace(" ", ""))
    silver = out["stats"]["silver"]
    card = torch.cuda.get_device_properties(0).total_memory
    if (made[0][0] < 8_000_000_000 or silver.recruits <= 0
            or not 68e9 < peak < card or launches["consume"] <= 0
            or launches["presence_merge"] != len(made)):
        raise AssertionError(f"7(d)(iii): sizes {made}, {silver.recruits} "
                             f"recruits, peak {peak}, launches {launches}")
    return launches


def phase_direct(fx: dict) -> tuple[dict, dict, dict]:
    """Phase 7(d), the direct filter at 2^32 slots and more, after 7(c):
    (i) the "direct_2_32" digests, every launch count zeroed just before
    and read just after; (ii) its kernels against their plain versions at
    4,603,242,496 slots and at 142,368,384 (not counted); (iii) the
    capacity run at G = 3e8, counted on its own.  Returns (i)'s launches,
    (iii)'s and (ii)'s records by kernel."""
    import torch
    from goldrush_tpu_torch import kernels
    gc_cuda()
    say("genome", part="d", allocated_before=torch.cuda.memory_allocated())
    for k in kernels.ALL + (kernels.INSERT_SORTED, kernels.INSERT_MAX):
        k.launches = 0
    direct_2_32_digests(fx)
    launches = {k.name: k.launches for k in kernels.ALL}
    say("genome", part="d(i)", launches=json.dumps(launches).replace(" ", ""))
    direct = ("seed_hash_fill", "presence_merge", "seed_hash_grid",
              "probe_vote", "classify", "consume")
    ranks = ("seed_hash_rank_grid", "rank_build")
    if (any(launches[k] <= 0 for k in direct)
            or any(launches[k] for k in ranks)
            or kernels.INSERT_SORTED.launches or kernels.INSERT_MAX.launches):
        raise AssertionError(f"7(d)(i): launches {launches}")
    dev = torch.device("cuda", 0)
    reads = bench_reads(dev)[1]
    checks = {k: {} for k in D232_KERNELS}
    for universe, tag in ((None, "d142m"),
                          (fx["direct_2_32"]["engine"]["hash_universe"],
                           "d232")):
        for k, v in direct_size_check(dev, reads, universe, tag).items():
            checks[k].update(v)
    for k, v in checks.items():
        for f in ("ms", "plain_ms", "bound_ms"):
            for tag in ("d142m", "d232"):
                vals = [v[f"{f}_{tag}_{c}"] for c, _ in D232_CASES]
                v[f"{f}_{tag}"] = sum(vals) / len(vals)
    del reads
    capacity = direct_capacity()
    return launches, capacity, checks


NTCARD_RBITS = (22, 27)        # the engine's and the reference's


def ntcard_edge_batches(fam, reads: list, dev) -> dict:
    """8(a)'s batches beside the bench reads': the first bench batch's
    shape with read i all base i % 4 (homopolymer: every lane of a warp
    reads one table entry), and 4,192,320 bases of short reads cycling
    through k - 1, k, k + 1, the longest span - 1, it, + 1 (the stale
    tails), 50, 100, 300 and 1,000 bases (one unit or item each, most of
    it empty), random from a seed."""
    import numpy as np
    from goldrush_tpu_torch.utils import ntcard as nt
    offsets = reads[0].offsets.cpu().numpy()
    lens = np.diff(offsets)
    homo = np.repeat((np.arange(len(lens)) % 4).astype(np.uint8), lens)
    k, top = fam.k, fam.spans[-1]
    short = np.tile([k - 1, k, k + 1, top - 1, top, top + 1, 50, 100, 300,
                     1_000], 2_640)
    rng = np.random.default_rng(16)
    codes = rng.integers(0, 4, int(short.sum())).astype(np.uint8)
    return {"homopolymer": nt.pack_batch(homo, offsets, fam.k, dev),
            "short": nt.pack_batch(codes, np.concatenate(
                [[0], np.cumsum(short)]), fam.k, dev)}


def ntcard_kernel_check(dev, reads: str) -> dict:
    """8(a): ntcard_count (K22) against its plain version on the card, on
    the bench dataset's batches, at rbits 22 (the engine's: 3 banks of
    2^23 uint32) and 27 (the reference's: 3 banks of 2^28, 3 GiB), sbits
    7: the counters equal and each seed's F0 too; and on a homopolymer
    batch and a batch of short reads (`ntcard_edge_batches`), each alone,
    the counters equal.  The first batch timed beside the plain version
    and index_add_ of ones into the counters from its sampled hashes' bank
    indices precomputed (the library call, held to the kernel's
    counters), the other two timed alone.  Bound: the hash's integer
    operations in the block-table form (ntcard_block_ops, the record's
    bound_ms) and in the per-care-offset form (ntcard_ops, bound_ms_care)
    over the batch's positions and every seed's own frames, or the codes,
    offsets and work list in and one 32-byte sector per atomic: one per
    sampled own frame (a seed's stale tail is one weighted atomic at its
    last own frame).  Returns the record at rbits 22 with the rbits 27
    times beside it."""
    import torch
    from goldrush_tpu_torch.ops.nthash import build_seed_family
    from goldrush_tpu_torch.ops.seeds import make_seed_pattern
    from goldrush_tpu_torch.utils import ntcard as nt
    fam = build_seed_family(make_seed_pattern(PRESET, 22, 16, 3))
    sbits = 7
    batches = [nt.pack_batch(c, o, fam.k, dev)
               for c, o in nt.read_batches(reads)]
    edges = ntcard_edge_batches(fam, batches, dev)
    first = batches[0]
    codes, offsets = first.codes, first.offsets
    lens = offsets[1:] - offsets[:-1]
    frames = torch.clamp(lens - fam.k + 1, min=0)
    positions = int(frames.sum())
    own = [int(torch.minimum(frames, torch.clamp(frames - s, min=1)).sum())
           for s in range(fam.h)]
    hashes = sum(own)
    n_care = len(fam.care_left) + len(fam.care_right)
    # block lookups a position: each half's blocks of 4 positions up to its
    # last care offset (SeedFamily.block_counts)
    lookups = sum(-(-(max(c, default=-1) + 1) // 4)
                  for c in (fam.care_left, fam.care_right))
    out = {}
    for rbits in NTCARD_RBITS:
        zeros = lambda: torch.zeros((fam.h, 2 << rbits),  # noqa: E731
                                    dtype=torch.int32, device=dev)
        k, p = zeros(), zeros()
        for b in batches:
            nt.ntcard_count(k, b, fam, rbits, sbits)
            nt._ntcard_count_plain(p, b.codes, b.offsets, fam, rbits, sbits)
        err = max_abs_err([(k, p)])
        f0 = [nt._estimate_f0(k[s], rbits, sbits, 10000)[0]
              for s in range(fam.h)]
        f0_plain = [nt._estimate_f0(p[s], rbits, sbits, 10000)[0]
                    for s in range(fam.h)]
        if f0 != f0_plain:
            raise AssertionError(f"ntcard rbits {rbits}: F0 {f0} vs "
                                 f"{f0_plain}")
        edge = {}
        for tag, b in edges.items():
            k.zero_()
            p.zero_()
            nt.ntcard_count(k, b, fam, rbits, sbits)
            nt._ntcard_count_plain(p, b.codes, b.offsets, fam, rbits, sbits)
            e = max_abs_err([(k, p)])
            err = max(err, e)
            edge[tag] = cuda_ms(lambda: nt.ntcard_count(k, b, fam, rbits,
                                                        sbits), 10)
            say("ntcard", part="a", rbits=rbits, batch=tag,
                bases=b.codes.numel(), reads=b.offsets.numel() - 1,
                counted=int(p.sum()), max_abs_err=e, ms=f"{edge[tag]:.4f}")
        del p
        # the first batch's sampled counters, one per frame (the stale tail
        # repeated), as the plain version computes them; the kernel's
        # atomics, one per sampled own frame
        idx, atomics = [], 0
        for s, (hs, valid) in enumerate(nt.seed_hashes(codes, offsets, fam)):
            i = nt.bank_index(hs[valid], rbits, sbits)
            idx.append(s * (2 << rbits) + i[i < 2 << rbits])
            pos = torch.arange(hs.numel() // lens.numel(), device=dev)
            owned = valid & (pos[None, :] < torch.clamp(
                lens - fam.spans[s] + 1, min=1)[:, None]).reshape(-1)
            atomics += int((nt.bank_index(hs[owned], rbits, sbits)
                            < 2 << rbits).sum())
        idx = torch.cat(idx)
        ones = torch.ones(idx.shape, dtype=torch.int32, device=dev)
        one_k, lib = zeros(), zeros()
        nt.ntcard_count(one_k, first, fam, rbits, sbits)
        lib.view(-1).index_add_(0, idx, ones)
        err = max(err, max_abs_err([(one_k, lib)]))
        ms = cuda_ms(lambda: nt.ntcard_count(one_k, first, fam, rbits,
                                             sbits), 10)
        pms = cuda_ms(lambda: nt._ntcard_count_plain(
            lib, codes, offsets, fam, rbits, sbits), 2)
        lib_ms = cuda_ms(lambda: lib.view(-1).index_add_(0, idx, ones), 10)
        sampled = idx.numel()
        nbytes = (codes.numel() + offsets.numel() * 8
                  + first.item_read.numel() * 12 + atomics * 32)
        rec = checked(err, ms, pms, nbytes, ntcard_block_ops(
            positions, lookups, hashes, hashes - own[0], atomics),
            ms_homopolymer=edge["homopolymer"], ms_short=edge["short"])
        rec["bound_ms_care"] = checked(err, ms, pms, nbytes, ntcard_ops(
            positions, hashes, n_care))["bound_ms"]
        rec["library_ms"] = lib_ms
        say("ntcard", part="a", rbits=rbits, batches=len(batches),
            batch_bases=codes.numel(), positions=positions, hashes=hashes,
            sampled=sampled, atomics=atomics, counters=k.numel(),
            max_abs_err=err,
            f0=",".join(str(int(x)) for x in f0), ms=f"{ms:.4f}",
            plain_ms=f"{pms:.4f}", library_ms=f"{lib_ms:.4f}",
            bound_ms=f"{rec['bound_ms']:.4f}", bound_by=rec["bound_by"],
            bound_ms_care=f"{rec['bound_ms_care']:.4f}")
        if err or sampled == 0:
            raise AssertionError(f"ntcard rbits {rbits}: max_abs_err {err}, "
                                 f"{sampled} sampled")
        del k, one_k, lib, idx, ones
        gc_cuda()
        if not out:
            out = rec
        else:
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out.update({f"{key}_r{rbits}": rec[key] for key in (
                "ms", "ms_homopolymer", "ms_short", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "bound_ms_care")})
    return out


def ntcard_digests(fx: dict) -> None:
    """8(b): the engine sized by ntCard on the 1 Mbp gate dataset, exact
    mode, each filter: universe, size, silver and golden digests against
    the fixture's "ntcard" key."""
    nc = fx["ntcard"]
    fq = os.path.join(WORK, "qgate.fq")
    for mode in ("direct", "compressed"):
        t0 = time.time()
        got = silver_golden(fq, os.path.join(WORK, f"ntcard_{mode}"),
                            fx["engine"], {**nc["engine"], "mibf_mode": mode},
                            sizing=True)
        say("ntcard", part="b", filter=mode, universe=got["universe"],
            size=got["size"], files=len(got["silver"]) + 1,
            recruits=got["recruits"], golden_recruits=got["golden_recruits"],
            seconds=f"{time.time() - t0:.1f}", match=got == nc[mode])
        if got != nc[mode]:
            raise AssertionError(f"ntcard {mode}: {got} vs {nc[mode]}")


def insert_digests(fx: dict) -> None:
    """8(c): the sampled inserts on the 1 Mbp gate dataset, each case of
    the fixture's "insert" key: the silver digests, recruits > 0 and one
    insert inside the consume kernel per recruit."""
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine as Engine
    ins = fx["insert"]
    fq = os.path.join(WORK, "qgate.fq")
    for tag, case in ins["cases"].items():
        prefix = os.path.join(WORK, f"insert_{tag}")
        t0 = time.time()
        consume0 = kernels.CONSUME.launches
        eng = Engine(PathConfig(input=fq, prefix_file=prefix,
                                **fx["engine"], **case), device="cuda")
        st = eng.run()
        silver = {str(i): sha256_file(f"{prefix}_{i}.fq")
                  for i in range(1, fx["engine"]["max_paths"] + 1)
                  if os.path.exists(f"{prefix}_{i}.fq")}
        got = {"recruits": st.recruits,
               "paths_completed": st.paths_completed, "silver": silver}
        c = eng.consume_counts
        say("ntcard", part="c", case=tag, files=len(silver),
            recruits=st.recruits, consume_launches=kernels.CONSUME.launches
            - consume0, consume_inserts=c["insert"],
            recheck_probes=c["recheck"], seconds=f"{time.time() - t0:.1f}",
            match=got == ins[tag])
        if got != ins[tag] or st.recruits <= 0 or \
                c["insert"] != st.recruits:
            raise AssertionError(f"insert {tag}: {got} vs {ins[tag]}, "
                                 f"consume counts {c}")


def ntcard_bench(reads: str) -> None:
    """8(d): the bench reads' silver pass in the throughput cell with the
    compressed filter, sized by ntCard and then by the closed form (G):
    the estimate, size, superblocks, the occupancy after the fill, the
    ntCard pass's wall time, the fill's, assign reads/s and peak device
    memory; then ntCard's pass again alone (estimate_genome_size, as the
    engine calls it), its wall time split into the host's read stream and
    packing, the launches' device time and the F0 histograms, its
    estimate equal to the engine's."""
    import torch
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.path.engine import GoldenPathEngine as Engine
    from goldrush_tpu_torch.utils import ntcard as nt
    for sizing, extra in (("ntcard", {"ntcard": True}), ("closed_form", {})):
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(PathConfig(input=reads,
                                prefix_file=os.path.join(WORK, f"nb_{sizing}"),
                                mibf_mode="compressed", **BENCH_ENGINE,
                                **THROUGHPUT, **extra), device="cuda")
        st = eng.run()
        pop = int(cz._popcount32(eng.cstate.bitrank[:-1]
                                 & 0xFFFFFFFF).sum())
        say("ntcard", part="d", sizing=sizing, universe=eng.universe,
            size=eng.size, n_super=cz.n_supers(eng.size), pop=pop,
            occupancy=f"{pop / eng.size:.4f}",
            ntcard_s=f"{st.wall_ntcard_s:.3f}", fill_s=f"{st.wall_fill_s:.3f}",
            assign_s=f"{st.wall_assign_s:.3f}", recruits=st.recruits,
            reads_per_s=f"{st.num_reads / max(st.wall_assign_s, 1e-9):.2f}",
            paths_completed=st.paths_completed,
            device_peak_bytes=st.device_peak_bytes)
        if st.recruits <= 0 or (sizing == "ntcard") != (st.wall_ntcard_s > 0):
            raise AssertionError(f"ntcard bench {sizing}: {st}")
        if sizing == "ntcard":
            times = {}
            t0 = time.perf_counter()
            universe = nt.estimate_genome_size(
                reads, eng.seeds, nt.NtCardParams(rbits=22, sbits=7),
                device="cuda", times=times)
            wall = time.perf_counter() - t0
            say("ntcard", part="d", split="estimate_genome_size",
                universe=universe, wall_s=f"{wall:.3f}",
                read_pack_s=f"{times['read_s']:.3f}",
                batches=times["batches"],
                launches_device_ms=f"{times['count_ms']:.4f}",
                f0_histogram_s=f"{times['f0_s']:.3f}",
                other_s=f"{wall - times['read_s'] - times['f0_s']:.3f}")
            if universe != eng.universe:
                raise AssertionError(f"ntcard split: {universe} vs "
                                     f"{eng.universe}")
        del eng


def phase_ntcard() -> tuple[dict, dict]:
    """Phase 8, ntCard's sizing and the sampled inserts: (a) the kernel
    against its plain version; then, every launch count zeroed just before
    and read just after, (b) the "ntcard" digests, (c) the "insert"
    digests, (d) the bench reads sized by ntCard.  ntcard_count and every
    kernel of the compressed and the direct path must launch in (b)-(d).
    Returns the launch counts and ntcard_count's record."""
    import torch
    from goldrush_tpu_torch import kernels
    gc_cuda()
    dev = torch.device("cuda", 0)
    with open(os.path.join(REPO, "tests", "fixtures",
                           "torch_port_digests.json")) as f:
        fx = json.load(f)
    reads = os.path.join(WORK, "bench_reads.fq")
    rec = ntcard_kernel_check(dev, reads)
    inserts = (kernels.INSERT_SORTED, kernels.INSERT_MAX)
    for k in kernels.ALL + inserts:
        k.launches = 0
    ntcard_digests(fx)
    insert_digests(fx)
    ntcard_bench(reads)
    launches = {k.name: k.launches for k in kernels.ALL}
    say("ntcard", launches=json.dumps(launches).replace(" ", ""))
    missing = [k.name for k in kernels.PATH + kernels.SIZING
               if launches[k.name] <= 0]
    if missing or any(k.launches for k in inserts + kernels.STAGES):
        raise AssertionError(f"ntcard path: launches {launches}")
    return launches, rec


WAVE = dict(wavefront=True, wave_window=256)


def wave_round_bytes(counts: dict, rows, n_tiles, grids, T: int, table,
                     side, compressed: bool, word: int = 32) -> int:
    """The bytes of a window's rounds, from its counters and final rows:
    per classified read its query grid row, frame_ok and two table words
    (both tables) per entry, and its row; per rechecked read the same over
    the insert grid; per committed read (a final decision above 0) its
    tiles of the insert grid and two atomics per entry; per rotation the
    id table read and written (the direct words keep PRESENT) and the side
    table written; the adjacency read once.  A table word or an atomic is
    a random address: `word` bytes each, 32 for the card's sector, 4 for
    the word alone."""
    import torch
    grid, grid_ins = grids
    B, Hq, TFq = grid.shape
    _, Hi, TFi = grid_ins.shape

    def per_probe(H, TF):
        return H * TF * 8 + TF + 2 * word * H * TF + 64
    nbytes = (counts["classified"] * per_probe(Hq, TFq)
              + counts["rechecked"] * per_probe(Hi, TFi))
    dec, ts, te = rows[:, 0], rows[:, 1], rows[:, 2]
    tiles = torch.where(dec == 1, n_tiles.long(),
                        torch.where(dec == 2, te - ts + 1, 0))
    nbytes += int(tiles.sum()) * Hi * (TFi // T) * (8 + 2 * word)
    nbytes += counts["rotations"] * (table.numel() * 4 * (1 if compressed
                                                           else 2)
                                     + side.numel() * 4)
    return nbytes + B * B * 4


# 9(a)'s windows of 256 reads, in turn on one filter: two of the bench
# reads, a third whose first commit fills the silver path (a rotation
# inside the window), one of homopolymer reads (read i all base i % 4: a
# conflict key per seed and strand holds 20,000 frames of each of 128
# reads) and one bench read repeated 256 times (every key in 256 reads)
WAVE_WINDOWS = ("bench_1", "bench_2", "rotation", "homopolymer", "repeated")


def wave_filters(dev, reads):
    """9(a)'s engines: bench.py's throughput cell with wavefront=True and
    windows of 256 reads, each filter (direct, then compressed), its
    filter filled from the bench reads.  Yields (mode, engine, filter)."""
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    for mode in ("direct", "compressed"):
        te = GoldenPathEngine(PathConfig(**BENCH_ENGINE, **THROUGHPUT,
                                         **WAVE, mibf_mode=mode), device=dev)
        bits = dm.presence_bitmap(te.size, dev)
        for c, n in fill_pass_batches(dev, reads):
            dm.fill_presence_bits(bits, c, n, te.fam_ins, te.size,
                                  te.cfg.slot_map)
        if mode == "direct":
            dm.merge_presence(te.state.words, bits, te.size, first_write=True)
        else:
            te.cstate = cz.with_tables(*cz.build_rank(bits, te.size), te.size)
        del bits
        yield mode, te, te.cstate if mode == "compressed" else te.state
        del te
        gc_cuda()


def wave_inputs(te, reads, w: int, name: str) -> tuple:
    """The engine's inputs (`_window_inputs`) of WAVE_WINDOWS[w], `name`,
    from the bench reads."""
    import numpy as np
    B, T, L = te.batch_reads, 20, BENCH["read_len"]
    codes = np.zeros((B, 21 * te.cfg.tile_length), np.uint8)
    if name == "homopolymer":
        codes[:, :L] = (np.arange(B) % 4)[:, None]
    elif name == "repeated":
        codes[:, :L] = reads[w * B].cpu().numpy()
    else:
        codes[:, :L] = reads[w * B:(w + 1) * B].cpu().numpy()
    lengths = np.full(B, L, np.int32)
    return te._window_inputs(codes, lengths, np.full(B, L, np.int64), T)


def wave_kernel_check(dev) -> dict:
    """9(a): wave_adjacency and wave_rounds against their plain versions on
    the card, at bench.py's throughput cell with wavefront=True and
    windows of 256 reads (B = 256, 20 tiles, one probed seed at stride 8,
    h = 3 insert seeds at full resolution), each filter, on a filter filled
    from the bench dataset's reads: the WAVE_WINDOWS in turn (two of the
    bench reads, a rotation inside the third, homopolymer reads, one read
    repeated).  The adjacency exactly (max_abs_err 0), the rounds' rows,
    scal, counters and both tables exactly and no fault; each timed
    with CUDA events (the rounds from the same start, restored outside
    the timed span), beside the plain version, its bound and, for the
    adjacency, torch.sort of the window's keys (the library time).
    Returns {"wave_adjacency": record, "wave_rounds": record}."""
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.ops.nthash import fingerprints
    from goldrush_tpu_torch.path import wavefront as wave
    _, reads = bench_reads(dev)
    adj_rec, rnd_rec, err_a, err_r = {}, {}, 0, 0
    for mode, te, filt in wave_filters(dev, reads):
        B, T = te.batch_reads, 20
        table = filt.ids if mode == "compressed" else filt.words
        side = torch.zeros_like(table)
        plain = type(filt)(*(t.clone() for t in filt))
        side_p = side.clone()
        _, _, ranked, limit, _ = wave._filter_view(filt, te.size)
        target = te.cfg.target_bases()
        scal = torch.tensor([0, 0, 1, 0], dtype=torch.int64, device=dev)
        for w, name in enumerate(WAVE_WINDOWS):
            if name == "rotation":
                scal.copy_(torch.tensor([0, target - 1, 1, 0]))
            scal_p = scal.clone()
            inputs = wave_inputs(te, reads, w, name)
            codes_d, grid, ok, gi, oi, nt, fl = inputs
            # the adjacency
            a0 = kernels.WAVE_ADJACENCY.launches
            adj = wave.wave_adjacency(te.wave_spec, gi, codes_d, limit,
                                      ranked, T)
            launched = kernels.WAVE_ADJACENCY.launches - a0
            torch.cuda.synchronize()
            t0 = time.time()
            fp = fingerprints(codes_d, te.fam_ins, T * te.cfg.tile_length,
                              te.params_ins.frame_stride, wave.FP_BITS)
            adj_p = wave.wave_adjacency_plain(gi, fp, limit, ranked)
            torch.cuda.synchronize()
            pms = (time.time() - t0) * 1e3
            e = max_abs_err([(adj, adj_p)])
            err_a = max(err_a, e)
            ob = wave.ord_bits(B)
            conf = gi if ranked else gi & ((1 << 24) - 1)
            keys = (((conf << wave.FP_BITS | fp) << ob)
                    | torch.arange(B, device=dev)[:, None, None])[gi < limit]
            del fp, conf
            ms = cuda_ms(lambda: wave.wave_adjacency(
                te.wave_spec, gi, codes_d, limit, ranked, T), 5, hold=4)
            lib_ms = cuda_ms(lambda: torch.sort(keys), 5, hold=4)
            n_care = len(te.fam_ins.care_left) + len(te.fam_ins.care_right)
            positions = B * T * te.params_ins.tile_length \
                // te.params_ins.frame_stride
            a_bytes = gi.numel() * 8 + codes_d.numel() + B * B * 4
            a_ops = ntcard_ops(positions, keys.numel(), n_care)
            rec = checked(e, ms, pms, a_bytes, a_ops)
            tag = f"{mode}_{name}"
            adj_rec.update({f"ms_{tag}": ms, f"plain_ms_{tag}": pms,
                            f"library_ms_{tag}": lib_ms,
                            f"bound_ms_{tag}": rec["bound_ms"],
                            f"bound_by_{tag}": rec["bound_by"]})
            say("wave", part="a", kernel="wave_adjacency", filter=mode,
                window=name, B=B, keys=keys.numel(), launches=launched,
                overlaps=int((adj >= wave.ADJ_MIN).sum()), max_abs_err=e,
                ms=f"{ms:.4f}", plain_ms=f"{pms:.2f}",
                library_ms=f"{lib_ms:.4f}",
                bound_ms=f"{rec['bound_ms']:.4f}", bound_by=rec["bound_by"])
            del keys
            if e or launched != 1:
                raise AssertionError(f"wave_adjacency {tag}: max_abs_err {e},"
                                     f" {launched} launches")
            # the rounds
            saved = [t.clone() for t in filt] + [side.clone(), scal.clone()]
            rows_k = torch.empty((B, 8), dtype=torch.int64, device=dev)
            rows_p = torch.empty_like(rows_k)
            ck, cp = wave.new_counters(dev), wave.new_counters(dev)
            r0 = kernels.WAVE_ROUNDS.launches
            wave.wave_window(te.wave_spec, filt, side, grid, ok, gi, oi, nt,
                             fl, adj, scal, rows_k, ck, T)
            launched = kernels.WAVE_ROUNDS.launches - r0
            torch.cuda.synchronize()
            t0 = time.time()
            wave.wave_window_plain(te.wave_spec, plain, side_p, grid, ok, gi,
                                   oi, nt, fl, adj, scal_p, rows_p, cp, T)
            torch.cuda.synchronize()
            pms = (time.time() - t0) * 1e3
            e = max_abs_err([(rows_k, rows_p), (scal, scal_p), (ck, cp),
                             (side, side_p)] + list(zip(filt, plain)))
            err_r = max(err_r, e)
            after = [t.clone() for t in filt] + [side.clone(), scal.clone()]
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            ms, reps = 0.0, 3
            for _ in range(reps):
                for t, v in zip(list(filt) + [side, scal], saved):
                    t.copy_(v)
                torch.cuda._sleep(1_000_000)
                start.record()
                wave.wave_window(te.wave_spec, filt, side, grid, ok, gi, oi,
                                 nt, fl, adj, scal, rows_k,
                                 wave.new_counters(dev), T)
                stop.record()
                torch.cuda.synchronize()
                ms += start.elapsed_time(stop) / reps
            err_r = max(err_r, max_abs_err(zip(list(filt) + [side, scal],
                                               after)))
            counts = dict(zip(wave.WAVE_COUNTS, cp.tolist()))
            bound, bound_words = (wave_round_bytes(
                counts, rows_p.cpu(), nt.cpu(), (grid, gi), T, table, side,
                mode == "compressed", word) / HBM_BYTES_PER_S * 1e3
                for word in (32, 4))
            WAVE_MS[tag] = ms
            rnd_rec.update({f"ms_{tag}": ms, f"plain_ms_{tag}": pms,
                            f"bound_ms_{tag}": bound,
                            f"bound_ms_words_{tag}": bound_words,
                            f"rounds_{tag}": counts["rounds"]})
            say("wave", part="a", kernel="wave_rounds", filter=mode,
                window=name, launches=launched, max_abs_err=e,
                scal=scal.tolist(), **counts, ms=f"{ms:.4f}",
                plain_ms=f"{pms:.1f}", bound_ms=f"{bound:.5f}",
                bound_ms_words=f"{bound_words:.5f}")
            if e or launched != 1 or counts["faults"]:
                raise AssertionError(f"wave_rounds {tag}: max_abs_err {e}, "
                                     f"{launched} launches, {counts}")
            if name == "rotation" and not counts["rotations"]:
                raise AssertionError(f"wave_rounds {tag}: no rotation")
            del saved, after, inputs, adj, adj_p
        del te, filt, plain, side, side_p, table
    out = {}
    for kname, rec, err in (("wave_adjacency", adj_rec, err_a),
                            ("wave_rounds", rnd_rec, err_r)):
        # the record's times: the mean over the windows of bench reads
        tags = [k[3:] for k in rec if k.startswith("ms_")
                and k.split("_", 2)[2] in WAVE_WINDOWS[:3]]

        def mean(key):
            return sum(rec[f"{key}_{t}"] for t in tags) / len(tags)
        out[kname] = dict(
            max_abs_err=err, ms=mean("ms"), plain_ms=mean("plain_ms"),
            bound_ms=mean("bound_ms"),
            bound_by=(rec.get(f"bound_by_{tags[0]}") or "bytes"),
            **({"bound_ms_words": mean("bound_ms_words")}
               if kname == "wave_rounds" else {}),
            library_ms=mean("library_ms") if kname == "wave_adjacency"
            else None, **rec)
    return out


# 9(a)'s widest windows: one-tile reads of the fixture's "wave_8192"
# dataset, whose per-read state leaves wave_rounds' shared memory
WIDE_WINDOWS = (7_910, 7_981, 8_192)


def wave_8192_fastq(fx: dict) -> str:
    """WORK/one_tile.fq, the fixture's "wave_8192" dataset (9,000 reads of
    1,500 bases: one tile each)."""
    fq = os.path.join(WORK, "one_tile.fq")
    ds = fx["wave_8192"]["dataset"]
    if not os.path.exists(fq):
        os.makedirs(WORK, exist_ok=True)
        make_reads(fq, **{k: v for k, v in ds.items() if k != "sha256"})
    if sha256_file(fq) != ds["sha256"]:
        raise AssertionError("the wave_8192 dataset does not regenerate")
    return fq


def window_vs_plain(te, filt, batch, dev) -> dict:
    """One window of engine `te` (its filter `filt`): the padded batch
    `batch` (`_pack_batch`) through wave_adjacency, then wave_rounds and
    wave_window_plain on copies of the filter and zeroed side tables: the
    launch timed once (CUDA events) beside the plain version (host clock)
    and its bound; rows, scal, counters and both tables compared.  Returns
    the window's B, T, plan (`rounds_smem`), times, counters, launches and
    largest difference."""
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.path import wavefront as wave
    table = filt.ids if te.compressed else filt.words
    _, _, ranked, limit, _ = wave._filter_view(filt, te.size)
    codes, lengths, full, T = batch
    B = codes.shape[0]
    codes_d, grid, ok, gi, oi, nt, fl = te._window_inputs(codes, lengths,
                                                          full, T)
    adj = wave.wave_adjacency(te.wave_spec, gi, codes_d, limit, ranked, T)
    plan = wave.rounds_smem(B, T, te.params.vote_topk,
                            grid.shape[1] * grid.shape[2] // T,
                            gi.shape[1] * gi.shape[2] // T, te.spec.rech_on)
    fk = type(filt)(*(t.clone() for t in filt))
    fp = type(filt)(*(t.clone() for t in filt))
    side_k = torch.zeros_like(table)
    side_p = torch.zeros_like(table)
    scal_k = torch.tensor([0, 0, 1, 0], dtype=torch.int64, device=dev)
    scal_p = scal_k.clone()
    ck, cp = wave.new_counters(dev), wave.new_counters(dev)
    rows_k = torch.empty((B, 8), dtype=torch.int64, device=dev)
    rows_p = torch.empty_like(rows_k)
    r0 = kernels.WAVE_ROUNDS.launches
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    wave.wave_window(te.wave_spec, fk, side_k, grid, ok, gi, oi, nt, fl, adj,
                     scal_k, rows_k, ck, T)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop)
    launched = kernels.WAVE_ROUNDS.launches - r0
    t0 = time.time()
    wave.wave_window_plain(te.wave_spec, fp, side_p, grid, ok, gi, oi, nt,
                           fl, adj, scal_p, rows_p, cp, T)
    torch.cuda.synchronize()
    pms = (time.time() - t0) * 1e3
    e = max_abs_err([(rows_k, rows_p), (scal_k, scal_p), (ck, cp),
                     (side_k, side_p)] + list(zip(fk, fp)))
    counts = dict(zip(wave.WAVE_COUNTS, cp.tolist()))
    bound = wave_round_bytes(counts, rows_p.cpu(), nt.cpu(), (grid, gi), T,
                             table, side_k, te.compressed) \
        / HBM_BYTES_PER_S * 1e3
    return dict(B=B, T=T, plan=plan, ms=ms, pms=pms, bound=bound,
                counts=counts, launched=launched, err=e,
                scal=scal_k.tolist())


def wave_wide_check(dev, fx: dict) -> dict:
    """9(a) at the widest windows: wave_rounds on windows of 7,910, 7,981
    and 8,192 one-tile reads (the largest that `rounds_smem` keeps in
    shared memory beside the kernel's static arrays, the first it moves
    out, and the tile budget's largest), each filter filled from the
    "wave_8192" reads, in its throughput cell (windows of 8,192), against
    wave_window_plain: rows, scal, counters and both tables bit for bit,
    no fault, one launch a window; each launch timed once (CUDA events)
    beside the plain version and its bound.  Returns the record's keys
    and the largest difference."""
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    fq = wave_8192_fastq(fx)
    rec, err = {}, 0
    for mode in ("direct", "compressed"):
        te = GoldenPathEngine(PathConfig(
            input=fq, mibf_mode=mode,
            **{**fx["engine"], **fx["wave_8192"]["engine"]}), device=dev)
        te.calc_phred_threshold(fq)
        te.fill(fq)
        filt = te.cstate if te.compressed else te.state
        recs = list(te._eligible(fq))
        for B in WIDE_WINDOWS:
            te.batch_reads = B
            w = window_vs_plain(te, filt, te._pack_batch(recs[:B]), dev)
            err = max(err, w["err"])
            tag = f"{mode}_w{B}"
            rec.update({f"ms_{tag}": w["ms"], f"plain_ms_{tag}": w["pms"],
                        f"bound_ms_{tag}": w["bound"]})
            say("wave", part="a", kernel="wave_rounds", filter=mode,
                window=f"one_tile_{B}", B=B, T=w["T"], smem=w["plan"].smem,
                spill_bytes_a_cta=w["plan"].slice_bytes,
                launches=w["launched"], max_abs_err=w["err"], scal=w["scal"],
                **w["counts"], ms=f"{w['ms']:.4f}",
                plain_ms=f"{w['pms']:.1f}", bound_ms=f"{w['bound']:.5f}")
            if (w["err"] or w["launched"] != 1 or w["counts"]["faults"]
                    or (w["plan"].slice_bytes > 0) != (B > 7_910)
                    or not w["counts"]["commits"]):
                raise AssertionError(f"wave_rounds {tag}: {w}")
        for B in PADDED_WINDOWS:
            e, ms, pms = adjacency_vs_plain(te, filt, recs[:8_192], B, dev)
            err = max(err, e)
            tag = f"{mode}_w{B}"
            rec.update({f"wave_adjacency:ms_{tag}": ms,
                        f"wave_adjacency:plain_ms_{tag}": pms})
        del te, filt
        gc_cuda()
    return rec, err


# windows of one-tile reads that the mesh's padding makes of a full window
# of 8,192 (3 and 7 data rows)
PADDED_WINDOWS = (8_193, 8_199)


def adjacency_vs_plain(te, filt, recs, B: int, dev
                       ) -> tuple[int, float, float]:
    """wave_adjacency on the window of `recs` padded to B reads with empty
    rows, as a mesh of d data rows pads a full window to a multiple of d
    (the engine's _pad_batch), against its plain version: (largest
    difference, ms (CUDA events, mean of 5), plain ms)."""
    import numpy as np
    import torch
    from goldrush_tpu_torch.ops.nthash import fingerprints
    from goldrush_tpu_torch.path import wavefront as wave
    _, _, ranked, limit, _ = wave._filter_view(filt, te.size)
    te.batch_reads = len(recs)
    codes, lengths, full, T = te._pack_batch(recs)
    pad = B - codes.shape[0]
    codes = np.pad(codes, ((0, pad), (0, 0)))
    lengths, full = np.pad(lengths, (0, pad)), np.pad(full, (0, pad))
    codes_d, _, _, gi, *_ = te._window_inputs(codes, lengths, full, T)
    adj = wave.wave_adjacency(te.wave_spec, gi, codes_d, limit, ranked, T)
    torch.cuda.synchronize()
    t0 = time.time()
    fp = fingerprints(codes_d, te.fam_ins, T * te.cfg.tile_length,
                      te.params_ins.frame_stride, wave.FP_BITS)
    want = wave.wave_adjacency_plain(gi, fp, limit, ranked)
    torch.cuda.synchronize()
    pms = (time.time() - t0) * 1e3
    e = max_abs_err([(adj, want)])
    ms = cuda_ms(lambda: wave.wave_adjacency(te.wave_spec, gi, codes_d,
                                             limit, ranked, T), 5, hold=4)
    say("wave", part="a", kernel="wave_adjacency", window=f"one_tile_{B}",
        B=B, ord_bits=wave.ord_bits(B),
        overlaps=int((adj >= wave.ADJ_MIN).sum()), max_abs_err=e,
        ms=f"{ms:.4f}", plain_ms=f"{pms:.2f}")
    if e or B <= 8_192 or not (adj >= wave.ADJ_MIN).any():
        raise AssertionError(f"wave_adjacency at {B} reads: max_abs_err {e}")
    return e, ms, pms


# 9(a)'s windows of long reads at the bench tiers: (tile bucket, reads a
# window, tiles a read); two reads a window, as the plain version takes
# ~3 s a read classified at these widths (tests/test_torch_kernels.py
# test_wave_rounds_long_reads runs windows of the whole tile budget)
LONG_WINDOWS = ((1_024, 2, 1_000), (1_536, 2, 1_400), (2_048, 2, 2_000))


def wave_long_check(dev, fx: dict) -> tuple[dict, int]:
    """9(a) at the largest tile buckets: wave_rounds on a window of each of
    LONG_WINDOWS (reads of 1.0-2.0 Mbp sampled from the bench genome with
    5% substitutions, made on the card from a seed; bench.py's throughput
    cell, tiles of 1,000, K = 32: kernel C on 7-14 warps of a CTA), each
    filter filled from the window's reads, and on the first window of the
    fixture's "wave_long" dataset (8 reads of 937 tiles of 256, its own
    cell; the direct filter, the compressed one in 9(e)'s digests),
    against wave_window_plain: rows, scal, counters and both tables bit
    for bit, no fault, one launch a window, each timed once beside the
    plain version and its bound.  Returns the record's keys and the
    largest difference."""
    import numpy as np
    import torch
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    genome, _ = bench_reads(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(71)
    rec, err = {}, 0
    for mode in ("direct", "compressed"):
        for T, n, tiles in LONG_WINDOWS:
            L = tiles * 1_000 + 500
            starts = torch.randint(0, genome.shape[0] - L, (n, 1),
                                   device=dev, generator=g)
            reads = genome[starts + torch.arange(L, device=dev)]
            subst = torch.rand((n, L), device=dev, generator=g) < 0.05
            reads = torch.where(subst, torch.randint(
                0, 4, (n, L), dtype=torch.uint8, device=dev, generator=g),
                reads)
            te = GoldenPathEngine(PathConfig(**BENCH_ENGINE, **THROUGHPUT,
                                             **WAVE, mibf_mode=mode),
                                  device=dev)
            lengths = torch.full((n,), L, dtype=torch.int32, device=dev)
            bits = dm.presence_bitmap(te.size, dev)
            dm.fill_presence_bits(bits, reads, lengths, te.fam_ins, te.size,
                                  te.cfg.slot_map)
            if mode == "direct":
                dm.merge_presence(te.state.words, bits, te.size,
                                  first_write=True)
            else:
                te.cstate = cz.with_tables(*cz.build_rank(bits, te.size),
                                           te.size)
            del bits
            filt = te.cstate if te.compressed else te.state
            codes = np.zeros((n, (T + 1) * 1_000), np.uint8)
            codes[:, :L] = reads.cpu().numpy()
            w = window_vs_plain(te, filt, (codes, np.full(n, L, np.int32),
                                           np.full(n, L, np.int64), T), dev)
            err = max(err, w["err"])
            tag = f"{mode}_t{T}"
            rec.update({f"ms_{tag}": w["ms"], f"plain_ms_{tag}": w["pms"],
                        f"bound_ms_{tag}": w["bound"]})
            say("wave", part="a", kernel="wave_rounds", filter=mode,
                window=f"long_{T}", B=n, T=T, smem=w["plan"].smem,
                c_warps=w["plan"].c_warps, launches=w["launched"],
                max_abs_err=w["err"], **w["counts"], ms=f"{w['ms']:.4f}",
                plain_ms=f"{w['pms']:.1f}", bound_ms=f"{w['bound']:.5f}")
            if (w["err"] or w["launched"] != 1 or w["counts"]["faults"]
                    or w["T"] != T or w["plan"].c_warps == 16):
                raise AssertionError(f"wave_rounds {tag}: {w}")
            del te, filt, reads
            gc_cuda()
    wl = fx["wave_long"]
    fq = wave_long_fastq(fx)
    for mode in ("direct",):
        te = GoldenPathEngine(PathConfig(
            input=fq, mibf_mode=mode, **{**fx["engine"], **wl["engine"]}),
            device=dev)
        te.calc_phred_threshold(fq)
        te.fill(fq)
        filt = te.cstate if te.compressed else te.state
        recs = list(te._eligible(fq))
        # the engine's first window: the reads that fill the tile budget
        w = window_vs_plain(te, filt, te._pack_batch(recs[:8_192 // 1_024]),
                            dev)
        err = max(err, w["err"])
        say("wave", part="a", kernel="wave_rounds", filter=mode,
            window="wave_long", B=w["B"], T=w["T"], c_warps=w["plan"].c_warps,
            launches=w["launched"], max_abs_err=w["err"], **w["counts"],
            ms=f"{w['ms']:.4f}", plain_ms=f"{w['pms']:.1f}",
            bound_ms=f"{w['bound']:.5f}")
        if w["err"] or w["launched"] != 1 or w["T"] != 1_024:
            raise AssertionError(f"wave_rounds wave_long {mode}: {w}")
        del te, filt
        gc_cuda()
    return rec, err


def wave_long_fastq(fx: dict) -> str:
    """WORK/long_reads.fq, the fixture's "wave_long" dataset."""
    fq = os.path.join(WORK, "long_reads.fq")
    ds = fx["wave_long"]["dataset"]
    if not os.path.exists(fq):
        os.makedirs(WORK, exist_ok=True)
        make_reads(fq, **{k: v for k, v in ds.items() if k != "sha256"})
    if sha256_file(fq) != ds["sha256"]:
        raise AssertionError("the wave_long dataset does not regenerate")
    return fq


def engine_digests(fq: str, case: dict, want: dict, tag: str, part: str,
                   devices=None) -> None:
    """A wavefront case of the fixture on the card, each filter: the
    engine over `fq` with `case` over the fixture's ENGINE settings (on
    the mesh of `devices` when given, its data rows' replicas equal), its
    silver digests, recruits and paths against the JAX engine's (`want`),
    the two wavefront kernels once a window (wave_rounds once a window a
    data row)."""
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine as Engine
    for mode in ("direct", "compressed"):
        prefix = os.path.join(WORK, f"{tag}_{mode}")
        before = {k.name: k.launches for k in kernels.WAVE}
        t0 = time.time()
        eng = Engine(PathConfig(input=fq, prefix_file=prefix,
                                mibf_mode=mode, **case),
                     device=devices or "cuda")
        st = eng.run()
        if devices:
            replicas_equal(eng)
        got_launches = {k.name: k.launches - before[k.name]
                        for k in kernels.WAVE}
        silver = {str(i): sha256_file(f"{prefix}_{i}.fq")
                  for i in range(1, case["max_paths"] + 1)
                  if os.path.exists(f"{prefix}_{i}.fq")}
        got = {"recruits": st.recruits,
               "paths_completed": st.paths_completed, "silver": silver}
        d = eng.mesh.data
        say("wave", part=part, case=tag, filter=mode,
            window=eng.batch_reads, windows=st.num_batches,
            **eng.consume_counts, **got_launches, recruits=st.recruits,
            seconds=f"{time.time() - t0:.1f}", match=got == want[mode])
        if (got != want[mode] or got_launches != {
                "wave_adjacency": st.num_batches,
                "wave_rounds": st.num_batches * d}):
            raise AssertionError(f"{tag} {mode}: {got} vs {want[mode]}, "
                                 f"launches {got_launches}")


def wave_8192_digests(fx: dict) -> None:
    """9(d): the fixture's "wave_8192" case on the card, each filter: the
    wavefront engine over the one-tile reads in windows of 8,192 reads,
    its silver digests, recruits and paths against the JAX wavefront
    engine's; wave_adjacency and wave_rounds once a window."""
    engine_digests(wave_8192_fastq(fx),
                   {**fx["engine"], **fx["wave_8192"]["engine"]},
                   fx["wave_8192"], "w8k", "d")


def recruit_ids(prefix: str, max_paths: int) -> set:
    """The read names of a silver run's path files."""
    from goldrush_tpu_torch.io import fastq
    ids = set()
    for i in range(1, max_paths + 1):
        p = f"{prefix}_{i}.fq"
        if os.path.exists(p):
            ids.update(r.id.rsplit("_", 1)[0] for r in fastq.read_records(p))
    return ids


def wave_bench() -> dict:
    """9(b): bench.py's throughput cell at full width with wavefront=True
    and windows of 256 reads through GoldenPathEngine, each filter, on the
    bench reads (written by phase 4): every launch count zeroed just
    before and read just after.  wave_adjacency and wave_rounds must
    launch once per window, the consume kernel and the batched kernels B
    and C never (the wave's first round classifies every read), every
    other kernel of the filter's path as in phase 4.  Prints assign reads/s,
    the submit and replay seconds, rounds per window, commits per round,
    recruits, the recruit-set Jaccard against phase 4's sequential
    throughput pass of the same filter (not gated) and the peak device
    memory.  Returns the launch counts."""
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine as Engine
    reads = os.path.join(WORK, "bench_reads.fq")
    for k in kernels.ALL + (kernels.INSERT_SORTED, kernels.INSERT_MAX):
        k.launches = 0
    for mode in ("compressed", "direct"):
        before = {k.name: k.launches for k in kernels.ALL}
        prefix = os.path.join(WORK, f"wave_{mode}")
        gc_cuda()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        eng = Engine(PathConfig(input=reads, prefix_file=prefix,
                                mibf_mode=mode, **BENCH_ENGINE, **THROUGHPUT,
                                **WAVE), device="cuda")
        st = eng.run()
        wall = time.time() - t0
        got = {k.name: k.launches - before[k.name] for k in kernels.ALL}
        c = eng.consume_counts
        RATES[("wave", mode, "silver")] = \
            st.num_reads / max(st.wall_assign_s, 1e-9)
        wave_ids = recruit_ids(prefix, eng.cfg.max_paths)
        seq_ids = recruit_ids(os.path.join(WORK, f"throughput_{mode}"),
                              eng.cfg.max_paths)
        jac = len(wave_ids & seq_ids) / max(len(wave_ids | seq_ids), 1)
        say("wave", part="b", filter=mode, fill_s=f"{st.wall_fill_s:.3f}",
            assign_s=f"{st.wall_assign_s:.3f}",
            submit_s=f"{st.wall_submit_s:.3f}",
            replay_s=f"{st.wall_replay_s:.3f}", reads=st.num_reads,
            recruits=st.recruits,
            reads_per_s=f"{st.num_reads / max(st.wall_assign_s, 1e-9):.2f}",
            windows=st.num_batches,
            rounds_per_window=f"{c['rounds'] / max(st.num_batches, 1):.2f}",
            commits_per_round=f"{c['commits'] / max(c['rounds'], 1):.3f}",
            **c, jaccard_vs_scan=f"{jac:.4f}",
            recruits_scan=len(seq_ids), paths_completed=st.paths_completed,
            wave_adjacency=got["wave_adjacency"],
            wave_rounds=got["wave_rounds"], wall_s=f"{wall:.2f}",
            device_peak_bytes=st.device_peak_bytes)
        grid = "seed_hash_rank_grid" if mode == "compressed" \
            else "seed_hash_grid"
        need = ("seed_hash_fill", grid, "wave_adjacency", "wave_rounds")
        if (got["wave_adjacency"] != st.num_batches
                or got["wave_rounds"] != st.num_batches
                or any(got[k] for k in ("consume", "probe_vote", "classify"))
                or any(got[k] <= 0 for k in need) or st.recruits <= 0
                or c["commits"] < st.recruits or c["faults"]):
            raise AssertionError(f"wave bench {mode}: launches {got}, "
                                 f"counts {c}, {st.recruits} recruits over "
                                 f"{st.num_batches} windows")
        del eng
    launches = {k.name: k.launches for k in kernels.ALL}
    say("wave", launches=json.dumps(launches).replace(" ", ""))
    return launches


def gate_fastq(fx: dict) -> str:
    """WORK/qgate.fq, the 1 Mbp gate dataset of the fixture (written by
    phase 5, or here)."""
    fq = os.path.join(WORK, "qgate.fq")
    if not os.path.exists(fq):
        make_reads(fq, **{k: v for k, v in fx["dataset"].items()
                          if k != "sha256"})
    return fq


def wave_digests(fx: dict, devices=None, model: int = 1,
                 part: str = "c") -> None:
    """9(c): the wavefront's silver digests of the 1 Mbp gate dataset
    (written by phase 5), each filter, against the fixture's "wavefront"
    key (the JAX wavefront engine on the CPU); with `devices` (10(c),
    10(d)) on their mesh with `model` banks a row, every row's replica and
    side table equal to row 0's."""
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine as Engine
    wv = fx["wavefront"]
    fq = gate_fastq(fx)
    mesh = {} if devices is None else dict(devices=len(devices),
                                           model_shards=model)
    layout = f"{len(devices) // model}x{model}" if devices else "single"
    for mode in ("direct", "compressed"):
        prefix = os.path.join(WORK, f"qgate_wave_{layout}_{mode}")
        t0 = time.time()
        eng = Engine(PathConfig(input=fq, prefix_file=prefix, mibf_mode=mode,
                                **fx["engine"], **wv["engine"], **mesh),
                     device=devices or "cuda")
        st = eng.run()
        if devices:
            replicas_equal(eng)
        silver = {str(i): sha256_file(f"{prefix}_{i}.fq")
                  for i in range(1, fx["engine"]["max_paths"] + 1)
                  if os.path.exists(f"{prefix}_{i}.fq")}
        got = {"recruits": st.recruits,
               "paths_completed": st.paths_completed, "silver": silver}
        say("wave", part=part, layout=layout, filter=mode,
            files=len(silver), recruits=st.recruits, windows=st.num_batches,
            rounds=eng.consume_counts["rounds"],
            seconds=f"{time.time() - t0:.1f}", match=got == wv[mode])
        if got != wv[mode] or not eng.wave:
            raise AssertionError(f"wavefront {mode}: {got} vs {wv[mode]}")


def phase_wave() -> tuple[dict, dict]:
    """Phase 9, the wavefront consume (K23): (a) both kernels against
    their plain versions, wave_rounds at 7,910, 7,981 and 8,192 one-tile
    reads and on windows of the largest tile buckets, the adjacency at
    8,193 and 8,199 reads; then, every launch count
    zeroed just before and read just after, (b) the bench reads'
    throughput cell with wavefront=True, each filter, (c) the "wavefront"
    digests, (d) the "wave_8192" digests and (e) the "wave_long" digests.
    Returns the launch counts and the two kernels' records."""
    import torch
    from goldrush_tpu_torch import kernels
    gc_cuda()
    dev = torch.device("cuda", 0)
    with open(os.path.join(REPO, "tests", "fixtures",
                           "torch_port_digests.json")) as f:
        fx = json.load(f)
    recs = wave_kernel_check(dev)
    for check in (wave_wide_check, wave_long_check):
        wide, err = check(dev, fx)
        for key, v in wide.items():
            name, _, k = key.rpartition(":")
            recs[name or "wave_rounds"][k] = v
        for name in ("wave_adjacency", "wave_rounds"):
            recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], err)
    launches = wave_bench()
    before = {k.name: k.launches for k in kernels.WAVE}
    wave_digests(fx)
    wave_8192_digests(fx)
    engine_digests(wave_long_fastq(fx),
                   {**fx["engine"], **fx["wave_long"]["engine"]},
                   fx["wave_long"], "wave_long", "e")
    for k in kernels.WAVE:
        launches[k.name] = k.launches
        if k.launches <= before[k.name]:
            raise AssertionError(f"wave digests: {k.name} never launched")
    return launches, recs


# --------------------------------------------------------------- phase 10

# 10(a)'s bank counts, all banks on the lead card
MESH_BANKS = (1, 2, 4)
# 10(b)'s runs on ["cuda:0"] * 4: (tag, devices, model_shards, cell,
# filter)
MESH_RUNS = (("dp4x1", 4, 1, "exact", "direct"),
             ("banked2x2", 4, 2, "exact", "direct"),
             ("banked2x2", 4, 2, "exact", "compressed"),
             ("banked2x2", 4, 2, "throughput", "direct"),
             ("banked2x2", 4, 2, "throughput", "compressed"))


def banked_copy(filt, devices):
    """A copy of the filter `filt` placed on a mesh row of `devices`, its
    per-slot (or per-rank) tables banked over them (one tensor when there
    is one): the engine's `shard_state`."""
    from goldrush_tpu_torch.parallel import mesh as tmesh
    return tmesh.shard_state(filt, tmesh.Mesh((tuple(devices),)), True)[0]


def filter_err(a, b) -> int:
    """max_abs_err of two filters' tables, banks gathered."""
    from goldrush_tpu_torch.mibf import mibf as dm
    pairs = [(dm.whole(x), dm.whole(y)) for x, y in zip(a, b)]
    return max_abs_err((x, y.to(x.device)) for x, y in pairs)


def mesh_kernel_check(layouts: dict, tag: str) -> dict:
    """10(a): the kernels that read or write the filter, on a banked
    filter, against their plain versions on the unbanked one, bit for bit,
    on the first bench batch (bench.py's engine, 3,000 x 20 kb reads of 5
    Mbp at 5% error, T = 20) of a filter filled from the bench reads, for
    each bank layout of `layouts` (banks -> the banks' devices, the first
    the lead): the consume kernel in exact mode with the direct filter
    (B = 32) and in the throughput cell with the compressed one (B = 64),
    rows, scal, counters and the gathered filter; probe_vote in both
    filters; the standalone insert_sorted and insert_max of the batch's
    first read (every tile), in both filters; the per-bank presence_merge
    of the direct filter against its unbanked merge.  Times: consume's
    launch (median of 5, the filter copied afresh before each, outside the
    timed span) and probe_vote's (cuda_ms) at each layout, beside the
    consume batch's bound, which banks do not change (the same bytes).
    Returns {kernel: {"banked_err": e, ...}} with `tag` in each time's
    key."""
    import numpy as np
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.path import consume as tcons
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    lead = next(iter(layouts.values()))[0]
    _, reads = bench_reads(lead)
    out = {k: {"banked_err": 0} for k in ("consume", "probe_vote",
                                          "insert_sorted", "insert_max",
                                          "presence_merge")}

    def err_of(name, e):
        out[name]["banked_err"] = max(out[name]["banked_err"], e)
        return e
    T, L = 20, BENCH["read_len"]
    for cell, mode, extra in (("exact", "direct", {}),
                              ("throughput", "compressed", THROUGHPUT)):
        sfx = "" if cell == "exact" else "_throughput"
        te = GoldenPathEngine(PathConfig(
            **{**BENCH_ENGINE, "max_paths": 2, "ratio": 0.02},
            mibf_mode=mode, **extra), device=lead)
        bits = dm.presence_bitmap(te.size, lead)
        for c, n in fill_pass_batches(lead, reads):
            dm.fill_presence_bits(bits, c, n, te.fam_ins, te.size,
                                  te.cfg.slot_map)
        if mode == "direct":
            dm.merge_presence(te.state.words, bits, te.size,
                              first_write=True)
            for m, devs in layouts.items():
                words = dm.new_banks(te.params.alloc, devs, torch.empty)
                before = kernels.PRESENCE_MERGE.launches
                dm.merge_presence_banks(words, bits, te.size)
                launched = kernels.PRESENCE_MERGE.launches - before
                e = err_of("presence_merge", max_abs_err(
                    [(dm.whole(words).to(lead), te.state.words)]))
                say("mesh", part="10a", layout=tag, kernel="presence_merge",
                    banks=m, launches=launched, max_abs_err=e)
                if launched != m:
                    raise AssertionError(f"presence_merge launched "
                                         f"{launched} times for {m} banks")
        else:
            te.cstate = cz.with_tables(*cz.build_rank(bits, te.size),
                                       te.size)
        del bits
        filt = te.cstate if mode == "compressed" else te.state
        table, counts, ranked, limit, or_bits = tcons._filter_view(
            filt, te.size)
        B = te.batch_reads
        codes = np.zeros((B, (T + 1) * te.cfg.tile_length), np.uint8)
        codes[:, :L] = reads[:B].cpu().numpy()
        inputs = te._batch_inputs(codes, np.full(B, L, np.int32),
                                  np.full(B, L, np.int64), T)
        grid, ok, grid_ins = inputs[0], inputs[1], inputs[2]
        # the plain versions on the unbanked filter, each timed once
        torch.cuda.synchronize()
        t0 = time.time()
        want_vote = dm._probe_and_vote_plain(table, grid, ok, te.params, T,
                                             ranked)
        torch.cuda.synchronize()
        out["probe_vote"][f"banked_plain_ms_{mode}"] = \
            (time.time() - t0) * 1e3
        ins_p = type(filt)(*(t.clone() for t in filt))
        tp_, cp_, _, _, _ = tcons._filter_view(ins_p, te.size)
        dm._insert_plain(tp_, cp_, grid_ins[0], 0, T - 1, 1, False,
                         te.params_ins, T, limit, or_bits)
        max_p = type(filt)(*(t.clone() for t in filt))
        dm._insert_max_plain(tcons._filter_view(max_p, te.size)[0],
                             grid_ins[0], 0, T - 1, 1, False,
                             te.params.block_size, T, limit, or_bits)
        plain = type(filt)(*(t.clone() for t in filt))
        scal_p = torch.tensor([0, 0, 1, 0], dtype=torch.int64, device=lead)
        rows_p = torch.empty((B, 8), dtype=torch.int64, device=lead)
        cnt_p = tcons.new_counters(lead)
        torch.cuda.synchronize()
        t0 = time.time()
        tcons.consume_batch_plain(te.spec, plain, *inputs, scal_p, rows_p,
                                  cnt_p, T)
        torch.cuda.synchronize()
        out["consume"][f"banked_plain_ms{sfx}"] = (time.time() - t0) * 1e3
        log_filt = type(filt)(*(t.clone() for t in filt))
        with plain_steps(te.spec, grid, grid_ins, limit) as log:
            tcons.consume_batch_plain(
                te.spec, log_filt, *inputs,
                torch.tensor([0, 0, 1, 0], dtype=torch.int64, device=lead),
                torch.empty_like(rows_p), tcons.new_counters(lead), T)
        del log_filt
        bound = consume_bytes(te, inputs, log, filt, T) / HBM_BYTES_PER_S \
            * 1e3
        out["consume"][f"banked_bound_ms{sfx}"] = bound
        for m, devs in layouts.items():
            bk = banked_copy(filt, devs)
            btab = tcons._filter_view(bk, te.size)[0]
            got = dm.probe_and_vote(btab, grid, ok, te.params, T, ranked)
            e = err_of("probe_vote", max_abs_err(zip(got, want_vote)))
            vms = cuda_ms(lambda: dm.probe_and_vote(btab, grid, ok,
                                                    te.params, T, ranked),
                          10)
            out["probe_vote"][f"banked_ms_{tag}{m}_{mode}"] = vms
            # the inserts alone, on fresh banked copies
            bi = banked_copy(filt, devs)
            bt, bc, _, _, _ = tcons._filter_view(bi, te.size)
            dm.insert_blocks(bt, bc, grid_ins[0], 0, T - 1, 1, False,
                             te.params_ins, T, limit, or_bits)
            e_ins = err_of("insert_sorted", filter_err(bi, ins_p))
            bm = banked_copy(filt, devs)
            dm.insert_max(tcons._filter_view(bm, te.size)[0], grid_ins[0],
                          0, T - 1, 1, False, te.params_ins, T, limit,
                          or_bits)
            e_max = err_of("insert_max", filter_err(bm, max_p))
            del bi, bm
            # the consume batch, then its launch timed on fresh copies
            times, e_c = [], 0
            for rep in range(6):
                bk = banked_copy(filt, devs)
                scal = torch.tensor([0, 0, 1, 0], dtype=torch.int64,
                                    device=lead)
                rows = torch.empty((B, 8), dtype=torch.int64, device=lead)
                ck = tcons.new_counters(lead)
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                torch.cuda._sleep(1_000_000)
                before = kernels.CONSUME.launches
                start.record()
                tcons.consume_batch(te.spec, bk, *inputs, scal, rows, ck, T,
                                    row=devs)
                stop.record()
                torch.cuda.synchronize()
                if kernels.CONSUME.launches - before != 1:
                    raise AssertionError("consume did not launch once")
                if rep:
                    times.append(start.elapsed_time(stop))
                e_c = max(e_c, max_abs_err([(rows, rows_p), (scal, scal_p),
                                            (ck, cnt_p)]),
                          filter_err(bk, plain))
                del bk
            err_of("consume", e_c)
            cms = sorted(times)[len(times) // 2]
            out["consume"][f"banked_ms_{tag}{m}{sfx}"] = cms
            say("mesh", part="10a", layout=tag, cell=cell, filter=mode,
                banks=m, devices=",".join(map(str, devs)),
                probe_vote_err=e, probe_vote_ms=f"{vms:.4f}",
                insert_sorted_err=e_ins, insert_max_err=e_max,
                consume_err=e_c, consume_ms=f"{cms:.4f}",
                consume_bound_ms=f"{bound:.5f}",
                counters=cnt_p.tolist(), scal=scal_p.tolist())
        del te, filt, plain, ins_p, max_p
        torch.cuda.empty_cache()
    bad = {k: r["banked_err"] for k, r in out.items() if r["banked_err"]}
    if bad:
        raise AssertionError(f"10(a) {tag}: banked kernels differ from "
                             f"their plain versions: {bad}")
    return out


def mesh_engine_class(devices: list, model: int, engines: list):
    """A factory standing for GoldenPathEngine in pipeline.py: each engine
    it makes runs on the mesh of `devices` with `model` banks, and is
    appended to `engines`."""
    from goldrush_tpu_torch.path.engine import GoldenPathEngine

    def make(pc, device):
        pc.devices, pc.model_shards = len(devices), model
        eng = GoldenPathEngine(pc, device=devices)
        engines.append(eng)
        return eng
    return make


def replicas_equal(eng) -> None:
    """Every data row's filter, and under the wavefront its side table,
    equals row 0's, banks gathered."""
    sides = eng.wave_sides
    for r, rep in enumerate(eng.replicas[1:], 1):
        e = filter_err(eng.replicas[0], rep)
        if sides:
            e = max(e, filter_err(sides[:1], sides[r: r + 1]))
        if e:
            raise AssertionError(f"mesh: row {r}'s replica differs from "
                                 f"row 0's by {e}")


def mesh_bench_run(tag: str, devices, model: int, cell: str,
                   mode: str) -> tuple[dict, list]:
    """One 10(b) run on the bench reads (written by phase 4, or here): the
    exact cell's silver and golden stages through the pipeline (the CLI's
    run of phase 4), the throughput cell's silver pass through
    GoldenPathEngine (phase 4's throughput run), on the mesh of `devices`
    (None: one card, the phase 4 run itself).  Returns {file name: sha256}
    and the engines."""
    from goldrush_tpu_torch import cli, pipeline
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    engines: list = []
    if cell == "exact":
        outdir = os.path.join(WORK, f"bench_{mode}" if devices is None
                              else f"mesh_{tag}_{mode}")
        argv = ["goldrush-path", f"reads={os.path.join(WORK, 'bench_reads')}",
                "G=5000000", "device=cuda", f"mibf_mode={mode}",
                f"prefix={outdir}", "dev=1"]
        cmd, cfg, extra = cli.parse_args(argv)
        made = pipeline.GoldenPathEngine
        if devices is not None:
            pipeline.GoldenPathEngine = mesh_engine_class(devices, model,
                                                          engines)
        try:
            out = cli.run(cmd, cfg, extra)
        finally:
            pipeline.GoldenPathEngine = made
        stats = out["stats"]
        files = sorted(f for f in os.listdir(outdir)
                       if f.endswith((".fq", ".fa")))
        digests = {f: sha256_file(os.path.join(outdir, f)) for f in files}
    else:
        prefix = os.path.join(WORK, f"throughput_{mode}" if devices is None
                              else f"mesh_{tag}_tp_{mode}")
        over = {} if devices is None else dict(devices=len(devices),
                                               model_shards=model)
        eng = GoldenPathEngine(PathConfig(
            input=os.path.join(WORK, "bench_reads.fq"), prefix_file=prefix,
            mibf_mode=mode, **BENCH_ENGINE, **THROUGHPUT, **over),
            device=devices or "cuda")
        stats = {"silver": eng.run()}
        engines.append(eng)
        digests = silver_digests(prefix)
    rates = {stage: st.num_reads / max(st.wall_assign_s, 1e-9)
             for stage, st in stats.items()}
    if devices is None:
        RATES.update({(cell, mode, s): r for s, r in rates.items()})
    for eng in engines:
        replicas_equal(eng)
    say("mesh", part="10b", run=tag if devices else "single", cell=cell,
        filter=mode, files=len(digests),
        recruits=sum(st.recruits for st in stats.values()),
        **{f"{s}_reads_per_s": f"{r:.2f}" for s, r in rates.items()},
        **{f"{s}_single_reads_per_s": f"{RATES[(cell, mode, s)]:.2f}"
           for s in rates if (cell, mode, s) in RATES})
    return digests, engines


def mesh_gate_runs(devices, runs, fx: dict) -> None:
    """10(b) on the 1 Mbp gate dataset (written by phase 5, or here): each
    run's silver digests against the fixture (the JAX package's), and its
    filter, gathered from row 0's banks, against a single-card run's of
    the same configuration; every row's replica equal to row 0's."""
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    fq = gate_fastq(fx)
    tp = fx["throughput"]
    want = {("exact", "direct"): (fx, {}),
            ("exact", "compressed"): (fx["compressed"], {}),
            ("throughput", "direct"): (tp["direct"], tp["engine"]),
            ("throughput", "compressed"): (tp["compressed"], tp["engine"])}
    single = {}
    for tag, n, model, cell, mode in runs:
        ref, extra = want[(cell, mode)]
        over = dict(devices=n, model_shards=model)
        for who, kw, dev in (("single", {}, "cuda"),
                             (tag, over, devices[:n])):
            if who == "single" and (cell, mode) in single:
                continue
            prefix = os.path.join(WORK, f"mesh_gate_{who}_{cell}_{mode}")
            eng = GoldenPathEngine(PathConfig(
                input=fq, prefix_file=prefix, mibf_mode=mode,
                **fx["engine"], **extra, **kw), device=dev)
            st = eng.run()
            got = {str(i): sha256_file(f"{prefix}_{i}.fq")
                   for i in range(1, fx["engine"]["max_paths"] + 1)
                   if os.path.exists(f"{prefix}_{i}.fq")}
            if got != ref["silver"] or st.recruits != ref["recruits"]:
                raise AssertionError(f"10(b) gate {who} {cell} {mode}: "
                                     f"digests {got} ({st.recruits} "
                                     f"recruits) vs {ref}")
            if who == "single":
                single[(cell, mode)] = eng.replicas[0]
                continue
            replicas_equal(eng)
            e = filter_err(eng.replicas[0], single[(cell, mode)])
            say("mesh", part="10b", dataset="gate", run=tag, cell=cell,
                filter=mode, digests_match=True, recruits=st.recruits,
                filter_vs_single_err=e)
            if e:
                raise AssertionError(f"10(b) gate {tag} {cell} {mode}: the "
                                     "gathered filter differs from the "
                                     "single card's")
            del eng


def mesh_engine_check(devices: list, runs=MESH_RUNS) -> dict:
    """10(b): the engine on the mesh of `devices` in each of `runs`, every
    launch count zeroed just before and read just after the bench runs:
    every silver and golden file's sha256 equal to the single-card run of
    the same configuration (phase 4's, or run here when absent), every
    row's replica equal to row 0's; the consume kernel, kernel B and kernel
    C d times a batch (d data rows, each B and C on its B/d reads), kernel
    D and insert_max never from the host, rank_build d times an engine
    run of the compressed filter; then the gate dataset
    (`mesh_gate_runs`).  Returns the launch counts of the bench runs."""
    from goldrush_tpu_torch import kernels
    with open(os.path.join(REPO, "tests", "fixtures",
                           "torch_port_digests.json")) as f:
        fx = json.load(f)
    reads = os.path.join(WORK, "bench_reads")
    if not os.path.exists(reads + ".fq"):
        make_reads(reads + ".fq", **BENCH)
    single = {}
    for _, _, _, cell, mode in runs:
        key = (cell, mode)
        if key in single:
            continue
        have = os.path.join(WORK, f"bench_{mode}" if cell == "exact"
                            else f"throughput_{mode}_1.fq")
        if not os.path.exists(have):
            single[key] = mesh_bench_run("single", None, 1, cell, mode)[0]
        elif cell == "exact":
            single[key] = {f: sha256_file(os.path.join(have, f))
                           for f in sorted(os.listdir(have))
                           if f.endswith((".fq", ".fa"))}
        else:
            single[key] = silver_digests(os.path.join(WORK,
                                                      f"throughput_{mode}"))
    inserts = (kernels.INSERT_SORTED, kernels.INSERT_MAX)
    for k in kernels.ALL + inserts:
        k.launches = 0
    passes, undo = consume_counts_of_passes()
    try:
        for tag, n, model, cell, mode in runs:
            before = {k.name: k.launches for k in kernels.PATH}
            n_pass = len(passes)
            digests, engines = mesh_bench_run(tag, devices[:n], model, cell,
                                              mode)
            got = {k.name: k.launches - before[k.name]
                   for k in kernels.PATH}
            d = n // model
            batches = sum(p["batches"] for p in passes[n_pass:])
            recruits = sum(e.stats.recruits for e in engines)
            inserted = sum(p["insert"] for p in passes[n_pass:])
            # the compressed filter: one freeze a data row an engine run
            freezes = d * len(engines) if mode == "compressed" else 0
            say("mesh", part="10b", run=tag, cell=cell, filter=mode,
                batches=batches, data_rows=d,
                **{f"launches_{k}": got[k] for k in
                   ("consume", "probe_vote", "classify", "rank_build")})
            if (got["consume"] != d * batches
                    or got["rank_build"] != freezes
                    or got["probe_vote"] != d * batches
                    or got["classify"] != d * batches
                    or any(k.launches for k in inserts)
                    or inserted != recruits or recruits <= 0):
                raise AssertionError(f"10(b) {tag} {cell} {mode}: launches "
                                     f"{got} for {batches} batches of {d} "
                                     f"rows, {recruits} recruits, "
                                     f"{inserted} inserts")
            if digests != single[(cell, mode)]:
                raise AssertionError(f"10(b) {tag} {cell} {mode}: files "
                                     f"{digests} differ from the single "
                                     f"card's {single[(cell, mode)]}")
            say("mesh", part="10b", run=tag, cell=cell, filter=mode,
                files_match_single=len(digests))
            del engines
    finally:
        undo()
    launches = {k.name: k.launches for k in kernels.PATH}
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"mesh path: kernels never launched {missing}")
    mesh_gate_runs(devices, runs, fx)
    return launches


def mesh_cross_cards() -> dict:
    """10(c): where the host has two cards or more, the banked 1x2 across
    cuda:0 and cuda:1 (and with four the 2x2 across all four): each pair's
    peer access and native atomics printed, 10(a)'s kernel checks with
    banks on the real cards, and the gate dataset's digests and filter
    (`mesh_gate_runs`).  On one card it prints why it did not run."""
    import torch
    from goldrush_tpu_torch import kernels
    n = torch.cuda.device_count()
    if n < 2:
        print("10(c) not run: 1 card", flush=True)
        return {}
    cards = [torch.device("cuda", i) for i in range(min(n, 4))]
    for a in cards:
        for b in cards:
            if a != b:
                can, atomics = kernels.peer_attributes(a, b)
                say("mesh", part="10c", device=a, peer=b, peer_access=can,
                    native_atomics=atomics)
    layouts = {2: cards[:2]}
    if len(cards) == 4:
        layouts[4] = cards
    recs = mesh_kernel_check(layouts, "cards")
    recs.update(mesh_wave_kernel_check(layouts, "cards"))
    with open(os.path.join(REPO, "tests", "fixtures",
                           "torch_port_digests.json")) as f:
        fx = json.load(f)
    runs = [("banked1x2", 2, 2, "exact", "direct"),
            ("banked1x2", 2, 2, "throughput", "compressed")]
    mesh_gate_runs(cards[:2], runs, fx)
    wave_digests(fx, cards[:2], 2, part="10c")
    if len(cards) == 4:
        mesh_gate_runs(cards, [("banked2x2", 4, 2, "exact", "compressed"),
                               ("banked2x2", 4, 2, "throughput",
                                "direct")], fx)
        wave_digests(fx, cards, 2, part="10c")
    return recs


# 10(d)'s engine runs of the wavefront on ["cuda:0"] * 4: (tag, devices,
# model_shards)
MESH_WAVE_RUNS = (("banked2x2", 4, 2), ("dp4x1", 4, 1))


def mesh_wave_kernel_check(layouts: dict, tag: str) -> dict:
    """10(d), the kernel: wave_rounds on the id table and the side table
    banked over each layout of `layouts` (banks -> the banks' devices, the
    first the lead) against wave_window_plain on the unbanked tables, bit
    for bit (rows, scal, counters, both tables gathered), on 9(a)'s three
    windows of bench reads per filter (the third with a silver rotation
    inside it), the tables carried window to window as in 9(a).  Each
    banked launch is timed with CUDA events (the median of 3, the tables
    banked afresh before each, outside the timed span) beside 9(a)'s
    unbanked time of the window, when phase 9 ran, and the window's
    `wave_round_bytes` bound.  Returns {"wave_rounds": {"banked_err": e,
    "banked_ms_{tag}{banks}_{filter}_{window}": ms, ...}}."""
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.path import wavefront as wave
    lead = next(iter(layouts.values()))[0]
    _, reads = bench_reads(lead)
    rec, err, T = {}, 0, 20
    for mode, te, filt in wave_filters(lead, reads):
        table, _, ranked, limit, _ = wave._filter_view(filt, te.size)
        side = torch.zeros_like(table)
        scal = torch.tensor([0, 0, 1, 0], dtype=torch.int64, device=lead)
        for w, name in enumerate(WAVE_WINDOWS[:3]):
            if name == "rotation":
                scal.copy_(torch.tensor([0, te.cfg.target_bases() - 1, 1,
                                         0]))
            codes_d, *inputs = wave_inputs(te, reads, w, name)
            adj = wave.wave_adjacency(te.wave_spec, inputs[2], codes_d,
                                      limit, ranked, T)
            start = (type(filt)(*(t.clone() for t in filt)), side.clone(),
                     scal.clone())
            rows_p = torch.empty((codes_d.shape[0], 8), dtype=torch.int64,
                                 device=lead)
            cp = wave.new_counters(lead)
            # the plain version carries the unbanked tables to the next
            # window
            wave.wave_window_plain(te.wave_spec, filt, side, *inputs, adj,
                                   scal, rows_p, cp, T)
            counts = dict(zip(wave.WAVE_COUNTS, cp.tolist()))
            bound = wave_round_bytes(
                counts, rows_p.cpu(), inputs[4].cpu(), (inputs[0], inputs[2]),
                T, table, side, mode == "compressed") / HBM_BYTES_PER_S * 1e3
            wtag = f"{mode}_{name}"
            for m, devs in layouts.items():
                times, e = [], 0
                for rep in range(4):
                    bk = banked_copy(start[0], devs)
                    bside = dm.to_banks(start[1], devs)
                    bscal = start[2].clone()
                    rows = torch.empty_like(rows_p)
                    ck = wave.new_counters(lead)
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    torch.cuda.synchronize()
                    torch.cuda._sleep(1_000_000)
                    before = kernels.WAVE_ROUNDS.launches
                    ev[0].record()
                    wave.wave_window(te.wave_spec, bk, bside, *inputs, adj,
                                     bscal, rows, ck, T, row=devs)
                    ev[1].record()
                    torch.cuda.synchronize()
                    if kernels.WAVE_ROUNDS.launches - before != 1:
                        raise AssertionError("wave_rounds did not launch "
                                             "once")
                    if rep:
                        times.append(ev[0].elapsed_time(ev[1]))
                    e = max(e, max_abs_err([(rows, rows_p), (bscal, scal),
                                            (ck, cp)]),
                            filter_err(bk, filt),
                            filter_err((bside,), (side,)))
                    del bk, bside
                err = max(err, e)
                ms = sorted(times)[len(times) // 2]
                rec[f"banked_ms_{tag}{m}_{wtag}"] = ms
                say("mesh", part="10d", layout=tag, kernel="wave_rounds",
                    filter=mode, window=name, banks=m,
                    devices=",".join(map(str, devs)), max_abs_err=e,
                    ms=f"{ms:.4f}",
                    unbanked_ms_9a=(f"{WAVE_MS[wtag]:.4f}" if wtag in WAVE_MS
                                    else "not run"),
                    bound_ms=f"{bound:.5f}", **counts)
            del start, adj, inputs, codes_d
        del te, filt, side, table
        gc_cuda()
    if err:
        raise AssertionError(f"10(d) {tag}: banked wave_rounds differs from "
                             f"its plain version by {err}")
    return {"wave_rounds": {"banked_err": err, **rec}}


def mesh_wave_engine_check(devices: list, runs=MESH_WAVE_RUNS) -> dict:
    """10(d), the engine: bench.py's throughput cell with wavefront=True
    and windows of 256 reads on the mesh of `devices` in each of `runs`,
    each filter, the silver pass of the bench reads (written by phase 4,
    or here), every launch count zeroed just before and read just after:
    every file's sha256 equal to 9(b)'s single-card wave run (run here
    when absent), every row's replica and side table equal to row 0's,
    wave_rounds d times a window (d data rows) and wave_adjacency once,
    the consume kernel and the batched B and C never; assign reads/s
    beside 9(b)'s.  Then the gate dataset's "wavefront" digests under 2x2.
    Returns the launch counts of the bench runs."""
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine as Engine
    reads = os.path.join(WORK, "bench_reads.fq")
    if not os.path.exists(reads):
        make_reads(reads, **BENCH)
    cfg = dict(input=reads, **BENCH_ENGINE, **THROUGHPUT, **WAVE)
    single = {}
    for mode in ("compressed", "direct"):
        prefix = os.path.join(WORK, f"wave_{mode}")
        if not os.path.exists(f"{prefix}_1.fq"):
            st = Engine(PathConfig(prefix_file=prefix, mibf_mode=mode, **cfg),
                        device=devices[0]).run()
            RATES[("wave", mode, "silver")] = \
                st.num_reads / max(st.wall_assign_s, 1e-9)
        single[mode] = silver_digests(prefix)
    for k in kernels.ALL + (kernels.INSERT_SORTED, kernels.INSERT_MAX):
        k.launches = 0
    for tag, n, model in runs:
        d = n // model
        for mode in ("compressed", "direct"):
            before = {k.name: k.launches for k in kernels.ALL}
            prefix = os.path.join(WORK, f"mesh_wave_{tag}_{mode}")
            gc_cuda()
            torch.cuda.reset_peak_memory_stats()
            eng = Engine(PathConfig(prefix_file=prefix, mibf_mode=mode,
                                    devices=n, model_shards=model, **cfg),
                         device=devices[:n])
            st = eng.run()
            got = {k.name: k.launches - before[k.name] for k in kernels.ALL}
            replicas_equal(eng)
            digests = silver_digests(prefix)
            rate = st.num_reads / max(st.wall_assign_s, 1e-9)
            say("mesh", part="10d", run=tag, filter=mode,
                windows=st.num_batches, data_rows=d,
                recruits=st.recruits, **eng.consume_counts,
                **{f"launches_{k}": got[k] for k in (
                    "wave_adjacency", "wave_rounds", "consume", "probe_vote",
                    "classify")},
                files_match_single=digests == single[mode],
                reads_per_s=f"{rate:.2f}",
                single_reads_per_s=(
                    f"{RATES[('wave', mode, 'silver')]:.2f}"
                    if ("wave", mode, "silver") in RATES else "not run"),
                device_peak_bytes=st.device_peak_bytes)
            if (digests != single[mode] or not digests
                    or got["wave_rounds"] != d * st.num_batches
                    or got["wave_adjacency"] != st.num_batches
                    or any(got[k] for k in ("consume", "probe_vote",
                                            "classify"))
                    or eng.consume_counts["faults"] or st.recruits <= 0):
                raise AssertionError(
                    f"10(d) {tag} {mode}: files {digests} vs the single "
                    f"card's {single[mode]}, launches {got} over "
                    f"{st.num_batches} windows of {d} rows, "
                    f"{eng.consume_counts}")
            del eng
    launches = {k.name: k.launches for k in kernels.ALL}
    with open(os.path.join(REPO, "tests", "fixtures",
                           "torch_port_digests.json")) as f:
        wave_digests(json.load(f), devices[:4], 2, part="10d")
    return launches



def mesh_phase() -> tuple[dict, dict]:
    """Phase 10, the mesh (parallel/mesh.py): (a) `mesh_kernel_check` with
    1, 2 and 4 banks on cuda:0; (b) `mesh_engine_check` on ["cuda:0"] * 4
    (phase 4's and 5's files in WORK when they ran, else made here); (c)
    `mesh_cross_cards`; (d) the wavefront under the mesh,
    `mesh_wave_kernel_check` with 1, 2 and 4 banks on cuda:0 and
    `mesh_wave_engine_check` on ["cuda:0"] * 4 (phase 9's files and times
    when it ran); (e) the fixture's "wave_8192_d3" digests on ["cuda:0"] *
    3, whose windows of 8,192 reads pad to 8,193.  Runs alone from a
    driver that sets WORK.  Returns (launches of (b), (d) and (e), the
    kernels' banked checks and times)."""
    import torch
    t0 = time.time()
    dev = torch.device("cuda", 0)
    os.makedirs(WORK, exist_ok=True)
    layouts = {m: [dev] * m for m in MESH_BANKS}
    recs = mesh_kernel_check(layouts, "m")
    launches = mesh_engine_check([dev] * 4)
    t1 = time.time()
    more = [mesh_cross_cards()]
    t2 = time.time()
    more.append(mesh_wave_kernel_check(layouts, "m"))
    for name, n in mesh_wave_engine_check([dev] * 4).items():
        launches[name] = launches.get(name, 0) + n
    t3 = time.time()
    from goldrush_tpu_torch import kernels
    with open(os.path.join(REPO, "tests", "fixtures",
                           "torch_port_digests.json")) as f:
        fx = json.load(f)
    before = {k.name: k.launches for k in kernels.WAVE}
    engine_digests(wave_8192_fastq(fx),
                   {**fx["engine"], **fx["wave_8192_d3"]["engine"]},
                   fx["wave_8192_d3"], "w8k_d3", "10e", devices=[dev] * 3)
    for k in kernels.WAVE:
        launches[k.name] = launches.get(k.name, 0) + k.launches \
            - before[k.name]
    for name, rec in ((k, v) for r in more for k, v in r.items()):
        have = recs.setdefault(name, {"banked_err": 0})
        have["banked_err"] = max(have["banked_err"], rec.pop("banked_err"))
        have.update(rec)
    say("mesh", seconds=f"{time.time() - t0:.1f}",
        seconds_10c=f"{t2 - t1:.1f}", seconds_10d=f"{t3 - t2:.1f}",
        seconds_10e=f"{time.time() - t3:.1f}")
    return launches, recs


# --------------------------------------------------------------- phase 11

# 11(b)'s mesh layouts of sharded_train_step on ["cuda:0"] * n: (data rows,
# banks a row); the filter is banked when a row has more than one device
TRAIN_LAYOUTS = ((1, 2), (2, 1), (2, 2))


@contextlib.contextmanager
def no_host_sync():
    """Raise on any host synchronisation with the card inside the block
    (torch.cuda's sync debug mode): train_step fetches nothing before its
    insert."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def digest(t) -> str:
    """sha256 of a tensor's bytes (the fixture's digests of uint32 arrays,
    whose bits the port's int32 tensors hold)."""
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def train_inputs(fx: dict) -> tuple:
    """The fixture's "train_step" inputs on the card: the bench reads
    (written once, `bench_fastq`) packed as 20-tile reads (codes uint8
    [3,000, 21,000], lengths int32), the engine's geometry at their
    width (`MibfParams`, 142,368,384 slots) and the seed family."""
    import numpy as np
    import torch
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.io import fastq
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.ops.nthash import build_seed_family
    from goldrush_tpu_torch.ops.seeds import make_seed_pattern
    tr = fx["train_step"]
    path = bench_fastq()
    if sha256_file(path) != tr["dataset"]["sha256"]:
        raise AssertionError("the bench dataset does not regenerate")
    cfg = PathConfig(input=path, **tr["engine"])
    L = (tr["num_tiles"] + 1) * cfg.tile_length
    recs = list(fastq.read_records(path))
    codes = np.zeros((len(recs), L), np.uint8)
    lengths = np.zeros(len(recs), np.int32)
    for i, r in enumerate(recs):
        c = fastq.encode(r.seq)[: L - 1]
        codes[i, : len(c)] = c
        lengths[i] = len(c)
    seeds = make_seed_pattern(cfg.seed_preset, cfg.kmer_size, cfg.weight,
                              cfg.hash_num)
    params = dm.MibfParams(
        size=tr["size"], h=cfg.hash_num, k=cfg.kmer_size,
        spans=tuple(len(s) for s in seeds), tile_length=cfg.tile_length,
        threshold=cfg.threshold, block_size=cfg.block_size,
        vote_topk=cfg.vote_topk)
    return (torch.from_numpy(codes).cuda(), torch.from_numpy(lengths).cuda(),
            params, build_seed_family(seeds))


def train_kernel_check(bits, words, codes, lengths, params, fam,
                       T: int) -> dict:
    """11(a): kernel D as insert_read runs it against its plain version on
    the bench-width filter: 16 recruits of the first 16 bench reads (whole
    at max_blocks 2, trimmed tiles 3..16 at max_blocks 1), the words (or
    ids) at every slot of the first 12 recruits' grids set to SAT
    beforehand; the direct filter (keep = SAT | PRESENT) and the
    compressed one frozen from the same presence (the slot grid mapped to
    ranks in the launch, keep = SAT).  Words, ids and counters bit for
    bit, SAT kept; then a whole recruit timed on scratch copies beside
    the plain version and its bound: the window's grid entries, each
    distinct key's counter read and written, the accepted entries read
    and written, and the rank map's bitrank word an entry.  No PyTorch
    call computes a reservoir insert: no library time.  Returns the
    record's keys."""
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    size, bs, SAT = params.size, params.block_size, dm.SAT_BIT
    grid, _ = dm.build_slot_grid(codes[:16], lengths[:16], fam, params, T)
    recruits = [(i, 0, T - 1, 100 + 4 * i, False, 2) if i % 2 == 0 else
                (i, 3, 16, 100 + 4 * i, True, 1) for i in range(16)]
    sat_slots = grid[:12][grid[:12] < size]
    sat_int = SAT - (1 << 32)
    cstate = cz.with_tables(*cz.build_rank(bits, size), size)
    out, err = {}, 0
    for label, filt, keep in (("direct", dm.MibfState(words.clone(),
                                                     torch.zeros_like(words)),
                               SAT | dm.PRESENT_BIT),
                              ("compressed", cstate, SAT)):
        ranked = label == "compressed"
        table = filt.ids if ranked else filt.words
        limit = filt.sentinel if ranked else size
        sat_keys = (cz.rank_grid(filt, sat_slots, size) if ranked
                    else sat_slots)
        sat_keys = sat_keys[sat_keys < limit]
        table[sat_keys] |= sat_int
        plain = [table.clone(), filt.counts.clone()]
        mod = cz if ranked else dm
        before = kernels.INSERT_SORTED.launches
        for i, lo, hi, base, tr, mb in recruits:
            mod.insert_read(filt, grid[i], lo, hi, base, tr, params, mb, T)
            keys = cz.rank_grid(filt, grid[i], size) if ranked else grid[i]
            dm._insert_plain(*plain, keys, lo, min(hi, lo + mb * bs - 1),
                             base, tr, params, T, limit, 0, keep)
        launched = kernels.INSERT_SORTED.launches - before
        e = max_abs_err([(table, plain[0]), (filt.counts, plain[1])])
        kept = bool((table[sat_keys] < 0).all())
        changed = int((plain[1] != 0).sum())
        err = max(err, e)
        # a whole recruit of a fresh read, timed on scratch copies
        g = grid[15]
        k = type(filt)(*(t.clone() for t in filt))
        p = [table.clone(), filt.counts.clone()]
        keys = cz.rank_grid(filt, g, size) if ranked else g
        ms = cuda_ms(lambda: mod.insert_read(k, g, 0, T - 1, 17, False,
                                             params, 2, T), 20)
        pms = cuda_ms(lambda: dm._insert_plain(*p, keys, 0, T - 1, 17, False,
                                               params, T, limit, 0, keep), 3)
        q = [table.clone(), filt.counts.clone()]
        dm._insert_plain(*q, keys, 0, T - 1, 17, False, params, T, limit, 0,
                         keep)
        accepted = int((q[0] != table).sum())
        distinct = torch.unique(keys[keys < limit]).numel()
        nbytes = g.numel() * 8 * (2 if ranked else 1) + distinct * 8 \
            + accepted * 8
        rec = checked(e, ms, pms, nbytes)
        say("train", part="a", kernel="insert_sorted", filter=label,
            keep=hex(keep), recruits=len(recruits), launches=launched,
            max_abs_err=e, sat_kept=kept, counters_set=changed,
            accepted=accepted, distinct_keys=distinct, ms=f"{ms:.4f}",
            plain_ms=f"{pms:.4f}", bound_ms=f"{rec['bound_ms']:.5f}")
        if e or not kept or launched != len(recruits) or not changed:
            raise AssertionError(f"insert_read {label}: max_abs_err {e}, "
                                 f"SAT kept {kept}, {launched} launches")
        tag = "keep" if label == "direct" else "rank_map"
        out.update({f"ms_{tag}": ms, f"plain_ms_{tag}": pms,
                    f"bound_ms_{tag}": rec["bound_ms"]})
        del k, p, q, plain
    out["train_max_abs_err"] = err
    return out


def train_filled(dev) -> tuple:
    """The fixture's "train_step" case on the card (`train_inputs`) and
    the port's pass-1 fill of all its reads into the bench-width direct
    filter (kernel A's fill, the merge), its words held to the JAX fill's
    digest.  Returns (case, codes, lengths, params, fam, words, bits)."""
    import torch
    from goldrush_tpu_torch.mibf import mibf as dm
    with open(os.path.join(REPO, "tests", "fixtures",
                           "torch_port_digests.json")) as f:
        fx = json.load(f)
    tr = fx["train_step"]
    codes, lengths, params, fam = train_inputs(fx)
    size = params.size
    words = torch.zeros(params.alloc, dtype=torch.int32, device=dev)
    bits = dm.presence_bitmap(size, dev)
    for i in range(0, codes.shape[0], FILL_BATCH):
        dm.fill_presence_bits(bits, codes[i: i + FILL_BATCH],
                              lengths[i: i + FILL_BATCH], fam, size)
    dm.merge_presence(words, bits, size)
    present = int(((words[:size] >> 30) & 1).sum())
    say("train", part="fill", size=size, present=present,
        match=digest(words[:size]) == tr["filled"])
    if digest(words[:size]) != tr["filled"] or present != tr["present"]:
        raise AssertionError("train_step: the fill differs from JAX's")
    return tr, codes, lengths, params, fam, words, bits


def recruit_windows(dec, ts, te, lengths, params, T: int, mb: int) -> list:
    """Each read's (lo, last) as train_step inserts it (csrc/insert.cuh
    batch_read), or None for a drop, on the host."""
    rows = torch_rows(dec, ts, te, lengths)
    out = []
    for d, lo, hi, n in rows:
        if d == 0:
            out.append(None)
            continue
        lo, hi = (0, n // params.tile_length - 1) if d == 1 else (lo, hi)
        out.append((lo, min(hi, lo + mb * params.block_size - 1, T - 1)))
    return out


def torch_rows(*cols) -> list:
    """Rows of int tensors of one length, fetched to the host."""
    import torch
    return torch.stack([c.long().cpu() for c in cols]).t().tolist()


def batch_kernel_check(words, codes, lengths, params, fam, T: int,
                       B: int) -> dict:
    """11(a), the batch entry: kernel D's batch entry (`dm.insert_batch`,
    train_step's insert) on the first step's batch of B bench reads as
    kernel C classifies it against the filled filter, and on that batch
    with reads that share slots (read 1 repeating read 0, read 3 a trimmed
    copy of read 2, every fifth read dropped), at max_blocks 2 and 1:
    against its plain version, against kernel D launched once a recruit
    in batch order (the design it replaces) and against the batch cut
    into chunks of 8 reads, words and counters bit for bit, one launch a
    batch.  Then the step's batch at max_blocks 2 timed beside the plain
    version, the launches a recruit (their verdicts fetched beforehand)
    and the bound: the recruits' windows' grid entries, the verdicts,
    lengths and base ids read once, each distinct key's counter read and
    written, each accepted word read and written.  No PyTorch call
    computes a reservoir insert: no library time.  Returns the record."""
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.parallel import mesh as tmesh
    dev, size = words.device, params.size
    keep = dm.SAT_BIT | dm.PRESENT_BIT
    counts0 = torch.zeros_like(words)

    def fresh():
        return dm.MibfState(words.clone(), counts0.clone())
    res, slots, _ = tmesh.classify_step(words, codes[:B], lengths[:B], fam,
                                        params, T, 10, 5, 1)
    n = lengths[:B]
    base = torch.arange(1, 1 + 2 * B, 2, dtype=torch.int64, device=dev)
    real = (res.decision, res.trim_start, res.trim_end)
    shared = slots.clone()
    shared[1], shared[3] = slots[0], slots[2]
    dec, ts, te = (t.clone() for t in real)
    dec[:4] = torch.tensor([1, 1, 1, 2], dtype=dec.dtype, device=dev)
    dec[4::5] = 0
    ts[3], te[3] = 2, T - 3
    H, TF = slots.shape[1], slots.shape[2]
    err = 0
    for label, g, verdicts in (("step", slots, real),
                               ("shared", shared, (dec, ts, te))):
        for mb in (2, 1):
            got, plain, per, chunked = (fresh() for _ in range(4))
            before = kernels.INSERT_BATCH.launches
            dm.insert_batch(got, g, *verdicts, n, base, params, mb, T)
            launched = kernels.INSERT_BATCH.launches - before
            dm._insert_batch_plain(plain.words, plain.counts, g, *verdicts,
                                   n, base, params, T, mb, size, 0, keep)
            wins = recruit_windows(*verdicts, n, params, T, mb)
            for i, (w, b) in enumerate(zip(wins, base.tolist())):
                if w is not None:
                    dm.insert_read(per, g[i], w[0], w[1], b,
                                   bool(verdicts[0][i] == 2), params, mb, T)
            dm._insert_batch_cuda(chunked.words, chunked.counts, g,
                                  *verdicts, n, base, params, T, mb, size, 0,
                                  keep, window=8 * H * TF)
            e = max_abs_err([(x.words, plain.words) for x in
                             (got, per, chunked)]
                            + [(x.counts, plain.counts) for x in
                               (got, per, chunked)])
            recruits = sum(w is not None for w in wins)
            counted = int((plain.counts != 0).sum())
            say("train", part="a", kernel="insert_batch", batch=label,
                max_blocks=mb, recruits=recruits, launches=launched,
                counters_set=counted, max_abs_err=e)
            if e or launched != 1 or not counted:
                raise AssertionError(f"insert_batch {label} max_blocks {mb}:"
                                     f" max_abs_err {e}, {launched} "
                                     "launches")
            err = max(err, e)
    wins = recruit_windows(*real, n, params, T, 2)
    F = TF // T
    keys = torch.cat([slots[i][:, w[0] * F: (w[1] + 1) * F].reshape(-1)
                      for i, w in enumerate(wins) if w is not None])
    distinct = torch.unique(keys[keys < size]).numel()
    q = fresh()
    dm._insert_batch_plain(q.words, q.counts, slots, *real, n, base, params,
                           T, 2, size, 0, keep)
    accepted = int((q.words != words).sum())
    k = fresh()
    ms = cuda_ms(lambda: dm.insert_batch(k, slots, *real, n, base, params, 2,
                                         T), 20)
    p = fresh()
    pms = cuda_ms(lambda: dm._insert_batch_plain(
        p.words, p.counts, slots, *real, n, base, params, T, 2, size, 0,
        keep), 2)
    r = fresh()
    rows = [(i, w, b, bool(d == 2)) for i, (w, b, d) in enumerate(
        zip(wins, base.tolist(), real[0].tolist())) if w is not None]

    def per_recruit():
        for i, w, b, tr in rows:
            dm.insert_read(r, slots[i], w[0], w[1], b, tr, params, 2, T)
    per_ms = cuda_ms(per_recruit, 5, hold=len(rows) // 6 + 1)
    nbytes = keys.numel() * 8 + B * 20 + distinct * 8 + accepted * 8
    rec = checked(err, ms, pms, nbytes, per_recruit_ms=per_ms,
                  recruits=len(rows), window_entries=keys.numel())
    say("train", part="a", kernel="insert_batch", recruits=len(rows),
        window_entries=keys.numel(), distinct_keys=distinct,
        accepted=accepted, ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
        per_recruit_ms=f"{per_ms:.4f}", bound_ms=f"{rec['bound_ms']:.5f}")
    del q, k, p, r
    return rec


def train_ab_check(dev) -> dict:
    """--ab's phase 11 times, in either tree: the first step's batch of the
    fixture's "train_step" case classified against the filled filter, its
    insert at max_blocks 2 (this tree: one launch of the batch entry; an
    earlier one: kernel D once a recruit, the verdicts fetched beforehand),
    held to the fixture's JAX digest of the step, and timed on the card
    (`ms_insert`); and the fixture's four steps of train_step at
    max_blocks 2 from the filled filter, each timed on the host's clock to
    a synchronize (`ms_step`, their mean; two passes)."""
    import numpy as np
    import torch
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.parallel import mesh as tmesh
    tr, codes, lengths, params, fam, words, bits = train_filled(dev)
    del bits
    T, B, size = tr["num_tiles"], tr["steps"]["batch"], params.size
    res, slots, _ = tmesh.classify_step(words, codes[:B], lengths[:B], fam,
                                        params, T, 10, 5, 1)
    base = 1 + 2 * np.arange(B)
    if hasattr(dm, "insert_batch"):
        base_d = torch.from_numpy(base).to(dev)

        def insert(st):
            dm.insert_batch(st, slots, res.decision, res.trim_start,
                            res.trim_end, lengths[:B], base_d, params, 2, T)
        hold = 1
    else:
        rows = tmesh._fetch_recruits(res, lengths[:B], base, params)

        def insert(st):
            tmesh._recruit(st, slots, rows, params, T, 2)
        hold = len(rows) // 6 + 1
    st = dm.MibfState(words.clone(), torch.zeros_like(words))
    insert(st)
    want = tr["max_blocks_2"][0]
    err = int(digest(st.words[:size]) != want["words"]
              or digest(st.counts[:size]) != want["counts"])
    ms_insert = cuda_ms(lambda: insert(st), 20, hold)
    step_ms = []
    for _ in range(2):
        st = dm.MibfState(words.clone(), torch.zeros_like(words))
        for s in range(tr["steps"]["steps"]):
            sl = slice(s * B, (s + 1) * B)
            torch.cuda.synchronize()
            t0 = time.time()
            st, _ = tmesh.train_step(st, codes[sl], lengths[sl],
                                     1 + 2 * np.arange(s * B, (s + 1) * B),
                                     fam, params, T, 2)
            torch.cuda.synchronize()
            step_ms.append((time.time() - t0) * 1e3)
    say("train", part="ab", max_abs_err=err, ms_insert=f"{ms_insert:.4f}",
        ms_step=f"{sum(step_ms) / len(step_ms):.3f}")
    if err:
        raise AssertionError("train_step's insert differs from the JAX "
                             "digest")
    return {"max_abs_err": err, "ms_insert": ms_insert,
            "ms_step": sum(step_ms) / len(step_ms)}


def train_phase() -> tuple[dict, dict, dict]:
    """Phase 11, the state-mutating step (parallel/mesh.py train_step and
    sharded_train_step; mibf.insert_read and insert_batch): the fixture's
    "train_step" case at the bench width.  The port's pass-1 fill of all
    3,000 bench reads (`train_filled`), then (a) `train_kernel_check` and
    `batch_kernel_check`; then, every launch count zeroed just before and
    read just after, (b) four train_steps of 64 reads at each of the
    fixture's max_blocks from the filled filter, with no host
    synchronisation inside a step (`no_host_sync`): after each step the
    sha256 of the real slots' words and of the counters and decisions
    against the JAX train_step's, its decision counts, ms (host clock to a
    synchronize) and launches (A's grid, B, C and D's batch entry once,
    D's single-recruit entry never); and the same steps through
    sharded_train_step at each of TRAIN_LAYOUTS on ["cuda:0"] * n: every
    row's replica (gathered) and the decisions equal the single card's
    after each step, the batch entry once a data row.  Returns (launches
    of (b), D's record keys, the batch entry's record)."""
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.parallel import mesh as tmesh
    gc_cuda()
    t_start = time.time()
    dev = torch.device("cuda", 0)
    tr, codes, lengths, params, fam, words, bits = train_filled(dev)
    T, B, size = tr["num_tiles"], tr["steps"]["batch"], params.size
    d_rec = train_kernel_check(bits, words, codes, lengths, params, fam, T)
    del bits
    gc_cuda()
    b_rec = batch_kernel_check(words, codes, lengths, params, fam, T, B)
    gc_cuda()
    for k in kernels.ALL + (kernels.INSERT_SORTED,):
        k.launches = 0
    path = (kernels.SEED_HASH_GRID, kernels.PROBE_VOTE, kernels.CLASSIFY,
            kernels.INSERT_BATCH, kernels.INSERT_SORTED)
    snaps, step_ms = {}, []
    for mb in tr["steps"]["max_blocks"]:
        st = dm.MibfState(words.clone(), torch.zeros_like(words))
        for s, want in enumerate(tr[f"max_blocks_{mb}"]):
            sl = slice(s * B, (s + 1) * B)
            base = torch.arange(1 + 2 * s * B, 1 + 2 * (s + 1) * B, 2,
                                dtype=torch.int64, device=dev)
            before = [k.launches for k in path]
            torch.cuda.synchronize()
            t0 = time.time()
            with no_host_sync():
                st, dec = tmesh.train_step(st, codes[sl], lengths[sl], base,
                                           fam, params, T, mb)
            torch.cuda.synchronize()
            ms = (time.time() - t0) * 1e3
            step_ms.append(ms)
            launched = [k.launches - b for k, b in zip(path, before)]
            got = {"words": digest(st.words[:size]),
                   "counts": digest(st.counts[:size]),
                   "decisions": digest(dec),
                   "decision_counts": [int((dec == v).sum())
                                       for v in (0, 1, 2)]}
            say("train", part="b", layout="single", max_blocks=mb, step=s,
                decisions=got["decision_counts"], ms=f"{ms:.2f}",
                launches=launched, match=got == want)
            if got != want or launched != [1, 1, 1, 1, 0]:
                raise AssertionError(f"train_step max_blocks {mb} step {s}:"
                                     f" {got} vs {want}, launches "
                                     f"{launched}")
            snaps[(mb, s)] = (st.words.clone(), st.counts.clone(),
                              dec.clone())
        del st
    mesh_ms = {}
    for data, model in TRAIN_LAYOUTS:
        mesh = tmesh.make_mesh(data * model, data=data, model=model,
                               devices=[dev] * (data * model))
        for mb in tr["steps"]["max_blocks"]:
            reps = tmesh.shard_state(
                dm.MibfState(words, torch.zeros_like(words)), mesh, model > 1)
            step = tmesh.sharded_train_step(mesh, fam, params, T, mb,
                                            model > 1)
            for s in range(tr["steps"]["steps"]):
                sl = slice(s * B, (s + 1) * B)
                base = torch.arange(1 + 2 * s * B, 1 + 2 * (s + 1) * B, 2,
                                    dtype=torch.int64, device=dev)
                before = [k.launches for k in path[3:]]
                torch.cuda.synchronize()
                t0 = time.time()
                with no_host_sync():
                    reps, dec = step(reps, codes[sl], lengths[sl], base)
                torch.cuda.synchronize()
                ms = (time.time() - t0) * 1e3
                mesh_ms.setdefault(f"{data}x{model}", []).append(ms)
                w, c, d = snaps[(mb, s)]
                equal = torch.equal(dec, d) and all(
                    torch.equal(dm.whole(r.words), w)
                    and torch.equal(dm.whole(r.counts), c) for r in reps)
                launched = [k.launches - x for k, x in zip(path[3:], before)]
                say("train", part="b", layout=f"{data}x{model}",
                    max_blocks=mb, step=s, ms=f"{ms:.2f}",
                    insert_launches=launched, equal=equal)
                if not equal or launched != [data, 0]:
                    raise AssertionError(
                        f"sharded_train_step {data}x{model} max_blocks {mb} "
                        f"step {s}: equal {equal}, {launched} launches")
            del reps
            gc_cuda()
    launches = {k.name: k.launches for k in kernels.ALL}
    b_rec["train_step_ms"] = step_ms
    b_rec["sharded_train_step_ms"] = mesh_ms
    for k in path[:4]:
        if k.launches == 0:
            raise AssertionError(f"train: {k.name} never launched")
    say("train", seconds=f"{time.time() - t_start:.1f}",
        step_ms_mean=f"{sum(step_ms) / len(step_ms):.2f}",
        insert_batch_launches=kernels.INSERT_BATCH.launches,
        insert_sorted_launches=kernels.INSERT_SORTED.launches)
    del snaps
    gc_cuda()
    return launches, d_rec, b_rec


def bench_fastq() -> str:
    """smoke_work/bench_reads.fq, the bench reads (`BENCH`), written once
    for the runs of --ab that share it."""
    path = os.path.join(WORK, "bench_reads.fq")
    if not os.path.exists(path):
        os.makedirs(WORK, exist_ok=True)
        make_reads(path + ".tmp", **BENCH)
        os.replace(path + ".tmp", path)
    return path


def phase_ab(earlier: str) -> None:
    """Phase 3, 8(a) and 9(a) of the tree `earlier` and of this checkout in
    turns (earlier, this, this, earlier), each in a process of its own;
    prints every time (each record key starting with "ms") that both trees
    measured, from the four runs side by side."""
    bench_fastq()
    runs = []
    for tree in (earlier, REPO, REPO, earlier):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--kernels-of", tree], capture_output=True,
                           text=True, timeout=1200)
        os.makedirs(WORK, exist_ok=True)
        with open(os.path.join(WORK, "ab_runs.log"), "a") as f:
            f.write(f"=== {tree}\n{r.stdout}{r.stderr[-5000:]}\n")
        if r.returncode != 0:
            raise AssertionError(f"phase 3 of {tree} failed:\n"
                                 f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    for name, rec in runs[1].items():
        for key in sorted(k for k in rec if k.startswith("ms")):
            if key in rec and key in runs[0].get(name, {}):
                say("ab", kernel=name, time=key,
                    earlier=",".join(f"{runs[i][name][key]:.4f}"
                                     for i in (0, 3)),
                    this=",".join(f"{runs[i][name][key]:.4f}"
                                  for i in (1, 2)),
                    max_abs_err=max(runs[i][name]["max_abs_err"]
                                    for i in range(4)))


def main(argv: list[str]) -> int:
    tree = REPO
    if argv[:1] == ["--kernels-of"] and len(argv) == 2:
        tree = os.path.abspath(argv[1])
    elif argv and not (argv[:1] == ["--ab"] and len(argv) == 2):
        raise SystemExit(__doc__)
    # the port must come from a checkout, never from an installed copy
    if not os.path.isdir(os.path.join(tree, "goldrush_tpu_torch", "csrc")):
        raise SystemExit(f"chip_smoke: no goldrush_tpu_torch checkout in "
                         f"{tree}")
    sys.path.insert(0, tree)
    if argv[:1] == ["--kernels-of"]:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: torch.cuda is not available")
        phase_build()
        out = phase_kernels()
        dev = torch.device("cuda", 0)
        rec = freeze_scale_check(dev)
        out["rank_build"]["max_abs_err"] = max(out["rank_build"]["max_abs_err"],
                                               rec.pop("max_abs_err"))
        out["rank_build"].update(rec)
        out.update(wave_kernel_check(dev))
        out["ntcard_count"] = ntcard_kernel_check(dev, bench_fastq())
        out["train_insert"] = train_ab_check(dev)
        print(json.dumps(out))
        return 0
    from goldrush_tpu_torch import kernels
    device_name = phase_device()
    import torch
    if argv[:1] == ["--ab"]:
        phase_ab(os.path.abspath(argv[1]))
        return 0
    phase_build()
    checks = phase_kernels()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        exact = phase_e2e()
        throughput = phase_throughput()
        phase_digests()
        pipeline = phase_pipeline()
        genome, freeze = phase_genome()
        with open(os.path.join(REPO, "tests", "fixtures",
                               "torch_port_digests.json")) as f:
            direct, capacity, direct_checks = phase_direct(json.load(f))
        ntcard, checks["ntcard_count"] = phase_ntcard()
        wave, wave_checks = phase_wave()
        checks.update(wave_checks)
        mesh, mesh_checks = mesh_phase()
        for name, rec in mesh_checks.items():
            checks[name].update(rec)
        train, train_d, checks["insert_batch"] = train_phase()
        checks["insert_sorted"]["max_abs_err"] = max(
            checks["insert_sorted"]["max_abs_err"],
            train_d.pop("train_max_abs_err"))
        checks["insert_sorted"].update(train_d)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    runs = {"exact": exact, "throughput": throughput, "pipeline": pipeline,
            "genome": genome, "direct_2_32": direct, "capacity": capacity,
            "ntcard": ntcard, "wave": wave, "mesh": mesh, "train": train}
    for name, rec in list(freeze.items()) + list(direct_checks.items()):
        checks[name].update(rec)
    # kernel D's and insert_max's code runs inside the consume kernel: their
    # standalone launches' checks and times go with its record
    for inner in ("insert_sorted", "insert_max"):
        checks["consume"].update({f"{inner}_{k}": v
                                  for k, v in checks.pop(inner).items()})
    record = [dict(name=k.name, route="cuda", source=k.source,
                   replaces=k.replaces,
                   launches=sum(r.get(k.name, 0) for r in runs.values()),
                   **{f"launches_{p}": r.get(k.name, 0)
                      for p, r in runs.items()},
                   **checks[k.name]) for k in kernels.ALL]
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
