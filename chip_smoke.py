#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (goldrush_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # one card
    python3 chip_smoke.py --ab DIR        # phase 3 of an earlier tree of
                                          # the port in DIR, then this one's

Phases (one line each; any failure raises, so the exit code is non-zero):
  1. device: require CUDA; print the card and its power limit;
  2. build: compile the kernels of goldrush_tpu_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the slice's shapes (B=32 reads, T=20 tiles of 1000, h=3, K=32, a
     142,368,384-slot filter filled from seeded reads, then frozen into
     the rank-compressed filter; B=1 for the live re-probe), bit for bit
     (every output is an integer), with both times and each kernel's bound (the
     bytes it must move over the card's 3.35 TB/s, or for kernel A its
     integer operations, whichever takes longer); kernel A's fill, merge
     and both grids in both slot maps, the fill per 64-read batch and over
     a whole fill pass of the bench's shape (47 batches and the direct
     filter's merge), the merge on the bench filter as the words' first
     write (dirty memory) and as an OR, rank_pack on the pass's bitmap;
     both grids also at a frame stride: the throughput mode's query grid
     (B=64, h=1, S=8), S=2 with h=3 and its full-resolution insert grid
     (B=64, h=3), timed, and the grid cases of hard_cases.grid_lengths;
     kernel D also on
     recruits whose keys one of its CTAs owns or that repeat one k-mer
     (past a CTA's shared memory), in both filters, and timed on a
     20-tile and a 2-tile trimmed recruit and for its window read alone;
     insert_max (the throughput mode's max-id-wins insert) on the same
     recruits and ids near 2^30 in both filters, timed on the 20-tile and
     the 2-tile recruit beside torch's scatter_reduce_(amax) on the
     20-tile recruit's precomputed keys and values (the library time);
     kernels B and C also on the inputs their designs branch on
     (goldrush_tpu_torch/hard_cases.py) at B=32 and B=1, B in both
     filters, and C's warp cummax (row_cummax) against torch.cummax;
     the stages' kernels: minimizer_keys (K20) on 32 x 32,768 codes at
     (k, w) = (15, 10), (40, 250), (32, 1,000), one 2^20-wide chunk and
     rows narrower than k + w - 1, beside unfold(1, w, 1).amin(-1) on
     precomputed keys; kmer_count (K21) of 64 x 32,768 reads into a
     2^22+1-slot table and of a homopolymer batch, beside index_add_;
     kmer_query on one 1 Mbp contig row and 40,000 candidate windows of
     width 2k + 2, beside advanced indexing (each library call on
     precomputed slots and held to the kernel);
  4. end to end, two paths, each with every launch count zeroed just
     before it and read just after:
     exact: goldrush-path (silver M=5, then golden) through the CLI
     entry point on 3,000 x 20 kb reads of a 5 Mbp genome at 5% error
     (bench.py's dataset, seeds 11/12), once with the direct filter and
     once with the rank-compressed one; the fill once per batch, the
     merge once per direct fill pass and never in the compressed filter,
     each grid entry once per grid of its filter, kernel D once per
     recruit, recruits > 0, each completed silver path > r*G bases;
     throughput: bench.py's throughput cell (stride 8, one probed seed,
     optimistic staleness, batches of 64; bench.py:173-180) through
     GoldenPathEngine on the same reads, compressed filter then direct;
     insert_max once per recruit and kernel D never; kernel B's launches
     split into batched probes, live re-probes and full-resolution
     rechecks; every kernel must have launched in one of the two paths;
     each run's times, reads/s and peak device memory are printed;
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
     must launch in (a) or (b).
The line before the last is the per-kernel JSON record, the last line
{"ok": true, "device": {...}}.  Imports nothing of JAX.

With --ab DIR it runs phase 3 alone, four times, each in a process of its
own that imports the port from its tree: DIR (for example a `git archive`
of the parent commit, whose kernels' entry points may differ: only the
Python wrappers are called), this checkout, this checkout, DIR; then it
prints each kernel's times side by side.  Every run checks its tree's
kernels against their plain versions.  An earlier tree skips what its
wrappers cannot run: the strided grids, insert_max, and the hard cases of
B and C.
"""

from __future__ import annotations

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
# NVIDIA H100 SXM device memory rate and 32-bit rate outside the tensor
# cores (data sheet), for each kernel's bound; an integer operation counts
# as one operation at the float32 rate
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
FILL_BATCH, FILL_WIDTH = 64, 32_768     # the engine's pass-1 batches here
# bench.py's engine_cfg (bench.py:80-84) and its throughput cell (:173-180)
BENCH_ENGINE = dict(genome_size=5_000_000, kmer_size=22, weight=16,
                    hash_num=3, seed_preset=PRESET, silver_path=True,
                    max_paths=5, min_length=20_000)
THROUGHPUT = dict(frame_stride=8, probe_seeds=1, recheck="optimistic",
                  batch_reads=64)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


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
    once) over the device memory rate and its integer operations, where
    counted, over OPS_PER_S; the other kernels do a few integer operations
    per byte.  No single PyTorch call computes any of these functions, so
    there is no library time."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
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


def fill_pass_batches(dev) -> list:
    """A fill pass of the bench dataset's shape, made on the card from a
    seed: 3,000 reads of 20 kb sampled from a 5 Mbp random genome with 5%
    substitutions (bench.py's sizes; ~3x coverage, as there), in the
    engine's 47 batches of 64 reads padded to 32,768 bases."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(BENCH["genome_seed"])
    n, L, G = BENCH["n_reads"], BENCH["read_len"], BENCH["genome"]
    u8 = dict(dtype=torch.uint8, device=dev, generator=g)
    genome = torch.randint(0, 4, (G,), **u8)
    starts = torch.randint(0, G - L, (n, 1), device=dev, generator=g)
    reads = genome[starts + torch.arange(L, device=dev)]
    subst = torch.rand((n, L), device=dev, generator=g) < BENCH["err_rate"]
    reads = torch.where(subst, torch.randint(0, 4, (n, L), **u8), reads)
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


def insert_phase(state_k, state_p, recruits, timed, params, T, limit,
                 or_bits, label) -> tuple:
    """Kernel D on state_k and its plain version on state_p, both (table,
    counts), recruit after recruit; then both timed on scratch copies for
    the full recruit of grid `timed` and a 2-tile trimmed one, and the
    window read alone (key limit 0: every CTA streams the window and owns
    no key).  Returns the record of the full recruit, whose bound counts
    the window's grid entries, each distinct key's counter read and
    written, and the words it accepts."""
    import torch
    from goldrush_tpu_torch.mibf import mibf as dm
    for grid, lo, hi, base, tr in recruits:
        dm.insert_blocks(*state_k, grid, lo, hi, base, tr, params, T, limit,
                         or_bits)
        dm._insert_plain(*state_p, grid, lo, hi, base, tr, params, T, limit,
                         or_bits)
    err = max_abs_err(zip(state_k, state_p))
    k = [t.clone() for t in state_k]
    p = [t.clone() for t in state_k]
    keys = torch.unique(timed[timed < limit])
    dm._insert_plain(*p, timed, 0, T - 1, 17, False, params, T, limit,
                     or_bits)
    accepted = int((p[0] != k[0]).sum())
    nbytes = timed.numel() * 8 + keys.numel() * 8 + accepted * 4
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
        window_share=f"{window / ms:.4f}")
    return checked(err, ms, pms, nbytes)


def insert_max_phase(table, recruits, timed, params, T, limit, or_bits,
                     label) -> dict:
    """insert_max on `table` and its plain version on a copy, recruit after
    recruit; then, on scratch copies, both timed for the full recruit of
    grid `timed` and a 2-tile trimmed one, and torch's scatter_reduce_
    (amax) for the full recruit from its keys and values precomputed (the
    library yardstick, held to the kernel's result).  Returns the full
    recruit's record, whose bound counts the window's grid entries read
    and one 32-byte sector per distinct key written."""
    import torch
    from goldrush_tpu_torch.mibf import mibf as dm
    bs = params.block_size
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
    say("kernels", kernel="insert_max", filter=label,
        recruits=len(recruits), max_abs_err=err, changed=changed,
        accepted=accepted,
        distinct_keys=distinct, ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
        library_ms=f"{lib_ms:.4f}", ms_2tile=f"{ms2:.4f}",
        plain_ms_2tile=f"{pms2:.4f}")
    if changed == 0 or accepted == 0:
        raise AssertionError(f"insert_max {label}: degenerate check inputs")
    rec = checked(err, ms, pms, timed.numel() * 8 + distinct * 32,
                  ms_2tile=ms2, plain_ms_2tile=pms2)
    rec["library_ms"] = lib_ms
    return rec


def strided_grids(codes, lengths, params, cs, n_care) -> tuple:
    """Kernel A's slot and rank grid entries at a frame stride against their
    plain versions (the JAX package's sampled routes: the last-tile grid at
    S >= h, the general one below) in both slot maps: the throughput
    mode's query grid (B=64, h=1, S=8), S=2 with h=3 at B=32, and the
    full-resolution grid a B=64 throughput batch inserts from (h=3, S=1),
    each timed in the fastrange map; and the grid cases of
    hard_cases.grid_lengths at S=8 with h=1 and S=2 with h=3.  Returns the
    two entries' extra record keys and their max_abs_err."""
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
        kernel's slots and frame_ok."""
        p = par(h, S, mode)
        sk = dm.build_slot_grid(c, n, fams[h], p, Tg)
        rk = cz.build_rank_grid(cs, c, n, fams[h], p, Tg)
        es = max_abs_err(zip(sk, dm._build_slot_grid_plain(c, n, fams[h], p,
                                                            Tg)))
        er = max_abs_err(zip(rk, cz._build_rank_grid_plain(cs, c, n, fams[h],
                                                            p, Tg)))
        return es, er, sk
    slot_rec, rank_rec = {}, {}
    err_s = err_r = 0
    for tag, (B, h, S) in {"s8": (64, 1, 8), "s2": (32, 3, 2),
                           "ins_b64": (64, 3, 1)}.items():
        qc = torch.from_numpy(codes[:B, : T * TL + TL].copy()).to(dev)
        ql = torch.from_numpy(lengths[:B].copy()).to(dev)
        for mode in ("mod", "fastrange"):
            es, er, (slots, ok) = both(qc, ql, h, S, mode, T)
            err_s, err_r = max(err_s, es), max(err_r, er)
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
    cases = hard.grid_lengths(TL, 22)
    for h, S in ((1, 8), (3, 2)):
        for case, (lens, Tc) in cases.items():
            c, n = (torch.from_numpy(a).to(dev) for a in
                    hard.read_batch(lens, Tc * TL + TL, seed=len(case)))
            for mode in ("mod", "fastrange"):
                es, er, _ = both(c, n, h, S, mode, Tc)
                err_s, err_r = max(err_s, es), max(err_r, er)
    say("kernels", kernel="seed_hash_grid+rank_grid", strides="8,2",
        grid_cases=len(cases), max_abs_err=max(err_s, err_r))
    return slot_rec, rank_rec, err_s, err_r


def minimizer_check(dev) -> dict:
    """K20 against its plain version at the slice's shapes, bit for bit:
    32 x 32,768 codes (1% N) at (k, w) = (15, 10), (40, 250) and (32,
    1,000), the first rows of each batch as long as the windows branch on
    (shorter than k + w - 1, one window, one tile of 2,048 windows and one
    more); one 2^20-wide chunk (the mapper's position-packing limit) at
    (15, 10) and (32, 1,000); and rows narrower than k + w - 1.  Each
    32-row shape is timed beside the plain version and the library call,
    unfold(1, w, 1).amin(-1) on its keys precomputed with the sign bit
    flipped (held to the kernel's keys).  Returns the (15, 10) record, the
    others under suffixed keys."""
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
        # codes in, keys and hashes out; per position the rolling hash of
        # both strands, the canonical min and the key (~40 operations), per
        # window one 64-bit min (~5) per doubling pass
        nw = keys.shape[1]
        r = checked(0, ms, pms, c.numel() + (keys.numel() + hashes.numel())
                    * 8, 32 * (P * 40 + nw * 5 * (w.bit_length())))
        r["library_ms"] = lib
        tag = "" if (k, w) == (15, 10) else f"_k{k}_w{w}"
        rec.update({f"{key}{tag}": r[key] for key in
                    ("ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")})
        say("kernels", kernel="minimizer_keys", shape=f"32x{W}", k=k, w=w,
            ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", library_ms=f"{lib:.4f}",
            bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"])
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
    2k + 2 on the filled table.  Timed at k = 32 beside the plain versions
    and the library calls on the slots precomputed: index_add_ for the
    count, advanced indexing for the query (both held to the kernels).
    Returns the count's and the query's records (the candidate batch; the
    contig row under `_contig`)."""
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
        for c, n in ((rows, one), cand):
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
        ms_homopolymer=f"{homo_ms:.4f}", bound_ms=f"{count['bound_ms']:.4f}")
    query = {}
    for tag, (c, n) in (("", cand32), ("_contig", (rows, one))):
        sl = tpol._slots_plain(c, k, size)
        got = tpol.query_kmers(table, c, n, k, size)[0]
        err_q = max(err_q, max_abs_err([(got, table[sl])]))
        ms = cuda_ms(lambda: tpol.query_kmers(table, c, n, k, size), 20)
        pms = cuda_ms(lambda: tpol._query_kmers_plain(table, c, k, size), 3)
        lib = cuda_ms(lambda: table[sl], 20)
        distinct = torch.unique(sl).numel()
        # codes in, counts out, each distinct slot read once
        r = checked(0, ms, pms, c.numel() + got.numel() * 4 + distinct * 4,
                    sl.numel() * 50)
        r["library_ms"] = lib
        query.update({f"{key}{tag}": r[key] for key in
                      ("ms", "plain_ms", "bound_ms", "bound_by",
                       "library_ms")})
        say("kernels", kernel="kmer_query", shape="x".join(
            map(str, c.shape)), k=k, ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
            library_ms=f"{lib:.4f}", bound_ms=f"{r['bound_ms']:.4f}")
    query["max_abs_err"] = err_q
    say("kernels", kernel="kmer_count+kmer_query", ks="32,13,24",
        max_abs_err=max(err_c, err_q))
    return count, query


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


def phase_kernels(own: bool = True) -> dict:
    """Each kernel vs its plain version at the slice's shapes; with `own`
    also kernel A at a stride, insert_max, the hard cases of B and C and
    C's warp cummax alone, which an earlier tree of the port (timed by
    --ab) may lack."""
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
    # recruits its key partition finds hard ------------------------------
    plan = [(0, T - 1, 1, False), (0, T - 1, 3, False), (3, 14, 5, True),
            (0, T - 1, 7, False), (5, 5, 9, True), (0, T - 1, 11, False),
            (2, 17, 13, True), (0, T - 1, 15, False)]
    out["insert_sorted"] = insert_phase(
        st_k, st_p, [(slots[i], *p) for i, p in enumerate(plan)]
        + hard_recruits(size, T, TL), slots[8], params, T, size,
        dm.PRESENT_BIT, "direct")
    # --- insert_max (throughput mode): D's recruits, then ids near 2^30 ---
    # (grid row, lo, hi, base, trimmed)
    max_plan = [(i, *p) for i, p in enumerate(plan)] + [
        (10, 0, T - 1, dm.ID_MASK - 40, True),
        (11, 2, 17, dm.ID_MASK - 20, False)]
    if own:
        out["insert_max"] = insert_max_phase(
            st_k.words.clone(), [(slots[i], *p) for i, *p in max_plan]
            + hard_recruits(size, T, TL),
            slots[8], params, T, size, dm.PRESENT_BIT, "direct")

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
    bk, tk = cz.rank_pack(pass_bits, size)
    bp, tp = cz._rank_pack_plain(pass_bits, size)
    err = max_abs_err([(bk, bp), (tk, tp)])
    ms = cuda_ms(lambda: cz.rank_pack(pass_bits, size), 20)
    pms = cuda_ms(lambda: cz._rank_pack_plain(pass_bits, size), 3)
    nw = -(-size // 32)
    # the bitmap in, bitrank + totals out
    out["rank_pack"] = checked(err, ms, pms, pass_bits.numel() * 4
                               + bk.numel() * 8 + tk.numel() * 8)
    say("kernels", kernel="rank_pack", slots=size, max_abs_err=err,
        ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
        bound_ms=f"{out['rank_pack']['bound_ms']:.4f}")
    del pass_words, pass_bits
    # timed on a scratch copy: each call adds its carry again
    scratch = bk.clone()
    pop = cz.rank_carry(bk, tk)
    pop_p = int(cz._rank_carry_plain(bp, tp))
    err = max(max_abs_err([(bk, bp)]), abs(pop - pop_p))
    ms = cuda_ms(lambda: cz._rank_carry_cuda(scratch, tk), 20)
    pms = cuda_ms(lambda: cz._rank_carry_plain(scratch, tk), 3)
    # the words' ranks read and written, the block totals read
    out["rank_carry"] = checked(err, ms, pms, 2 * nw * 8 + tk.numel() * 8
                                + 8)
    say("kernels", kernel="rank_carry", present=pop, max_abs_err=err,
        ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}",
        bound_ms=f"{out['rank_carry']['bound_ms']:.4f}")
    del scratch, bp, tp, bk, tk
    # the filter of the grid's batch, frozen (freeze: its words' bits packed
    # by plain torch ops, then rank_pack and rank_carry); the plain rank map
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
    err = insert_phase(
        (cs_k.ids, cs_k.counts), (cs_p.ids, cs_p.counts),
        [(ranks[i], *p) for i, p in enumerate(plan)]
        + hard_recruits(cs_k.sentinel, T, TL), ranks[8], params, T,
        cs_k.sentinel, 0, "compressed")["max_abs_err"]
    if own:
        rec = insert_max_phase(
            cs_k.ids.clone(), [(ranks[i], *p) for i, *p in max_plan]
            + hard_recruits(cs_k.sentinel, T, TL), ranks[8], params, T,
            cs_k.sentinel, 0, "compressed")
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
    hard_b, hard_c = hard_cases(dev) if own else (0, 0)
    if own:
        out["classify"].update(cummax_check(dev))
        out["minimizer_keys"] = minimizer_check(dev)
        out["kmer_count"], out["kmer_query"] = kmer_check(dev)
    err_cummax = out["classify"].get("cummax_max_abs_err", 0)
    out["insert_sorted"]["max_abs_err"] = max(
        out["insert_sorted"]["max_abs_err"], err)
    out["probe_vote"]["max_abs_err"] = max(out["probe_vote"]["max_abs_err"],
                                           err_b, hard_b)
    out["classify"]["max_abs_err"] = max(out["classify"]["max_abs_err"],
                                         hard_c, err_cummax)
    del cs_k, cs_p
    bad = {k: v["max_abs_err"] for k, v in out.items()
           if v["max_abs_err"] != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    if present == 0 or voted == 0 or decisions.sum() != B or ranked == 0:
        raise AssertionError("kernel check inputs are degenerate")
    del st_k, st_p
    torch.cuda.empty_cache()
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
                        rank_pack=passes, rank_carry=passes)
        if any(got[k] != n or called.get(k, n) != n
               for k, n in want.items()):
            raise AssertionError(f"{mode}: launches {got} for wrapper calls "
                                 f"{called} over {passes} fill passes")
        say("e2e", filter=mode, fill_batches=called["seed_hash_fill"],
            fill_passes=passes, grids=called["seed_hash_grid"]
            + called["seed_hash_rank_grid"])
    return launches


def drive_bench(reads: str, calls: dict) -> tuple[dict, dict]:
    """Both filters' silver and golden stages on the bench reads: the
    kernels' launch counts over both, and for each filter its launches,
    its counted wrapper calls and its number of fill passes (stage
    runs)."""
    import torch
    from goldrush_tpu_torch import cli, kernels
    from goldrush_tpu_torch.io import fastq
    for k in kernels.ALL:
        k.launches = 0
    recruits = 0
    per_filter = {}
    for mode in ("direct", "compressed"):
        before = {k.name: k.launches for k in kernels.PATH}
        called0 = dict(calls)
        outdir = os.path.join(WORK, f"bench_{mode}")
        argv = ["goldrush-path", f"reads={reads}", "G=5000000",
                "device=cuda", f"mibf_mode={mode}", f"prefix={outdir}",
                "dev=1"]
        cmd, cfg, extra = cli.parse_args(argv)
        torch.cuda.reset_peak_memory_stats()
        t1 = time.time()
        out = cli.run(cmd, cfg, extra)
        wall = time.time() - t1
        peak = torch.cuda.max_memory_allocated()
        for stage, st in out["stats"].items():
            rate = st.num_reads / max(st.wall_assign_s, 1e-9)
            say("e2e", filter=mode, stage=stage,
                fill_s=f"{st.wall_fill_s:.3f}",
                assign_s=f"{st.wall_assign_s:.3f}",
                submit_s=f"{st.wall_submit_s:.3f}",
                replay_s=f"{st.wall_replay_s:.3f}",
                reads=st.num_reads, recruits=st.recruits,
                reads_per_s=f"{rate:.2f}",
                paths_completed=st.paths_completed)
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
        say("e2e", filter=mode, wall_s=f"{wall:.2f}",
            max_memory_allocated=peak,
            silver_paths_ok=silver.paths_completed, golden_bases=golden)
    launches = {k.name: k.launches for k in kernels.ALL}
    say("e2e", launches=json.dumps(launches).replace(" ", ""))
    if any(k.launches for k in kernels.STAGES):
        raise AssertionError("goldrush-path launched a later stage's kernel")
    launches = {k.name: k.launches for k in kernels.PATH}
    # every kernel but the throughput mode's insert
    missing = [k for k, n in launches.items() if n <= 0 and k != "insert_max"]
    if missing or launches["insert_max"]:
        raise AssertionError(f"exact path: kernels never launched {missing}, "
                             f"insert_max {launches['insert_max']}")
    # kernel D covers a whole recruit in one launch
    if launches["insert_sorted"] != recruits:
        raise AssertionError(f"insert_sorted launched {launches['insert_sorted']}"
                             f" times for {recruits} recruits")
    return launches, per_filter


def phase_throughput() -> dict:
    """bench.py's throughput cell at full width on the bench reads (written
    by phase_e2e): GoldenPathEngine(device="cuda") with bench.py's
    engine_cfg and its throughput settings, compressed filter then direct,
    every launch count zeroed just before and read just after.  Kernel B's
    launches are split by the consume loop's probes: the batch's, the live
    re-probes and the full-resolution trim rechecks.  insert_max must
    launch once per recruit and kernel D never; every kernel but D must
    launch.  Returns the launch counts."""
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.io import fastq
    from goldrush_tpu_torch.path.engine import GoldenPathEngine as Engine
    reads = os.path.join(WORK, "bench_reads.fq")
    probes = dict(batched=0, live=0, recheck=0)
    batch_open = [False]
    consume, probe = Engine._consume, Engine._probe_classify

    def counted_consume(self, *args):
        batch_open[0] = True            # its first probe is the batch's
        return consume(self, *args)

    def counted_probe(self, grid, frame_ok, n_tiles, T, full=False):
        before = kernels.PROBE_VOTE.launches
        rows = probe(self, grid, frame_ok, n_tiles, T, full)
        kind = "recheck" if full else "batched" if batch_open[0] else "live"
        batch_open[0] = False
        probes[kind] += kernels.PROBE_VOTE.launches - before
        return rows
    Engine._consume, Engine._probe_classify = counted_consume, counted_probe
    try:
        for k in kernels.ALL:
            k.launches = 0
        for mode in ("compressed", "direct"):
            before = {k.name: k.launches for k in kernels.PATH}
            p0 = dict(probes)
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
            n = {k: v - p0[k] for k, v in probes.items()}
            say("throughput", filter=mode, fill_s=f"{st.wall_fill_s:.3f}",
                assign_s=f"{st.wall_assign_s:.3f}",
                submit_s=f"{st.wall_submit_s:.3f}",
                replay_s=f"{st.wall_replay_s:.3f}", reads=st.num_reads,
                recruits=st.recruits,
                reads_per_s=f"{st.num_reads / max(st.wall_assign_s, 1e-9):.2f}",
                batches=st.num_batches, batched_probes=n["batched"],
                live_probes=n["live"], recheck_probes=n["recheck"],
                paths_completed=st.paths_completed, wall_s=f"{wall:.2f}",
                max_memory_allocated=torch.cuda.max_memory_allocated())
            if (st.recruits <= 0 or got["insert_max"] != st.recruits
                    or got["insert_sorted"] or n["batched"] != st.num_batches
                    or sum(n.values()) != got["probe_vote"]):
                raise AssertionError(f"throughput {mode}: launches {got}, "
                                     f"probes {n}, {st.recruits} recruits, "
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
        Engine._consume, Engine._probe_classify = consume, probe
    launches = {k.name: k.launches for k in kernels.ALL}
    say("throughput", launches=json.dumps(launches).replace(" ", ""))
    if any(k.launches for k in kernels.STAGES):
        raise AssertionError("goldrush-path launched a later stage's kernel")
    launches = {k.name: k.launches for k in kernels.PATH}
    missing = [k for k, n in launches.items()
               if n <= 0 and k != "insert_sorted"]
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


def phase_ab(earlier: str) -> None:
    """Phase 3 of the tree `earlier` and of this checkout in turns (earlier,
    this, this, earlier), each in a process of its own; prints every
    kernel's times from the four runs side by side."""
    runs = []
    for tree in (earlier, REPO, REPO, earlier):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--kernels-of", tree], capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            raise AssertionError(f"phase 3 of {tree} failed:\n"
                                 f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    for name, rec in runs[1].items():
        for key in ("ms", "ms_b1", "ms_compressed", "ms_b1_compressed",
                    "ms_fill_pass", "ms_or", "ms_words_merge", "ms_2tile",
                    "ms_s8", "ms_s2", "ms_ins_b64", "ms_k40_w250",
                    "ms_k32_w1000", "ms_chunk", "ms_homopolymer",
                    "ms_contig"):
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
        print(json.dumps(phase_kernels(own=tree == REPO)))
        return 0
    from goldrush_tpu_torch import kernels
    name = phase_device()
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
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    runs = {"exact": exact, "throughput": throughput, "pipeline": pipeline}
    record = [dict(name=k.name, route="cuda", source=k.source,
                   replaces=k.replaces,
                   launches=sum(r.get(k.name, 0) for r in runs.values()),
                   **{f"launches_{p}": r.get(k.name, 0)
                      for p, r in runs.items()},
                   **checks[k.name]) for k in kernels.ALL]
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
