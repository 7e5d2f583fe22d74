"""Whole goldrush-path jobs back to back: ``GoldenPathEngine(cfg).run()`` on
one FASTQ made from the seed.

Set-up makes the reads on the card, writes the FASTQ into a directory of
its own under TMPDIR and runs one job (it builds the kernels and the
native reader, and warms every shape the traffic uses).  The window then
runs fresh jobs until ``seconds`` have passed; the job running at the
deadline finishes and counts.  Each engine is dropped before the next is
built (two filters of a human-size deployment do not fit one card), and
each job's path files are deleted once their digest is taken.  The last
job's engine is kept: after the window its rows, path files and filter are
held to the plain reference (reference/silver.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import os
import shutil
import sys
import tempfile
import time
import weakref

import numpy as np
import torch

from portbench import lib
from portbench.counts import bounds
from portbench.reference.silver import SilverJob
from portbench.traffic import reads as traffic_reads

from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.path.engine import GoldenPathEngine

_MASK32 = 0xFFFFFFFF
# the direct filter's presence bit (goldrush_tpu/mibf/mibf_np.py PRESENT_BIT)
PRESENT_BIT = 1 << 30


def _digest_paths(prefix: str) -> list:
    """sha256 of each path file of a job, in path order, then delete them."""
    out, k = [], 1
    while os.path.exists(f"{prefix}_{k}.fq"):
        with open(f"{prefix}_{k}.fq", "rb") as f:
            out.append(hashlib.sha256(f.read()).hexdigest())
        os.remove(f"{prefix}_{k}.fq")
        k += 1
    return out


def _job(cfg: PathConfig, device, spans: bool = False):
    """One job; its engine, stats, rows digest and path-file digests.
    With ``spans`` the construction, the engine's three phases and the
    digest each run inside a profiler span."""
    with lib.span(spans, "engine.__init__"):
        eng = (_SpannedEngine if spans else GoldenPathEngine)(
            dataclasses.replace(cfg), device=device)
    with contextlib.redirect_stdout(sys.stderr):
        stats = eng.run()
    with lib.span(spans, "job.digest"):
        rows = hashlib.sha256(np.ascontiguousarray(eng.last_rows)).hexdigest()
        return eng, stats, rows, _digest_paths(cfg.prefix_file)


class _SpannedEngine(GoldenPathEngine):
    """The engine with a profiler span around each phase ``run`` calls, for
    the traced jobs (a subclass, so that no span ties an engine to
    itself)."""

    def calc_phred_threshold(self, path):
        with lib.span(True, "engine.calc_phred_threshold"):
            return super().calc_phred_threshold(path)

    def fill(self, path):
        with lib.span(True, "engine.fill"):
            return super().fill(path)

    def assign(self, path):
        with lib.span(True, "engine.assign"):
            return super().assign(path)


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _collect_if_alive(ref) -> None:
    """Free a dropped engine before the next is built: its last reference
    frees it (an engine holds no cycle); a collection, ~0.1 s, only where
    something still holds it."""
    if ref is not None and ref() is not None:
        gc.collect()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: dict, config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, control: bool, device, t0: float) -> dict:
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run(cell, config, traffic, seed, seconds, trace, control,
                    device, t0, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, config, traffic, seed, seconds, trace, control, device, t0,
         tmp):
    dev = torch.device(device)
    reads = traffic_reads.make_reads(traffic, seed, dev)
    host = traffic_reads.host_reads(reads)
    del reads
    fq = os.path.join(tmp, "reads.fq")
    traffic_reads.write_fastq(fq, host)
    bases = sum(len(c) for _, c, _ in host)
    if control:
        return _control(host, config, dev)
    cfg = PathConfig(input=fq, prefix_file=os.path.join(tmp, "silver"),
                     **config["path_config"])
    # the warm job: builds, loads and warms what the window runs
    eng, _, rows0, paths0 = _job(cfg, dev)
    ref, eng = weakref.ref(eng), None
    _collect_if_alive(ref)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0

    jobs, digests = [], []
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
    profiled = int(traffic["profiled_units"]) if trace else 0
    w0 = time.perf_counter()
    deadline = w0 + seconds
    eng = None
    while True:
        ref, eng = (weakref.ref(eng) if eng is not None else None), None
        _collect_if_alive(ref)
        if len(jobs) == 0 and prof is not None:
            prof.__enter__()
            marker = torch.profiler.record_function(lib.WINDOW)
            marker.__enter__()
        tj = time.perf_counter()
        eng, stats, rows, paths = _job(cfg, dev, spans=len(jobs) < profiled)
        jobs.append(dict(dataclasses.asdict(stats),
                         wall_job_s=time.perf_counter() - tj))
        digests.append((rows, paths))
        if prof is not None and len(jobs) == profiled:
            _sync(dev)
            marker.__exit__(None, None, None)
            prof.__exit__(None, None, None)
        if time.perf_counter() >= deadline and len(jobs) >= profiled:
            break
    w1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    live = eng.consume_counts.get("live", 0)
    say(f"portbench timing setup_s={setup_s:.3f} window_s={w1 - w0:.3f} "
        f"jobs={len(jobs)} input_bases={bases} "
        f"consume_counts={eng.consume_counts} batches={jobs[-1]['num_batches']}"
        f" recruits={jobs[-1]['recruits']}")
    say("portbench jobs (wall, phred+other, fill, submit, replay s): " + " ".join(
        f"{j['wall_job_s']:.3f},{j['wall_job_s'] - j['wall_fill_s'] - j['wall_assign_s']:.3f},"
        f"{j['wall_fill_s']:.3f},{j['wall_submit_s']:.3f},{j['wall_replay_s']:.3f}"
        for j in jobs))
    tables = _table_bytes(eng)
    t = time.perf_counter()
    checks = _check(eng, host, config, dev, rows0, paths0, digests)
    ref_inserts = checks.pop("_inserts")
    say(f"portbench timing check_s={time.perf_counter() - t:.3f}")
    del eng
    n_eligible = sum(1 for _, c, _ in host if len(c) >= cfg.min_length)
    summary = lib.profile_summary(prof) if prof is not None else None
    return dict(
        attempted=len(jobs), failed=0,
        e2e=dict(path_Mbp_per_s=bases * len(jobs) / (w1 - w0) / 1e6,
                 device_peak_GB=peak / 1e9, setup_s=setup_s),
        memory_peak_bytes=peak, checks=checks, profile=summary,
        layer=dict(jobs=jobs, job_bases=bases, profiled=profiled,
                   tables_bytes=tables,
                   consume_bound_s=_consume_bound(host, cfg, live,
                                                  ref_inserts,
                                                  n_eligible)))


def _table_bytes(eng) -> int:
    """Bytes of the last job's filter tables (the direct words and
    counters, or the compressed bitrank, superblock bases, ids and
    counters), as the engine holds them on its card."""
    return sum(t.numel() * t.element_size() for rep in eng.replicas
               for t in (rep or ()) if isinstance(t, torch.Tensor))


def _control(host, config, dev) -> dict:
    """The control, in the program's place: the reference with each batch
    of ``batch_reads`` eligible reads voted against the filter as the batch
    found it, which breaks the exact sequential semantics the configuration
    states (the program's own optimistic policy fails its consume launch at
    this size: PERF.md, section 7), held to the reference by the same
    numbers."""
    pc = config["path_config"]
    ctl = SilverJob(pc, dev)
    got = ctl.run(host, stale=pc["batch_reads"])
    ref = SilverJob(pc, dev)
    want = ref.run(host)
    return dict(attempted=1, failed=0, e2e={}, memory_peak_bytes=0,
                profile=None, layer={},
                checks=dict(
                    rows_mismatched=(_rows_bad(got["rows"], want["rows"]), 0),
                    path_files_mismatched=(_paths_bad(got["path_digests"],
                                                      want["path_digests"]), 0),
                    ids_mismatched=(int((ctl.ids != ref.ids).sum()), 0),
                    counts_mismatched=(int((ctl.counts != ref.counts).sum()),
                                       0)))


def _rows_bad(rows, want) -> int:
    """Reads whose rows differ (trim start and end compared where the
    reference trims), and reads one side has and the other not."""
    n = min(len(rows), len(want))
    a, b = rows[:n], want[:n]
    trimmed = b[:, 0] == 2
    bad = (a[:, [0, 3, 4, 5, 6, 7]] != b[:, [0, 3, 4, 5, 6, 7]]).any(1) | \
        (trimmed & (a[:, 1:3] != b[:, 1:3]).any(1))
    return int(bad.sum()) + abs(len(rows) - len(want))


def _paths_bad(paths, want) -> int:
    return sum(x != y for x, y in zip(paths, want)) + abs(len(paths) -
                                                          len(want))


def _consume_bound(host, cfg, live, inserts, n_eligible) -> float:
    """The least time one job's consume launches could take
    (counts/bounds.consume_bytes): the eligible reads' rows, the pass's
    live re-probes at the eligible reads' mean probe, and the reference's
    inserts."""
    TL, h = cfg.tile_length, cfg.hash_num
    probe = [h * (len(c) // TL) * TL * 8 + (len(c) // TL) * TL
             + 4 * h * (len(c) // TL) * TL
             for _, c, _ in host if len(c) >= cfg.min_length]
    mean = sum(probe) / max(len(probe), 1)
    return bounds.seconds(bounds.consume_bytes(n_eligible, live, mean,
                                               inserts))


def _popcount_low32(words: torch.Tensor) -> int:
    """Set bits in the low 32 bits of int64 words, in chunks."""
    total = 0
    step = 1 << 26
    for i in range(0, words.shape[0], step):
        x = words[i: i + step] & _MASK32
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        total += int(((x * 0x01010101) >> 24 & 0xFF).sum())
    return total


def _nonzero(t: torch.Tensor) -> int:
    step = 1 << 28
    return sum(int(torch.count_nonzero(t[i: i + step]))
               for i in range(0, t.shape[0], step))


def _present_words(words: torch.Tensor) -> int:
    """Direct words with the presence bit set, in chunks."""
    step = 1 << 28
    return sum(int(torch.count_nonzero(words[i: i + step] & PRESENT_BIT))
               for i in range(0, words.shape[0], step))


def _compressed_tables(st, S: torch.Tensor) -> tuple:
    """The compressed filter against the present slots S: its ids and
    counters at every rank, and the checks of its presence (bitrank at every
    word S touches, the superblock bases, the present count) and of entries
    past the present ranks."""
    n = S.shape[0]
    W, inv = torch.unique(S >> 5, return_inverse=True)
    bits = torch.zeros(W.shape[0], dtype=torch.int64, device=S.device)
    bits.index_add_(0, inv, torch.ones_like(S) << (S & 31))
    base = (W * 32 >> 32) << 32
    rank = torch.searchsorted(S, W * 32) - torch.searchsorted(S, base)
    want = (rank << 32) | bits
    words_bad = int((st.bitrank[W] != want).sum())
    supers = torch.searchsorted(S, torch.arange(
        st.supers.shape[0], device=S.device, dtype=torch.int64) << 32)
    ids = st.ids[:n].to(torch.int64) & _MASK32
    counts = st.counts[:n].to(torch.int64) & _MASK32
    stray = (_nonzero(st.ids) - int(torch.count_nonzero(ids))
             + _nonzero(st.counts) - int(torch.count_nonzero(counts)))
    return ids, counts, dict(
        bitrank_words_mismatched=(words_bad, 0),
        supers_mismatched=(int((st.supers != supers).sum()), 0),
        present_slots_diff=(abs(_popcount_low32(st.bitrank) - n), 0),
        table_entries_stray=(stray, 0))


def _direct_tables(st, S: torch.Tensor) -> tuple:
    """The direct filter against the present slots S: the id (with the
    saturation bit, never set in a silver pass) and counter at each, and the
    checks of its presence (each slot of S present, the present count) and
    of entries at other slots."""
    words = st.words[S].to(torch.int64) & _MASK32
    counts = st.counts[S].to(torch.int64) & _MASK32
    stray = (_nonzero(st.words) - int(torch.count_nonzero(words))
             + _nonzero(st.counts) - int(torch.count_nonzero(counts)))
    return words & ~PRESENT_BIT, counts, dict(
        present_bits_missing=(int(((words & PRESENT_BIT) == 0).sum()), 0),
        present_slots_diff=(abs(_present_words(st.words) - S.shape[0]), 0),
        table_entries_stray=(stray, 0))


def _check(eng, host, config, dev, rows0, paths0, digests) -> dict:
    """Every number compared, with its limit (all exact: 0).  The program's
    filter is read at the slots the reference finds present, then freed
    before the reference's pass 2."""
    ref = SilverJob(config["path_config"], dev)
    ref.phred_gate(host)
    say(f"portbench present_slots={ref.present.shape[0]}")
    if eng.compressed:
        prog_ids, prog_counts, checks = _compressed_tables(eng.cstate,
                                                           ref.present)
    else:
        prog_ids, prog_counts, checks = _direct_tables(eng.state,
                                                       ref.present)
    rows = eng.last_rows
    eng.replicas = []
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = ref.run(host)
    jobs_bad = sum(d != (rows0, paths0) for d in digests)
    return dict(
        rows_mismatched=(_rows_bad(rows, out["rows"]), 0),
        path_files_mismatched=(_paths_bad(digests[-1][1],
                                          out["path_digests"]), 0),
        jobs_unlike_first=(jobs_bad, 0),
        **checks,
        ids_mismatched=(int((prog_ids != ref.ids).sum()), 0),
        counts_mismatched=(int((prog_counts != ref.counts).sum()), 0),
        _inserts=ref.inserts)
