"""Observability: reference-parity stderr logging + torch.profiler hooks.

Mirrors the reference's counters and messages (goldrush_path.cpp:126-154
log_path_stat, :308-325 filter breakdown, :914-916 progress ticks) and
replaces its coarse omp_get_wtime phase timing (SURVEY section 5) with
optional torch.profiler traces.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time


def log(msg: str, *, verbose_only: bool = False, verbose: bool = True) -> None:
    if verbose_only and not verbose:
        return
    print(msg, file=sys.stderr, flush=True)


def log_path_stat(curr_path: int, st, inserted_bases: int) -> None:
    """Verbose per-path stats in the reference's exact wording
    (goldrush_path.cpp:126-154)."""
    e = sys.stderr
    print(f"Visited {st.valid_reads} reads to generate {curr_path} "
          f"silver paths", file=e)
    print(f"Saw: {st.total_tiles} tiles to generate {curr_path} "
          f"silver paths", file=e)
    print(f"Assigned: {st.assigned_tiles} tiles to generate {curr_path} "
          f"silver paths", file=e)
    print(f"Unassigned: {st.unassigned_tiles} tiles to generate "
          f"{curr_path} silver paths", file=e)
    print(f"Total queries: {st.queries} to generate {curr_path} "
          f"silver paths", file=e)
    print(f"Total hits: {st.hits} to generate {curr_path} silver paths",
          file=e)
    print(f"Total misses: {st.misses} to generate {curr_path} silver paths",
          file=e)
    print(f"Num reads: {st.reads_in_path} in silver path {curr_path}",
          file=e)
    if inserted_bases > 0 and st.phred_sum_in_path > 0:
        avg_phred = int(-10 * math.log10(st.phred_sum_in_path /
                                         inserted_bases))
        print(f"Average Phred: {avg_phred} in silver path {curr_path}",
              file=e)


def log_filter_breakdown(st) -> None:
    """Pass-1 read filter breakdown (goldrush_path.cpp:308-325)."""
    e = sys.stderr
    skipped = (st.skipped_phred + st.skipped_delta + st.skipped_length
               + st.skipped_invalid)
    print(f"num_passed_reads: {st.num_passed_reads}", file=e)
    print(f"num_reads: {st.num_reads}", file=e)
    print(f"num_reads_skipped_by_phred: {st.skipped_phred}", file=e)
    print(f"num_reads_skipped_by_delta: {st.skipped_delta}", file=e)
    print(f"num_reads_skipped_by_length: {st.skipped_length}", file=e)
    print(f"num_reads_skipped_by_invalid_bases: {st.skipped_invalid}",
          file=e)
    print(f"Total reads skipped: {skipped}", file=e)


def log_engine_header(cfg, seeds, universe, phred_min) -> None:
    """Startup banner (goldrush_path.cpp:1133-1161)."""
    kind = (f"{cfg.max_paths} silver path(s)" if cfg.silver_path
            else "the golden path")
    e = sys.stderr
    print(f"Calculating {kind}", file=e)
    print("Using:", file=e)
    print(f"\ttile length: {cfg.tile_length}", file=e)
    print(f"\tblock size: {cfg.block_size}", file=e)
    print(f"\tseed patterns: {cfg.hash_num}", file=e)
    print(f"\tthreshold: {cfg.threshold}", file=e)
    print(f"\tbase seed pattern: {seeds[0]}", file=e)
    print(f"\tminimum unassigned tiles: {cfg.unassigned_min}", file=e)
    print(f"\tmaximum assigned tiles: {cfg.assigned_max}", file=e)
    print(f"\texpected hash space: {universe}", file=e)
    print(f"\tminimum average phred quality score: {phred_min}", file=e)
    print(f"\toccupancy: {cfg.occupancy}", file=e)
    if cfg.frame_stride != 1:
        print(f"\tframe stride (throughput mode): {cfg.frame_stride}",
              file=e)


def log_tile_states(ids, bools) -> None:
    """--debug per-pass tile-state dump, byte-compatible with the
    reference's log_tile_states (goldrush_path.cpp:109-124): one
    tab-separated line of per-tile ids, one of 0/1 assignment flags."""
    e = sys.stderr
    e.write("".join(f"{int(i)}\t" for i in ids) + "\n")
    e.write("".join(f"{int(b)}\t" for b in bools) + "\n")
    e.flush()


@contextlib.contextmanager
def phase_timer(name: str, verbose: bool = True):
    """omp_get_wtime-style phase timing (goldrush_path.cpp:244,337-338)."""
    t0 = time.time()
    yield
    if verbose:
        print(f"{name} in {time.time() - t0:.4f}", file=sys.stderr,
              flush=True)


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """torch.profiler trace around a phase, written to ``logdir`` as a
    TensorBoard/Chrome trace (device activity included when CUDA is up)."""
    if not logdir:
        yield
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield
