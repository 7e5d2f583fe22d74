"""Phred quality math, parity-exact with calc_phred_average.cpp:8-58.

Per read: de-logged mean phred (as error probability) and the absolute
difference between first- and second-half average phred — the reference's
hairpin/chimera heuristic.  Vectorized over byte arrays so the host-side
ingest path can compute it for whole record blocks at once.
"""

from __future__ import annotations

import numpy as np


def phred_stats(qual: np.ndarray, length: int | None = None) -> tuple[int, int]:
    """(avg_phred, delta_phred) for one quality string.

    ``qual``: uint8 array of ASCII quality codes.  Mirrors
    calc_phred_average.cpp:8-43 including its integer truncations:
    avg = (uint32)(-10*log10(mean(10^(-q/10)))),
    delta = |int(-10*log10(first_mean)) - int(-10*log10(second_mean))|.
    """
    if length is None:
        length = qual.shape[0]
    q = qual[:length].astype(np.float64) - 33.0
    delog = np.power(10.0, -q / 10.0)
    total = float(delog.sum())
    # first half = elements [0, len/2) — reference records the running sum at
    # i == len/2 - 1 (calc_phred_average.cpp:26-28)
    half = length // 2
    first = float(delog[:half].sum())
    second = total - first
    first_avg = first / (length * 0.5)
    second_avg = second / (length * 0.5)
    avg = int(np.uint32(int(-10.0 * np.log10(total / length))))
    delta = abs(int(np.int32(int(-10.0 * np.log10(first_avg))))
                - int(np.int32(int(-10.0 * np.log10(second_avg)))))
    return avg, int(np.uint32(delta))


def sum_phred(qual: np.ndarray, length: int | None = None) -> float:
    """Sum of de-logged phred error probabilities (calc_phred_average.cpp:45-58)."""
    if length is None:
        length = qual.shape[0]
    q = qual[:length].astype(np.float64) - 33.0
    return float(np.power(10.0, -q / 10.0).sum())


def phred_stats_block(quals: np.ndarray, lengths: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized (avg, delta, sum) over a padded [R, Lmax] block of quality
    bytes with per-read lengths.  Same truncation semantics as phred_stats."""
    R, Lmax = quals.shape
    idx = np.arange(Lmax)[None, :]
    valid = idx < lengths[:, None]
    q = quals.astype(np.float64) - 33.0
    delog = np.where(valid, np.power(10.0, -q / 10.0), 0.0)
    total = delog.sum(axis=1)
    halves = (lengths // 2)[:, None]
    first = np.where(idx < halves, delog, 0.0).sum(axis=1)
    second = total - first
    lf = lengths.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        avg = np.trunc(-10.0 * np.log10(total / lf)).astype(np.int64)
        d1 = np.trunc(-10.0 * np.log10(first / (lf * 0.5))).astype(np.int64)
        d2 = np.trunc(-10.0 * np.log10(second / (lf * 0.5))).astype(np.int64)
    delta = np.abs(d1 - d2)
    return avg.astype(np.uint32), delta.astype(np.uint32), total


def calc_median_phred(phred_scores: np.ndarray, n: int) -> int:
    """Median used for the auto phred threshold (goldrush_path.cpp:53-59):
    sort DESCENDING, take element [n/2]."""
    vec = np.sort(phred_scores)[::-1]
    return int(vec[n // 2])


MEDIAN_SAMPLES_NEEDED = 50000       # goldrush_path.cpp:38
MINIMUM_PHRED_THRESHOLD = 10        # goldrush_path.cpp:39
