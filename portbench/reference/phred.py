"""Phred quality math of goldrush-path, in NumPy.

Frozen copy of goldrush_tpu/ops/phred.py:1-78 at commit 93d720b (its own
provenance follows), with no import of that package: the parts the
reference uses (``phred_stats``, ``calc_median_phred`` and the constants).


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


def calc_median_phred(phred_scores: np.ndarray, n: int) -> int:
    """Median used for the auto phred threshold (goldrush_path.cpp:53-59):
    sort DESCENDING, take element [n/2]."""
    vec = np.sort(phred_scores)[::-1]
    return int(vec[n // 2])


MEDIAN_SAMPLES_NEEDED = 50000       # goldrush_path.cpp:38
MINIMUM_PHRED_THRESHOLD = 10        # goldrush_path.cpp:39
