"""Whole jobs on the direct filter in input Mbp a second, over the traced
run's unprofiled jobs: path_Mbp_per_s's quantity, which spreads too widely
across runs in this cell to hold a bound end to end (PERF.md, section 2)."""

from portbench.metrics_common import job_rate


def read(out):
    return job_rate(out)
