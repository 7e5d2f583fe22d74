"""The consume launches' share of their roofline: the least time a job's
batches, live re-probes and inserts could take (counts/bounds.py
``consume_bytes``) over ``gr::consume_kernel``'s device time in the
profiled jobs."""

from portbench.metrics_common import roofline


def read(out):
    return roofline(out, "consume_bound_s", ("consume_kernel",))
