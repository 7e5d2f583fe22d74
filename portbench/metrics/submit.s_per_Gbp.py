"""The assign's submit loop (the read stream, packing, uploads, launches,
the pass's one fetch) in seconds a Gbp of input: ``wall_submit_s`` over
the window's unprofiled jobs."""

from portbench.metrics_common import span_per_gbp


def read(out):
    return span_per_gbp(out, "wall_submit_s")
