"""Pass 1 (the read stream, kernel A's fill, the freeze) in seconds a Gbp
of input: the engine's ``wall_fill_s`` over the window's unprofiled
jobs."""

from portbench.metrics_common import span_per_gbp


def read(out):
    return span_per_gbp(out, "wall_fill_s")
