"""The replay (path files written on the host) in seconds a Gbp of input:
``wall_replay_s`` over the window's unprofiled jobs."""

from portbench.metrics_common import span_per_gbp


def read(out):
    return span_per_gbp(out, "wall_replay_s")
