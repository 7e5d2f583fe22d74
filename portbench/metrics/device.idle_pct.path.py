"""The share of the traced jobs' window in which no kernel, copy or set ran
on the card."""

from portbench.metrics_common import idle_pct


def read(out):
    return idle_pct(out)
