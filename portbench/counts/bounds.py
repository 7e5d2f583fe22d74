"""The least time the card could take for a kernel's work: its bytes over
the memory rate, each input byte read once and each output byte written
once.

Frozen from chip_smoke.py at commit 93d720b: the memory rate (:296) and the
consume batch's ``consume_bytes`` (:1161-1196).  It took tensors of one
run there; here it takes the shapes and counts, so that a trace's reader
can price every launch of a window.  The rate is the published one of an
H100 SXM; a card held to a lower power limit reads a lower share, and the
harness prints its limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def consume_bytes(batch_rows: int, probes: int, probe_bytes: float,
                  inserts: list) -> float:
    """A silver pass's consume launches: the batched rows in and out (8
    columns of 8 bytes, and 64 a row of scratch) and 64 a batch; each live
    probe's grid row, frame_ok and one word a present frame and seed
    (``probe_bytes``, the eligible reads' mean); each exact insert's window
    (8 bytes an entry), each distinct key's counter read and written and
    each accepted word written (``inserts``: (entries, distinct,
    accepted) a recruit)."""
    nbytes = batch_rows * (64 + 64) + probes * (probe_bytes + 64)
    for entries, distinct, accepted in inserts:
        nbytes += entries * 8 + distinct * 8 + accepted * 4
    return nbytes
