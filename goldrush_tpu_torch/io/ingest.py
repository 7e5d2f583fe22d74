"""Async read ingest: producer thread + bounded block queue.

Host-side analog of the reference's read-hashing producer pool
(read_hashing.cpp:78-117: a detached thread + 6 async workers feeding an
order-preserving queue ahead of the sequential consumer).  Here the producer
thread runs file IO, gzip inflate, FASTQ parsing, 2-bit encoding and the
phred gate math — via the native C++ reader (io/native/seqio.cpp) when the
toolchain is available, else the pure-Python reader — while the consumer
(presence fill / golden-path consume scan) drives the device.  Order is
preserved: one producer, one FIFO queue (read order is semantically
significant — the golden path is an online algorithm, README.md:199).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from . import fastq
from ..ops.phred import phred_stats_block


class PreppedRead:
    """One ingested record with everything the engine's gates need.

    seq/qual/codes may be views into a shared block buffer; ``seq_bytes`` /
    ``qual_bytes`` materialize copies only when a read is actually recruited
    (recruits are ~1/coverage of the stream)."""

    __slots__ = ("id", "length", "codes", "_seq", "_qual",
                 "phred_avg", "phred_delta", "phred_sum", "invalid")

    def __init__(self, rid, length, codes, seq, qual,
                 phred_avg, phred_delta, phred_sum, invalid):
        self.id = rid
        self.length = length
        self.codes = codes
        self._seq = seq
        self._qual = qual
        self.phred_avg = phred_avg
        self.phred_delta = phred_delta
        self.phred_sum = phred_sum
        self.invalid = invalid

    def seq_bytes(self) -> bytes:
        s = self._seq
        return s if isinstance(s, bytes) else s.tobytes()

    def qual_bytes(self) -> bytes | None:
        q = self._qual
        if q is None:
            return None
        return q if isinstance(q, bytes) else q.tobytes()

    def qual_array(self) -> np.ndarray | None:
        q = self._qual
        if q is None:
            return None
        return np.frombuffer(q, dtype=np.uint8) if isinstance(q, bytes) else q

    def pinned_nbytes(self, seen: set) -> int:
        """Bytes of backing allocations this record newly pins, given the
        id()s of allocations already accounted in ``seen``.

        A record's views keep their WHOLE block buffer alive (including
        bytes of non-eligible reads), so holders (the engine's replay
        cache) must budget by retained allocation bytes, not logical read
        length."""
        total = 0
        for a in (self.codes, self._seq, self._qual):
            if a is None:
                continue
            if isinstance(a, np.ndarray):
                base = a.base if a.base is not None else a
                if id(base) not in seen:
                    seen.add(id(base))
                    total += base.nbytes
            else:                      # bytes: owns exactly its own payload
                if id(a) not in seen:
                    seen.add(id(a))
                    total += len(a)
        return total


def _prep_python_block(block: list[fastq.Record]) -> list[PreppedRead]:
    """Python fallback: vectorized phred stats + per-record encode."""
    has_qual = block[0].qual is not None
    if has_qual:
        lens = np.array([len(r.qual) for r in block], dtype=np.int64)
        mx = max(1, int(lens.max()))
        quals = np.zeros((len(block), mx), dtype=np.uint8)
        for i, r in enumerate(block):
            quals[i, : len(r.qual)] = np.frombuffer(r.qual, dtype=np.uint8)
        avg, delta, total = phred_stats_block(quals, lens)
    out = []
    for i, r in enumerate(block):
        codes = fastq.encode(r.seq)
        out.append(PreppedRead(
            r.id, len(r.seq), codes, r.seq, r.qual,
            int(avg[i]) if has_qual else 0,
            int(delta[i]) if has_qual else 0,
            float(total[i]) if has_qual else 0.0,
            bool((codes > 3).any())))
    return out


def _native_blocks(path: str, block_records: int) -> Iterator[list]:
    from .native_reader import read_native_blocks
    for blk in read_native_blocks(path, max_records=block_records):
        out = []
        for i in range(len(blk)):
            lo, hi = int(blk.offsets[i]), int(blk.offsets[i + 1])
            out.append(PreppedRead(
                blk.names[i], hi - lo, blk.codes[lo:hi], blk.seq[lo:hi],
                blk.quals[lo:hi] if blk.fastq else None,
                int(blk.phred_avg[i]), int(blk.phred_delta[i]),
                float(blk.phred_sum[i]), bool(blk.invalid[i])))
        yield out


def _python_blocks(path: str, block_records: int) -> Iterator[list]:
    for block in fastq.read_blocks(path, block_records):
        yield _prep_python_block(block)


class ReadStream:
    """Iterator of PreppedRead blocks, produced ahead by a daemon thread.

    ``prefetch`` bounds the queue (blocks held in flight); close() (or
    exhaustion) stops the producer.  Falls back to synchronous iteration when
    prefetch == 0 (useful under debuggers/tests)."""

    def __init__(self, path: str, block_records: int = 256,
                 prefetch: int = 4, use_native: bool | None = None):
        if use_native is None:
            from .native_reader import native_available
            use_native = native_available()
        self._src = (_native_blocks if use_native else _python_blocks)(
            path, block_records)
        self.native = use_native
        self._prefetch = prefetch
        self._q: queue.Queue | None = None
        self._stop = threading.Event()
        self._thread = None
        if prefetch > 0:
            self._q = queue.Queue(maxsize=prefetch)
            self._thread = threading.Thread(target=self._produce,
                                            daemon=True)
            self._thread.start()

    def _produce(self):
        try:
            for block in self._src:
                while not self._stop.is_set():
                    try:
                        self._q.put(block, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._relay(None)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            self._relay(e)

    def _relay(self, item):
        """Enqueue the terminal item (sentinel or exception) without ever
        blocking forever: if the consumer stopped iterating with a full
        queue, the timeout-and-check-_stop loop lets the daemon exit."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def __iter__(self):
        if self._q is None:
            yield from self._src
            return
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def records(self) -> Iterator[PreppedRead]:
        for block in self:
            yield from block

    def close(self):
        self._stop.set()
        if self._q is not None:
            try:            # unblock a producer stuck on a full queue
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
