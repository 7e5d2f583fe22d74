"""FASTQ/FASTA ingest and path-file output.

Python reader mirroring the role of btllib SeqReader LONG_MODE block reading
(read_hashing.cpp:78-117); a C++ block reader (io/native) can be swapped in
for host-side throughput.  Records carry raw bytes; IDs are the first
whitespace token of the header, as btllib does.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class Record:
    id: str
    seq: bytes
    qual: bytes | None    # None for FASTA

    def __len__(self) -> int:
        return len(self.seq)


def _open(path: str):
    if path.endswith(".gz"):
        return io.BufferedReader(gzip.open(path, "rb"), 1 << 20)
    return open(path, "rb", buffering=1 << 20)


def detect_format(path: str) -> str:
    with _open(path) as f:
        first = f.read(1)
    if first == b"@":
        return "fastq"
    if first == b">":
        return "fasta"
    raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def read_records(path: str) -> Iterator[Record]:
    fmt = detect_format(path)
    with _open(path) as f:
        if fmt == "fastq":
            while True:
                header = f.readline()
                if not header:
                    return
                seq = f.readline().rstrip(b"\n")
                f.readline()                       # '+'
                qual = f.readline().rstrip(b"\n")
                rid = header[1:].split()[0].decode() if len(header) > 1 else ""
                yield Record(id=rid, seq=seq, qual=qual)
        else:
            rid, chunks = None, []
            for line in f:
                if line.startswith(b">"):
                    if rid is not None:
                        yield Record(id=rid, seq=b"".join(chunks), qual=None)
                    rid = line[1:].split()[0].decode() if len(line) > 1 else ""
                    chunks = []
                else:
                    chunks.append(line.rstrip(b"\n"))
            if rid is not None:
                yield Record(id=rid, seq=b"".join(chunks), qual=None)


def read_blocks(path: str, block_records: int = 256) -> Iterator[list[Record]]:
    block: list[Record] = []
    for rec in read_records(path):
        block.append(rec)
        if len(block) >= block_records:
            yield block
            block = []
    if block:
        yield block


class PathWriter:
    """Output writer for silver (.fq, with quality) / golden (.fa) paths,
    mirroring the write format of process_read (goldrush_path.cpp:996-1002,
    1064-1070)."""

    def __init__(self, path: str, fastq: bool):
        self.path = path
        self.fastq = fastq
        self._f = open(path, "wb")

    def write(self, rec_id: str, suffix: str, seq: bytes,
              qual: bytes | None) -> None:
        head = b"@" if self.fastq else b">"
        self._f.write(head + rec_id.encode() + suffix.encode() + b"\n")
        self._f.write(seq + b"\n")
        if self.fastq:
            self._f.write(b"+\n" + (qual or b"") + b"\n")

    def close(self) -> None:
        self._f.close()


_ENCODE = np.full(256, 255, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _ENCODE[b] = i
for i, b in enumerate(b"acgt"):
    _ENCODE[b] = i


def encode(seq: bytes) -> np.ndarray:
    return _ENCODE[np.frombuffer(seq, dtype=np.uint8)]


def write_fasta(path: str, entries: list[tuple[str, bytes]],
                width: int = 0) -> None:
    with open(path, "wb") as f:
        for name, seq in entries:
            f.write(b">" + name.encode() + b"\n")
            if width:
                for i in range(0, len(seq), width):
                    f.write(seq[i:i + width] + b"\n")
            else:
                f.write(seq + b"\n")
