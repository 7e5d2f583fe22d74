"""High-throughput block reader backed by the native seqio library.

Yields per-block numpy arrays (codes, offsets, phred stats, names) so the
engine's host-side gating and padding work on whole blocks without
per-record Python cost.  Mirrors the producer role of read_hashing.cpp.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .native.build import available, get_lib


@dataclass
class NativeBlock:
    names: list[str]
    seq: np.ndarray          # uint8 raw bases, concatenated
    codes: np.ndarray        # uint8 2-bit codes (255 = invalid)
    quals: np.ndarray        # uint8 raw quality bytes
    offsets: np.ndarray      # int64 [n+1]
    phred_avg: np.ndarray    # int32 [n]
    phred_delta: np.ndarray  # int32 [n]
    phred_sum: np.ndarray    # float64 [n]
    invalid: np.ndarray      # uint8 [n]
    fastq: bool

    def __len__(self):
        return len(self.names)

    def length(self, i: int) -> int:
        return int(self.offsets[i + 1] - self.offsets[i])

    def view(self, arr: np.ndarray, i: int) -> np.ndarray:
        return arr[self.offsets[i]: self.offsets[i + 1]]


def native_available() -> bool:
    return available()


def read_native_blocks(path: str, max_records: int = 512,
                       seq_cap: int = 64 << 20):
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native seqio unavailable")
    h = lib.seqio_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    import ctypes
    try:
        while True:
            seq = np.empty(seq_cap, dtype=np.uint8)
            codes = np.empty(seq_cap, dtype=np.uint8)
            quals = np.empty(seq_cap, dtype=np.uint8)
            offsets = np.zeros(max_records + 1, dtype=np.int64)
            names = np.zeros(max_records * 256, dtype=np.uint8)
            pa = np.zeros(max_records, dtype=np.int32)
            pd = np.zeros(max_records, dtype=np.int32)
            ps = np.zeros(max_records, dtype=np.float64)
            inv = np.zeros(max_records, dtype=np.uint8)
            fmt = np.zeros(1, dtype=np.int32)
            n = lib.seqio_read_block(
                ctypes.c_void_p(h), max_records,
                seq.ctypes.data_as(ctypes.c_void_p),
                codes.ctypes.data_as(ctypes.c_void_p),
                quals.ctypes.data_as(ctypes.c_void_p),
                seq_cap,
                offsets.ctypes.data_as(ctypes.c_void_p),
                names.ctypes.data_as(ctypes.c_void_p),
                names.size,
                pa.ctypes.data_as(ctypes.c_void_p),
                pd.ctypes.data_as(ctypes.c_void_p),
                ps.ctypes.data_as(ctypes.c_void_p),
                inv.ctypes.data_as(ctypes.c_void_p),
                fmt.ctypes.data_as(ctypes.c_void_p))
            if n == 0:
                break
            if n < 0:
                raise RuntimeError(f"seqio_read_block error {n} on {path}")
            name_list = bytes(names.tobytes()).split(b"\0")[:n]
            # trim the 3 seq_cap-sized buffers to the bytes actually used
            # (unconditionally: a block closing at e.g. 60 of 64 MB would
            # otherwise still pin the full 3 x 64 MB allocation for the
            # lifetime of any single downstream record view, and the
            # engine's replay-cache byte accounting assumes retained ==
            # used; the copy costs at most one memcpy of the data itself)
            used = int(offsets[n])
            if used < seq_cap:
                seq = seq[:used].copy()
                codes = codes[:used].copy()
                quals = quals[:used].copy()
            yield NativeBlock(
                names=[s.decode() for s in name_list],
                seq=seq, codes=codes, quals=quals,
                offsets=offsets[: n + 1],
                phred_avg=pa[:n], phred_delta=pd[:n], phred_sum=ps[:n],
                invalid=inv[:n], fastq=(int(fmt[0]) == 1))
    finally:
        lib.seqio_close(ctypes.c_void_p(h))
