"""ntCard streaming distinct-k-mer (F0) estimator: the --ntcard path.

The counterpart of goldrush_tpu/utils/ntcard.py, itself the reference's
vendored estimator (goldrush_path/ntcard.hpp:81-154, 248-274): per spaced
seed, hashes are sampled into two banks of 2^rbits counters (bank 0 takes
hashes whose top sbits + 1 bits equal 1, bank 1 those whose top sbits bits
equal 2^(sbits-1) - 1), then F0 and the multiplicity spectrum come from the
counters' histogram by the ntCard deconvolution (Mohamadi et al. 2017):

  F0 = (rbits * ln 2 - ln p[0]) * 2^(sbits + rbits)

The hash universe for the filter's sizing is the sum of the per-seed F0s.

``ntcard_count`` counts a batch of reads into every seed's banks: on the
card one launch of the hand-written kernel (csrc/ntcard.cu, K22), on the
CPU its plain version, ``hash_positions`` with the stale-tail clamp and
``_sample_and_count``.  The counters are integer sums, so neither how the
reads are grouped into batches nor the order of the additions changes
them: reads are packed by bases here, not in the JAX package's blocks of
64 records.  The histogram is a ``torch.bincount`` on the counters'
device; ``_estimate_f0`` runs on the host in float64, as the JAX function
does, so that F0 is the same integer.

Unlike the JAX function, unsampled hashes have no discard slot: the
counters are exactly the two banks the estimate reads (ROADMAP queue 3).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..io import fastq
from ..ops.nthash import SeedFamily, build_seed_family, hash_positions

# positions per work item of the kernel: two warp units (csrc/ntcard.cu
# kNtUnit)
CHUNK = 1024
# the kernel's block tables a half (csrc/ntcard.cu gr_ntcard_count): the
# least of these that holds the family's
KERNEL_BLOCKS = (3, 4, 8)
# the kernel's family limits: seeds a family, positions of the left half
# (the right half's window starts there) and bits of sbits (its bank test
# reads the hash's high word)
KERNEL_MAX_H, KERNEL_MAX_HALF, KERNEL_MAX_SBITS = 8, 32, 31
# bases per launch: a batch closes once its reads hold this many
BATCH_BASES = 1 << 24
# the histogram's bins: counters at or above CMAX - 1 share the last
CMAX = 65536


@dataclass
class NtCardParams:
    rbits: int = 27
    sbits: int = 7           # reference uses 7 for inputs < 50 GB
    cov_max: int = 10000
    batch: int = 64          # records per block read from the input


def _sample_and_count(counters: torch.Tensor, hashes: torch.Tensor,
                      valid: torch.Tensor, rbits: int, sbits: int
                      ) -> torch.Tensor:
    """Plain version of goldrush_tpu/utils/ntcard.py:41, in place: one
    seed's hashes int64 [N] (uint64 bits) with their mask bool [N] into
    its counters int32 [2 * 2^rbits] (uint32 bits).  A sampled valid hash
    adds one at bank * 2^rbits + (h & (2^rbits - 1)); the others, which the
    JAX function sends to a discard slot, are skipped.  Returns
    ``counters``."""
    idx = bank_index(hashes, rbits, sbits)
    idx = idx[(idx < 2 << rbits) & valid]
    counters.index_add_(0, idx, torch.ones(idx.shape, dtype=counters.dtype,
                                           device=counters.device))
    return counters


def bank_index(hashes: torch.Tensor, rbits: int, sbits: int
               ) -> torch.Tensor:
    """Each hash's counter, bank * 2^rbits + (h & (2^rbits - 1)), or
    2 * 2^rbits (past both banks) for an unsampled one."""
    rbuck = 1 << rbits
    smask = (1 << (sbits - 1)) - 1
    # logical shifts of the uint64 bits: the arithmetic shift, masked
    top_s1 = (hashes >> (63 - sbits)) & ((1 << (sbits + 1)) - 1)
    top_s = (hashes >> (64 - sbits)) & ((1 << sbits) - 1)
    bank = torch.where(top_s1 == 1, 0, torch.where(top_s == smask, 1, 2))
    return torch.where(bank < 2, bank * rbuck + (hashes & (rbuck - 1)),
                       2 * rbuck)


class NtBatch(NamedTuple):
    """A batch of whole reads on one device (``pack_batch``)."""
    codes: torch.Tensor      # uint8 [N]: the reads' codes end to end
    offsets: torch.Tensor    # int64 [B + 1]: read b at codes[o[b]:o[b + 1]]
    item_read: torch.Tensor  # int32 [items]: the kernel's work list,
    item_p0: torch.Tensor    # int64 [items]  one (read, first position) per
                             # chunk of CHUNK of its len - k + 1 positions


def pack_batch(codes: np.ndarray, offsets: np.ndarray, k: int,
               device) -> NtBatch:
    """``codes`` (A=0 C=1 G=2 T=3; the caller maps other bases to A, as
    goldrush_tpu/utils/ntcard.py:97 does) and ``offsets`` with the work
    list of seeds of span >= k, on ``device`` (on the card through pinned
    memory, without waiting for the stream)."""
    frames = np.maximum(np.diff(offsets) - k + 1, 0)
    chunks = -(-frames // CHUNK)
    read = np.repeat(np.arange(len(frames), dtype=np.int32), chunks)
    first = np.cumsum(chunks) - chunks
    p0 = (np.arange(len(read), dtype=np.int64) - first[read]) * CHUNK
    dev = torch.device(device)

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cpu":
            return t
        return t.pin_memory().to(dev, non_blocking=True)
    return NtBatch(put(codes), put(offsets.astype(np.int64)), put(read),
                   put(p0))


def ntcard_count(counters: torch.Tensor, batch: NtBatch, fam: SeedFamily,
                 rbits: int, sbits: int) -> torch.Tensor:
    """Count a batch of reads into every seed's banks, in place (K22).

    counters: int32 [h, 2 * 2^rbits] (uint32 bits), seed s's banks in row
    s; batch: ``pack_batch``'s.  Every position p < len - k + 1 of a read
    counts for every seed, at the seed's own position min(p, max(len -
    span_s, 0)) (goldrush_tpu/utils/ntcard.py:104-116).  Returns
    ``counters``."""
    if counters.is_cuda or batch.codes.is_cuda:
        return _ntcard_count_cuda(counters, batch, fam, rbits, sbits)
    return _ntcard_count_plain(counters, batch.codes, batch.offsets, fam,
                               rbits, sbits)


def _ntcard_count_cuda(counters, batch, fam, rbits, sbits):
    dev = counters.device
    codes, offsets, read, p0 = batch
    n = read.shape[0]
    kernels.check(counters, "counters", torch.int32,
                  (fam.h, 2 << rbits), dev)
    kernels.check(codes, "codes", torch.uint8, device=dev)
    kernels.check(offsets, "offsets", torch.int64, device=dev)
    kernels.check(read, "item_read", torch.int32, (n,), dev)
    kernels.check(p0, "item_p0", torch.int64, (n,), dev)
    table, nb = _block_args(fam, sbits, dev)
    kernels.NTCARD_COUNT(dev, kernels.ptr(codes), codes.numel(),
                         kernels.ptr(offsets),
                         kernels.ptr(read), kernels.ptr(p0), n,
                         kernels.ptr(table), nb, fam.h, fam.k, fam.half,
                         rbits, sbits, kernels.ptr(counters))
    return counters


def kernel_blocks(fam: SeedFamily, sbits: int) -> int:
    """The kernel's block tables a half for ``fam``; ValueError for a
    family or an sbits that the kernel does not take (the plain version
    takes any): seed s must span k + s, h <= 8, the left half <= 32
    positions, the right half's last care offset < 32 (so k <= 64) and
    sbits <= 31."""
    if any(sp != fam.k + s for s, sp in enumerate(fam.spans)):
        raise ValueError("seed s of the family must span k + s")
    if fam.h > KERNEL_MAX_H or fam.half > KERNEL_MAX_HALF:
        raise ValueError(f"ntcard_count takes h <= {KERNEL_MAX_H} and a "
                         f"left half of <= {KERNEL_MAX_HALF} positions, not "
                         f"h={fam.h}, half={fam.half}")
    if not 1 <= sbits <= KERNEL_MAX_SBITS:
        raise ValueError(f"ntcard_count takes sbits in [1, "
                         f"{KERNEL_MAX_SBITS}], not {sbits}")
    need = max(fam.block_counts())
    for nb in KERNEL_BLOCKS:
        if need <= nb:
            return nb
    raise ValueError(f"ntcard_count takes halves of <= {max(KERNEL_BLOCKS)} "
                     f"blocks of 4 positions, not {fam.block_counts()}")


# the kernel's block tables of each seed family, on each device it was used
# on
_BLOCK_TABLES: dict = {}


def _block_args(fam: SeedFamily, sbits: int, device) -> tuple:
    """(the family's ``block_table`` on ``device``, copied there once per
    family and device, and its blocks a half)."""
    nb = kernel_blocks(fam, sbits)
    table = _BLOCK_TABLES.get((fam, device))
    if table is None:
        table = torch.from_numpy(fam.block_table(nb).view(np.int64)).to(
            device)
        _BLOCK_TABLES[(fam, device)] = table
    return table, nb


def _ntcard_count_plain(counters, codes, offsets, fam, rbits, sbits):
    """The JAX loop body (goldrush_tpu/utils/ntcard.py:95-116) on the
    batch as one zero-padded block."""
    for s, (hs, valid) in enumerate(seed_hashes(codes, offsets, fam)):
        _sample_and_count(counters[s], hs, valid, rbits, sbits)
    return counters


def seed_hashes(codes: torch.Tensor, offsets: torch.Tensor,
                fam: SeedFamily):
    """Each seed's hashes of a batch as the JAX loop counts them: per seed
    (int64 [B * P] hashes at min(p, own frames - 1), bool [B * P] p < len
    - k + 1), the batch as one block of width L >= span + 1, P = L - k +
    1."""
    dev = codes.device
    lens = offsets[1:] - offsets[:-1]
    B = lens.shape[0]
    if B == 0:
        return
    L = max(int(lens.max()), fam.spans[-1] + 1)
    row = torch.repeat_interleave(torch.arange(B, device=dev), lens)
    col = torch.arange(codes.shape[0], device=dev) - offsets[row]
    block = torch.zeros((B, L), dtype=torch.uint8, device=dev)
    block[row, col] = codes
    P = L - fam.k + 1
    hashes = hash_positions(block, fam, P)                  # [B, h, P]
    pos = torch.arange(P, device=dev)[None, :]
    n_frames = torch.clamp(lens - fam.k + 1, min=0)
    valid = (pos < n_frames[:, None]).reshape(-1)
    for s in range(fam.h):
        own = torch.clamp(lens - fam.spans[s] + 1, min=1)
        idx = torch.minimum(pos, own[:, None] - 1)
        yield torch.gather(hashes[:, s], 1, idx).reshape(-1), valid


def _histogram(counter: torch.Tensor, rbits: int) -> np.ndarray:
    """float64 [2, CMAX]: the count of each value min(counter, CMAX - 1) in
    either bank (goldrush_tpu/utils/ntcard.py:60-65).  ``counter``: one
    seed's two banks, an int32 tensor of uint32 bits, bincounted on its
    device."""
    rbuck = 1 << rbits
    p = np.zeros((2, CMAX), dtype=np.float64)
    for i in range(2):
        bank = counter[i * rbuck:(i + 1) * rbuck]
        # int32 bits of uint32 values: the negative ones are >= 2^31
        vals = torch.where(bank < 0, CMAX - 1,
                           torch.clamp(bank, max=CMAX - 1))
        p[i] = torch.bincount(vals, minlength=CMAX).cpu().numpy()
    return p


def _estimate_f0(counter: torch.Tensor, rbits: int, sbits: int,
                 cov_max: int) -> tuple[float, np.ndarray]:
    """compEst (ntcard.hpp:114-154): counter histogram -> F0 + spectrum.
    goldrush_tpu/utils/ntcard.py:56-79, its float64 operations in the same
    order, so that F0 is the same integer."""
    cmax = CMAX
    p_mean = _histogram(counter, rbits).mean(axis=0)
    if p_mean[0] <= 0:
        p_mean[0] = 1.0
    f0 = float(int((rbits * math.log(2) - math.log(p_mean[0]))
                   * (1 << (sbits + rbits))))
    f = np.zeros(cmax)
    denom = p_mean[0] * (math.log(p_mean[0]) - rbits * math.log(2))
    if denom != 0:
        f[1] = -1.0 * p_mean[1] / denom
        for i in range(2, min(cov_max + 2, cmax)):
            s = float(np.dot(np.arange(1, i), p_mean[i - 1:0:-1] * f[1:i]))
            f[i] = -1.0 * p_mean[i] / denom - s / (i * p_mean[0])
    spectrum = np.abs((f * f0).astype(np.int64))
    return f0, spectrum


def read_batches(input_path: str, block_records: int = 64):
    """The input's reads, every record (no length or quality gate), as
    batches of whole reads holding about BATCH_BASES bases: (codes uint8
    [N] with every base other than ACGT mapped to A, offsets int64
    [B + 1])."""
    seqs, n = [], 0

    def batch():
        lens = np.fromiter((len(s) for s in seqs), dtype=np.int64,
                           count=len(seqs))
        codes = fastq.encode(b"".join(seqs))
        codes = np.where(codes > 3, 0, codes).astype(np.uint8)
        return codes, np.concatenate([[0], np.cumsum(lens)])
    for block in fastq.read_blocks(input_path, block_records=block_records):
        for r in block:
            seqs.append(r.seq)
            n += len(r.seq)
            if n >= BATCH_BASES:
                yield batch()
                seqs, n = [], 0
    if seqs:
        yield batch()


def estimate_genome_size(input_path: str, seeds: list[str],
                         p: NtCardParams | None = None,
                         device="cuda", times: dict | None = None) -> int:
    """calc_ntcard_genome_size equivalent: the sum of the per-seed F0
    estimates over every record of ``input_path``, counted on ``device``
    (goldrush_tpu/utils/ntcard.py:82-121).  ``times``, where given,
    receives the pass's split: ``read_s``, the host's read stream and
    packing (``pack_batch`` with its uploads); ``batches``; ``count_ms``,
    the counts' device time on the card (CUDA events around each launch);
    and ``f0_s``, the histograms and the estimate."""
    from ..path.engine import resolve_device
    p = p or NtCardParams()
    dev = resolve_device(device)
    fam = build_seed_family(seeds)
    counters = torch.zeros((fam.h, 2 << p.rbits), dtype=torch.int32,
                           device=dev)
    events, read_s, n = [], 0.0, 0
    t0 = time.perf_counter()
    for codes, offsets in read_batches(input_path, p.batch):
        batch = pack_batch(codes, offsets, fam.k, dev)
        read_s += time.perf_counter() - t0
        n += 1
        if times is not None and dev.type == "cuda":
            events.append([torch.cuda.Event(enable_timing=True)
                           for _ in range(2)])
            events[-1][0].record()
        ntcard_count(counters, batch, fam, p.rbits, p.sbits)
        if events:
            events[-1][1].record()
        t0 = time.perf_counter()
    t0 = time.perf_counter()
    total = 0
    for s in range(fam.h):
        f0, _ = _estimate_f0(counters[s], p.rbits, p.sbits, p.cov_max)
        total += int(f0)
    if times is not None:
        times.update(read_s=read_s, batches=n,
                     count_ms=sum(a.elapsed_time(b) for a, b in events),
                     f0_s=time.perf_counter() - t0)
    return total
