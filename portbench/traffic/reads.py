"""Long reads of a random genome, made from a seed on any device.

The genome, the error model and the quality strings follow goldrush_tpu_
torch/utils/synth.py:1-148 at commit 93d720b (``random_genome``,
``simulate_reads``, ``write_fastq``): uniform bases, per-base errors split
between substitutions, 1-bp insertions and 1-bp deletions, reads on either
strand, qualities ``phred`` + U{-jitter..jitter} clipped to 2..40.  Three
changes: read lengths follow a length law (log-normal, clipped, optionally
cut below a minimum) whose multiset is fixed by the traffic file, so every
seed gets the same sizes in another order; the errors are drawn per base
(each base kept, substituted, deleted or preceded by an inserted base) so
that the whole set is made in a few large tensor calls; and everything is
drawn from one ``torch.Generator`` on the device that asks for it.

A traffic mix (portbench/workloads/<name>.json) holds, beside its config
and driver: genome (bases), reads (count), median, sigma, min_clip,
max_clip, cut_below (0: none), error_rate, phred, phred_jitter.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# bases drawn at once (bounds the transient tensors of a pool)
CHUNK_BASES = 1 << 26


@dataclass
class Reads:
    codes: torch.Tensor       # uint8 [total]: the reads back to back, 0..3
    offsets: torch.Tensor     # int64 [n + 1]: read i is codes[o[i]:o[i+1]]
    quals: torch.Tensor       # uint8 [total]: ASCII phred

    def __len__(self) -> int:
        return self.offsets.shape[0] - 1


def length_law(t: dict) -> np.ndarray:
    """The traffic's read lengths before errors, in a fixed order: the
    log-normal (median, sigma) at the mid-quantiles of its part at or above
    ``cut_below``, clipped to [min_clip, max_clip]."""
    n, mu, sig = t["reads"], math.log(t["median"]), t["sigma"]
    lo = 0.0
    if t.get("cut_below"):
        lo = 0.5 * (1 + math.erf((math.log(t["cut_below"]) - mu)
                                 / (sig * math.sqrt(2))))
    u = lo + (np.arange(n) + 0.5) / n * (1 - lo)
    z = np.sqrt(2) * _erfinv(2 * u - 1)
    L = np.exp(mu + sig * z)
    return np.clip(np.round(L), t["min_clip"], t["max_clip"]).astype(np.int64)


def _erfinv(y: np.ndarray) -> np.ndarray:
    return torch.special.erfinv(torch.from_numpy(y)).numpy()


def make_reads(t: dict, seed: int, device) -> Reads:
    """The traffic's reads for ``seed`` on ``device``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed & ((1 << 63) - 1))
    G = int(t["genome"])
    genome = torch.randint(0, 4, (G,), dtype=torch.uint8, device=dev,
                           generator=g)
    src = torch.from_numpy(length_law(t)).to(dev)
    src = src[torch.randperm(src.shape[0], device=dev, generator=g)]
    n = src.shape[0]
    start = (torch.rand(n, device=dev, generator=g, dtype=torch.float64)
             * (G - src + 1)).long()
    minus = torch.rand(n, device=dev, generator=g) < 0.5
    e = float(t["error_rate"])
    parts, lens = [], []
    i = 0
    while i < n:
        j = i
        acc = 0
        while j < n and (acc == 0 or acc + int(src[j]) <= CHUNK_BASES):
            acc += int(src[j])
            j += 1
        c, ln = _mutate(genome, start[i:j], src[i:j], minus[i:j], e, g)
        parts.append(c)
        lens.append(ln)
        i = j
    codes = torch.cat(parts)
    out_len = torch.cat(lens)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(out_len, 0)
    j = int(t["phred_jitter"])
    quals = (torch.randint(-j, j + 1, (codes.shape[0],), device=dev,
                           generator=g) + int(t["phred"])
             ).clamp_(2, 40).add_(33).to(torch.uint8)
    return Reads(codes=codes, offsets=offsets, quals=quals)


def _mutate(genome, start, src, minus, e, g):
    """One chunk of reads: each source base is kept, substituted (e/3),
    deleted (e/3) or preceded by a random inserted base (e/3); minus-strand
    reads are reverse-complemented.  Returns (codes, lengths)."""
    dev = genome.device
    total = int(src.sum())
    read = torch.repeat_interleave(torch.arange(src.shape[0], device=dev),
                                   src)
    first = torch.cumsum(src, 0) - src
    pos = torch.arange(total, device=dev) - first[read]
    base = genome[start[read] + pos]
    u = torch.rand(total, device=dev, generator=g)
    rnd = torch.randint(0, 4, (total,), dtype=torch.uint8, device=dev,
                        generator=g)
    ins = torch.randint(0, 4, (total,), dtype=torch.uint8, device=dev,
                        generator=g)
    sub = u < e / 3
    dele = (u >= e / 3) & (u < 2 * e / 3)
    insm = (u >= 2 * e / 3) & (u < e)
    base = torch.where(sub, rnd, base)
    emit = 1 - dele.long() + insm.long()
    out_pos = torch.cumsum(emit, 0) - emit          # first output slot
    out_total = int(emit.sum())
    out = torch.empty(out_total, dtype=torch.uint8, device=dev)
    keep = ~dele
    out[out_pos[insm]] = ins[insm]
    out[(out_pos + insm.long())[keep]] = base[keep]
    out_len = torch.bincount(read, weights=emit.double(),
                             minlength=src.shape[0]).round().long()
    # reverse-complement the minus-strand reads in place
    o_first = torch.cumsum(out_len, 0) - out_len
    o_read = torch.repeat_interleave(torch.arange(src.shape[0], device=dev),
                                     out_len)
    o_pos = torch.arange(out_total, device=dev) - o_first[o_read]
    flip = minus[o_read]
    idx = torch.where(flip, o_first[o_read] + out_len[o_read] - 1 - o_pos,
                      torch.arange(out_total, device=dev))
    out = torch.where(flip, 3 - out[idx], out[idx])
    return out, out_len


def host_reads(r: Reads) -> list:
    """The reads on the host as (id, codes uint8 array, qual bytes)."""
    codes = r.codes.cpu().numpy()
    quals = r.quals.cpu().numpy()
    off = r.offsets.cpu().numpy()
    return [(f"r{i}", codes[off[i]: off[i + 1]],
             quals[off[i]: off[i + 1]].tobytes()) for i in range(len(r))]


_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_fastq(path: str, reads: list) -> None:
    """The FASTQ layout of synth.write_fastq."""
    with open(path, "wb") as f:
        for rid, codes, qual in reads:
            f.write(b"@" + rid.encode() + b"\n" + _ACGT[codes].tobytes()
                    + b"\n+\n" + qual + b"\n")
