"""Racon-equivalent consensus polisher (the reference's alternate polish
path: ``minimap2 -a -x map-ont`` + ``racon -u``, bin/goldrush:262-277,
selected with ``polisher=racon``).

Reformulation (goldrush_tpu/stages/racon.py): reads are mapped to the
draft with the minimizer anchor mapper (stages/mapping.py, K20 on the
card); each hit's anchor pairs define a
piecewise-linear projection of read coordinates onto the contig, and every
projected read base votes in a per-position pileup.  The consensus takes
the majority base wherever coverage >= min_cov (draft base otherwise) —
a column-consensus approximation of racon's windowed POA that corrects
substitution-dominated error without a quadratic alignment step.  Anchor
interpolation (rather than one global diagonal) keeps the projection from
drifting across read indels between anchors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io import fastq
from . import mapping

BASES = b"ACGT"


@dataclass
class RaconParams:
    k: int = 15
    w: int = 10
    min_cov: int = 3           # positions with fewer projected votes keep
                               # the draft base (racon -u keeps unpolished
                               # windows too)
    min_margin: int = 2        # majority must beat the runner-up base by
                               # this many votes to override the draft
                               # (low-coverage fringe ties stay unpolished)
    min_anchors: int = 4
    batch: int = 32


def _project_votes(counts: np.ndarray, q_pos: np.ndarray, t_pos: np.ndarray,
                   read: np.ndarray) -> None:
    """Accumulate one hit's base votes into counts[4, contig_len] using
    per-anchor piecewise-linear projection."""
    L = counts.shape[1]
    order = np.argsort(q_pos)
    qp, tp = q_pos[order], t_pos[order]
    # project every read base between consecutive anchors
    for i in range(len(qp) - 1):
        q0, q1 = int(qp[i]), int(qp[i + 1])
        t0, t1 = int(tp[i]), int(tp[i + 1])
        if q1 <= q0:
            continue
        span_q, span_t = q1 - q0, t1 - t0
        if span_t <= 0 or span_q > 4 * abs(span_t):
            continue
        qs = np.arange(q0, q1)
        ts = t0 + ((qs - q0) * span_t) // span_q
        ok = (ts >= 0) & (ts < L) & (qs >= 0) & (qs < len(read))
        b = read[qs[ok]]
        good = b <= 3
        np.add.at(counts, (b[good], ts[ok][good]), 1)


def polish_with_racon(contigs: list[tuple[str, bytes]],
                      reads: list[bytes], p: RaconParams | None = None,
                      device="cuda") -> tuple[list[tuple[str, bytes]], int]:
    """Consensus-polish contigs; returns (polished, n_corrected_bases)."""
    p = p or RaconParams()
    names = [n for n, _ in contigs]
    seqs = [s for _, s in contigs]
    index = mapping.build_index(seqs, names, p.k, p.w, device=device)
    read_mins = mapping._seq_minimizers(reads, p.k, p.w, batch=p.batch,
                                        device=device)
    counts = [np.zeros((4, len(s)), dtype=np.int32) for s in seqs]
    # hit finding batched over all reads at once (one searchsorted join);
    # only the per-read vote projection below stays a host loop
    all_hits = mapping.map_reads(index, reads, min_anchors=p.min_anchors,
                                 mins=read_mins)
    for read, (q_pos, q_hash), hits in zip(reads, read_mins, all_hits):
        if not hits:
            continue
        hit = hits[0]                      # primary alignment only (racon -u
        # uses one alignment per read)
        arr = fastq.encode(read)
        if hit.strand == -1:
            # reverse-complement the read; a minimizer at original position q
            # sits at q' = L - k - q in RC coordinates, where the rev-strand
            # anchor (diag q + t = offset) becomes forward-like
            # (t = q' + offset - L + k)
            rev = arr[::-1]
            arr = np.where(rev <= 3, 3 - rev, rev)
            q_pos = len(read) - p.k - q_pos
        # recompute this hit's anchor pairs: q/t minimizer matches on the
        # hit's diagonal band
        lo = np.searchsorted(index.hashes, q_hash, side="left")
        hi = np.searchsorted(index.hashes, q_hash, side="right")
        cnt = hi - lo
        keep = cnt <= 64
        reps = np.repeat(np.arange(len(q_hash))[keep], cnt[keep])
        if len(reps) == 0:
            continue
        flat = np.concatenate([np.arange(l, h)
                               for l, h in zip(lo[keep], hi[keep])])
        sel = index.tid[flat] == hit.tid
        qp = q_pos[reps[sel]].astype(np.int64)
        tp = index.pos[flat[sel]].astype(np.int64)
        diag = qp - tp
        center = hit.offset if hit.strand == 1 \
            else len(read) - p.k - hit.offset
        band = np.abs(diag - center) <= 1000
        if band.sum() < 2:
            continue
        _project_votes(counts[hit.tid], qp[band], tp[band], arr)
    out = []
    corrected = 0
    for (name, seq), c in zip(contigs, counts):
        draft = fastq.encode(seq)
        cov = c.sum(axis=0)
        maj = c.argmax(axis=0).astype(np.uint8)
        srt = np.sort(c, axis=0)
        margin = srt[-1] - srt[-2]
        use = (cov >= p.min_cov) & (margin >= p.min_margin) & (draft <= 3)
        new = np.where(use, maj, np.where(draft <= 3, draft, 0))
        corrected += int((use & (maj != draft)).sum())
        out.append((name, np.frombuffer(BASES, np.uint8)[new].tobytes()))
    return out, corrected
