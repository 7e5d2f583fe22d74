"""Tigmint-long equivalent: cut contigs at positions not spanned by enough
read molecules.

The reference shells out to ``tigmint-make tigmint-long draft=.. reads=..
cut=250 span=2 dist=500`` (bin/goldrush:286-287, defaults :83-86): long reads
are treated as pseudo-linked molecules, a contig position is trusted only if
>= span molecules span it, and contigs are cut at untrusted stretches.

Reformulation (goldrush_tpu/stages/tigmint.py): reads map by minimizer
anchors computed on the card (K20);
each (read, contig) anchor chain becomes molecule intervals, split where the
contig-coordinate gap between consecutive anchors exceeds ``dist``; per-base
spanning depth is an interval scatter-add + cumsum; cut points are the
midpoints of under-spanned stretches.  ``cut`` trims molecule ends (the
reference chops reads into cut-bp segments and untrusted end segments play
the same role).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import mapping


@dataclass
class TigmintParams:
    span: int = 2
    dist: int = 500
    cut: int = 250
    # anchor density must keep the expected anchor gap well under `dist` at
    # ONT error rates, or every molecule shreds and clean contigs overcut:
    # P(20-mer clean | 5% read err, 1% draft err) ~ 0.29, so anchors land
    # every ~w/0.29 ~ 55 bp << dist (validated in tools/downstream_validate)
    k: int = 20
    w: int = 16
    min_anchors: int = 4
    min_piece: int = 1000


def molecule_intervals(hits: list[mapping.Hit], dist: int = 500, k: int = 32
                       ) -> list[tuple[int, int, int]]:
    """(tid, start, end) molecule intervals from a read's hits.

    The reference's tigmint-long chops each read into cut-bp segments and
    merges mapped segments closer than ``dist`` into molecules; here each
    hit's anchor chain is split wherever the contig-coordinate gap between
    consecutive anchors exceeds ``dist`` — the same "evidence continuity"
    contract (an unanchored stretch > dist ends the molecule)."""
    out = []
    for h in hits:
        if h.t_anchors is None or len(h.t_anchors) == 0:
            out.append((h.tid, h.t_start, h.t_end))
            continue
        tps = h.t_anchors
        breaks = np.nonzero(np.diff(tps) > dist)[0]
        seg_start = 0
        for b in list(breaks) + [len(tps) - 1]:
            out.append((h.tid, int(tps[seg_start]), int(tps[b]) + k))
            seg_start = b + 1
    return out


def run_tigmint(contigs: list[tuple[str, bytes]], reads, p: TigmintParams,
                device="cuda") -> list[tuple[str, bytes]]:
    """Cut `contigs` using `reads` (iterable of (id, seq, qual) or Records).

    Returns the corrected contig list (pieces named <name>-1, <name>-2, ...
    when cut, preserving reference tigmint's output style)."""
    names = [n for n, _ in contigs]
    seqs = [s for _, s in contigs]
    idx = mapping.build_index(seqs, names, k=p.k, w=p.w, device=device)
    depth = [np.zeros(len(s) + 1, dtype=np.int32) for s in seqs]

    read_seqs = []
    for r in reads:
        seq = r[1] if isinstance(r, tuple) else r.seq
        read_seqs.append(seq)
    all_hits = mapping.map_reads(idx, read_seqs, min_anchors=p.min_anchors,
                                 diag_bin=p.dist, keep_anchors=True,
                                 device=device)
    for hits in all_hits:
        for tid, ts, te in molecule_intervals(hits, dist=p.dist, k=p.k):
            # molecule ends are untrusted: shrink by `cut`
            a, b = ts + p.cut, te - p.cut
            if b > a:
                depth[tid][a] += 1
                depth[tid][b] -= 1

    out: list[tuple[str, bytes]] = []
    for name, seq, d in zip(names, seqs, depth):
        cov = np.cumsum(d[:-1])
        well = np.nonzero(cov >= p.span)[0]
        if len(well) == 0:
            # no spanning evidence at all: keep the contig whole (nothing to
            # localize a cut with)
            out.append((name, seq))
            continue
        # contig ends can never be spanned (molecule ends are trimmed by
        # `cut`); a cut signal must be an under-spanned run strictly interior
        # to the covered span
        first_cov, last_cov = int(well[0]), int(well[-1])
        bad = cov < p.span
        bad[: first_cov + 1] = False
        bad[last_cov:] = False
        if not bad.any():
            out.append((name, seq))
            continue
        diff = np.diff(bad.astype(np.int8))
        starts = list(np.nonzero(diff == 1)[0] + 1)
        ends = list(np.nonzero(diff == -1)[0] + 1)
        cutpoints = [(a + b) // 2 for a, b in zip(starts, ends)]
        pieces = []
        prev = 0
        for c in cutpoints + [len(seq)]:
            if c - prev >= p.min_piece:
                pieces.append(seq[prev:c])
            prev = c
        if len(pieces) <= 1 and pieces:
            out.append((name, pieces[0]))
        else:
            for i, piece in enumerate(pieces, 1):
                out.append((f"{name}-{i}", piece))
    return out
