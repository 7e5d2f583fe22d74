"""Per-tile id votes and the per-read decision, from the ids a read's
frames see.

The vote of goldrush_tpu/mibf/mibf_np.py:64-108 at commit 93d720b
(``frame_query``, ``tile_votes``, ``counters_for_tile``), batched with torch
ops over many reads, and the candidate list that goldrush_tpu/path/
oracle_engine.py:102-123 builds from it, cut to the top ``vote_topk`` as
the device's vote keeps it (candidates past it are counted as overflow).
The decision is ``classify.classify_read``, one read at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from . import classify as clf

ID_MASK = (1 << 30) - 1
DECISION = {"drop": 0, "whole": 1, "trimmed": 2}


def read_rows(ids: torch.Tensor, present: torch.Tensor, valid: torch.Tensor,
              n_tiles: list, frames_per_read: int, tile_length: int,
              gates: dict) -> list:
    """The decision row of each read of a batch.

    ids int64 [B * frames_per_read, h]: the id each frame's seeds read (0
    where none); present bool [same rows]: every seed of the frame hit a
    present slot (the atRank gate); valid bool: the frame exists.  Frame i
    of a read lies in tile i // tile_length.  ``gates`` holds threshold,
    unassigned_min, assigned_max, vote_min and vote_topk.  Returns, per
    read, [decision, trim_start, trim_end, num_assigned, queries, hits,
    misses, overflow] (the engine's row), trim_start and trim_end -1 unless
    the read is trimmed."""
    B = len(n_tiles)
    F = frames_per_read
    h = ids.shape[1]
    ok = present & valid
    idv = torch.where(ok[:, None], ids & ID_MASK, 0)
    read_of = torch.arange(B * F, device=ids.device) // F
    queries = torch.bincount(read_of[valid], minlength=B)
    hits = torch.bincount(read_of, weights=(idv != 0).sum(1).double(),
                          minlength=B)
    misses = torch.bincount(read_of[ok], minlength=B) * h - hits
    # a frame's unique ids (frame_query's set)
    cols = [idv[:, 0]]
    for s in range(1, h):
        dup = torch.zeros_like(ok)
        for c in cols:
            dup |= idv[:, s] == c
        cols.append(torch.where(dup, 0, idv[:, s]))
    u = torch.stack(cols, 1)
    group = (torch.arange(B * F, device=ids.device) // tile_length)
    key = (group[:, None] << 31) | u
    key = key[u != 0]
    uk, cnt = torch.unique(key, return_counts=True)
    g, vid = uk >> 31, uk & ((1 << 31) - 1)
    # each tile's ids by count desc, then id asc (a count is at most a
    # tile's frames, below 2^11)
    order = torch.argsort((g << 42) | ((2047 - cnt) << 31) | vid)
    g, vid, cnt = g[order], vid[order], cnt[order]
    T = F // tile_length
    K, vmin = gates["vote_topk"], gates["vote_min"]
    # each tile's best id (0 where no votes)
    first = torch.ones_like(g, dtype=torch.bool)
    first[1:] = g[1:] != g[:-1]
    best = torch.zeros(B * T, dtype=torch.int64, device=ids.device)
    best[g[first]] = vid[first]
    # its candidates, count > vote_min, in that order: the first K kept,
    # the rest counted as overflow
    c = cnt > vmin
    gc, vc, cc = g[c], vid[c], cnt[c]
    idx = torch.arange(gc.shape[0], device=ids.device)
    start = torch.ones_like(gc, dtype=torch.bool)
    start[1:] = gc[1:] != gc[:-1]
    rank = idx - torch.cummax(torch.where(start, idx, 0), 0).values \
        if gc.numel() else idx
    over = torch.bincount(gc[rank >= K] // T, minlength=B).tolist()
    keep = rank < K
    gk = gc[keep]
    vk, ck = vc[keep].tolist(), cc[keep].tolist()
    bounds = torch.searchsorted(
        gk, torch.arange(B * T + 1, device=ids.device)).tolist()
    best = best.tolist()
    q, hi, mi = (x.cpu().numpy().astype(np.int64) for x in
                 (queries, hits.round().long(), misses.round().long()))
    rows = []
    for r in range(B):
        n = n_tiles[r]
        b0 = r * T
        all_id = [list(zip(vk[bounds[b0 + t]: bounds[b0 + t + 1]],
                           ck[bounds[b0 + t]: bounds[b0 + t + 1]]))
                  for t in range(n)]
        id_vec = best[b0: b0 + n]
        res = clf.classify_read(all_id, id_vec, [0] * n, gates["threshold"],
                                gates["unassigned_min"], gates["assigned_max"])
        ts, te = res.get("trim", (-1, -1))
        rows.append([DECISION[res["decision"]], ts, te, res["num_assigned"],
                     int(q[r]), int(hi[r]), int(mi[r]), over[r]])
    return rows
