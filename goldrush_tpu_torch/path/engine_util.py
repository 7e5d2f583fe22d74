"""The trim recheck's boundary-zone predicate and its margin signal
(goldrush_tpu/path/engine_util.py:10-46).

The consume loop is host code in this package, so the predicate takes a
read's decision row as Python ints; ``tile_min_count`` is the per-read
reduction the batched and live probes append to their rows.
"""

from __future__ import annotations

import torch

NO_TILE = 1 << 30        # tile_min of a read without in-read tiles


def recheck_zone(dec: int, na: int, n_tiles: int, trim_start: int,
                 trim_end: int, tile_min: int, frame_stride: int,
                 threshold: int, assigned_max: int) -> bool:
    """Whether a sampled-tier verdict re-classifies at full resolution:
    every trim (dec == 2); a partial assignment with an unassigned stretch
    of at least 3 tiles or near the whole-read boundary (na <= assigned_max
    + 2); a full assignment whose weakest tile, in full-vote units
    (tile_min * stride), is within 2x of the assignment gate.  Pinned by
    tests/test_recheck_zone.py."""
    weak = tile_min * frame_stride < 2 * threshold
    stretch = trim_end - trim_start - 1
    partial = 0 < na < n_tiles and (stretch >= 3 or na <= assigned_max + 2)
    return partial or dec == 2 or (na >= n_tiles and weak)


def tile_min_count(top_count: torch.Tensor, n_tiles: torch.Tensor
                   ) -> torch.Tensor:
    """Per-read minimum top vote count over in-read tiles: top_count int32
    [B, T], n_tiles [B] -> int64 [B] (NO_TILE for a read without tiles)."""
    T = top_count.shape[1]
    in_read = (torch.arange(T, device=top_count.device)[None, :]
               < n_tiles[:, None])
    return torch.where(in_read, top_count, NO_TILE).amin(dim=1).long()
