"""The trim recheck's boundary-zone predicate and its margin signal (K18,
goldrush_tpu/path/engine_util.py:10-46).

The consume scan (path/consume.py) evaluates the predicate read by read:
on the card inside the consume kernel (``recheck_zone`` in
csrc/consume.cu), on the CPU through ``recheck_zone`` below, the plain
version, which takes a read's decision row as Python ints.
``zone_batch`` launches the kernel's predicate alone over many rows, so
that it can be held against the plain one.  ``tile_min_count`` is the
per-read reduction the batched probe appends to its rows.
"""

from __future__ import annotations

import torch

from .. import kernels

NO_TILE = 1 << 30        # tile_min of a read without in-read tiles


def _wrap32(v: int) -> int:
    """v as an int32 wraps it."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def recheck_zone(dec: int, na: int, n_tiles: int, trim_start: int,
                 trim_end: int, tile_min: int, frame_stride: int,
                 threshold: int, assigned_max: int) -> bool:
    """Whether a sampled-tier verdict re-classifies at full resolution:
    every trim (dec == 2); a partial assignment with an unassigned stretch
    of at least 3 tiles or near the whole-read boundary (na <= assigned_max
    + 2); a full assignment whose weakest tile, in full-vote units
    (tile_min * stride, wrapped to int32 as the JAX package's int32
    product is: a read without tiles, tile_min NO_TILE, is weak at the
    strides where it wraps below the gate), is within 2x of the assignment
    gate.  Pinned by tests/test_recheck_zone.py.  Elementwise: Python
    ints give a bool, the wavefront's [B] tensors a bool tensor."""
    weak = _wrap32(tile_min * frame_stride) < 2 * threshold
    stretch = trim_end - trim_start - 1
    partial = (na > 0) & (na < n_tiles) & ((stretch >= 3)
                                           | (na <= assigned_max + 2))
    return partial | (dec == 2) | ((na >= n_tiles) & weak)


def zone_batch(rows: torch.Tensor, frame_stride: int, threshold: int,
               assigned_max: int) -> torch.Tensor:
    """The predicate over rows int64 [n, 6] = (dec, na, n_tiles,
    trim_start, trim_end, tile_min) -> bool [n]: on the card the consume
    kernel's device predicate launched alone, on the CPU ``recheck_zone``
    row by row."""
    if not rows.is_cuda:
        return torch.tensor([recheck_zone(*r, frame_stride, threshold,
                                          assigned_max)
                             for r in rows.tolist()], dtype=torch.bool)
    n = rows.shape[0]
    kernels.check(rows, "rows", torch.int64, (n, 6))
    out = torch.empty(n, dtype=torch.bool, device=rows.device)
    kernels.RECHECK_ZONE(rows.device, kernels.ptr(rows), n, frame_stride,
                         threshold, assigned_max, kernels.ptr(out))
    return out


def tile_min_count(top_count: torch.Tensor, n_tiles: torch.Tensor
                   ) -> torch.Tensor:
    """Per-read minimum top vote count over in-read tiles: top_count int32
    [B, T], n_tiles [B] -> int64 [B] (NO_TILE for a read without tiles)."""
    T = top_count.shape[1]
    in_read = (torch.arange(T, device=top_count.device)[None, :]
               < n_tiles[:, None])
    return torch.where(in_read, top_count, NO_TILE).amin(dim=1).long()
