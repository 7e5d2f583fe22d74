"""Spaced-seed ntHash, slot maps and tile frames in plain torch.

Frozen rewrite, at commit 93d720b, of goldrush_tpu/ops/nthash_np.py:1-126
(the hash, its stale tails, ``tile_frame_hashes``), goldrush_tpu/ops/
seeds.py (the preset family: seed i = left + i zeros + right),
goldrush_tpu/mibf/mibf_np.py:40-47 (fastrange) and the reference's
``hash % size`` (MIBloomFilter.hpp), with no import of either package.
Hashes are int64 tensors holding uint64 bits, on any device.

  fwd(p) = XOR_{j in care} rol64(TAB[c[p+j]], span-1-j)
  rev(p) = XOR_{j in care} rol64(TAB[3-c[p+j]], j)
  canon  = min(fwd, rev) as unsigned values
"""

from __future__ import annotations

import torch

NT_TAB = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324,
          0x295549F54BE24456)
_M64 = (1 << 64) - 1
_SIGN = -(1 << 63)


def seed_family(preset: str, h: int) -> list[str]:
    """The h seeds of a preset: its halves with i zeros between them."""
    half = len(preset) // 2
    left, right = preset[:half], preset[half: 2 * half]
    return [left + "0" * i + right for i in range(h)]


def _rol(u: int, r: int) -> int:
    r %= 64
    return u if r == 0 else ((u << r) | (u >> (64 - r))) & _M64


def _signed(u: int) -> int:
    return u - (1 << 64) if u >> 63 else u


def _tables(seed: str, device) -> tuple[list, torch.Tensor, torch.Tensor]:
    span = len(seed)
    care = [j for j, c in enumerate(seed) if c == "1"]
    fwd = [[_signed(_rol(NT_TAB[b], span - 1 - j)) for b in range(4)]
           for j in care]
    rev = [[_signed(_rol(NT_TAB[3 - b], j)) for b in range(4)] for j in care]
    return (care, torch.tensor(fwd, dtype=torch.int64, device=device),
            torch.tensor(rev, dtype=torch.int64, device=device))


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where((a ^ _SIGN) < (b ^ _SIGN), a, b)


def canonical(codes: torch.Tensor, seed: str) -> torch.Tensor:
    """Canonical hashes of every window of ``seed`` over the flat codes
    (uint8 [N], values 0..3): int64 [N - span + 1].  Windows that cross
    two reads of a flat pool are computed and left to the caller to drop."""
    care, ft, rt = _tables(seed, codes.device)
    n = codes.shape[0] - len(seed) + 1
    c = codes.to(torch.int64)
    fwd = torch.zeros(max(n, 0), dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    for i, j in enumerate(care):
        b = c[j: j + n]
        fwd ^= ft[i][b]
        rev ^= rt[i][b]
    return umin(fwd, rev)


def slot_of(h: torch.Tensor, size: int, slot_map: str) -> torch.Tensor:
    """The slot of each hash: ``mod`` is the unsigned h % size, ``fastrange``
    floor(h * size / 2^64), both exact at any size."""
    if slot_map == "mod":
        half = (h >> 1) & ((1 << 63) - 1)          # the unsigned h // 2
        return (2 * (half % size) + (h & 1)) % size
    if slot_map != "fastrange":
        raise ValueError(f"unknown slot map {slot_map!r}")
    if size >= 1 << 46:
        raise ValueError("fastrange here takes sizes below 2^46")
    carry = torch.zeros_like(h)
    for i in range(4):                  # 16-bit limbs, lowest first
        carry = (((h >> (16 * i)) & 0xFFFF) * size + carry) >> 16
    return carry


def tile_frames(lengths: torch.Tensor, tiles: int, tile_length: int, k: int,
                h: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Read-relative positions of the tile frames of a batch of reads, as
    ``tile_frame_hashes`` lays them out: tile t covers codes [t TL, t TL +
    TL + k - 1), so its frames number P_t = min(TL, length - t TL - k + 1);
    seed s (span k + s) has P_t - s valid positions there and repeats its
    last one for the frames after them.  ``lengths`` int64 [B]; frame f of
    tile t sits at t * TL + f of ``tiles`` * TL frames a read.  Returns
    (positions int64 [B, tiles * TL, h], valid bool [B, tiles * TL]): a
    frame is valid in the read's length // TL tiles and below P_t."""
    dev = lengths.device
    TL = tile_length
    t = torch.arange(tiles, device=dev)
    f = torch.arange(TL, device=dev)
    L = lengths.to(torch.int64)[:, None]
    p_t = torch.clamp(L - t[None, :] * TL - k + 1, max=TL)       # [B, T]
    valid = (t[None, :] < L // TL)[:, :, None] & \
        (f[None, None, :] < p_t[:, :, None])                    # [B, T, TL]
    s = torch.arange(h, device=dev)
    last = torch.clamp(p_t[:, :, None, None] - 1 - s, min=0)     # [B, T, 1, h]
    pos = t[None, :, None, None] * TL + torch.minimum(
        f[None, None, :, None], last)
    B = lengths.shape[0]
    return pos.reshape(B, tiles * TL, h), valid.reshape(B, tiles * TL)
