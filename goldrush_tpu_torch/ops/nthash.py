"""Spaced-seed ntHash: seed families and the plain PyTorch hash definition.

A hash is one 64-bit strand-canonical ntHash per (seed, position), with the
published per-base constants restricted to the seed's care positions
(ops/nthash_np.py of the JAX package, mirroring multiLensfrHashIterator.hpp):

  fwd(p) = XOR_{j in care} rol64(TAB[s[p+j]], span-1-j)
  rev(p) = XOR_{j in care} rol64(TABC[s[p+j]], j)
  canon  = min(fwd, rev)            (as unsigned 64-bit values)

``hash_positions`` evaluates that definition directly with torch ops; it is
the plain version that the CPU path and the tests use.  On the card the main
path never materialises raw hashes: kernel A (csrc/seed_hash.cu) computes the
same definition per thread and fuses it with the slot map into the probe
grid (``mibf.build_slot_grid``) and the presence fill
(``mibf.fill_presence``).

Hashes are carried as int64 tensors holding the uint64 bits: PyTorch has no
shifts, comparisons or ``min`` on uint64, so rotates use masked logical
shifts and the unsigned minimum compares with the sign bit flipped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ntHash per-base constants (encoding A=0 C=1 G=2 T=3)
NT_TAB = np.array(
    [0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324,
     0x295549F54BE24456], dtype=np.uint64)
# complement under that encoding is 3-b
NT_TABC = NT_TAB[::-1].copy()

_SIGN = -(1 << 63)


def _rol64_np(x: np.ndarray, r: int) -> np.ndarray:
    r %= 64
    if r == 0:
        return x.astype(np.uint64)
    with np.errstate(over="ignore"):
        return ((x << np.uint64(r)) | (x >> np.uint64(64 - r))).astype(np.uint64)


@dataclasses.dataclass(frozen=True)
class SeedFamily:
    """One multi-length seed family: seed s = left + s*'0' + right, so seed
    s has span k + s and its care offsets are the left half's plus the right
    half's shifted by half + s."""

    seeds: tuple[str, ...]
    half: int                      # length of the shared left half
    spans: tuple[int, ...]         # span of each seed (k, k+1, ..)
    care_left: tuple[int, ...]     # care offsets within the left half
    care_right: tuple[int, ...]    # care offsets relative to right-half start

    @property
    def h(self) -> int:
        return len(self.seeds)

    @property
    def k(self) -> int:
        return self.spans[0]

    @property
    def pad_needed(self) -> int:
        """Positions beyond the last frame that seed h-1 reads."""
        mx = max(self.care_right, default=0)
        return self.half + (self.h - 1) + mx + 1

    def care(self, s: int) -> tuple[int, ...]:
        """Care offsets of seed s within its span."""
        return self.care_left + tuple(self.half + s + c
                                      for c in self.care_right)

    def descriptor(self) -> np.ndarray:
        """int32 [5 + nl + nr] layout read by kernel A:
        (h, k, half, nl, nr, care_left..., care_right...)."""
        return np.array([self.h, self.k, self.half, len(self.care_left),
                         len(self.care_right), *self.care_left,
                         *self.care_right], dtype=np.int32)


def build_seed_family(seeds: list[str]) -> SeedFamily:
    left = seeds[0][: len(seeds[0]) // 2]
    right = seeds[0][len(left):]
    for i, s in enumerate(seeds):
        if s != left + "0" * i + right:
            raise ValueError("seed list is not a left+zeros+right family "
                             "from make_seed_pattern")
    return SeedFamily(
        seeds=tuple(seeds),
        half=len(left),
        spans=tuple(len(s) for s in seeds),
        care_left=tuple(j for j, c in enumerate(left) if c == "1"),
        care_right=tuple(j for j, c in enumerate(right) if c == "1"),
    )


def _as_i64(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64).copy())


def umin64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned minimum of int64 tensors holding uint64 bits."""
    return torch.where((a ^ _SIGN) < (b ^ _SIGN), a, b)


def hash_positions(codes: torch.Tensor, fam: SeedFamily,
                   num_frames: int) -> torch.Tensor:
    """Canonical hashes at every position of a padded batch.

    codes: uint8 [B, L] base codes (only the low 2 bits are read, as the JAX
    kernel does); positions past L read as 0, the zero padding of
    ``goldrush_tpu.ops.nthash.hash_positions``.  Returns int64 [B, h,
    num_frames] (uint64 bits): entry [b, s, p] hashes codes[b, p : p+span_s].
    Frames past a read's valid range hold hashes of the padding, which the
    callers mask or clamp exactly as the JAX package does.
    """
    B, L = codes.shape
    P = num_frames
    need = P + fam.pad_needed
    c = (codes.to(torch.int64) & 3)
    if L < need:
        c = torch.nn.functional.pad(c, (0, need - L))
    out = torch.empty((B, fam.h, P), dtype=torch.int64, device=codes.device)
    for s in range(fam.h):
        span = fam.spans[s]
        fwd = torch.zeros((B, P), dtype=torch.int64, device=codes.device)
        rev = torch.zeros_like(fwd)
        for j in fam.care(s):
            tf = _as_i64(_rol64_np(NT_TAB, span - 1 - j)).to(codes.device)
            tr = _as_i64(_rol64_np(NT_TABC, j)).to(codes.device)
            cj = c[:, j: j + P]
            fwd ^= tf[cj]
            rev ^= tr[cj]
        out[:, s] = umin64(fwd, rev)
    return out
