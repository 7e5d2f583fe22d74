"""Spaced-seed ntHash: seed families and the plain PyTorch hash definition.

A hash is one 64-bit strand-canonical ntHash per (seed, position), with the
published per-base constants restricted to the seed's care positions
(ops/nthash_np.py of the JAX package, mirroring multiLensfrHashIterator.hpp):

  fwd(p) = XOR_{j in care} rol64(TAB[s[p+j]], span-1-j)
  rev(p) = XOR_{j in care} rol64(TABC[s[p+j]], j)
  canon  = min(fwd, rev)            (as unsigned 64-bit values)

``hash_positions`` (every position, or every stride-th), ``hash_at``
(per-seed positions) and ``hash_sampled`` (both, as the sampled grid needs
them) evaluate that definition directly with torch ops; they are the plain
versions that the CPU path and the tests use.  On the card the main
path never materialises raw hashes: kernel A (csrc/seed_hash.cu) fuses them
with the slot map into the probe grid (``mibf.build_slot_grid``) and the
presence fill (``mibf.fill_presence_bits``), through the factorisation that
``SeedFamily.kernel_table`` tabulates.  Seed s = left + s zeros + right
splits into a left half whose rotations grow by s and a right half that
starts s later but whose forward rotations do not depend on s:

  fwd_s(p) = rol64(FL(p), s) ^ FR(p + half + s)
  rev_s(p) = RL(p) ^ rol64(RR(p + half + s), s)

with FL, RL the XOR over the left care offsets j of rol64(TAB[b], k-1-j)
and rol64(TABC[b], j), and FR, RR over the right ones c of
rol64(TAB[b], k-1-half-c) and rol64(TABC[b], half+c).  The four partials
are computed once per position and shared by all h seeds.

Hashes are carried as int64 tensors holding the uint64 bits: PyTorch has no
shifts, comparisons or ``min`` on uint64, so rotates use masked logical
shifts and the unsigned minimum compares with the sign bit flipped.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

# ntHash per-base constants (encoding A=0 C=1 G=2 T=3)
NT_TAB = np.array(
    [0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324,
     0x295549F54BE24456], dtype=np.uint64)
# complement under that encoding is 3-b
NT_TABC = NT_TAB[::-1].copy()

_SIGN = -(1 << 63)
# positions of a block table (SeedFamily.block_table): 4 codes, 256 entries
BLOCK = 4


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

    def kernel_table(self) -> np.ndarray:
        """uint64 [(nl + nr) * 9] read by kernel A: the care offsets
        (care_left..., care_right...), then for each of them and each base
        b its (forward, reverse) constant with the rotation of the
        factorisation above applied (module docstring)."""
        k, half = self.k, self.half
        rows = ([(k - 1 - j, j) for j in self.care_left]
                + [(k - 1 - half - c, half + c) for c in self.care_right])
        table = [(_rol64_np(NT_TAB, rf), _rol64_np(NT_TABC, rr))
                 for rf, rr in rows]
        pairs = np.stack([np.stack(t, axis=1) for t in table]).reshape(-1)
        care = np.array(self.care_left + self.care_right, dtype=np.uint64)
        return np.concatenate([care, pairs])

    def block_counts(self) -> tuple[int, int]:
        """Blocks of BLOCK positions that the left and the right half's
        windows span, up to each half's last care offset."""
        return tuple(-(-(max(care, default=-1) + 1) // BLOCK)
                     for care in (self.care_left, self.care_right))

    def block_table(self, nb: int) -> np.ndarray:
        """uint64 [2 * nb * 256 * 2] read by ntCard's counter kernel: each
        half's window (the left half's from the seed's start, the right
        half's from ``half``) cut into nb blocks of BLOCK positions, the
        left half's first.  Entry x of block b, x holding the codes of the
        window's positions 4b .. 4b + 3 two bits each (position 4b + t at
        bits 2t), is the XOR of the (forward, reverse) constants of
        ``kernel_table`` of the care offsets in the block, with their codes
        from x: a half's partials (module docstring) are the XOR of its
        blocks' entries.  Positions without a care offset add nothing, so
        blocks past a half's last care offset are all zero."""
        if nb < max(self.block_counts()):
            raise ValueError(f"{nb} blocks a half; the family spans "
                             f"{self.block_counts()}")
        k, half = self.k, self.half
        x = np.arange(4 ** BLOCK)
        out = np.zeros((2, nb, 4 ** BLOCK, 2), dtype=np.uint64)
        rots = ([(j, (k - 1 - j, j)) for j in self.care_left],
                [(c, (k - 1 - half - c, half + c)) for c in self.care_right])
        for side, rows in enumerate(rots):
            for j, (rf, rr) in rows:
                code = (x >> (2 * (j % BLOCK))) & 3
                out[side, j // BLOCK, :, 0] ^= _rol64_np(NT_TAB, rf)[code]
                out[side, j // BLOCK, :, 1] ^= _rol64_np(NT_TABC, rr)[code]
        return out.reshape(-1)


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


@lru_cache(maxsize=None)
def unspaced_family(k: int) -> SeedFamily:
    """The family of one all-care seed of span k: the classic canonical
    ntHash of k-mers, which the mapper (K20) and the polisher (K21) use."""
    return build_seed_family(["1" * k])


def _as_i64(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64).copy())


def umin64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned minimum of int64 tensors holding uint64 bits."""
    return torch.where((a ^ _SIGN) < (b ^ _SIGN), a, b)


def _padded_codes(codes: torch.Tensor, width: int) -> torch.Tensor:
    """The codes' low 2 bits as int64, zero-padded to at least ``width``."""
    c = codes.to(torch.int64) & 3
    if c.shape[1] < width:
        c = torch.nn.functional.pad(c, (0, width - c.shape[1]))
    return c


def _canon(fam: SeedFamily, s: int, at) -> torch.Tensor:
    """Canonical hash of seed s where ``at(j)`` gives the codes at care
    offset j of every frame hashed."""
    span = fam.spans[s]
    fwd = rev = None
    for j in fam.care(s):
        cj = at(j)
        tf = _as_i64(_rol64_np(NT_TAB, span - 1 - j)).to(cj.device)
        tr = _as_i64(_rol64_np(NT_TABC, j)).to(cj.device)
        fwd = tf[cj] if fwd is None else fwd ^ tf[cj]
        rev = tr[cj] if rev is None else rev ^ tr[cj]
    return umin64(fwd, rev)


def hash_positions(codes: torch.Tensor, fam: SeedFamily,
                   num_frames: int, stride: int = 1) -> torch.Tensor:
    """Canonical hashes at every position of a padded batch.

    codes: uint8 [B, L] base codes (only the low 2 bits are read, as the JAX
    kernel does); positions past L read as 0, the zero padding of
    ``goldrush_tpu.ops.nthash.hash_positions``.  Returns int64 [B, h,
    num_frames // stride] (uint64 bits): entry [b, s, q] hashes
    codes[b, p : p+span_s] at p = q * stride (a multiple of stride must
    divide num_frames).  Frames past a read's valid range hold hashes of the
    padding, which the callers mask or clamp exactly as the JAX package does.
    """
    B, _ = codes.shape
    P = num_frames
    if P % stride:
        raise ValueError("num_frames must be a multiple of stride")
    c = _padded_codes(codes, P + fam.pad_needed)
    out = torch.empty((B, fam.h, P // stride), dtype=torch.int64,
                      device=codes.device)
    for s in range(fam.h):
        out[:, s] = _canon(fam, s, lambda j: c[:, j: j + P: stride])
    return out


def fingerprints(codes: torch.Tensor, fam: SeedFamily, num_frames: int,
                 stride: int, bits: int) -> torch.Tensor:
    """The wavefront's k-mer fingerprints (goldrush_tpu/path/wavefront.py:
    293-296): the low ``bits`` bits of every seed's hash at every
    stride-th position, int64 [B, h, num_frames // stride].  The position
    is the plain one, f * stride, also where the insert grid clamps a
    frame at a tile's tail; past a read's end the k-mer reads the zero
    padding, as ``hash_positions`` does.  The plain version; on the card
    the wave_adjacency kernel hashes its own (csrc/wavefront.cu)."""
    return hash_positions(codes, fam, num_frames, stride) & ((1 << bits) - 1)


def _hash_at_padded(c: torch.Tensor, fam: SeedFamily, pos: torch.Tensor,
                    L_valid: int) -> torch.Tensor:
    """Hashes at per-seed positions of padded codes ``c``, each position
    clipped to [0, L_valid - 1] (goldrush_tpu/ops/nthash.py:276-306)."""
    B, h, N = pos.shape
    if h != fam.h:
        raise ValueError(f"positions for {h} seeds, family has {fam.h}")
    pos = pos.to(torch.int64).clamp(0, L_valid - 1)
    out = torch.empty((B, h, N), dtype=torch.int64, device=c.device)
    for s in range(h):
        out[:, s] = _canon(fam, s, lambda j: torch.gather(c, 1, pos[:, s] + j))
    return out


def hash_at(codes: torch.Tensor, fam: SeedFamily, pos: torch.Tensor
            ) -> torch.Tensor:
    """Canonical hashes at arbitrary per-seed positions: pos int [B, h, N]
    (row s holds seed s's positions) -> int64 [B, h, N], equal to
    ``hash_positions(...)[b, s, pos[b, s, n]]`` for positions inside the
    batch (goldrush_tpu/ops/nthash.py:310)."""
    L = codes.shape[1]
    return _hash_at_padded(_padded_codes(codes, L + fam.pad_needed), fam,
                           pos, L)


def hash_sampled(codes: torch.Tensor, fam: SeedFamily, num_frames: int,
                 stride: int, clamp_pos: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hash_positions(codes, fam, num_frames, stride), the hashes at
    ``clamp_pos``): the codes are padded to num_frames + pad_needed, and
    the clamp positions clipped to that width less pad_needed
    (goldrush_tpu/ops/nthash.py:324-373)."""
    L = max(codes.shape[1], num_frames + fam.pad_needed)
    h_strided = hash_positions(codes, fam, num_frames, stride)
    c = _padded_codes(codes, L)
    return h_strided, _hash_at_padded(c, fam, clamp_pos, L - fam.pad_needed)
