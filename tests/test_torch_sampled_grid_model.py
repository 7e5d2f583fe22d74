"""A Python model of kernel A's standalone sampled grid as the card runs it
at a frame stride S >= h, S > 1, with no query grid beside it, as slots or
as ranks of one seed (csrc/seed_hash.cu seed_hash_sampled_kernel; other
grids run the CTA-per-tile kernel, but the map holds there too), held to
the plain grid
``mibf._build_slot_grid_plain`` bit for bit: thread g of the launch takes frame g of the batch's frames
flattened as [B, T, F] (F = TL / S), whatever tile it lies in; its read,
tile and frame, the tile's valid frames, the stale-tail clamp of each seed,
the 32-code window of its probe position packed two bits a code (0 at or
past the batch width; ``window_at``), and each seed's hash from the
family's block table (``half_at``: a lookup a block of 4 window positions,
the left half's once a frame at offset 0, the right half's a seed at the
window offset half + s), then the slot map."""

import numpy as np
import pytest
import torch

from goldrush_tpu_torch import hard_cases as hard
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.ops.nthash import build_seed_family
from goldrush_tpu_torch.ops.seeds import make_seed_pattern

MASK64 = (1 << 64) - 1
THREADS = 256


def rol64(x, r):
    r &= 63
    return ((x << r) | (x >> (64 - r))) & MASK64 if r else x


def slot_of(h, size, mode):
    """seed_hash.cu slot_of below 2^32 slots: fastrange or h % size."""
    return h % size if mode else (h * size) >> 64


def window_at(row, q):
    """Codes [q, q + 32) of the row packed two bits a code, code q lowest;
    0 at or past the row's width."""
    w = 0
    for i in range(32):
        if q + i < len(row):
            w |= (int(row[q + i]) & 3) << (2 * i)
    return w


class Family:
    """The block table as the kernel stages it: for each half, nb tables of
    256 (fwd, rev) entries, one a block of 4 positions."""

    def __init__(self, fam):
        self.h, self.k, self.half = fam.h, fam.k, fam.half
        self.nb = max(fam.block_counts())
        # the window holds every care offset, and the blocks' bytes
        assert self.k + self.h <= 33
        assert 2 * (self.half + self.h - 1) + 8 * (self.nb - 1) <= 56
        t = fam.block_table(self.nb).view(np.uint64).reshape(
            2, self.nb, 256, 2)
        self.blk = [[[(int(a), int(b)) for a, b in t[side, blk]]
                     for blk in range(self.nb)] for side in (0, 1)]

    def partial(self, right, base, win):
        """half_at: the XOR of the half's block entries, block b's entry
        the window's byte at position base + 4 b."""
        fw = rv = 0
        for b in range(self.nb):
            a, c = self.blk[int(right)][b][(win >> (2 * base + 8 * b)) & 255]
            fw ^= a
            rv ^= c
        return fw, rv


def model_grid(codes, lengths, fam: Family, T, TL, S, size, mode):
    """The launch: ceil(frames / THREADS) CTAs of THREADS threads, thread g
    writing frame g's frame_ok and its h slots."""
    B = codes.shape[0]
    F = TL // S
    frames = B * T * F
    slots = np.zeros((B, fam.h, T * F), np.int64)
    ok = np.zeros((B, T * F), bool)
    for g in range(-(-frames // THREADS) * THREADS):
        if g >= frames:
            continue
        b, col = divmod(g, T * F)
        t, j = divmod(col, F)
        n = int(lengths[b])
        pos0 = t * TL
        frames_t = (min(TL + fam.k - 1, n - pos0) - fam.k + 1
                    if t < n // TL else 0)
        fr = j * S
        ok[b, col] = fr < frames_t
        if not ok[b, col]:
            slots[b, :, col] = size
            continue
        own_win = window_at(codes[b], pos0 + fr)
        own = fam.partial(False, 0, own_win)
        for s in range(fam.h):
            p = min(fr, frames_t - s - 1)          # the stale-tail clamp
            win = own_win if p == fr else window_at(codes[b], pos0 + p)
            left = own if p == fr else fam.partial(False, 0, win)
            right = fam.partial(True, fam.half + s, win)
            fwd = rol64(left[0], s) ^ right[0]
            rev = left[1] ^ rol64(right[1], s)
            slots[b, s, col] = slot_of(min(fwd, rev), size, mode)
    return slots, ok


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("S", [2, 5, 8])
def test_sampled_model_matches_plain(S, h, mode):
    """The model against the plain sampled grid (the JAX package's routes:
    the last-tile grid at S >= h, the general one below) on every grid case
    of hard_cases.grid_lengths at a tile length of 40 (frames that span
    CTAs and tiles, reads shorter than k, the clamp) and one batch of
    longer reads, both slot maps."""
    TL, size = 40, 1_000_003
    fam = build_seed_family(
        make_seed_pattern("1011011110110111101101", 22, 16, 3)[:h])
    params = tdm.MibfParams(size=size, h=h, k=22, spans=fam.spans,
                            tile_length=TL, frame_stride=S, slot_map=mode)
    cases = dict(hard.grid_lengths(TL, 22))
    cases["long"] = ([7 * TL + 3, 6 * TL, 5 * TL + 21, 0, 8 * TL], 8)
    for i, (lengths, T) in enumerate(cases.values()):
        codes, lens = hard.read_batch(lengths, T * TL + TL, seed=i)
        want = tdm._build_slot_grid_plain(
            torch.from_numpy(codes), torch.from_numpy(lens), fam, params, T)
        got = model_grid(codes, lens, Family(fam), T, TL, S, size,
                         mode == "mod")
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())
