"""rank_build's design (csrc/rank.cu) as a numpy model of its arithmetic,
held bit for bit to the port's plain freeze (`build_rank` on the CPU) and
to the JAX freeze (`_freeze_from_bits`).

The model is generic over the tile (threads a CTA, 16-byte rows a
thread), the superblock and the look-back window.  A CTA takes its tile by
ticket; thread t's row r holds words 4 (r * threads + t) .. + 3 of the
tile (copied to shared memory and read back by t alone), masked past
`size` and popcounted; each row's sums are scanned
across each warp by __shfl_up_sync steps and the warps' row totals
combined into the tile's aggregate and each thread's offsets.  Every tile
publishes its aggregate; then, in a completion order (ticket order, or
shuffled: the kernel's tiles finish in any order), each looks back over
its predecessors a window at a time, nearest first, to an inclusive value
or its superblock's first tile, and publishes its inclusive value; its
words are written final; the last tile of each superblock writes the
superblock's count, and the superblock finished last turns the counts
into their exclusive sum and the population.  At the real constants a
superblock is 2^27 words (512 MB of bitmap), so the superblock restart is
held at reduced ones, with the plain and JAX freezes' superblock constants
reduced alike (monkeypatched here, never in the packages).  The kernel
itself runs only on a card (tests/test_torch_kernels.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.mibf import compressed as jcz

from goldrush_tpu_torch.mibf import compressed as tcz

AGG, INCL = 1, 2


def popcount(v):
    v = v.astype(np.uint64)
    v = v - ((v >> np.uint64(1)) & np.uint64(0x55555555))
    v = (v & np.uint64(0x33333333)) + ((v >> np.uint64(2))
                                       & np.uint64(0x33333333))
    v = (v + (v >> np.uint64(4))) & np.uint64(0x0F0F0F0F)
    return ((v * np.uint64(0x01010101)) >> np.uint64(24)) & np.uint64(0xFF)


def warp_scan(x):
    """Inclusive scan of [..., threads] across each warp of 32 lanes, as
    the __shfl_up_sync steps compute it."""
    w = x.reshape(*x.shape[:-1], -1, 32)
    lane = np.arange(32)
    for d in (1, 2, 4, 8, 16):
        up = np.zeros_like(w)
        up[..., d:] = w[..., :-d]
        w = np.where(lane >= d, w + up, w)
    return w.reshape(x.shape)


def tile_of(bits, size, tile, threads, rows):
    """One CTA's load, mask, popcounts and block scan: the words' indices
    [rows, threads, 4], their real bits, their popcounts, each thread's
    row offsets within the tile and the tile's aggregate."""
    nw = len(bits)
    idx = (tile * 4 * rows * threads
           + 4 * (np.arange(rows)[:, None, None] * threads
                  + np.arange(threads)[None, :, None])
           + np.arange(4)[None, None, :])
    b = np.where(idx < nw, bits[np.minimum(idx, nw - 1)], 0).astype(
        np.uint64)
    tail = size - idx * 32
    mask = np.where(tail >= 32, 0xFFFFFFFF,
                    (np.uint64(1) << np.clip(tail, 0, 31).astype(np.uint64))
                    - np.uint64(1))
    b &= np.where(tail > 0, mask, 0).astype(np.uint64)
    pc = popcount(b)
    row = pc.sum(-1)                                   # [rows, threads]
    inc = warp_scan(row)
    wtot = inc.reshape(rows, -1, 32)[..., 31]          # [rows, warps]
    warp = np.arange(threads) // 32
    before_rows = np.concatenate([[0], np.cumsum(wtot.sum(1))[:-1]])
    before_warps = np.cumsum(wtot, 1) - wtot           # warps before
    off = before_rows[:, None] + before_warps[:, warp] + inc - row
    return idx, b, pc, off, int(wtot.sum())


def rank_build_model(bits, size, threads=128, rows=16, super_words=1 << 27,
                     window=32, order=None):
    """(bitrank, supers, pop, look-back windows read) as rank_build
    computes them, its tiles' look-backs in `order` (ticket order by
    default)."""
    nw = len(bits)
    tile_words = 4 * rows * threads
    super_tiles = super_words // tile_words
    n_tiles = -(-nw // tile_words)
    n_super = -(-n_tiles // super_tiles)
    tiles = [tile_of(bits, size, x, threads, rows) for x in range(n_tiles)]
    # every tile publishes its aggregate before any look-back ends (the
    # kernel's look-back waits while a predecessor has published nothing)
    status = [(AGG, t[4]) for t in tiles]
    bitrank = np.zeros(nw + 1, np.uint64)
    supers = np.zeros(n_super, np.uint64)
    done, pop, windows = 0, None, 0
    for x in (range(n_tiles) if order is None else order):
        idx, b, pc, off, agg = tiles[x]
        first = x - x % super_tiles
        excl = 0
        if x != first:
            j = x - 1
            while True:
                windows += 1
                seen = [status[p] if p >= first else (INCL, 0)
                        for p in range(j, j - window, -1)]
                stop = next((i for i, s in enumerate(seen) if s[0] == INCL),
                            None)
                excl += sum(v for _, v in seen[: window if stop is None
                                               else stop + 1])
                if stop is not None:
                    break
                j -= window
        status[x] = (INCL, excl + agg)
        rank = (excl + off)[..., None] + np.cumsum(pc, -1) - pc
        keep = idx < nw
        assert int(rank.max()) < 1 << 32
        bitrank[idx[keep]] = (rank.astype(np.uint64) << np.uint64(32)
                              | b)[keep]
        s = x // super_tiles
        if x == min(s * super_tiles + super_tiles, n_tiles) - 1:
            supers[s] = excl + agg
            done += 1
            if done == n_super:
                counts = supers.copy()
                supers = np.concatenate([[0], np.cumsum(counts)[:-1]]
                                        ).astype(np.uint64)
                pop = int(counts.sum())
    return bitrank, supers, pop, windows


def reduced(monkeypatch, super_words):
    """The plain and JAX freezes with superblocks of `super_words` words
    (plain blocks of 32 words)."""
    bits = (super_words * 32).bit_length() - 1
    monkeypatch.setattr(jcz, "SUPER_BITS", bits)
    monkeypatch.setattr(tcz, "SUPER_BITS", bits)
    monkeypatch.setattr(tcz, "RANK_BLOCK_SLOTS", 1024)
    monkeypatch.setattr(tcz, "SUPER_BLOCKS", super_words // 32)


# (threads, rows, superblock words, window, bitmap words, slots short of
# the last word's end, how the bitmap is drawn, completion order)
CASES = {
    "real_one_ragged_tile": (128, 16, 1 << 27, 32, 3_001, 27, "dense",
                             "ticket"),
    "real_tiles_ticket": (128, 16, 1 << 27, 32, 40 * 8_192 + 123, 5,
                          "sparse", "ticket"),
    "real_tiles_shuffled": (128, 16, 1 << 27, 32, 100 * 8_192 + 123, 0,
                            "dense", "shuffled"),
    "reduced_supers_ticket": (32, 1, 1_024, 32, 5 * 1_024 + 700, 9,
                              "dense", "ticket"),
    "reduced_supers_shuffled": (32, 1, 1_024, 32, 5 * 1_024 + 700, 9,
                                "sparse", "shuffled"),
    "reduced_full_super": (32, 2, 4_096, 32, 3 * 4_096 + 1, 31, "full",
                           "shuffled"),
    "reduced_window_4": (32, 1, 8_192, 4, 2 * 8_192 + 200, 1, "dense",
                         "shuffled"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rank_build_model_matches_plain_and_jax(case, monkeypatch):
    """Tiles in ticket and shuffled completion orders, look-back windows
    of 32 and 4 tiles, several superblocks restarting at 0, a fully set
    superblock (its count exactly its slots, its last word's rank its
    slots less 32), and a ragged last word with dirty bits past size: the
    model's bitrank, supers and pop equal the plain freeze's and the JAX
    freeze's."""
    threads, rows, super_words, window, nw, short, kind, order = CASES[case]
    if super_words != 1 << 27:
        reduced(monkeypatch, super_words)
    size = nw * 32 - short
    rng = np.random.default_rng(nw + short)
    bits = rng.integers(0, 1 << 32, nw, dtype=np.uint64)
    if kind == "sparse":
        bits &= rng.integers(0, 1 << 32, nw, dtype=np.uint64)
        bits &= rng.integers(0, 1 << 32, nw, dtype=np.uint64)
    elif kind == "full":
        bits[super_words: 2 * super_words] = 0xFFFFFFFF
    bits = bits.astype(np.uint32)
    tile_words = 4 * rows * threads
    n_tiles = -(-nw // tile_words)
    perm = (None if order == "ticket"
            else np.random.default_rng(n_tiles).permutation(n_tiles))
    got, supers, pop, windows = rank_build_model(
        bits, size, threads, rows, super_words, window, perm)

    want, want_supers, want_pop = tcz.build_rank(
        torch.from_numpy(bits.view(np.int32).copy()), size)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint64))
    np.testing.assert_array_equal(supers,
                                  want_supers.numpy().view(np.uint64))
    assert pop == want_pop

    real = bits.copy()
    if size % 32:
        real[-1] &= np.uint32((1 << (size % 32)) - 1)
    j = jcz._freeze_from_bits(real, size)
    np.testing.assert_array_equal(got, np.asarray(j.bitrank))
    np.testing.assert_array_equal(supers, np.asarray(j.supers))
    last = int(np.asarray(j.bitrank)[-2] >> np.uint64(32))
    assert pop == int(supers[-1]) + last + bin(int(real[-1])).count("1")

    super_tiles = super_words // tile_words
    if kind == "full":
        assert int(supers[2] - supers[1]) == super_words * 32
        assert int(got[2 * super_words - 1] >> np.uint64(32)) == \
            super_words * 32 - 32
    if order == "shuffled" and super_tiles > window:
        # some tile looked back past its first window
        assert windows > n_tiles - len(supers)
    if order == "ticket":
        # each tile finds its predecessor inclusive: one window a tile
        assert windows == n_tiles - len(supers)
