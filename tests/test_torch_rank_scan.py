"""rank_scan's kernel design (csrc/rank.cu) as a numpy model of its
arithmetic, held bit for bit to the port's plain `_rank_scan_plain` and,
at one superblock, to the JAX freeze (`_freeze_from_bits`): tiles of
2,048 block totals (32 a superblock), one CTA of 256 threads each, whose
threads take four 16-byte pairs at a stride of the CTA's width; the first
launch's tile sums; then each tile's carry from the sums of the tiles
before it in its superblock, the pairs' sums scanned across each warp by
__shfl_up_sync steps, the warps' totals carried row by row, the first
tile of each superblock's `supers` entry and the last tile's pop.  The
kernel itself runs only on a card (tests/test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.mibf import compressed as jcz

from goldrush_tpu_torch.mibf import compressed as tcz

THREADS, PAIRS = 256, 4
TILE = 2 * PAIRS * THREADS
TILES_PER_SUPER = tcz.SUPER_BLOCKS // TILE


def tile_pairs(totals, tile):
    """[PAIRS, THREADS, 2]: pair r of thread t is totals 2u, 2u + 1 of the
    tile, u = t + r * THREADS; zero past the last block."""
    i = tile * TILE + 2 * (np.arange(THREADS)[None, :]
                           + THREADS * np.arange(PAIRS)[:, None])
    i = np.stack([i, i + 1], -1)
    return np.where(i < len(totals), totals[np.minimum(i, len(totals) - 1)],
                    0)


def model(totals):
    """(carries, supers, pop) as the two launches compute them."""
    n_tiles = -(-len(totals) // TILE)
    sums = np.array([tile_pairs(totals, x).sum() for x in range(n_tiles)],
                    np.uint64)
    carries = np.zeros_like(totals)
    supers = np.zeros(-(-n_tiles // TILES_PER_SUPER), np.uint64)
    pop = None
    lane = np.arange(32)
    for x in range(n_tiles):
        first = x - x % TILES_PER_SUPER
        if x == first:
            supers[x // TILES_PER_SUPER] = sums[:first].sum()
        if x == n_tiles - 1:
            pop = int(sums.sum())
        p = tile_pairs(totals, x).astype(np.uint64)
        inc = p.sum(-1).reshape(PAIRS, THREADS // 32, 32)
        for d in (1, 2, 4, 8, 16):                      # __shfl_up_sync
            up = np.zeros_like(inc)
            up[..., d:] = inc[..., :-d]
            inc = np.where(lane >= d, inc + up, inc)
        wtot = inc[..., 31]                             # [PAIRS, warps]
        base = np.uint64(sums[first:x].sum())           # the tile's carry
        out = np.zeros((PAIRS, THREADS, 2), np.uint64)
        for r in range(PAIRS):
            before = base + np.concatenate(
                [[0], np.cumsum(wtot[r])[:-1]]).astype(np.uint64)
            base += wtot[r].sum()
            ex = (before[:, None] + inc[r] - p[r].sum(-1).reshape(
                THREADS // 32, 32)).reshape(THREADS)
            out[r, :, 0] = ex
            out[r, :, 1] = ex + p[r, :, 0]
        i = x * TILE + 2 * (np.arange(THREADS)[None, :]
                            + THREADS * np.arange(PAIRS)[:, None])
        i = np.stack([i, i + 1], -1)
        keep = i < len(totals)
        carries[i[keep]] = out[keep]
    return carries, supers, pop


# (superblocks, blocks of the last one, how the totals are drawn)
CASES = {
    "one_partial": (1, 2_173, "random"),
    "one_full": (1, tcz.SUPER_BLOCKS, "full"),
    "two_partial": (2, 4_097, "random"),
    "three_full_sums": (3, 2_049, "full"),
    "three_last_one_block": (3, 1, "sparse"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scan_model_matches_plain(case):
    """1, 2 and 3 superblocks with a partial last one (a partial last tile,
    a last tile of one block), totals of 65,536 (every slot present: a
    superblock's sum is 2^32 and supers pass 2^33) and sparse ones."""
    n_super, last, kind = CASES[case]
    nblk = (n_super - 1) * tcz.SUPER_BLOCKS + last
    rng = np.random.default_rng(nblk)
    if kind == "full":
        totals = np.full(nblk, 65_536, np.int64)
    elif kind == "sparse":
        totals = rng.integers(0, 65_537, nblk) * (rng.random(nblk) < 0.01)
    else:
        totals = rng.integers(0, 65_537, nblk)
    size = (nblk - 1) * tcz.RANK_BLOCK_SLOTS + 12_345
    carries, supers, pop = model(totals.astype(np.uint64))
    t = torch.from_numpy(totals.astype(np.int64))
    want_supers, want_pop = tcz._rank_scan_plain(t, size)
    np.testing.assert_array_equal(carries.astype(np.int64), t.numpy())
    np.testing.assert_array_equal(supers.astype(np.int64),
                                  want_supers.numpy())
    assert pop == want_pop == int(totals.sum())
    if kind == "full":
        assert int(supers[-1]) >= (n_super - 1) << 32


def test_scan_model_matches_jax_freeze():
    """One superblock of two tiles (2,050 blocks): the carries are the JAX
    freeze's ranks of each block's first word, supers its super_base, pop
    its present count."""
    size = 2_049 * tcz.RANK_BLOCK_SLOTS + 12_345
    nw = -(-size // 32)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 1 << 32, nw, dtype=np.uint64).astype(np.uint32)
    bits &= rng.integers(0, 1 << 32, nw, dtype=np.uint64).astype(np.uint32)
    bits[-1] &= np.uint32((1 << (size % 32)) - 1)
    j = jcz._freeze_from_bits(bits, size)
    _, totals = tcz._rank_pack_plain(torch.from_numpy(bits.view(np.int32)),
                                     size)
    carries, supers, pop = model(totals.numpy().astype(np.uint64))
    first_words = np.asarray(j.bitrank)[: nw: tcz.RANK_BLOCK_SLOTS // 32]
    np.testing.assert_array_equal(carries, first_words >> np.uint64(32))
    np.testing.assert_array_equal(supers, np.asarray(j.supers))
    jpop = int(np.asarray(j.bitrank)[-2] >> np.uint64(32)) + \
        bin(int(bits[-1])).count("1")
    assert pop == jpop
