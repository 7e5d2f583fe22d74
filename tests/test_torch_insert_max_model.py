"""A Python model of insert_max (K15) as the card runs it (csrc/insert.cuh),
held to the plain version ``mibf._insert_max_plain``: the window as H seed
spans of the tiles' keys, each entry's seed and span column and each
key's block id by multiply-highs (``Div32``, ``MaxWindow``), and the two
branches of the consume kernel: loaded (tiles lo..last read from the
grid, a key a thread over the grid, also the standalone launch's shape)
and staged (each key owner's slice, ``slice_of``, of a probed read's
whole window copied into shared memory, then the tiles lo..last raised
from it), through the bank view (the kernels' multiply-shift bank,
``mibf.bank_of``) at ranks past 2^32.  Every window entry must be raised
exactly once."""

import numpy as np
import pytest
import torch

from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.path import consume as tcons

MASK32 = 0xFFFFFFFF


def slice_of(W, rank, n):
    per = -(-W // n)
    lo = min(W, rank * per)
    return lo, min(W, lo + per)


def div32(n, d):
    """Div32: n // d from the multiply-high of n by floor((2^32 - 1) / d)
    and one correction."""
    q = (n * (MASK32 // d)) >> 32
    return q + int(n - q * d >= d)


class Window:
    """MaxWindow: H spans of L = tiles * F keys, entry e at seed e // L
    and span column e % L, both from Div32; a key's value from its
    column."""

    def __init__(self, H, tiles, F, bs, base, trimmed, or_bits):
        self.L, self.W = tiles * F, tiles * F * H
        self.F, self.bs = F, bs
        self.first = or_bits | (base + int(trimmed and bs == 1))

    def at(self, e):
        s = div32(e, max(self.L, 1))
        return s, e - s * self.L

    def value(self, c):
        return (self.first + div32(c, self.F * self.bs)) & MASK32


class BankView:
    """The table as the kernels reach it: n banks of bank_len entries, key
    k in bank bank_of(k) (no division) at k - bank * bank_len; entries
    held sparsely, each starting at initial(k)."""

    def __init__(self, n, bank_len, initial):
        self.n, self.bank_len, self.initial = n, bank_len, initial
        self.banks = [dict() for _ in range(n)]

    def where(self, k):
        b = tdm.bank_of(k, self.bank_len) if self.n > 1 else 0
        assert 0 <= b < self.n and b == k // self.bank_len
        return b, k - b * self.bank_len

    def raise_max(self, k, limit, v):
        if k < 0 or k >= limit:
            return
        b, off = self.where(k)
        cur = self.banks[b].get(off, self.initial(k))
        self.banks[b][off] = max(cur, v)

    def value(self, k):
        b, off = self.where(k)
        return self.banks[b].get(off, self.initial(k))


def model_loaded(view, grid, T, F, lo, last, limit, or_bits, base, trimmed,
                 bs, threads, seen):
    """insert_max_loaded over `threads` threads: tiles lo..last from the
    grid, thread j taking entries j, j + threads, ..."""
    H, TF = grid.shape
    if last < lo:
        return
    w = Window(H, last - lo + 1, F, bs, base, trimmed, or_bits)
    for j in range(min(threads, w.W)):
        for e in range(j, w.W, threads):
            s, c = w.at(e)
            seen[s, lo * F + c] += 1
            view.raise_max(int(grid[s, lo * F + c]), limit, w.value(c))


def model_staged(view, grid, nt, F, lo, last, limit, or_bits, base,
                 trimmed, bs, owners, cap, seen):
    """stage_max_slice on each owner (its slice of the window of tiles
    0..nt-1 into `cap` slots of shared memory), then insert_max_staged."""
    H, TF = grid.shape
    w = Window(H, nt, F, bs, base, trimmed, or_bits)
    stages = []
    for rank in range(owners):
        e0, e1 = slice_of(w.W, rank, owners)
        assert e1 - e0 <= cap
        stage = np.full(cap, -1, np.int64)
        for j in range(e1 - e0):
            s, c = w.at(e0 + j)
            stage[j] = grid[s, c]
        stages.append(stage)
    if last < lo:
        return
    assert lo >= 0 and last < nt
    a, b = lo * F, (last + 1) * F
    for rank in range(owners):
        e0, e1 = slice_of(w.W, rank, owners)
        for j in range(e1 - e0):
            s, c = w.at(e0 + j)
            if a <= c < b:
                seen[s, c] += 1
                view.raise_max(int(stages[rank][j]), limit,
                               w.value(c - a))


def reference(grid, keys, initial, lo, hi, base, trimmed, bs, T, limit,
              or_bits):
    """_insert_max_plain on the table compacted to the grid's real keys
    (a key's maximum depends on its own entries alone): key -> value."""
    index = {int(k): i for i, k in enumerate(keys)}
    comp = np.vectorize(lambda k: index.get(int(k), len(keys)),
                        otypes=[np.int64])(grid)
    table = torch.tensor([initial(int(k)) for k in keys] + [0],
                         dtype=torch.int64).to(torch.int32)
    tdm._insert_max_plain(table, torch.from_numpy(comp), lo, hi, base,
                          trimmed, bs, T, len(keys), or_bits)
    return {int(k): int(table[i]) for i, k in enumerate(keys)}


# name: (H, T, F, keys: "slots" below a limit with sentinels, or "ranks"
# around and past 2^32 in two banks)
SHAPES = {
    "bench_h3_f1000": (3, 5, 1000, "slots"),
    "odd_f": (3, 12, 7, "slots"),
    "stride8_f125": (3, 9, 125, "slots"),
    "one_seed": (1, 24, 40, "slots"),
    "ranks_2_banks": (3, 6, 250, "ranks"),
    "ranks_odd_f": (2, 11, 33, "ranks"),
}
# (lo, hi, trimmed, base): whole, trimmed, one tile, past the bucket,
# empty, ids near 2^30
RANGES = [(0, 99, False, 5), (1, -2, True, 70), (2, 2, True, 9),
          (3, 120, False, 11), (4, 3, False, 1),
          (0, 99, True, tdm.ID_MASK - 40)]


@pytest.mark.parametrize("owners", [130, 7])
@pytest.mark.parametrize("bs", [1, 3, 10, 20])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_insert_max_model_matches_plain(shape, bs, owners):
    """``owners``: the key owners that stage a probed read (an H100's
    130, and few, whose slices cross spans more often)."""
    H, T, F, space = SHAPES[shape]
    rng = np.random.default_rng([H, T, F, bs, owners])
    if space == "slots":
        limit, n_banks, or_bits = 50_021, 1, tdm.PRESENT_BIT
        bank_len = limit + 1
        grid = rng.integers(0, 5_000, (H, T * F))
        grid[:, -F // 3:] = limit                    # invalid frames
        grid[rng.random(grid.shape) < 0.05] = limit
    else:
        bank_len = (1 << 32) + 3 * (1 << 20) + 7
        limit, n_banks, or_bits = 2 * bank_len - 5, 2, 0
        pool = np.concatenate([
            (1 << 32) - 2_000 + np.arange(4_000),    # 2^32 in bank 0
            bank_len - 1_000 + np.arange(2_000),     # across the banks
            limit - 500 + np.arange(500),            # the last ranks
            np.arange(1_000)])
        grid = rng.choice(pool, (H, T * F))
        grid[rng.random(grid.shape) < 0.05] = limit  # the sentinel rank
    grid[:, 2 * F: 3 * F] = grid[0, 2 * F]           # one key a whole tile
    keys = np.unique(grid[grid < limit])

    def initial(k):
        return or_bits | ((k * 2654435761) % 97)
    for lo, hi, trimmed, base in RANGES:
        hi = hi if hi >= 0 else T + hi
        last = min(hi, T - 1)
        want = reference(grid, keys, initial, lo, hi, base, trimmed, bs, T,
                         limit, or_bits)
        W = H * max(0, last - lo + 1) * F
        window = np.zeros((H, T * F), bool)
        window[:, lo * F: (last + 1) * F] = last >= lo
        # the consume kernel's grid, and the standalone launch's: one
        # thread a key
        runs = [("consume", 132 * 512), ("standalone", max(1, W))]
        for branch, threads in runs:
            view = BankView(n_banks, bank_len, initial)
            seen = np.zeros((H, T * F), np.int64)
            model_loaded(view, grid, T, F, lo, last, limit, or_bits, base,
                         trimmed, bs, threads, seen)
            assert (seen == window).all(), branch
            assert {k: view.value(int(k)) for k in keys} == want, branch
        # staged: the owners, each holding its slice of the read's whole
        # window (a cap that just fits), then a cap one short, which the
        # kernel refuses (the loaded branch above)
        cap = -(-H * T * F // owners)
        assert tcons.stage_fits(H, T, F, owners, cap)
        assert not tcons.stage_fits(H, T, F, owners, cap - 1)
        assert not tcons.stage_fits(H, 0, F, owners, cap)
        view = BankView(n_banks, bank_len, initial)
        seen = np.zeros((H, T * F), np.int64)
        model_staged(view, grid, T, F, lo, last, limit, or_bits, base,
                     trimmed, bs, owners, cap, seen)
        assert (seen == window).all(), "staged"
        assert {k: view.value(int(k)) for k in keys} == want, "staged"


def test_div32_is_the_quotient():
    """Div32's multiply-high and one correction give n // d for every n <
    2^31 and d >= 1: the path's block widths (F * bs) and divisors at the
    edges of the proof, on numerators at and beside multiples of d."""
    rng = np.random.default_rng(3)
    ds = [1, 2, 3, 7, 10, 125, 1000, 3000, 20_000, 65_537, (1 << 16) - 1,
          (1 << 30) - 1, 1 << 30, (1 << 31) - 1]
    ds += [int(x) for x in rng.integers(1, 1 << 31, 40)]
    for d in ds:
        ns = [0, 1, d - 1, d, d + 1, (1 << 31) - 1, (1 << 31) - 2]
        ns += [int(x) for x in rng.integers(0, 1 << 31, 300)]
        q = rng.integers(0, max(1, ((1 << 31) - 1) // d), 100)
        ns += [int(x) * d + r for x in q for r in (-1, 0, 1)]
        for n in ns:
            if 0 <= n < 1 << 31:
                assert div32(n, d) == n // d, (n, d)


def test_stage_budget_holds_a_bench_read():
    """The consume kernel's default staging budget holds a bench read (20
    tiles of 1,000 frames, three insert seeds) on the 130 key owners of an
    H100, and not a 140 kb read of phase 3 (which takes the loaded
    branch)."""
    cap = tcons.STAGE_BYTES // 8
    _, owners = tcons.launch_shape(132)
    assert tcons.stage_fits(3, 20, 1000, owners, cap)
    assert not tcons.stage_fits(3, 140, 1000, owners, cap)
