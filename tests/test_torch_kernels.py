"""The hand-written CUDA kernels of goldrush_tpu_torch against their plain
PyTorch versions, bit for bit, on a card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor tests/conftest.py, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from goldrush_tpu_torch import hard_cases as hard
from goldrush_tpu_torch import kernels
from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.ops.nthash import build_seed_family
from goldrush_tpu_torch.ops.seeds import make_seed_pattern
from goldrush_tpu_torch.path.classify import classify_batch, row_cummax
from goldrush_tpu_torch.path.engine import GoldenPathEngine
from goldrush_tpu_torch.utils import synth

pytestmark = pytest.mark.gpu
FAM = build_seed_family(make_seed_pattern("1011011110110111101101", 22, 16, 3))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def reads_batch(rng, lengths, width):
    codes = np.zeros((len(lengths), width), np.uint8)
    for i, L in enumerate(lengths):
        codes[i, :L] = rng.integers(0, 4, L)
    return torch.from_numpy(codes), torch.tensor(lengths, dtype=torch.int32)


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
def test_seed_hash_grid_and_fill(cuda, mode):
    rng = np.random.default_rng(1)
    params = tdm.MibfParams(size=142_368_384, h=3, k=22, spans=FAM.spans,
                            tile_length=1000, slot_map=mode)
    T = 20
    codes, lens = reads_batch(rng, [20_000, 19_999, 5_432, 999, 0, 20_500],
                              T * 1000 + 1000)
    got = tdm.build_slot_grid(codes.to(cuda), lens.to(cuda), FAM, params, T)
    assert_same(got, tdm.build_slot_grid(codes, lens, FAM, params, T))
    words = torch.zeros(params.alloc, dtype=torch.int32)
    before = (kernels.SEED_HASH_FILL.launches, kernels.PRESENCE_MERGE.launches)
    wk = tdm.fill_presence(words.to(cuda), codes.to(cuda), lens.to(cuda),
                           FAM, params.size, mode)
    wp = tdm.fill_presence(words, codes, lens, FAM, params.size, mode)
    assert torch.equal(wk.cpu(), wp) and int((wp != 0).sum()) > 100_000
    assert (kernels.SEED_HASH_FILL.launches, kernels.PRESENCE_MERGE.launches) \
        == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
def test_seed_hash_fill_bits_and_merge(cuda, mode):
    """Kernel A's fill into one bitmap over several batches, one of them
    32,768 wide for reads of at most 2,000 bases (most of its CTAs hold no
    frame), then the merge into words holding ids and saturation bits, as
    an OR and as the words' first write, all against the plain versions;
    and the merge alone on sizes that end inside a 4-slot group and a
    bitmap word."""
    rng = np.random.default_rng(2)
    size = 1_000_003
    bits_k = tdm.presence_bitmap(size, cuda)
    bits_p = tdm.presence_bitmap(size, device="cpu")
    for lengths, width in [([20_000, 19_999, 5_432, 999, 21, 0], 21_000),
                           ([2_000, 1_024, 1_023, 22, 23], 32_768),
                           ([4_096] * 8, 4_096)]:
        codes, lens = reads_batch(rng, lengths, width)
        tdm.fill_presence_bits(bits_k, codes.to(cuda), lens.to(cuda), FAM,
                               size, mode)
        tdm.fill_presence_bits(bits_p, codes, lens, FAM, size, mode)
        assert torch.equal(bits_k.cpu(), bits_p)
    alloc = -(-(size + 1) // 1024) * 1024
    w = torch.from_numpy(rng.integers(-2**31, 2**31, alloc, dtype=np.int64)
                         .astype(np.int32))
    for first in (False, True):
        wk = tdm.merge_presence(w.to(cuda), bits_k, size, first)
        wp = tdm.merge_presence(w.clone(), bits_p, size, first)
        assert torch.equal(wk.cpu(), wp) and not torch.equal(wp, w)
    # the merge alone, both forms, the first write on dirty words
    for n in (31, 33, 1_000_001, 1_000_003):
        b = torch.from_numpy(rng.integers(-2**31, 2**31, -(-n // 32),
                                          dtype=np.int64).astype(np.int32))
        for first in (False, True):
            assert torch.equal(
                tdm.merge_presence(w.to(cuda), b.to(cuda), n, first).cpu(),
                tdm.merge_presence(w.clone(), b, n, first))


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
@pytest.mark.parametrize("case", list(hard.grid_lengths(1000, 22)))
def test_seed_hash_grid_cases(cuda, case, mode):
    """Kernel A's grid against its plain version on the lengths its tiles
    and stale-tail clamp branch on (goldrush_tpu_torch/hard_cases.py), at
    the path's tile length."""
    params = tdm.MibfParams(size=142_368_384, h=3, k=22, spans=FAM.spans,
                            tile_length=1000, slot_map=mode)
    lengths, T = hard.grid_lengths(1000, 22)[case]
    codes, lens = (torch.from_numpy(a) for a in
                   hard.read_batch(lengths, T * 1000 + 1000, seed=len(case)))
    got = tdm.build_slot_grid(codes.to(cuda), lens.to(cuda), FAM, params, T)
    assert_same(got, tdm.build_slot_grid(codes, lens, FAM, params, T))


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
@pytest.mark.parametrize("case", list(hard.grid_lengths(1000, 22)))
def test_seed_hash_rank_grid_cases(cuda, case, mode):
    """Kernel A's rank grid against its plain version (the slot grid mapped
    through rank_grid) on the grid cases, at the path's tile length, over a
    frozen filter holding the batch's own slots and random others."""
    size = 1_000_003
    params = tdm.MibfParams(size=size, h=3, k=22, spans=FAM.spans,
                            tile_length=1000, slot_map=mode)
    lengths, T = hard.grid_lengths(1000, 22)[case]
    codes, lens = (torch.from_numpy(a) for a in
                   hard.read_batch(lengths, T * 1000 + 1000, seed=len(case)))
    rng = np.random.default_rng(len(case))
    bits = torch.from_numpy(rng.integers(0, 2**31, -(-size // 32),
                                         dtype=np.int64).astype(np.int32))
    tdm.fill_presence_bits(bits, codes, lens, FAM, size, mode)
    host = tcz.with_tables(*tcz.build_rank(bits, size), size)
    dev = tcz.with_tables(*tcz.build_rank(bits.to(cuda), size), size)
    before = kernels.SEED_HASH_RANK_GRID.launches
    got = tcz.build_rank_grid(dev, codes.to(cuda), lens.to(cuda), FAM, params,
                              T)
    assert kernels.SEED_HASH_RANK_GRID.launches == before + 1
    assert_same(got, tcz.build_rank_grid(host, codes, lens, FAM, params, T))


@pytest.mark.parametrize("ranked", [False, True])
@pytest.mark.parametrize("mode", ["fastrange", "mod"])
@pytest.mark.parametrize("h,S", [(1, 8), (3, 2), (3, 4), (1, 5)])
@pytest.mark.parametrize("case", list(hard.grid_lengths(1000, 22)))
def test_seed_hash_grid_strided_cases(cuda, case, h, S, mode, ranked):
    """Kernel A's slot and rank grids at a frame stride against their plain
    versions (the JAX package's sampled routes: the last-tile grid at
    S >= h, the general one below) on the grid cases, for the throughput
    mode's one probed seed and for all three."""
    size = 1_000_003
    fam = FAM if h == 3 else build_seed_family(
        make_seed_pattern("1011011110110111101101", 22, 16, 3)[:h])
    params = tdm.MibfParams(size=size, h=h, k=22, spans=fam.spans,
                            tile_length=1000, frame_stride=S, slot_map=mode)
    lengths, T = hard.grid_lengths(1000, 22)[case]
    codes, lens = (torch.from_numpy(a) for a in
                   hard.read_batch(lengths, T * 1000 + 1000, seed=len(case)))
    if not ranked:
        got = tdm.build_slot_grid(codes.to(cuda), lens.to(cuda), fam, params,
                                  T)
        assert_same(got, tdm.build_slot_grid(codes, lens, fam, params, T))
        return
    rng = np.random.default_rng(len(case))
    bits = torch.from_numpy(rng.integers(0, 2**31, -(-size // 32),
                                         dtype=np.int64).astype(np.int32))
    host = tcz.with_tables(*tcz.build_rank(bits, size), size)
    dev = tcz.with_tables(*tcz.build_rank(bits.to(cuda), size), size)
    got = tcz.build_rank_grid(dev, codes.to(cuda), lens.to(cuda), fam,
                              params, T)
    assert_same(got, tcz.build_rank_grid(host, codes, lens, fam, params, T))


# (query stride, insert stride, query seeds): bench.py's throughput cell,
# a sampled insert grid, and the trim recheck's S=1 tier of one seed
FUSED = [(8, 1, 1), (8, 2, 1), (1, 1, 1), (4, 2, 2)]


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
@pytest.mark.parametrize("S,s_ins,hq", FUSED)
@pytest.mark.parametrize("ranked", [False, True])
def test_fused_grid_matches_separate_launches(cuda, ranked, S, s_ins, hq,
                                              mode):
    """Kernel A's insert grid with the query grid written by the same
    launch (build_slot_grids / build_rank_grids) against the two separate
    launches and against the plain versions, bit for bit, on the grid
    cases at the path's tile length; one launch each."""
    size = 1_000_003
    seeds = make_seed_pattern("1011011110110111101101", 22, 16, 3)
    fq = build_seed_family(seeds[:hq])
    pq = tdm.MibfParams(size=size, h=hq, k=22, spans=fq.spans,
                        tile_length=1000, frame_stride=S, slot_map=mode)
    pi = tdm.MibfParams(size=size, h=3, k=22, spans=FAM.spans,
                        tile_length=1000, frame_stride=s_ins, slot_map=mode)
    rng = np.random.default_rng([S, s_ins, hq])
    bits = torch.from_numpy(rng.integers(0, 2**31, -(-size // 32),
                                         dtype=np.int64).astype(np.int32))
    host = tcz.with_tables(*tcz.build_rank(bits, size), size)
    dev = tcz.with_tables(*tcz.build_rank(bits.to(cuda), size), size)
    kern = kernels.SEED_HASH_RANK_GRID if ranked else kernels.SEED_HASH_GRID
    for case, (lengths, T) in hard.grid_lengths(1000, 22).items():
        codes, lens = (torch.from_numpy(a) for a in hard.read_batch(
            lengths, T * 1000 + 1000, seed=len(case)))
        c, n = codes.to(cuda), lens.to(cuda)
        if ranked:
            def one(p, fam, st, cc, nn):
                return tcz.build_rank_grid(st, cc, nn, fam, p, T)
            fused = tcz.build_rank_grids
            st_d, st_h = (dev,), (host,)
        else:
            def one(p, fam, st, cc, nn):
                return tdm.build_slot_grid(cc, nn, fam, p, T)
            fused = tdm.build_slot_grids
            st_d = st_h = ()
        before = kern.launches
        got = fused(*st_d, c, n, FAM, pi, pq, T)
        assert kern.launches == before + 1
        apart = (*one(pq, fq, dev, c, n), *one(pi, FAM, dev, c, n))
        assert_same(got, apart)
        assert_same(got, fused(*st_h, codes, lens, FAM, pi, pq, T))


@pytest.mark.parametrize("space", ["slots", "ranks"])
@pytest.mark.parametrize("kind", ["homopolymer", "one_partition", "random"])
def test_insert_max_cases(cuda, space, kind):
    """insert_max against its plain version in both key spaces (slots:
    PRESENT | id words; ranks: bare ids), bs 1, 3 and 10, whole and trimmed
    recruits, one past the bucket, an empty tile range and ids up to
    ID_MASK, over keys that repeat within and across blocks and sentinel
    entries."""
    rng = np.random.default_rng([len(space), len(kind)])
    T, F = 24, 1000
    limit = 10_000_019 if space == "slots" else 3_999_999
    or_bits = tdm.PRESENT_BIT if space == "slots" else 0
    grid = hard_grid(rng, kind, limit, T, F)
    n = -(-(limit + 1) // 1024) * 1024
    w = rng.integers(0, 1 << 20, n).astype(np.int32) | or_bits
    host = torch.from_numpy(w.copy())
    dev = host.to(cuda)
    grid_d = grid.to(cuda)
    before = kernels.INSERT_MAX.launches
    calls = 0
    for bs in (1, 3, 10):
        params = tdm.MibfParams(size=limit, h=3, k=22, spans=FAM.spans,
                                tile_length=F, block_size=bs)
        for lo, hi, tr, base in [(0, T - 1, False, 5 + bs),
                                 (3, T - 2, True, 70 + bs),
                                 (20, T + 5, False, 90), (7, 6, False, 1),
                                 (0, T - 1, True, tdm.ID_MASK - 30)]:
            tdm.insert_max(dev, grid_d, lo, hi, base, tr, params, T, limit,
                           or_bits)
            tdm.insert_max(host, grid, lo, hi, base, tr, params, T, limit,
                           or_bits)
            calls += lo <= min(hi, T - 1)
            assert torch.equal(dev.cpu(), host)
    assert kernels.INSERT_MAX.launches == before + calls
    assert int((host != torch.from_numpy(w)).sum()) >= 3


@pytest.mark.parametrize("banks", [1, 2])
@pytest.mark.parametrize("F,shift", [(1000, 0), (1000, 1), (125, 0),
                                     (125, 1), (7, 1)])
def test_insert_max_rows_and_banks(cuda, F, shift, banks):
    """insert_max's rows (csrc/insert.cuh): tiles of an odd number of
    frames, a grid whose first key is not 16-byte aligned (the head and
    tail keys of a row loaded alone), one and two banks of the table on
    the card, against the plain version on the whole table, bs 1, 3, 10
    and 20, whole, trimmed, one-tile, past-the-bucket and empty ranges."""
    rng = np.random.default_rng([F, shift, banks])
    T, H, limit = 24, 3, 2_000_003
    buf = torch.from_numpy(rng.integers(0, limit, H * T * F + 1))
    buf[torch.from_numpy(rng.random(buf.numel()) < 0.05)] = limit
    grid = buf[shift: shift + H * T * F].view(H, T * F)
    n = -(-(limit + 1) // 1024) * 1024
    # ids below the recruits' (5-100), so that most keys take a new one
    w = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)
                         | tdm.PRESENT_BIT)
    host = w.clone()
    table = tdm.to_banks(w, [cuda] * banks)
    grid_d = buf.to(cuda)[shift: shift + H * T * F].view(H, T * F)
    assert grid_d.data_ptr() % 16 == 8 * shift
    for bs in (1, 3, 10, 20):
        params = tdm.MibfParams(size=limit, h=3, k=22, spans=FAM.spans,
                                tile_length=F, block_size=bs)
        for lo, hi, tr, base in [(0, T - 1, False, 5 + bs),
                                 (3, T - 2, True, 70 + bs), (5, 5, True, 9),
                                 (20, T + 5, False, 90), (7, 6, False, 1)]:
            tdm.insert_max(table, grid_d, lo, hi, base, tr, params, T, limit,
                           tdm.PRESENT_BIT)
            tdm.insert_max(host, grid, lo, hi, base, tr, params, T, limit,
                           tdm.PRESENT_BIT)
            assert torch.equal(tdm.whole(table).cpu(), host)
    assert int((host != w).sum()) > H * T * F // 10


@pytest.mark.parametrize("stage", ["staged", "loaded"])
@pytest.mark.parametrize("case", ["opt-direct", "opt-compressed-rotation",
                                  "s5-p1-opt-direct-recheck",
                                  "s5-is5-p1-opt-compressed"])
def test_consume_insert_max_branches(cuda, tmp_path, monkeypatch, case,
                                     stage):
    """The consume kernel's insert_max on both branches: a probed read's
    keys staged in its owners' shared memory while it is classified (the
    default budget), or read from the grid at the insert (no staging),
    against consume_batch_plain, bit for bit."""
    from goldrush_tpu_torch.path import consume as tcons
    if stage == "loaded":
        monkeypatch.setattr(tcons, "STAGE_BYTES", 0)
    test_consume_matches_plain(cuda, tmp_path, case)


@pytest.mark.parametrize("bs,T", [(3, 6), (20, 24)])
def test_probe_vote_and_insert(cuda, bs, T):
    """bs=20 at T=24: the insert kernel takes a 72,000-entry window in one
    launch, each CTA the keys insert_part gives it (in shared memory,
    since random keys spread over every CTA)."""
    rng = np.random.default_rng(bs)
    size = 1_000_003
    params = tdm.MibfParams(size=size, h=3, k=22, spans=FAM.spans,
                            tile_length=1000, threshold=4, block_size=bs,
                            vote_topk=8)
    codes, lens = reads_batch(rng, [T * 1000, T * 1000 - 300, 2500, 0],
                              T * 1000 + 1000)
    slots, ok = tdm.build_slot_grid(codes, lens, FAM, params, T)
    w = rng.integers(0, 9, params.alloc).astype(np.uint32)
    w |= np.uint32(tdm.PRESENT_BIT)
    c = rng.integers(0, 3, params.alloc).astype(np.uint32)
    host = tdm.state_from_numpy(w, c, device="cpu")
    dev = tdm.state_from_numpy(w, c, cuda)
    for i, (lo, hi, base, tr) in enumerate([(0, T - 1, 3, False),
                                            (1, T - 2, 9, True),
                                            (0, 1, 40, False)]):
        tdm.insert_read_sorted(host, slots[i], lo, hi, base, tr, params, T)
        tdm.insert_read_sorted(dev, slots[i].to(cuda), lo, hi, base, tr,
                               params, T)
        assert_same(dev, host)
    for rows in (slice(0, 4), slice(1, 2)):
        s, o = slots[rows].contiguous(), ok[rows].contiguous()
        assert_same(tdm.probe_and_vote(dev.words, s.to(cuda), o.to(cuda),
                                       params, T),
                    tdm.probe_and_vote(host.words, s, o, params, T))


def hard_grid(rng, kind, limit, T, F):
    """A [3, T*F] key grid with a sentinel tail: one repeated k-mer, keys
    all owned by the kernel's first CTA, or uniform keys."""
    if kind == "homopolymer":
        g = np.repeat(rng.integers(0, limit, (3, 1)), T * F, axis=1)
    elif kind == "one_partition":
        keys = torch.from_numpy(rng.integers(0, limit, 1_000_000))
        pool = keys[tdm.insert_part(keys) == 0].numpy()
        g = pool[rng.integers(0, len(pool), (3, T * F))]
    else:
        g = rng.integers(0, limit, (3, T * F))
    g[:, -377:] = limit
    return torch.from_numpy(g.astype(np.int64))


@pytest.mark.parametrize("near_max", [False, True])
@pytest.mark.parametrize("kind", ["homopolymer", "one_partition", "random"])
@pytest.mark.parametrize("space", ["slots", "ranks"])
def test_insert_hard_cases(cuda, space, kind, near_max):
    """Kernel D against its plain version in both key spaces (slots:
    PRESENT | id words; ranks: bare ids), bs 1, 3, 10 and 20, whole and
    trimmed recruits, counters that wrap past 0xFFFFFFFF.  A repeated
    k-mer or keys of one CTA put a 24-tile window's 72,000 entries into
    three CTAs or one, past INSERT_CAP: the global-scratch path."""
    rng = np.random.default_rng([len(space), len(kind), int(near_max)])
    T, F = 24, 1000
    limit = 10_000_019 if space == "slots" else 3_999_999
    or_bits = tdm.PRESENT_BIT if space == "slots" else 0
    grid = hard_grid(rng, kind, limit, T, F)
    if kind != "random":            # each seed's entries overflow alone
        assert T * F - 377 > tdm.INSERT_CAP
    n = -(-(limit + 1) // 1024) * 1024
    w = rng.integers(0, 1 << 30, n).astype(np.uint32)
    c = (0xFFFFFFFF - rng.integers(0, 4, n) if near_max
         else rng.integers(0, 5, n)).astype(np.uint32)
    host = [torch.from_numpy(a.view(np.int32).copy()) for a in (w, c)]
    dev = [t.to(cuda) for t in host]
    grid_d = grid.to(cuda)
    for bs in (1, 3, 10, 20):
        params = tdm.MibfParams(size=limit, h=3, k=22, spans=FAM.spans,
                                tile_length=F, block_size=bs)
        for lo, hi, tr, base in [(0, T - 1, False, 5 + bs),
                                 (3, T - 2, True, 70 + bs)]:
            tdm.insert_blocks(*dev, grid_d, lo, hi, base, tr, params, T,
                              limit, or_bits)
            tdm.insert_blocks(*host, grid, lo, hi, base, tr, params, T,
                              limit, or_bits)
            assert_same(dev, host)
    assert int((host[1] != torch.from_numpy(c.view(np.int32))).sum()) >= 3


@pytest.mark.parametrize("kind", ["homopolymer", "one_partition", "random"])
@pytest.mark.parametrize("space", ["slots", "ranks"])
def test_insert_read_keep_and_rank_map(cuda, space, kind):
    """Kernel D as the blockwise insert_read runs it, against its plain
    version: the direct filter's words keep SAT and PRESENT (set at random
    beforehand), the compressed filter's slot grid mapped to ranks inside
    the launch (absent slots and the sentinel never insert) and its ids
    keep SAT; blocks of 1, 3 and 10 tiles, max_blocks below and at the
    block count, whole and trimmed recruits.  A repeated k-mer or keys of
    one CTA take the global-scratch path, which re-reads the window
    through the rank map."""
    rng = np.random.default_rng([len(space), len(kind), 7])
    T, F, size = 24, 1000, 10_000_019
    grid = hard_grid(rng, kind, size, T, F)
    if space == "slots":
        n = -(-(size + 1) // 1024) * 1024
        w = rng.integers(0, 1 << 30, n).astype(np.uint32) | (
            rng.integers(0, 4, n).astype(np.uint32) << 30)
        c = rng.integers(0, 5, n).astype(np.uint32)
        host = tdm.state_from_numpy(w, c, device="cpu")
    else:
        w = None
        bits = torch.from_numpy(
            rng.integers(-(1 << 31), 1 << 31, -(-size // 32),
                         dtype=np.int64).astype(np.int32))
        host = tcz.with_tables(*tcz.build_rank(bits, size), size)
        n = host.ids.shape[0]
        host.ids.copy_(torch.from_numpy(
            (rng.integers(0, 1 << 30, n) | (rng.integers(0, 2, n) << 31))
            .astype(np.uint32).view(np.int32)))
        host.counts.copy_(torch.from_numpy(
            rng.integers(0, 5, n).astype(np.int32)))
    dev = type(host)(*(t.to(cuda) for t in host))
    grid_d = grid.to(cuda)
    mod = tdm if space == "slots" else tcz
    for bs in (1, 3, 10):
        params = tdm.MibfParams(size=size, h=3, k=22, spans=FAM.spans,
                                tile_length=F, block_size=bs)
        for lo, hi, tr, base in [(0, T - 1, False, 5 + bs),
                                 (3, T - 2, True, 70 + bs)]:
            blocks = -(-(hi - lo + 1) // bs)
            for mb in (max(1, blocks // 2), blocks):
                before = kernels.INSERT_SORTED.launches
                mod.insert_read(dev, grid_d, lo, hi, base, tr, params, mb, T)
                assert kernels.INSERT_SORTED.launches == before + 1
                mod.insert_read(host, grid, lo, hi, base, tr, params, mb, T)
                assert_same(dev, host)
    if w is not None:
        got = host.words.numpy().view(np.uint32)
        changed = got != w
        assert changed.any()
        assert (got[changed] >> 30 == w[changed] >> 30).all()


def batch_inputs(rng, kind, size, B, T, F):
    """A classified batch of B reads of [3, T*F] slot grids whose reads
    share slots (read 1 repeats read 0, read 3 is a trimmed copy of read
    2, drops between them), as hard_grid makes them (one_partition: keys
    owned by the batch launch's first owner), with their verdicts,
    lengths (tile length F) and base ids, on the host."""
    if kind == "one_partition":
        keys = torch.from_numpy(rng.integers(0, size, 2_000_000))
        parts = tdm.batch_parts(B * 3 * T * F)
        pool = keys[tdm.insert_part(keys, parts) == 0].numpy()
        g = pool[rng.integers(0, len(pool), (B, 3, T * F))]
        g[:, :, -377:] = size
        grid = torch.from_numpy(g.astype(np.int64))
    else:
        grid = torch.stack([hard_grid(rng, kind, size, T, F)
                            for _ in range(B)])
    grid[1] = grid[0]
    grid[3] = grid[2]
    dec = np.array([1, 1, 1, 2, 0, 2, 1, 0, 2, 1, 2, 1][:B], np.int32)
    ts = rng.integers(0, T // 2, B).astype(np.int32)
    te = (ts + rng.integers(0, T, B)).astype(np.int32)
    ts[3], te[3] = 2, T - 3
    lengths = rng.integers(F * T // 2, F * (T + 2), B).astype(np.int32)
    base = (5 + 40 * np.arange(B)).astype(np.int64)
    return grid, *(torch.from_numpy(a) for a in (dec, ts, te, lengths, base))


def banked_state(w, c, dev, banks):
    """A direct state of words ``w`` and counters ``c`` on ``dev``, banked
    over ``[dev] * banks`` when banks > 1."""
    if banks == 1:
        return tdm.state_from_numpy(w, c, dev)
    return tdm.state_from_numpy(w, c, [dev] * banks)


@pytest.mark.parametrize("banks", [1, 2])
@pytest.mark.parametrize("kind", ["homopolymer", "one_partition", "random"])
def test_insert_batch_matches_per_recruit(cuda, kind, banks):
    """Kernel D's batch entry (train_step's insert: every recruit of a
    classified batch in one launch, the verdicts read on the card) against
    one launch of kernel D a recruit in batch order (insert_read) and the
    plain version, on one bank and on two of ["cuda:0"] * 2: blocks of 1,
    3 and 10 tiles, max_blocks 1, 2 and past the reads' blocks, words whose
    SAT and PRESENT bits are set at random; then the same batch cut into
    chunks of two reads (five more launches), bit for bit.  A repeated
    k-mer or keys of one owner take the owners' distinct and spill
    paths."""
    rng = np.random.default_rng([len(kind), banks])
    B, T, F, size = 12, 24, 1000, 10_000_019
    grid, dec, ts, te, lengths, base = batch_inputs(rng, kind, size, B, T, F)
    n = -(-(size + 1) // 1024) * 1024
    w = rng.integers(0, 1 << 30, n).astype(np.uint32) | (
        rng.integers(0, 4, n).astype(np.uint32) << 30)
    c = rng.integers(0, 5, n).astype(np.uint32)
    cols = [t.to(cuda) for t in (dec, ts, te, lengths, base)]
    grid_d = grid.to(cuda)
    rows = torch.stack([dec, ts, te, lengths]).t().tolist()
    for bs in (1, 3, 10):
        params = tdm.MibfParams(size=size, h=3, k=22, spans=FAM.spans,
                                tile_length=F, block_size=bs)
        for mb in (1, 2, 100):
            got = banked_state(w, c, cuda, banks)
            before = kernels.INSERT_BATCH.launches
            tdm.insert_batch(got, grid_d, *cols, params, mb, T)
            assert kernels.INSERT_BATCH.launches == before + 1
            per = banked_state(w, c, cuda, banks)
            for i, (d, lo, hi, ln) in enumerate(rows):
                if d:
                    lo, hi = (0, ln // F - 1) if d == 1 else (lo, hi)
                    tdm.insert_read(per, grid_d[i], lo, hi, int(base[i]),
                                    d == 2, params, mb, T)
            host = tdm.state_from_numpy(w, c, device="cpu")
            tdm.insert_batch(host, grid, dec, ts, te, lengths, base, params,
                             mb, T)
            want = (host.words, host.counts)
            assert_same([tdm.whole(t) for t in got], want)
            assert_same([tdm.whole(t) for t in per], want)
    chunked = banked_state(w, c, cuda, banks)
    before = kernels.INSERT_BATCH.launches
    tdm._insert_batch_cuda(chunked.words, chunked.counts, grid_d, *cols,
                           params, T, 100, size, 0,
                           tdm.SAT_BIT | tdm.PRESENT_BIT,
                           window=2 * 3 * T * F)
    assert kernels.INSERT_BATCH.launches == before + B // 2
    assert_same([tdm.whole(t) for t in chunked], want)
    got = host.words.numpy().view(np.uint32)
    changed = got != w
    assert changed.any()
    assert (got[changed] >> 30 == w[changed] >> 30).all()


def train_batch():
    """16 reads of 2 kb from a 20 kb genome packed as 8-tile reads of 250
    (tests/test_torch_train.py's batch), a filter of 200,003 slots
    presence-filled with them, and its geometry."""
    from goldrush_tpu_torch.io.fastq import encode
    genome = synth.random_genome(20_000, seed=7)
    reads = synth.simulate_reads(genome, 16, 2_000, seed=8, err_rate=0.02)
    T, TL = 8, 250
    codes = np.zeros((16, T * TL + TL), np.uint8)
    lengths = np.zeros(16, np.int32)
    for i, (_, seq, _) in enumerate(reads):
        c = encode(seq)[: T * TL + TL - 1]
        codes[i, : len(c)] = c
        lengths[i] = len(c)
    params = tdm.MibfParams(size=200_003, h=3, k=22, spans=FAM.spans,
                            tile_length=TL, block_size=2)
    state = tdm.init_state(params, device="cpu")
    tdm.fill_presence(state.words, torch.from_numpy(codes),
                      torch.from_numpy(lengths), FAM, params.size)
    return torch.from_numpy(codes), torch.from_numpy(lengths), state, params, T


@pytest.mark.parametrize("layout", ["single", "1x2", "2x1"])
def test_train_step_one_insert_launch(cuda, layout):
    """train_step (one card) and sharded_train_step (1x2 banked, 2x1 on
    ["cuda:0"] * 2) on the card: A's grid, B, C and one launch of kernel
    D's batch entry a data row a step, no single-recruit D, and no host
    synchronisation in the step (torch.cuda's sync debug mode raises on
    one); two steps of 8 reads, replicas and decisions bit for bit with
    the plain train_step on the CPU."""
    from goldrush_tpu_torch.parallel import mesh as tmesh
    codes, lengths, state, params, T = train_batch()
    host = tdm.MibfState(state.words.clone(), state.counts.clone())
    if layout == "single":
        dev_state, rows = tdm.MibfState(state.words.to(cuda),
                                        state.counts.to(cuda)), 1
        step = None
    else:
        data, model = (1, 2) if layout == "1x2" else (2, 1)
        mesh = tmesh.make_mesh(2, data=data, model=model, devices=[cuda] * 2)
        dev_state = tmesh.shard_state(state, mesh, model > 1)
        step = tmesh.sharded_train_step(mesh, FAM, params, T, 2, model > 1)
        rows = data
    path = (kernels.SEED_HASH_GRID, kernels.PROBE_VOTE, kernels.CLASSIFY,
            kernels.INSERT_BATCH, kernels.INSERT_SORTED)
    for k in range(2):
        sl = slice(8 * k, 8 * (k + 1))
        base = torch.arange(1 + 8 * k, 9 + 8 * k, dtype=torch.int64)
        c, n, b = codes[sl].to(cuda), lengths[sl].to(cuda), base.to(cuda)
        before = [kk.launches for kk in path]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            if step is None:
                dev_state, dec = tmesh.train_step(dev_state, c, n, b, FAM,
                                                  params, T, 2)
            else:
                dev_state, dec = step(dev_state, c, n, b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launched = [kk.launches - x for kk, x in zip(path, before)]
        assert launched == [rows, rows, rows, rows, 0]
        host, want = tmesh.train_step(host, codes[sl], lengths[sl], base,
                                      FAM, params, T, 2)
        assert torch.equal(dec.cpu(), want)
        for rep in (dev_state if step else [dev_state]):
            assert torch.equal(tdm.whole(rep.words).cpu(), host.words)
            assert torch.equal(tdm.whole(rep.counts).cpu(), host.counts)
    assert int((host.counts != 0).sum()) > 1_000


def random_tables(rng, B, T, K, n_ids):
    curr_id = np.zeros((B, T), np.int32)
    ci = np.zeros((B, T, K), np.int32)
    cc = np.zeros((B, T, K), np.int32)
    for b in range(B):
        for t in range(T):
            ids = rng.choice(np.arange(1, n_ids + 1), replace=False,
                             size=min(int(rng.integers(0, K + 1)), n_ids))
            counts = rng.integers(3, 40, len(ids))
            order = np.lexsort((ids, -counts))
            ci[b, t, :len(ids)] = ids[order]
            cc[b, t, :len(ids)] = counts[order]
            curr_id[b, t] = ci[b, t, 0] if len(ids) else n_ids // 2
    n = rng.integers(0, T + 1, B).astype(np.int32)
    n[:8] = [0, 1, 2, 3, 14, 15, 16, T]
    return [torch.from_numpy(a) for a in
            (curr_id, np.zeros_like(curr_id), ci, cc, n)]


@pytest.mark.parametrize("n_ids,K,T", [(6, 8, 20), (40, 32, 20),
                                       (12, 8, 160)])
def test_classify(cuda, n_ids, K, T):
    args = random_tables(np.random.default_rng(n_ids), 64, T, K, n_ids)
    got = classify_batch(*(a.to(cuda) for a in args), 10, 5, 1, debug=True)
    want = classify_batch(*args, 10, 5, 1, debug=True)
    assert_same(got[0], want[0])
    assert_same(got[1:], want[1:])



@pytest.mark.parametrize("vote_min", [2, 0])
@pytest.mark.parametrize("ranked", [False, True])
def test_probe_vote_hard_cases(cuda, ranked, vote_min):
    """Kernel B against its plain version at the main path's widths (H=3,
    F=1000, K=32) on the tiles of goldrush_tpu_torch/hard_cases.py, each
    kind in turn, at B=32 and for single reads (B=1).  A vote_min of 0
    makes every distinct id a candidate: past the CTA's thread count the kernel sorts
    its whole table."""
    T, F, K = 20, 1000, 32
    params = tdm.MibfParams(size=1 << 20, h=3, k=22, spans=FAM.spans,
                            tile_length=F, threshold=10, vote_topk=K,
                            vote_min=vote_min)
    grid, ok = hard.vote_case(None, 32, T, F, 3, K, vote_min, 10, seed=3)
    w = hard.vote_words()
    if ranked:
        w = np.append(w & np.uint32(~tdm.PRESENT_BIT & 0xFFFFFFFF),
                      np.uint32(0))
        grid = np.where(grid == hard.ABSENT, w.size - 1, grid)
    words = torch.from_numpy(w.view(np.int32).copy()).to(cuda)
    grid, ok = torch.from_numpy(grid).to(cuda), torch.from_numpy(ok).to(cuda)
    for rows in [slice(0, 32)] + [slice(i, i + 1) for i in (0, 7, 31)]:
        g, o = grid[rows].contiguous(), ok[rows].contiguous()
        got = tdm.probe_and_vote(words, g, o, params, T, ranked)
        assert_same(got, tdm._probe_and_vote_plain(words, g, o, params, T,
                                                   ranked))
    assert int(got.overflow.sum()) > 0


@pytest.mark.parametrize("T", [20, 2048])
def test_classify_hard_cases(cuda, T):
    """Kernel C against its plain version on reads of 0, 1, 2, 3, 14, 15,
    16 and T tiles (T=20, K=32, B=32 and single reads), and on a 2,048-tile
    bucket holding a full, a short, a 1,500-tile and an empty read (its
    candidates staged in chunks of 32 tiles)."""
    n = [0, 1, 2, 3, 14, 15, 16, T] * 4 if T == 20 else [2048, 5, 1500, 0]
    args = [torch.from_numpy(a) for a in hard.classify_case(n, T, 32,
                                                            seed=T)]
    for rows in [slice(0, len(n))] + [slice(i, i + 1) for i in range(8)
                                      if i < len(n)]:
        a = [x[rows].contiguous() for x in args]
        got = classify_batch(*(x.to(cuda) for x in a), 10, 5, 1, debug=True)
        want = classify_batch(*a, 10, 5, 1, debug=True)
        assert_same(got[0], want[0])
        assert_same(got[1:], want[1:])


@pytest.mark.parametrize("R,T", [(32, 20), (1, 20), (4, 2048), (3, 33)])
def test_row_cummax(cuda, R, T):
    """Kernel C's warp cummax launched alone, against torch.cummax."""
    x = torch.from_numpy(np.random.default_rng(T).integers(
        -2**31, 2**31, (R, T)).astype(np.int32))
    before = kernels.ROW_CUMMAX.launches
    assert_same([row_cummax(x.to(cuda))], [torch.cummax(x, 1).values])
    assert kernels.ROW_CUMMAX.launches == before + 1


def test_wrappers_check_their_inputs(cuda):
    params = tdm.MibfParams(size=1000, h=3, k=22, spans=FAM.spans,
                            tile_length=100)
    codes = torch.zeros((2, 600), dtype=torch.uint8, device=cuda)
    lens = torch.full((2,), 500, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tdm.build_slot_grid(codes, lens.long(), FAM, params, 5)
    with pytest.raises(ValueError):
        tdm.build_slot_grid(codes[:, ::2], lens, FAM, params, 5)
    words = torch.zeros(params.alloc, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tdm.fill_presence(words, codes.cpu(), lens, FAM, params.size)
    with pytest.raises(ValueError):
        tdm.fill_presence_bits(tdm.presence_bitmap(params.size, "cpu"),
                               codes, lens, FAM, params.size)
    with pytest.raises(ValueError):
        tdm.merge_presence(words[1:], tdm.presence_bitmap(params.size, cuda),
                           params.size)
    with pytest.raises(ValueError):    # a first write of a partial group
        tdm.merge_presence(words[:-2], tdm.presence_bitmap(params.size, cuda),
                           params.size, first_write=True)
    with pytest.raises(ValueError):    # a tile shorter than k + h - 1
        tdm.build_slot_grid(codes, lens, FAM,
                            dataclasses.replace(params, tile_length=23), 5)
    before = kernels.SEED_HASH_GRID.launches
    tdm.build_slot_grid(codes, lens, FAM, params, 5)
    assert kernels.SEED_HASH_GRID.launches == before + 1
    # an empty tile range launches nothing and is not counted
    state = tdm.init_state(params, cuda)
    slots = torch.zeros((3, 500), dtype=torch.int64, device=cuda)
    before = kernels.INSERT_SORTED.launches
    tdm.insert_read_sorted(state, slots, 3, 2, 1, False, params, 5)
    assert kernels.INSERT_SORTED.launches == before
    tdm.insert_read_sorted(state, slots, 0, 2, 1, False, params, 5)
    assert kernels.INSERT_SORTED.launches == before + 1


@pytest.mark.parametrize("size", [31, 1_000_003, 65_536 * 40])
def test_rank_kernels(cuda, size):
    """rank_build from a bitmap (dirty past size: the freeze, one launch),
    kernel A's rank grid, and kernels B and D on the rank-indexed tables,
    against the plain versions."""
    rng = np.random.default_rng(size)
    bits = torch.from_numpy(rng.integers(-2**31, 2**31, -(-size // 32),
                                         dtype=np.int64).astype(np.int32))
    # the launch alone, its appended word included and its pop not fetched
    before = kernels.RANK_BUILD.launches
    bk, sk, pk = tcz._build_rank_cuda(bits.to(cuda), size)
    assert kernels.RANK_BUILD.launches == before + 1
    bp, sp, pop = tcz._build_rank_plain(bits, size)
    assert_same((bk, sk), (bp, sp)) and int(pk) == pop
    host = tcz.with_tables(*tcz.build_rank(bits, size), size)
    dev = tcz.with_tables(*tcz.build_rank(bits.to(cuda), size), size)
    assert_same(dev, host)
    # the freeze of direct words: their bits packed, then the same kernels
    alloc = -(-(size + 1) // 1024) * 1024
    w = rng.integers(0, 1 << 30, alloc).astype(np.uint32)
    w |= np.where(rng.random(alloc) < 0.3, np.uint32(tdm.PRESENT_BIT),
                  np.uint32(0))
    words = torch.from_numpy(w.view(np.int32).copy())
    host, dev = tcz.freeze(words, size), tcz.freeze(words.to(cuda), size)
    assert_same(dev, host)
    assert int(host.bitrank[-2] >> 32) > 0 or size < 64
    if size < 1000:
        return
    T = 6
    params = tdm.MibfParams(size=size, h=3, k=22, spans=FAM.spans,
                            tile_length=1000, threshold=4, block_size=2,
                            vote_topk=8)
    codes, lens = reads_batch(rng, [6000, 5300, 999, 0], T * 1000 + 1000)
    ranks, ok = tcz.build_rank_grid(host, codes, lens, FAM, params, T)
    assert_same(tcz.build_rank_grid(dev, codes.to(cuda), lens.to(cuda), FAM,
                                    params, T), (ranks, ok))
    assert int((ranks < host.sentinel).sum()) > 1000
    ids = torch.from_numpy(rng.integers(0, 6, host.ids.shape[0],
                                        dtype=np.int32))
    ids[-1] = 0
    host = host._replace(ids=ids)
    dev = dev._replace(ids=ids.to(cuda))
    for lo, hi, base, tr in [(0, T - 1, 3, False), (1, T - 2, 9, True)]:
        tcz.insert_read_sorted(host, ranks[0], lo, hi, base, tr, params, T)
        tcz.insert_read_sorted(dev, ranks[0].to(cuda), lo, hi, base, tr,
                               params, T)
        assert_same(dev, host)
    assert_same(tcz.probe_and_vote(dev, ranks.to(cuda), ok.to(cuda),
                                   params, T),
                tcz.probe_and_vote(host, ranks, ok, params, T))


@pytest.mark.parametrize("size", [(1 << 32) - 64, 4_603_242_496,
                                  (3 << 32) + 12_345])
@pytest.mark.parametrize("mode", ["fastrange", "mod"])
def test_seed_hash_past_2_32_slots(cuda, mode, size):
    """Kernel A's slot grid and bitmap fill at 2^32 slots and more, where
    fastrange computes the JAX function's wrapped products, against the
    plain versions on the card."""
    rng = np.random.default_rng(size % 1000)
    params = tdm.MibfParams(size=size, h=3, k=22, spans=FAM.spans,
                            tile_length=1000, slot_map=mode)
    T = 20
    codes, lens = reads_batch(rng, [20_000, 19_999, 5_432, 999, 0, 20_500],
                              T * 1000 + 1000)
    codes, lens = codes.to(cuda), lens.to(cuda)
    got = tdm.build_slot_grid(codes, lens, FAM, params, T)
    want = tdm._build_slot_grid_plain(codes, lens, FAM, params, T)
    assert_same(got, want)
    real = got[0][got[1][:, None, :].expand_as(got[0])]
    assert (int(real.max()) >= 1 << 32) == (mode == "mod" and size > 1 << 32)
    bk = tdm.fill_presence_bits(tdm.presence_bitmap(size, cuda), codes,
                                lens, FAM, size, mode)
    bp = tdm._fill_bits_plain(tdm.presence_bitmap(size, cuda), codes, lens,
                              FAM, size, mode)
    assert torch.equal(bk, bp) and int((bk != 0).sum()) > 10_000


def test_rank_superblocks(cuda):
    """The freeze (rank_build) of a bitmap of three superblocks, the
    second fully set, and a partial fourth, and kernel A's rank grid
    through it, against the plain versions on the card."""
    size = (3 << 32) + 12_345
    rng = np.random.default_rng(11)
    nw = -(-size // 32)
    g = torch.Generator(device=cuda)
    g.manual_seed(12)
    bits = torch.randint(-2**31, 2**31, (nw,), dtype=torch.int32,
                         device=cuda, generator=g)
    bits &= torch.randint(-2**31, 2**31, (nw,), dtype=torch.int32,
                          device=cuda, generator=g)
    bits[1 << 27: 2 << 27] = -1
    bk, sk, pop = tcz.build_rank(bits, size)
    bp, sp, pop_p = tcz._build_rank_plain(bits, size)
    assert_same((bk, sk), (bp, sp))
    # a quarter of the other slots set: ~6.5e9 present, ranks past 2^32
    assert pop == pop_p and sk.shape == (4,) and pop > 5 << 30
    assert int(sk[2] - sk[1]) == 1 << 32
    assert (int(bk[(2 << 27) - 1]) >> 32) & 0xFFFFFFFF == (1 << 32) - 32
    del bits, bp, sp
    # the rank grid reads the tables' length only: the sentinel rank
    table = torch.empty(1, dtype=torch.int32, device=cuda).expand(pop + 1)
    state = tcz.CompressedState(bk, sk, table, table)
    T = 20
    params = tdm.MibfParams(size=size, h=3, k=22, spans=FAM.spans,
                            tile_length=1000, slot_map="mod")
    codes, lens = reads_batch(rng, [20_000] * 8 + [7_777, 0],
                              T * 1000 + 1000)
    codes, lens = codes.to(cuda), lens.to(cuda)
    got = tcz.build_rank_grid(state, codes, lens, FAM, params, T)
    want = tcz._build_rank_grid_plain(state, codes, lens, FAM, params, T)
    assert_same(got, want)
    high = (got[0] >= int(sk[2])) & (got[0] < state.sentinel)
    assert int(high.sum()) > 100


@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_throughput_engine_on_card_matches_cpu(cuda, tmp_path, mode):
    """bench.py's throughput cell at 60 kb (stride 8 over tiles of 256, one
    probed seed, optimistic, trim recheck, batch_reads 64) on the card and
    on the CPU: files, counters, rows and the final filter agree."""
    genome = synth.random_genome(60_000, seed=3)
    reads = synth.simulate_reads(genome, n_reads=120, read_len=3000, seed=4,
                                 err_rate=0.0, phred=20)
    path = str(tmp_path / "reads.fq")
    synth.write_fastq(path, reads)
    cfg = dict(genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
               seed_preset="1011011110110111101101", tile_length=256,
               min_length=1000, block_size=4, phred_min=15,
               silver_path=True, max_paths=2, ratio=0.5, batch_reads=64,
               frame_stride=8, probe_seeds=1, recheck="optimistic",
               vote_topk=32, mibf_mode=mode)
    runs = {}
    for dev in ("cuda", "cpu"):
        before = (kernels.INSERT_MAX.launches, kernels.CONSUME.launches)
        prefix = str(tmp_path / f"{mode}-{dev}")
        grids = (kernels.SEED_HASH_GRID.launches
                 + kernels.SEED_HASH_RANK_GRID.launches)
        eng = GoldenPathEngine(PathConfig(input=path, prefix_file=prefix,
                                          **cfg), device=dev)
        st = eng.run()
        if dev == "cuda":
            # the inserts run inside the consume kernel, one launch a batch;
            # kernel A writes both grids of a batch in one launch
            assert kernels.INSERT_MAX.launches == before[0]
            assert kernels.CONSUME.launches - before[1] == st.num_batches
            assert eng.fuse_q and (kernels.SEED_HASH_GRID.launches
                                   + kernels.SEED_HASH_RANK_GRID.launches
                                   - grids) == st.num_batches
        assert eng.consume_counts["insert"] == st.recruits > 0
        files = [open(f"{prefix}_{i}.fq", "rb").read() for i in (1, 2)
                 if os.path.exists(f"{prefix}_{i}.fq")]
        state = (tcz.state_to_numpy(eng.cstate).values()
                 if mode == "compressed"
                 else tdm.state_to_numpy(eng.state))
        runs[dev] = (files, st.recruits, st.queries, st.hits,
                     eng.last_rows.tolist(), list(state))
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu[:5] == cpu[:5] and len(gpu[0]) == 2
    for a, b in zip(gpu[5], cpu[5]):
        np.testing.assert_array_equal(a, b)


def test_engine_on_card_matches_cpu(cuda, tmp_path):
    genome = synth.random_genome(60_000, seed=3)
    reads = synth.simulate_reads(genome, n_reads=120, read_len=3000, seed=4,
                                 err_rate=0.0, phred=20)
    path = str(tmp_path / "reads.fq")
    synth.write_fastq(path, reads)
    cfg = dict(genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
               seed_preset="1011011110110111101101", tile_length=250,
               min_length=1000, block_size=4, phred_min=15,
               silver_path=True, max_paths=2, ratio=0.5, batch_reads=32)
    for mode in ("direct", "compressed"):
        runs = {}
        for dev in ("cuda", "cpu"):
            prefix = str(tmp_path / f"{mode}-{dev}")
            eng = GoldenPathEngine(PathConfig(input=path, prefix_file=prefix,
                                              mibf_mode=mode, **cfg),
                                   device=dev)
            st = eng.run()
            files = [open(f"{prefix}_{i}.fq", "rb").read() for i in (1, 2)
                     if os.path.exists(f"{prefix}_{i}.fq")]
            state = (tcz.state_to_numpy(eng.cstate).values()
                     if mode == "compressed"
                     else tdm.state_to_numpy(eng.state))
            runs[dev] = (files, st.recruits, st.queries, st.hits,
                         eng.last_rows.tolist(), list(state))
        gpu, cpu = runs["cuda"], runs["cpu"]
        assert gpu[:5] == cpu[:5] and len(gpu[0]) == 2
        for a, b in zip(gpu[5], cpu[5]):
            np.testing.assert_array_equal(a, b)


# the consume scan (K9) on tests/test_torch_consume.py's cases: (config,
# scal at the first batch's start, batches, bases inserted set at the last
# batch's start or None)
CONSUME_CFG = dict(genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
                   seed_preset="1011011110110111101101", tile_length=250,
                   min_length=1000, threshold=10, block_size=4,
                   unassigned_min=5, assigned_max=1, occupancy=0.1,
                   phred_min=15, silver_path=True, max_paths=2, ratio=0.5,
                   batch_reads=32)
OPT, S5 = dict(recheck="optimistic"), dict(recheck="optimistic",
                                           frame_stride=5, probe_seeds=1)
TARGET, ROT = 30_000, dict(max_paths=4, ratio=2.0)
CONSUME_CASES = {
    "exact-direct": ({}, [0, 0, 1, 0], 2, None),
    "exact-compressed": (dict(mibf_mode="compressed"), [0, 0, 1, 0], 2,
                         None),
    "opt-direct": (OPT, [0, 0, 1, 0], 2, None),
    "opt-compressed": (dict(OPT, mibf_mode="compressed"), [0, 0, 1, 0], 2,
                       None),
    "exact-rotation": (ROT, [0, 0, 1, 0], 2, 119_999),
    "opt-compressed-rotation": (dict(OPT, mibf_mode="compressed", **ROT),
                                [0, 0, 1, 0], 2, 119_999),
    "opt-direct-rotation": (dict(OPT, **ROT), [0, 0, 1, 0], 2, 119_999),
    "exact-done": ({}, [7, TARGET - 6001, 2, 0], 1, None),
    "opt-compressed-done": (dict(OPT, mibf_mode="compressed"),
                            [7, TARGET - 6001, 2, 0], 1, None),
    "s5-p1-opt-compressed-recheck": (dict(S5, mibf_mode="compressed"),
                                     [0, 0, 1, 0], 2, None),
    "s5-p1-opt-direct-recheck": (S5, [0, 0, 1, 0], 2, None),
    "s2-exact-direct-recheck": (dict(frame_stride=2), [0, 0, 1, 0], 2, None),
    # the sampled inserts (tests/test_torch_consume.py's cases)
    "is2-exact-direct": (dict(insert_stride=2), [0, 0, 1, 0], 2, None),
    "is2-exact-compressed-rotation": (
        dict(insert_stride=2, mibf_mode="compressed", **ROT), [0, 0, 1, 0],
        2, 119_999),
    "s5-is5-p1-opt-compressed": (dict(S5, insert_stride=5,
                                      mibf_mode="compressed"),
                                 [0, 0, 1, 0], 2, None),
    "p1-i2-opt-direct-recheck": (dict(OPT, probe_seeds=1, insert_seeds=2),
                                 [0, 0, 1, 0], 2, None),
}


@pytest.mark.parametrize("case", list(CONSUME_CASES))
def test_consume_matches_plain(cuda, tmp_path, case):
    """The consume kernel against consume_batch_plain on the same batches
    of a filter the card filled: rows, scal, counters and the filter, bit
    for bit; one launch per batch."""
    from goldrush_tpu_torch.path import consume as tcons
    over, scal0, n, bump = CONSUME_CASES[case]
    genome = synth.random_genome(60_000, seed=3)
    reads = synth.simulate_reads(genome, n_reads=120, read_len=3000, seed=4,
                                 err_rate=0.0, phred=20)
    path = str(tmp_path / "reads.fq")
    synth.write_fastq(path, reads)
    te = GoldenPathEngine(PathConfig(input=path, **{**CONSUME_CFG, **over}),
                          device=cuda)
    te.calc_phred_threshold(path)
    te.fill(path)
    state_k = te.cstate if te.compressed else te.state
    state_p = type(state_k)(*(t.clone() for t in state_k))
    recs = list(te._eligible(path))
    scal_k = torch.tensor(scal0, dtype=torch.int64, device=cuda)
    scal_p = scal_k.clone()
    ck, cp = tcons.new_counters(cuda), tcons.new_counters(cuda)
    before = kernels.CONSUME.launches
    k = te.batch_reads
    for b in range(n):
        if b == n - 1 and bump is not None:
            scal_k[1] = scal_p[1] = bump
        codes, lengths, full, T = te._pack_batch(recs[b * k: (b + 1) * k])
        inputs = te._batch_inputs(codes, lengths, full, T)
        rows_k = torch.empty((codes.shape[0], 8), dtype=torch.int64,
                             device=cuda)
        rows_p = torch.empty_like(rows_k)
        tcons.consume_batch(te.spec, state_k, *inputs, scal_k, rows_k, ck, T)
        tcons.consume_batch_plain(te.spec, state_p, *inputs, scal_p, rows_p,
                                  cp, T)
        assert_same([rows_k, scal_k, ck, *state_k],
                    [rows_p, scal_p, cp, *state_p])
    assert kernels.CONSUME.launches == before + n
    assert ck[0] > 0 and ck[2] > 0
    # a configuration the kernel refuses raises, and is not counted
    spec = dataclasses.replace(
        te.spec, params=dataclasses.replace(te.spec.params, vote_topk=10_000),
        params_full=dataclasses.replace(te.spec.params_full,
                                        vote_topk=10_000))
    with pytest.raises(RuntimeError, match="consume"):
        tcons.consume_batch(spec, state_k, *inputs, scal_k, rows_k, ck, T)
    assert kernels.CONSUME.launches == before + n


@pytest.mark.parametrize("rbits,sbits", [(12, 3), (22, 7)])
def test_ntcard_count_matches_plain(cuda, rbits, sbits):
    """ntcard_count (K22) against its plain version: reads of 20 kb, of k
    .. k + 2 bases (shorter than the longer seeds' spans), shorter than k
    and empty, over two batches; one launch per batch with work."""
    from goldrush_tpu_torch.utils import ntcard as tnt
    rng = np.random.default_rng(rbits)
    lens = [20_000, 5_000, 1_024, 1_025, 24, 23, 22, 21, 0, 3_000]
    codes = rng.integers(0, 4, sum(lens)).astype(np.uint8)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    k = torch.zeros((3, 2 << rbits), dtype=torch.int32, device=cuda)
    p = torch.zeros((3, 2 << rbits), dtype=torch.int32)
    before = kernels.NTCARD_COUNT.launches
    for _ in range(2):
        tnt.ntcard_count(k, tnt.pack_batch(codes, offsets, FAM.k, cuda), FAM,
                         rbits, sbits)
        tnt.ntcard_count(p, tnt.pack_batch(codes, offsets, FAM.k, "cpu"),
                         FAM, rbits, sbits)
    assert torch.equal(k.cpu(), p) and int(p.sum()) > 100
    assert kernels.NTCARD_COUNT.launches == before + 2
    # a batch of reads shorter than k has no work: nothing launches
    short = tnt.pack_batch(codes[:21], np.array([0, 21]), FAM.k, cuda)
    tnt.ntcard_count(k, short, FAM, rbits, sbits)
    assert kernels.NTCARD_COUNT.launches == before + 2


@pytest.mark.parametrize("case", ["homopolymer", "short", "long"])
def test_ntcard_count_edge_batches(cuda, case):
    """ntcard_count against its plain version at sbits 7 and 3: a
    homopolymer batch (read i all base i % 4: every lane of a warp reads
    one table entry, and a sampled k-mer's frames all add to one counter),
    reads shorter than k, of k and up to the longest span (the stale
    tails), and one read of 40 work items beside short ones."""
    from goldrush_tpu_torch.utils import ntcard as tnt
    rng = np.random.default_rng(16)
    k, top = FAM.k, FAM.spans[-1]
    lens = {"homopolymer": [20_000] * 8 + [3_000] * 4,
            "short": [k - 1, k, k + 1, top - 1, top, top + 1, 5, 0] * 3,
            "long": [40 * tnt.CHUNK + k + 16, 100, k, 3_000]}[case]
    parts = [rng.integers(0, 4, n).astype(np.uint8) for n in lens]
    if case == "homopolymer":
        parts = [np.full(n, i % 4, np.uint8) for i, n in enumerate(lens)]
    codes, offsets = np.concatenate(parts), np.concatenate(
        [[0], np.cumsum(lens)])
    for sbits in (7, 3):
        k_ = torch.zeros((3, 2 << 14), dtype=torch.int32, device=cuda)
        p = torch.zeros((3, 2 << 14), dtype=torch.int32)
        before = kernels.NTCARD_COUNT.launches
        tnt.ntcard_count(k_, tnt.pack_batch(codes, offsets, FAM.k, cuda),
                         FAM, 14, sbits)
        tnt.ntcard_count(p, tnt.pack_batch(codes, offsets, FAM.k, "cpu"),
                         FAM, 14, sbits)
        assert torch.equal(k_.cpu(), p)
        assert kernels.NTCARD_COUNT.launches == before + 1
    assert int(p.sum()) > 0


def test_engine_with_ntcard_and_sampled_inserts_on_card_matches_cpu(
        cuda, tmp_path):
    """The engine sized by ntCard, inserting every 2nd frame of two seeds
    under one probed seed, on the card and on the CPU: universe, files,
    counters, rows and the final filter agree."""
    genome = synth.random_genome(60_000, seed=3)
    reads = synth.simulate_reads(genome, n_reads=120, read_len=3000, seed=4,
                                 err_rate=0.01, phred=20)
    path = str(tmp_path / "reads.fq")
    synth.write_fastq(path, reads)
    cfg = dict(CONSUME_CFG, ntcard=True, recheck="optimistic",
               probe_seeds=1, insert_seeds=2, insert_stride=2,
               mibf_mode="compressed")
    runs = {}
    for dev in ("cuda", "cpu"):
        before = kernels.NTCARD_COUNT.launches
        prefix = str(tmp_path / dev)
        eng = GoldenPathEngine(PathConfig(input=path, prefix_file=prefix,
                                          **cfg), device=dev)
        st = eng.run()
        if dev == "cuda":
            assert kernels.NTCARD_COUNT.launches == before + 1
        files = [open(f"{prefix}_{i}.fq", "rb").read() for i in (1, 2)
                 if os.path.exists(f"{prefix}_{i}.fq")]
        runs[dev] = (eng.universe, files, st.recruits, st.queries,
                     eng.last_rows.tolist(),
                     list(tcz.state_to_numpy(eng.cstate).values()))
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu[:5] == cpu[:5] and gpu[2] > 0
    for a, b in zip(gpu[5], cpu[5]):
        np.testing.assert_array_equal(a, b)


def test_recheck_zone_device_predicate(cuda):
    """The consume kernel's zone predicate (K18), launched alone, against
    the plain one."""
    from goldrush_tpu_torch.path.engine_util import recheck_zone, zone_batch
    for stride in sorted({r[6] for r in hard.ZONE_ROWS}):
        rows = [r[:6] for r in hard.ZONE_ROWS if r[6] == stride]
        got = zone_batch(torch.tensor(rows, dtype=torch.int64, device=cuda),
                         stride, 10, 1)
        assert got.cpu().tolist() == [recheck_zone(*r, stride, 10, 1)
                                      for r in rows]


@pytest.mark.parametrize("k,w", [(15, 10), (40, 250), (32, 1000)])
def test_minimizer_keys(cuda, k, w):
    """K20 against its plain version at chip_smoke.py's shapes: 32 x 32,768
    codes with N bases, rows shorter than k + w - 1 among them."""
    from goldrush_tpu_torch.ops import minimizers as tmin
    lengths = hard.minimizer_lengths(k, w, 32_768, 32)
    codes, _ = hard.stage_codes(lengths, 32_768, seed=k + w, n_frac=0.01)
    c = torch.from_numpy(codes).to(cuda)
    P = 32_768 - k + 1
    before = kernels.MINIMIZER_KEYS.launches
    assert_same(tmin.minimizer_keys(c, k, w, P),
                tmin._minimizer_keys_plain(c, k, w, P))
    assert kernels.MINIMIZER_KEYS.launches == before + 1


def test_minimizer_keys_one_chunk_and_short_rows(cuda):
    """One 2^20-wide chunk (the mapper's position-packing limit) and rows
    narrower than k + w - 1, whose positions past the codes read as A."""
    from goldrush_tpu_torch.ops import minimizers as tmin
    from goldrush_tpu_torch.stages import mapping as tmap
    L = tmap.MAX_SEQ - 2
    codes, _ = hard.stage_codes([L], L, seed=5)
    c = torch.from_numpy(codes).to(cuda)
    for k, w in ((15, 10), (32, 1000)):
        P = L - k + 1
        assert_same(tmin.minimizer_keys(c, k, w, P),
                    tmin._minimizer_keys_plain(c, k, w, P))
    short, _ = hard.stage_codes([30, 7, 0], 40, seed=6)
    s = torch.from_numpy(short).to(cuda)
    assert_same(tmin.minimizer_keys(s, 24, 100, 100),
                tmin._minimizer_keys_plain(s, 24, 100, 100))
    with pytest.raises(ValueError):
        tmin.minimizer_keys(c[:, :10], 15, 10, (1 << 20) + 1)


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("k,w", [(15, 1), (15, 10), (24, 100), (40, 250),
                                 (32, 1000)])
def test_minimizer_keys_tile_edges(cuda, k, w, offset):
    """K20 against its plain version where its windows end on the kernel's
    tile edges (two tiles exactly, and one window more; rows that end on
    them), with the codes at a 16-byte-aligned address and 5 bytes past
    one."""
    from goldrush_tpu_torch.ops import minimizers as tmin
    tw = hard.minimizer_tile(k, w)[1]
    for n_win in (2 * tw, 2 * tw + 1):
        L = n_win + w - 1 + k - 1
        codes, _ = hard.stage_codes(hard.minimizer_lengths(k, w, L, 12), L,
                                    seed=n_win, n_frac=0.01)
        buf = torch.zeros(codes.size + 16, dtype=torch.uint8, device=cuda)
        c = buf[offset: offset + codes.size].view(codes.shape)
        c.copy_(torch.from_numpy(codes))
        P = L - k + 1
        assert_same(tmin.minimizer_keys(c, k, w, P),
                    tmin._minimizer_keys_plain(c, k, w, P))


def test_minimizer_keys_refuse_a_window_past_their_tile(cuda):
    """k + w past the kernel's tile (MAX_K_PLUS_W) raises before a launch;
    at the limit it runs; the plain version takes any."""
    from goldrush_tpu_torch.ops import minimizers as tmin
    k = 40
    w = tmin.MAX_K_PLUS_W - k
    codes, _ = hard.stage_codes([5_000, 4_200], 5_000, seed=3)
    c = torch.from_numpy(codes).to(cuda)
    P = 5_000 - k + 1
    assert_same(tmin.minimizer_keys(c, k, w, P),
                tmin._minimizer_keys_plain(c, k, w, P))
    before = kernels.MINIMIZER_KEYS.launches
    with pytest.raises(ValueError):
        tmin.minimizer_keys(c, k, w + 1, P)
    assert kernels.MINIMIZER_KEYS.launches == before


@pytest.mark.parametrize("nw,short,kind", [
    (1, 31, "dense"), (4_096, 0, "dense"), (4_097, 7, "sparse"),
    (1 << 27, 0, "full"), ((1 << 27) + 4_096 * 37 + 5, 1, "full")])
def test_rank_build_tiles(cuda, nw, short, kind):
    """rank_build against the plain freeze on bitmaps made on the card: one
    word, one tile, a tile and a ragged word (bits dirty past size), a
    whole superblock fully set (its inclusive count exactly 2^32) and one
    more superblock's ragged start; one launch each."""
    size = nw * 32 - short
    g = torch.Generator(device=cuda)
    g.manual_seed(nw)
    bits = torch.randint(-2**31, 2**31, (nw,), dtype=torch.int32,
                         device=cuda, generator=g)
    if kind == "sparse":
        bits &= torch.randint(-2**31, 2**31, (nw,), dtype=torch.int32,
                              device=cuda, generator=g)
    elif kind == "full":
        bits[: 1 << 27] = -1
    before = kernels.RANK_BUILD.launches
    got = tcz.build_rank(bits, size)
    assert kernels.RANK_BUILD.launches == before + 1
    want = tcz._build_rank_plain(bits, size)
    assert_same(got[:2], want[:2]) and got[2] == want[2]
    if kind == "full":
        assert (int(got[0][(1 << 27) - 1]) >> 32) & 0xFFFFFFFF == \
            (1 << 32) - 32
        assert got[2] >= 1 << 32


@pytest.mark.parametrize("k", [13, 16, 24, 32])
def test_kmer_count_and_query(cuda, k):
    """K21 against its plain version at chip_smoke.py's shapes: 64 x 32,768
    reads into a 2^22+1-slot table, a homopolymer batch, one 1 Mbp contig
    row and 40,000 candidate windows of width 2k + 2."""
    from goldrush_tpu_torch.stages import polish as tpol
    size = (1 << 22) | 1
    lengths = [32_768, 0, k - 1, k] + list(
        np.random.default_rng(k).integers(1, 32_769, 60))
    codes, lens = hard.stage_codes(lengths, 32_768, seed=k)
    homo = np.full((8, 4_096), 3, np.uint8)
    counts = {d: torch.zeros(size + 1, dtype=torch.int32, device=d)
              for d in (cuda, "cpu")}
    for c, n in ((codes, lens), (homo, np.full(8, 4_096, np.int64))):
        for d in (cuda, "cpu"):
            tpol.count_kmers(counts[d], torch.from_numpy(c).to(d),
                             torch.from_numpy(n).to(d), k, size)
        assert_same([counts[cuda]], [counts["cpu"]])
    assert int(counts["cpu"].max()) >= 8 * (4_096 - k + 1)
    contig, _ = hard.stage_codes([1_000_000], 1_000_000, seed=9)
    cand = hard.candidate_windows(contig[0], 40_000, k, seed=10)
    for c, n in ((contig, np.array([1_000_000])), cand):
        got = tpol.query_kmers(counts[cuda], torch.from_numpy(c).to(cuda),
                               torch.from_numpy(n).to(cuda), k, size)
        want = tpol.query_kmers(counts["cpu"], torch.from_numpy(c),
                                torch.from_numpy(n), k, size)
        assert_same(got, want)


def kmer_edge_batch(case, k, rng):
    """Batches on whose tiles K21's kernels branch (csrc/kmer_count.cu):
    short rows packed into one tile (the candidate windows), rows split
    over tiles whose P is not a multiple of 32 or of the tile, one k-mer a
    row (P = 1), homopolymer rows, and codes above 3."""
    if case == "windows":
        return hard.candidate_windows(
            hard.stage_codes([100_000], 100_000, seed=k)[0][0], 3_000, k,
            seed=k + 1)
    if case == "split_rows":
        return hard.stage_codes([5_003, 4_000, 0, k - 1, k, 2_500], 5_003,
                                seed=k)
    if case == "one_kmer_rows":
        return hard.stage_codes(rng.integers(k - 1, k + 1, 700), k, seed=k)
    if case == "homopolymer":
        return (np.full((5, 3_001), 1, np.uint8),
                np.array([3_001, 3_001, 2_000, k, 3_001], np.int64))
    codes, lens = hard.stage_codes(rng.integers(0, 1_500, 40), 1_500, seed=k)
    return (codes | (rng.integers(0, 64, codes.shape) << 2)).astype(
        np.uint8), lens


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("case", ["windows", "split_rows", "one_kmer_rows",
                                  "homopolymer", "high_codes"])
@pytest.mark.parametrize("k", [13, 32, 40])
def test_kmer_tile_edges(cuda, k, case, offset):
    """K21 against its plain version on the tile edges of its design, with
    the codes at a 16-byte-aligned address and 5 bytes past one (the
    staging's unaligned start and its guarded ends)."""
    from goldrush_tpu_torch.stages import polish as tpol
    rng = np.random.default_rng(k)
    codes, lens = kmer_edge_batch(case, k, rng)
    size = 1_000_003
    buf = torch.zeros(codes.size + 16, dtype=torch.uint8, device=cuda)
    c = buf[offset: offset + codes.size].view(codes.shape)
    c.copy_(torch.from_numpy(codes))
    n = torch.from_numpy(lens).to(cuda)
    start = torch.from_numpy(rng.integers(0, 1 << 31, size + 1).astype(
        np.int32))
    start[::7] = -1                           # uint32 adds wrap
    counts = {cuda: start.to(cuda), "cpu": start.clone()}
    for d in (cuda, "cpu"):
        tpol.count_kmers(counts[d], c.to(d), n.to(d), k, size)
    assert_same([counts[cuda]], [counts["cpu"]])
    assert_same(tpol.query_kmers(counts[cuda], c, n, k, size),
                tpol.query_kmers(counts["cpu"], c.cpu(), n.cpu(), k, size))


def test_kmer_kernels_refuse_a_k_past_their_tile(cuda):
    """A k-mer whose codes do not fit a CTA's tile (k > 1,009) raises on
    the card; the plain version takes it."""
    from goldrush_tpu_torch.stages import polish as tpol
    codes = torch.zeros((2, 2_100), dtype=torch.uint8, device=cuda)
    n = torch.full((2,), 2_100, dtype=torch.int64, device=cuda)
    counts = torch.zeros(65_538, dtype=torch.int32, device=cuda)
    tpol.count_kmers(counts, codes, n, 1_009, 65_537)
    with pytest.raises(RuntimeError):
        tpol.count_kmers(counts, codes, n, 1_010, 65_537)
    with pytest.raises(RuntimeError):
        tpol.query_kmers(counts, codes, n, 1_010, 65_537)


def test_stage_wrappers_check_their_inputs(cuda):
    from goldrush_tpu_torch.ops import minimizers as tmin
    from goldrush_tpu_torch.stages import polish as tpol
    codes = torch.zeros((2, 100), dtype=torch.uint8, device=cuda)
    n = torch.full((2,), 100, dtype=torch.int64, device=cuda)
    counts = torch.zeros(65_538, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tmin.minimizer_keys(codes.int(), 15, 10, 86)
    with pytest.raises(TypeError):
        tpol.count_kmers(counts, codes, n.int(), 13, 65_537)
    with pytest.raises(ValueError):
        tpol.count_kmers(counts.cpu(), codes, n, 13, 65_537)
    with pytest.raises(ValueError):
        tpol.query_kmers(counts, codes[:, ::2], n, 13, 65_537)
    before = kernels.KMER_COUNT.launches
    tpol.count_kmers(counts, codes[:0], n[:0], 13, 65_537)   # empty batch
    assert kernels.KMER_COUNT.launches == before
    tpol.count_kmers(counts, codes, n, 13, 65_537)
    assert kernels.KMER_COUNT.launches == before + 1


def test_pipeline_on_card_matches_fixture(cuda, tmp_path):
    """`run` on the card on tests/test_pipeline.py's 60 kb dataset writes
    the stage files whose digests tests/fixtures/torch_port_digests.json
    holds (the JAX package's), and launches K20 and K21."""
    import hashlib
    import json
    from goldrush_tpu_torch.config import PipelineConfig, stage_filenames
    from goldrush_tpu_torch.pipeline import run_pipeline
    fx = json.load(open(os.path.join(os.path.dirname(__file__), "fixtures",
                                     "torch_port_digests.json")))["pipeline"]
    ds = fx["dataset"]
    genome = synth.random_genome(ds["genome"], seed=ds["genome_seed"])
    synth.write_fastq(str(tmp_path / "reads.fq"), synth.simulate_reads(
        genome, ds["n_reads"], ds["read_len"], seed=ds["reads_seed"],
        err_rate=ds["err_rate"], phred=ds["phred"]))
    cfg = PipelineConfig(reads=str(tmp_path / "reads"), **fx["config"])
    before = [k.launches for k in kernels.STAGES]
    run_pipeline(cfg, workdir=str(tmp_path), until="final", device=cuda)
    assert all(k.launches > n for k, n in zip(kernels.STAGES, before))
    files = stage_filenames(cfg)
    got = {s: hashlib.sha256(open(tmp_path / files[s], "rb").read())
           .hexdigest() for s in ("polished", "tigmint", "ntlink", "final")}
    got["gaps"] = hashlib.sha256(open(
        tmp_path / (files["ntlink"] + ".gaps.json"), "rb").read()).hexdigest()
    assert got == fx["files"]


# tests/test_wavefront.py's settings with the wavefront on
WAVE_CFG = dict(genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
                seed_preset="1011011110110111101101", silver_path=True,
                max_paths=2, min_length=4_000, ratio=0.5,
                hash_universe=3_000_000, batch_reads=16, frame_stride=8,
                probe_seeds=1, recheck="optimistic", wavefront=True)


def wave_reads(tmp_path):
    genome = synth.random_genome(60_000, seed=7)
    path = str(tmp_path / "wave.fq")
    synth.write_fastq(path, synth.simulate_reads(genome, 80, 6_000, seed=8,
                                                 err_rate=0.02))
    return path


@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_wave_kernels_match_plain(cuda, tmp_path, mode):
    """wave_adjacency and wave_rounds against their plain versions on the
    two windows of 64 reads of a filter the card filled, the first
    window's first commit filling the silver path (a rotation inside it),
    then on a window of homopolymer reads (read i all base i % 4), whose
    groups of one k-mer (32,000 keys each in the direct filter) make
    partitions past the shared-memory capacity (and past the 8,192 keys
    that the parent design sorted in shared memory): the counts, rows,
    scal, counters and both tables bit for bit, one launch of each kernel
    per window; the adjacency also at a capacity of 64 keys, where every
    partition takes its distinct keys or sorts its slice."""
    from goldrush_tpu_torch.ops.nthash import fingerprints
    from goldrush_tpu_torch.path import wavefront as wave
    path = wave_reads(tmp_path)
    te = GoldenPathEngine(PathConfig(input=path, mibf_mode=mode,
                                     wave_window=64, **WAVE_CFG),
                          device=cuda)
    te.calc_phred_threshold(path)
    te.fill(path)
    state_k = te.cstate if te.compressed else te.state
    state_p = type(state_k)(*(t.clone() for t in state_k))
    side_k = torch.zeros_like(state_k.ids if te.compressed
                              else state_k.words)
    side_p = side_k.clone()
    _, _, ranked, limit, _ = wave._filter_view(state_k, te.size)
    scal_k = torch.tensor([0, 29_999, 1, 0], dtype=torch.int64, device=cuda)
    scal_p = scal_k.clone()
    ck, cp = wave.new_counters(cuda), wave.new_counters(cuda)
    before = [k.launches for k in kernels.WAVE]
    recs = list(te._eligible(path))
    wins = [te._pack_batch(recs[i: i + 64]) for i in range(0, len(recs), 64)]
    codes, lengths, full, T = wins[0]
    homo = np.zeros_like(codes) + (np.arange(64) % 4)[:, None]
    wins.append((homo.astype(np.uint8), lengths, full, T))
    for w, (codes, lengths, full, T) in enumerate(wins):
        if w == 2:
            scal_k.copy_(torch.tensor([0, 0, 1, 0]))
            scal_p.copy_(scal_k)
        codes_d, grid, ok, gi, oi, nt, fl = te._window_inputs(codes, lengths,
                                                              full, T)
        adj = wave.wave_adjacency(te.wave_spec, gi, codes_d, limit, ranked, T)
        fp = fingerprints(codes_d, te.fam_ins, T * te.cfg.tile_length,
                          te.params_ins.frame_stride, wave.FP_BITS)
        want = wave.wave_adjacency_plain(gi, fp, limit, ranked)
        assert torch.equal(adj, want)
        assert torch.equal(wave._adjacency_cuda(te.wave_spec, gi, codes_d,
                                                limit, ranked, T, cap=64),
                           want)
        if w == 2 and mode == "direct":
            groups = ((gi & ((1 << 24) - 1)) << wave.FP_BITS | fp)[gi < limit]
            assert torch.unique(groups, return_counts=True)[1].max() > 8_192
        rows_k = torch.empty((64, 8), dtype=torch.int64, device=cuda)
        rows_p = torch.empty_like(rows_k)
        wave.wave_window(te.wave_spec, state_k, side_k, grid, ok, gi, oi, nt,
                         fl, adj, scal_k, rows_k, ck, T)
        wave.wave_window_plain(te.wave_spec, state_p, side_p, grid, ok, gi,
                               oi, nt, fl, adj, scal_p, rows_p, cp, T)
        assert_same([rows_k, scal_k, ck, side_k, *state_k],
                    [rows_p, scal_p, cp, side_p, *state_p])
    # the capacity-64 calls launch the adjacency once more per window
    assert [k.launches for k in kernels.WAVE] == [
        before[0] + 2 * len(wins), before[1] + len(wins)]
    assert ck[4] > 0 and ck[3] > 0 and ck[5] == 0


# one-tile reads (tools/torch_port_digests.py WAVE_8192): windows of up to
# 8,192 reads under the wavefront's tile budget
ONE_TILE_CFG = dict(genome_size=1_000_000, kmer_size=22, weight=16,
                    hash_num=3, seed_preset="1011011110110111101101",
                    silver_path=True, max_paths=3, ratio=0.75,
                    min_length=1_000, batch_reads=64, frame_stride=8,
                    probe_seeds=1, recheck="optimistic", unassigned_min=1,
                    assigned_max=0, wavefront=True, wave_window=8_192)


@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_wave_rounds_past_7980_reads(cuda, tmp_path, mode):
    """wave_rounds on windows of 7,981 and 8,192 one-tile reads, whose
    insert index and per-read state leave shared memory for a global
    scratch, and of 7,910, the largest whose state stays there beside the
    kernel's static arrays, against wave_window_plain: rows, scal,
    counters and both tables bit for bit, one launch a window."""
    from goldrush_tpu_torch.path import wavefront as wave
    genome = synth.random_genome(1_000_000, seed=51)
    path = str(tmp_path / "one_tile.fq")
    synth.write_fastq(path, synth.simulate_reads(
        genome, 8_192, 1_500, seed=53, err_rate=0.05, indel_frac=0.4))
    te = GoldenPathEngine(PathConfig(input=path, mibf_mode=mode,
                                     **ONE_TILE_CFG), device=cuda)
    te.calc_phred_threshold(path)
    te.fill(path)
    state_k = te.cstate if te.compressed else te.state
    _, _, ranked, limit, _ = wave._filter_view(state_k, te.size)
    recs = list(te._eligible(path))
    for B in (7_910, 7_981, 8_192):
        assert (wave.rounds_smem(B, 1, 32, 125, 3_000, True)[1] > 0) == \
            (B > 7_910)
        te.batch_reads = B
        codes, lengths, full, T = te._pack_batch(recs[:B])
        assert codes.shape[0] == B and T == 1
        codes_d, *inputs = te._window_inputs(codes, lengths, full, T)
        adj = wave.wave_adjacency(te.wave_spec, inputs[2], codes_d, limit,
                                  ranked, T)
        f_k = type(state_k)(*(t.clone() for t in state_k))
        f_p = type(state_k)(*(t.clone() for t in state_k))
        side_k = torch.zeros_like(f_k.ids if te.compressed else f_k.words)
        side_p = side_k.clone()
        scal_k = torch.tensor([0, 0, 1, 0], dtype=torch.int64, device=cuda)
        scal_p = scal_k.clone()
        ck, cp = wave.new_counters(cuda), wave.new_counters(cuda)
        rows_k = torch.empty((B, 8), dtype=torch.int64, device=cuda)
        rows_p = torch.empty_like(rows_k)
        before = kernels.WAVE_ROUNDS.launches
        wave.wave_window(te.wave_spec, f_k, side_k, *inputs, adj, scal_k,
                         rows_k, ck, T)
        assert kernels.WAVE_ROUNDS.launches == before + 1
        wave.wave_window_plain(te.wave_spec, f_p, side_p, *inputs, adj,
                               scal_p, rows_p, cp, T)
        assert_same([rows_k, scal_k, ck, side_k, *f_k],
                    [rows_p, scal_p, cp, side_p, *f_p])
        assert ck[3] > 0 and ck[5] == 0


def test_wave_adjacency_past_8192_reads(cuda, tmp_path):
    """wave_adjacency on a full window of 8,192 one-tile reads padded
    with empty rows to 8,193 and 8,199 (the mesh's padding at 3 and 7
    data rows, the engine's _pad_batch) and to 16,384 (its largest,
    MAX_ADJ_READS) against its plain version."""
    from goldrush_tpu_torch.ops.nthash import fingerprints
    from goldrush_tpu_torch.path import wavefront as wave
    genome = synth.random_genome(1_000_000, seed=51)
    path = str(tmp_path / "one_tile.fq")
    synth.write_fastq(path, synth.simulate_reads(
        genome, 8_199, 1_500, seed=53, err_rate=0.05, indel_frac=0.4))
    te = GoldenPathEngine(PathConfig(input=path, mibf_mode="direct",
                                     **ONE_TILE_CFG), device=cuda)
    te.calc_phred_threshold(path)
    te.fill(path)
    _, _, ranked, limit, _ = wave._filter_view(te.state, te.size)
    recs = list(te._eligible(path))
    te.batch_reads = 8_192
    packed = te._pack_batch(recs[:8_192])
    T = packed[3]
    for B in (8_193, 8_199, wave.MAX_ADJ_READS):
        codes, lengths, full = (np.pad(a, ((0, B - 8_192),) + ((0, 0),)
                                       * (a.ndim - 1)) for a in packed[:3])
        codes_d, _, _, gi, *_ = te._window_inputs(codes, lengths, full, T)
        fp = fingerprints(codes_d, te.fam_ins, T * te.cfg.tile_length,
                          te.params_ins.frame_stride, wave.FP_BITS)
        got = wave.wave_adjacency(te.wave_spec, gi, codes_d, limit, ranked,
                                  T)
        want = wave.wave_adjacency_plain(gi, fp, limit, ranked)
        assert got.shape == (B, B) and torch.equal(got, want)
        assert int((want > 0).sum()) > 0


@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_wave_rounds_long_reads(cuda, tmp_path, mode):
    """wave_rounds on windows of reads in the 1,024-, 1,536- and
    2,048-tile buckets at the bench cell's tiers (tiles of 1,000, one
    probed seed at stride 8, the full-resolution recheck, K = 32), where
    kernel C runs on fewer warps of a CTA (wavefront.rounds_smem), against
    wave_window_plain: rows, scal, counters and both tables bit for
    bit."""
    from goldrush_tpu_torch.path import wavefront as wave
    genome = synth.random_genome(3_000_000, seed=61)
    path = str(tmp_path / "long.fq")
    reads = []
    for n_tiles, count, seed in ((1_000, 8, 62), (1_400, 5, 63),
                                 (2_000, 4, 64)):
        reads += synth.simulate_reads(genome, count, n_tiles * 1_000 + 500,
                                      seed=seed, err_rate=0.05)
    synth.write_fastq(path, reads)
    cfg = dict(WAVE_CFG, genome_size=3_000_000, hash_universe=0,
               min_length=20_000, vote_topk=32)
    te = GoldenPathEngine(PathConfig(input=path, mibf_mode=mode, **cfg),
                          device=cuda)
    te.calc_phred_threshold(path)
    te.fill(path)
    state_k = te.cstate if te.compressed else te.state
    _, _, ranked, limit, _ = wave._filter_view(state_k, te.size)
    recs = list(te._eligible(path))
    start = 0
    for count, want_T, warps in ((8, 1_024, 14), (5, 1_536, 8),
                                 (4, 2_048, 7)):
        te.batch_reads = count
        codes, lengths, full, T = te._pack_batch(recs[start: start + count])
        start += count
        assert T == want_T
        codes_d, *inputs = te._window_inputs(codes, lengths, full, T)
        grid, gi = inputs[0], inputs[2]
        assert wave.rounds_smem(
            codes.shape[0], T, 32, grid.shape[1] * grid.shape[2] // T,
            gi.shape[1] * gi.shape[2] // T, True).c_warps == warps
        adj = wave.wave_adjacency(te.wave_spec, gi, codes_d, limit, ranked, T)
        f_k = type(state_k)(*(t.clone() for t in state_k))
        f_p = type(state_k)(*(t.clone() for t in state_k))
        side_k = torch.zeros_like(f_k.ids if te.compressed else f_k.words)
        side_p = side_k.clone()
        scal_k = torch.tensor([0, 0, 1, 0], dtype=torch.int64, device=cuda)
        scal_p = scal_k.clone()
        ck, cp = wave.new_counters(cuda), wave.new_counters(cuda)
        rows_k = torch.empty((codes.shape[0], 8), dtype=torch.int64,
                             device=cuda)
        rows_p = torch.empty_like(rows_k)
        before = kernels.WAVE_ROUNDS.launches
        wave.wave_window(te.wave_spec, f_k, side_k, *inputs, adj, scal_k,
                         rows_k, ck, T)
        assert kernels.WAVE_ROUNDS.launches == before + 1
        wave.wave_window_plain(te.wave_spec, f_p, side_p, *inputs, adj,
                               scal_p, rows_p, cp, T)
        assert_same([rows_k, scal_k, ck, side_k, *f_k],
                    [rows_p, scal_p, cp, side_p, *f_p])
        assert ck[5] == 0


@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_wave_engine_on_card_matches_cpu(cuda, tmp_path, mode):
    """The wavefront engine (windows of 256 reads) on the card and on the
    CPU: files, counters, rows, the final filter and the side table agree;
    the consume kernel and the batched B and C never launch."""
    path = wave_reads(tmp_path)
    runs = {}
    for dev in ("cuda", "cpu"):
        before = {k.name: k.launches for k in kernels.ALL}
        prefix = str(tmp_path / f"{mode}-{dev}")
        eng = GoldenPathEngine(PathConfig(input=path, prefix_file=prefix,
                                          mibf_mode=mode, **WAVE_CFG),
                               device=dev)
        st = eng.run()
        if dev == "cuda":
            got = {k.name: k.launches - before[k.name] for k in kernels.ALL}
            assert got["wave_rounds"] == got["wave_adjacency"] == \
                st.num_batches
            assert got["consume"] == got["probe_vote"] == \
                got["classify"] == 0
        files = [open(f"{prefix}_{i}.fq", "rb").read() for i in (1, 2)
                 if os.path.exists(f"{prefix}_{i}.fq")]
        table = eng.cstate.ids if mode == "compressed" else eng.state.words
        runs[dev] = (files, st, eng.last_rows.tolist(),
                     dict(eng.consume_counts), table.cpu(),
                     eng.wave_side.cpu())
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu[0] == cpu[0] and len(gpu[0]) == 2
    assert gpu[2:4] == cpu[2:4] and gpu[1].recruits == cpu[1].recruits
    assert_same(gpu[4:], cpu[4:])


@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_wave_rounds_on_banks(cuda, tmp_path, mode):
    """wave_rounds on the id table and the side table banked over 1, 2 and
    4 banks on the card (a mesh row of one card repeated) against
    wave_window_plain on the unbanked tables, over the two windows of 64
    reads, the first with a silver rotation inside it: rows, scal,
    counters and both tables gathered, bit for bit, one launch a window.
    The tables are 4 entries longer than the engine's, so that banks of 2
    and 4 end in lengths that are not multiples of 4 (the reset's tails)."""
    from goldrush_tpu_torch.parallel import mesh as tmesh
    from goldrush_tpu_torch.path import wavefront as wave
    path = wave_reads(tmp_path)
    te = GoldenPathEngine(PathConfig(input=path, mibf_mode=mode,
                                     wave_window=64, **WAVE_CFG),
                          device=cuda)
    te.calc_phred_threshold(path)
    te.fill(path)
    filt = te.cstate if te.compressed else te.state
    pad = [torch.cat([t, t.new_zeros(4)])
           for t in (filt.ids if te.compressed else filt.words, filt.counts)]
    if te.compressed:
        te.cstate = filt = tcz.CompressedState(filt.bitrank, filt.supers,
                                               *pad)
    else:
        te.state = filt = tdm.MibfState(*pad)
    n = pad[0].shape[0]
    _, _, ranked, limit, _ = wave._filter_view(filt, te.size)
    recs = list(te._eligible(path))
    wins = []
    for i in range(0, len(recs), 64):
        codes, lengths, full, T = te._pack_batch(recs[i: i + 64])
        codes_d, *inputs = te._window_inputs(codes, lengths, full, T)
        adj = wave.wave_adjacency(te.wave_spec, inputs[2], codes_d, limit,
                                  ranked, T)
        wins.append((inputs, adj, T))
    target = te.cfg.target_bases()

    def run(f, side, row):
        scal = torch.tensor([0, target - 1, 1, 0], dtype=torch.int64,
                            device=cuda)
        counters = wave.new_counters(cuda)
        rows = []
        for inputs, adj, T in wins:
            r = torch.empty((64, 8), dtype=torch.int64, device=cuda)
            if row is None:
                wave.wave_window_plain(te.wave_spec, f, side, *inputs, adj,
                                       scal, r, counters, T)
            else:
                wave.wave_window(te.wave_spec, f, side, *inputs, adj, scal,
                                 r, counters, T, row=row)
            rows.append(r)
        return rows + [scal, counters, *(tdm.whole(t) for t in f),
                       tdm.whole(side)]
    want = run(type(filt)(*(t.clone() for t in filt)),
               torch.zeros(n, dtype=torch.int32, device=cuda), None)
    assert want[len(wins) + 1][4] > 0          # a rotation
    for m in (1, 2, 4):
        row = [cuda] * m
        bk = tmesh.shard_state(filt, tmesh.Mesh((tuple(row),)), True)[0]
        before = kernels.WAVE_ROUNDS.launches
        got = run(bk, tdm.new_banks(n, row), row)
        assert kernels.WAVE_ROUNDS.launches - before == len(wins)
        assert_same(got, want)
