"""PyTorch port, kernel A's query grid written by the insert grid's launch,
against goldrush_tpu on the CPU, bit for bit: ``mibf.build_slot_grids``
and ``compressed.build_rank_grids`` (their plain versions: the plain
insert grid, and the query grid taken from it) equal the JAX package's
two grids, ``build_slot_grid`` at the query tier's stride and seeds and at
the insert tier's (mapped through ``rank_grid`` for the compressed
filter), on reads shorter than k, reads that end inside a tile and the
stale-tail clamp; ``query_in_insert_grid`` accepts exactly the
configurations where that holds, and the engine fuses the two launches
only there."""

import dataclasses

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.mibf import compressed as jcz
from goldrush_tpu.mibf import mibf as jdm
from goldrush_tpu.ops import nthash as jnt
from goldrush_tpu_torch import hard_cases as hard
from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.ops import nthash as tnt
from goldrush_tpu_torch.ops.seeds import make_seed_pattern
from goldrush_tpu_torch.path.engine import GoldenPathEngine

PRESET = "1011011110110111101101"
SEEDS = make_seed_pattern(PRESET, 22, 16, 3)
FAMS = {h: (tnt.build_seed_family(SEEDS[:h]),
            jnt.build_seed_family(SEEDS[:h])) for h in (1, 2, 3)}
SIZE = 100003


def params(h, S, TL, mode="fastrange", size=SIZE):
    kw = dict(size=size, h=h, k=22, spans=FAMS[h][0].spans, tile_length=TL,
              threshold=4, block_size=3, vote_topk=8, frame_stride=S,
              slot_map=mode)
    return jdm.MibfParams(**kw), tdm.MibfParams(**kw)


def frozen(seed):
    """The same frozen structure of SIZE slots in both packages, about a
    third of the slots present."""
    rng = np.random.default_rng(seed)
    bits = np.packbits(rng.random(-(-SIZE // 32) * 32) < 0.3,
                       bitorder="little").view(np.uint32)
    return (jcz._freeze_from_bits(bits, SIZE),
            tcz.with_tables(*tcz.build_rank(torch.from_numpy(
                bits.view(np.int32).copy()), SIZE), SIZE))


def equal(got: torch.Tensor, want, msg):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(
        got.numpy().dtype), err_msg=msg)


# (tile length, query stride, insert stride, query seeds, insert seeds,
# accepted): bench.py's throughput cell (S=8, one probed seed over three
# insert seeds), the trim recheck's full tier at S=1, sampled inserts, and
# configurations the predicate refuses
CASES = {
    "bench_s8_h1": (1000, 8, 1, 1, 3, True),
    "s1_h1_of_3": (200, 1, 1, 1, 3, True),
    "s1_h3_same": (200, 1, 1, 3, 3, True),
    "s8_is2": (200, 8, 2, 1, 3, True),
    "s8_is8": (200, 8, 8, 1, 3, True),
    "s4_is2_h2": (200, 4, 2, 2, 3, True),
    "s5_is5_h1": (200, 5, 5, 1, 2, True),
    "s2_is4": (200, 2, 4, 1, 3, False),
    "s5_is2": (200, 5, 2, 1, 3, False),
    "h3_of_2": (200, 8, 1, 3, 2, False),
}


def batches(TL):
    """hard_cases.grid_lengths's reads in two batches, as (codes, lengths,
    T): those of buckets up to 4 tiles at T = 4 (reads shorter than k, of
    one tile, ending inside a tile and at its stale tail, filling and
    passing the bucket), and the one-tile bucket (a read past it)."""
    cases = hard.grid_lengths(TL, 22)
    wide = [n for name, (lens, _) in cases.items()
            if name != "one_tile_bucket" for n in lens]
    return [(*hard.read_batch(wide, 5 * TL, seed=1), 4),
            (*hard.read_batch(cases["one_tile_bucket"][0], 2 * TL, seed=2),
             1)]


@pytest.mark.parametrize("case,mode", [(c, "fastrange") for c in CASES]
                         + [("bench_s8_h1", "mod")])
def test_fused_grid_matches_jax(case, mode):
    TL, S, s_ins, hq, hi, ok = CASES[case]
    jq, tq = params(hq, S, TL, mode)
    ji, ti = params(hi, s_ins, TL, mode)
    assert tdm.query_in_insert_grid(tq, ti) == ok
    fam = FAMS[hi][0]
    if not ok:
        codes, lens, T = batches(TL)[1]
        c, n = torch.from_numpy(codes), torch.from_numpy(lens)
        with pytest.raises(ValueError, match="insert grid"):
            tdm.build_slot_grids(c, n, fam, ti, tq, T)
        with pytest.raises(ValueError, match="insert grid"):
            tcz.build_rank_grids(frozen(0)[1], c, n, fam, ti, tq, T)
        return
    jst, tst = frozen(S * 7 + s_ins)
    for b, (codes, lens, T) in enumerate(batches(TL)):
        c, n = torch.from_numpy(codes), torch.from_numpy(lens)
        want = {}
        for tier, (jp, h) in (("q", (jq, hq)), ("ins", (ji, hi))):
            slots, frame_ok = jdm.build_slot_grid(codes, lens, FAMS[h][1],
                                                  jp, T)
            # the JAX rank map on bench.py's cell; elsewhere the port's
            # plain one (held to it by tests/test_torch_sampled.py)
            ranks = (jcz.rank_grid(jst, slots, SIZE) if case == "bench_s8_h1"
                     else tcz.rank_grid(tst, torch.from_numpy(
                         np.asarray(slots)), SIZE))
            want[tier] = (slots, frame_ok, ranks)
        got_s = tdm.build_slot_grids(c, n, fam, ti, tq, T)
        got_r = tcz.build_rank_grids(tst, c, n, fam, ti, tq, T)
        for k, tier in enumerate(("q", "ins")):
            slots, frame_ok, ranks = want[tier]
            equal(got_s[2 * k], slots, f"batch {b} {tier} slots")
            equal(got_s[2 * k + 1], frame_ok, f"batch {b} {tier} frame_ok")
            equal(got_r[2 * k], ranks, f"batch {b} {tier} ranks")
            equal(got_r[2 * k + 1], frame_ok, f"batch {b} {tier} frame_ok")
        assert got_s[0].shape == (len(lens), hq, T * TL // S)
        assert got_s[0].is_contiguous() and got_s[1].is_contiguous()
        # the stale-tail clamp and invalid frames are in the batch
        assert (want["q"][1].sum() > 0 and not np.asarray(
            want["ins"][1]).all())


def test_query_predicate_needs_one_filter():
    """The two grids must map into one filter: the same size and slot map
    (and k and tile length); a query stride the insert stride divides,
    with seeds that are the first insert seeds, is not enough alone."""
    _, tq = params(1, 8, 200)
    _, ti = params(3, 1, 200)
    assert tdm.query_in_insert_grid(tq, ti)
    for change in (dict(size=SIZE + 1), dict(slot_map="mod"), dict(k=21),
                   dict(tile_length=400), dict(spans=(23,))):
        assert not tdm.query_in_insert_grid(
            dataclasses.replace(tq, **change), ti), change
    # the query tier's gates differ from the insert tier's: no matter
    assert tdm.query_in_insert_grid(
        dataclasses.replace(tq, threshold=1, vote_min=1, vote_topk=32), ti)


# engine settings -> whether the engine fuses the two grids (reuse_q:
# one grid serves both)
ENGINES = {
    "throughput": (dict(frame_stride=8, probe_seeds=1,
                        recheck="optimistic"), True),
    "exact": ({}, False),
    "s2_recheck": (dict(frame_stride=2), True),
    "p1_i2": (dict(recheck="optimistic", probe_seeds=1, insert_seeds=2),
              True),
    "is2": (dict(insert_stride=2), False),
    "s5_is5_p1": (dict(recheck="optimistic", frame_stride=5, probe_seeds=1,
                       insert_stride=5), True),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_fuses_where_the_predicate_holds(name):
    over, fused = ENGINES[name]
    eng = GoldenPathEngine(PathConfig(
        genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
        seed_preset=PRESET, tile_length=1000, **over), device="cpu")
    assert eng.fuse_q == fused
    assert eng.fuse_q == (not eng.reuse_q and tdm.query_in_insert_grid(
        eng.params, eng.params_ins))
    if name == "exact":
        assert eng.reuse_q
