"""PyTorch port, the throughput mode's functions against goldrush_tpu on the
CPU, bit for bit: strided hashes, hash_at and hash_sampled; the sampled
probe grids (kernel A at a stride) as slots and as ranks; probing a
prefix of a grid's seeds; the max-id-wins insert (insert_max) in both
filters; the trim recheck's zone predicate and tile_min_count; the
optimistic policy's silver reset."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.mibf import compressed as jcz
from goldrush_tpu.mibf import mibf as jdm
from goldrush_tpu.ops import nthash as jnt
from goldrush_tpu.path import engine_util as jeu
from goldrush_tpu_torch import hard_cases as hard
from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.ops import nthash as tnt
from goldrush_tpu_torch.ops.seeds import make_seed_pattern
from goldrush_tpu_torch.path import engine_util as teu

SEEDS = make_seed_pattern("1011011110110111101101", 22, 16, 3)
# h -> (port family, JAX family) of the first h seeds
FAMS = {h: (tnt.build_seed_family(SEEDS[:h]),
            jnt.build_seed_family(SEEDS[:h]))
        for h in (1, 3)}
SIZE = 100003
TL = 200                   # divisible by every stride tested


def params(h, S=1, mode="fastrange", **kw):
    fam = FAMS[h][0]
    kw = {**dict(size=SIZE, h=h, k=22, spans=fam.spans, tile_length=TL,
                 threshold=4, block_size=3, vote_topk=8, frame_stride=S,
                 slot_map=mode), **kw}
    return jdm.MibfParams(**kw), tdm.MibfParams(**kw)


def np_equal(got: torch.Tensor, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(
        got.numpy().dtype) if np.asarray(want).dtype != np.uint64
        else np.asarray(want).view(np.int64), err_msg=msg)


@pytest.mark.parametrize("stride", [2, 4, 5, 8])
def test_strided_hashes_match_jax(stride):
    rng = np.random.default_rng(stride)
    codes = rng.integers(0, 4, (3, 430)).astype(np.uint8)
    for h, (fam, jfam) in FAMS.items():
        want = jnt.hash_positions(jnp.asarray(codes), jfam, 400,
                                  stride=stride)
        np_equal(tnt.hash_positions(torch.from_numpy(codes), fam, 400,
                                    stride), want, f"h={h}")


@pytest.mark.parametrize("width", [330, 500])
def test_hash_at_and_hash_sampled_match_jax(width):
    """hash_at at positions inside, at and past both ends of the codes
    (clipped), and hash_sampled on codes narrower than its frames plus the
    family's padding (padded) and wider."""
    rng = np.random.default_rng(width)
    codes = rng.integers(0, 4, (4, width)).astype(np.uint8)
    for h, (fam, jfam) in FAMS.items():
        pos = rng.integers(-5, width + 40, (4, h, 9)).astype(np.int32)
        pos[:, :, 0] = width - 1
        want = jnt.hash_at(jnp.asarray(codes), jfam, jnp.asarray(pos))
        np_equal(tnt.hash_at(torch.from_numpy(codes), fam,
                             torch.from_numpy(pos)), want, f"hash_at h={h}")
        jhs, jhc = jnt.hash_sampled(jnp.asarray(codes), jfam, 320, 8,
                                    jnp.asarray(pos))
        ths, thc = tnt.hash_sampled(torch.from_numpy(codes), fam, 320, 8,
                                    torch.from_numpy(pos))
        np_equal(ths, jhs, f"strided h={h}")
        np_equal(thc, jhc, f"clamp h={h}")


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("stride", [2, 4, 8])
def test_sampled_grid_matches_jax(stride, h, mode):
    """build_slot_grid at a stride (the last-tile sampled grid at S >= h,
    the general one below) and build_rank_grid against goldrush_tpu's
    build_slot_grid and rank_grid, on the lengths of
    hard_cases.grid_lengths; the port's dense grid subsampled agrees too
    (what kernel A computes)."""
    fam, jfam = FAMS[h]
    jp, tp = params(h, stride, mode)
    rng = np.random.default_rng([stride, h])
    bits = np.packbits(rng.random(-(-SIZE // 32) * 32) < 0.3,
                       bitorder="little").view(np.uint32)
    j = jcz._freeze_from_bits(bits, SIZE)
    t = tcz.with_tables(*tcz.build_rank(torch.from_numpy(
        bits.view(np.int32).copy()), SIZE), SIZE)
    for case, (lengths, T) in hard.grid_lengths(TL, 22).items():
        codes, lens = hard.read_batch(lengths, T * TL + TL, seed=len(case))
        js, jok = jdm.build_slot_grid(codes, lens, jfam, jp, T)
        c, n = torch.from_numpy(codes), torch.from_numpy(lens)
        ts, tok = tdm.build_slot_grid(c, n, fam, tp, T)
        np_equal(ts, js, case)
        np_equal(tok, jok, case)
        dense = tdm.tile_slot_grid(tnt.hash_positions(c, fam, T * TL), n, tp,
                                   T)
        assert torch.equal(dense[0], ts) and torch.equal(dense[1], tok)
        want = np.asarray(jcz.rank_grid(j, js, SIZE))
        tr, trok = tcz.build_rank_grid(t, c, n, fam, tp, T)
        np_equal(tr, want, case)
        np_equal(trok, jok, case)
        assert tr.shape[2] == T * TL // stride


@pytest.mark.parametrize("probe", [1, 2])
@pytest.mark.parametrize("ranked", [False, True])
def test_probe_seeds_match_jax(ranked, probe):
    """probe_and_vote with params.probe_seeds probes the first seeds of a
    wider grid (goldrush_tpu/mibf/mibf.py:370; compressed.py:526)."""
    T = 4
    jp, tp = params(3, probe_seeds=probe)
    grid, ok = hard.vote_case(None, 3, T, TL, 3, tp.vote_topk, tp.vote_min,
                              tp.threshold, seed=probe)
    words = hard.vote_words()
    if ranked:
        ids = np.append(words & np.uint32(0xBFFFFFFF), np.uint32(0))
        ranks = np.where(grid == hard.ABSENT, ids.size - 1, grid)
        want = jcz.probe_and_vote_ranks(jnp.asarray(ids), jnp.asarray(ranks),
                                        jnp.asarray(ok), jp, num_tiles=T)
        state = tcz.CompressedState(
            torch.zeros(1, dtype=torch.int64),
            torch.zeros(1, dtype=torch.int64),
            torch.from_numpy(ids.view(np.int32).copy()),
            torch.zeros(ids.size, dtype=torch.int32))
        got = tcz.probe_and_vote(state, torch.from_numpy(ranks),
                                 torch.from_numpy(ok), tp, num_tiles=T)
    else:
        w = np.zeros(jp.alloc, np.uint32)
        w[:words.size] = words
        want = jdm.probe_and_vote(jnp.asarray(w), jnp.asarray(grid),
                                  jnp.asarray(ok), jp, num_tiles=T)
        got = tdm.probe_and_vote(torch.from_numpy(w.view(np.int32).copy()),
                                 torch.from_numpy(grid), torch.from_numpy(ok),
                                 tp, num_tiles=T)
    for name in got._fields:
        np_equal(getattr(got, name), getattr(want, name), name)
    full = dataclasses.replace(tp, probe_seeds=0)
    assert not torch.equal(got.hits, tdm.probe_and_vote(
        torch.from_numpy(np.append(words, np.zeros(1, np.uint32)).view(
            np.int32).copy()), torch.from_numpy(grid), torch.from_numpy(ok),
        full, num_tiles=T).hits)


# (lo, hi, trimmed, base, block_size)
INSERTS = [(0, 11, False, 7, 3), (3, 9, True, 40, 3), (1, 0, False, 9, 3),
           (5, 5, True, 3, 1), (0, 11, True, 60, 1), (2, 30, False, 11, 4),
           (0, 11, False, tdm.ID_MASK - 12, 1)]


@pytest.mark.parametrize("lo,hi,trimmed,base,bs", INSERTS)
@pytest.mark.parametrize("space", ["slots", "ranks"])
def test_insert_read_max_matches_jax(space, lo, hi, trimmed, base, bs):
    """insert_read_max against goldrush_tpu's in both filters (direct: the
    slot grid's scatter-max of PRESENT | id; compressed: the bare id into
    ids[rank], as insert_read_max on slots and insert_ranks_max on ranks):
    tile ranges inside, past and outside the bucket, trimmed ids, bs 1,
    ids up to ID_MASK, slots contested inside a block and across blocks,
    sentinel entries; counts stay untouched."""
    rng = np.random.default_rng([lo, hi, bs, len(space)])
    T = 12
    jp, tp = params(3, block_size=bs)
    slots = rng.integers(0, SIZE // 50, (3, T * TL)).astype(np.int64)
    slots[:, -37:] = SIZE                             # sentinel padding
    slots[1, 100:140] = slots[0, 100:140]             # contested in a block
    slots[2, 900:940] = slots[0, 100:140]             # and by a later block
    w = rng.integers(0, 50, jp.alloc).astype(np.uint32)
    c = rng.integers(0, 5, jp.alloc).astype(np.uint32)
    args = (jnp.int32(lo), jnp.int32(hi), jnp.uint32(base),
            jnp.asarray(trimmed))
    if space == "slots":
        w |= np.where(rng.random(jp.alloc) < 0.7, np.uint32(jdm.PRESENT_BIT),
                      np.uint32(0))
        want = jdm.insert_read_max(jnp.asarray(w), jnp.asarray(slots), *args,
                                   jp, num_tiles=T)
        st = tdm.state_from_numpy(w, c)
        tdm.insert_read_max(st, torch.from_numpy(slots), lo, hi, base,
                            trimmed, tp, T)
        got_w, got_c = tdm.state_to_numpy(st)
        np.testing.assert_array_equal(got_w[:SIZE], np.asarray(want)[:SIZE])
        np.testing.assert_array_equal(got_c, c)
        return
    pw = np.zeros(jp.alloc, np.uint32)
    pw[np.unique(slots[slots < SIZE])] = jdm.PRESENT_BIT
    pw[rng.random(jp.alloc) < 0.2] = jdm.PRESENT_BIT
    j = jcz.freeze_device_words(jnp.asarray(pw), SIZE)
    ids = rng.integers(0, 50, j.ids.shape[0]).astype(np.uint32)
    cnt = rng.integers(0, 5, j.ids.shape[0]).astype(np.uint32)
    ids[-1] = cnt[-1] = 0
    j = j._replace(ids=jnp.asarray(ids), counts=jnp.asarray(cnt))
    t = tcz.freeze(torch.from_numpy(pw.view(np.int32).copy()), SIZE)
    t = t._replace(ids=torch.from_numpy(ids.view(np.int32).copy()),
                   counts=torch.from_numpy(cnt.view(np.int32).copy()))
    want = np.asarray(jcz.insert_read_max(j, jnp.asarray(slots), *args, jp,
                                          num_tiles=T))
    jranks = jcz.rank_grid(j, jnp.asarray(slots), SIZE)
    want_r = np.asarray(jcz.insert_ranks_max(j.ids, jranks, *args, jp,
                                             num_tiles=T))
    np.testing.assert_array_equal(want, want_r)
    ranks = tcz.rank_grid(t, torch.from_numpy(slots), SIZE)
    tcz.insert_read_max(t, ranks, lo, hi, base, trimmed, tp, T)
    got = tcz.state_to_numpy(t)
    np.testing.assert_array_equal(got["ids"], want)
    np.testing.assert_array_equal(got["counts"], cnt)
    if lo <= min(hi, T - 1):
        assert int((got["ids"] != ids).sum()) > 0


def test_insert_read_max_rejects_ids_past_id_mask():
    _, tp = params(3, block_size=1)
    st = tdm.init_state(tp)
    slots = torch.zeros((3, 4 * TL), dtype=torch.int64)
    with pytest.raises(ValueError, match="2\\^30"):
        tdm.insert_read_max(st, slots, 0, 3, tdm.ID_MASK - 2, False, tp, 4)


# tests/test_recheck_zone.py's boundary vectors: (dec, na, n_tiles, ts, te,
# tmin, stride)
ZONE_VECTORS = [(2, 5, 20, 3, 4, 1000, 8), (0, 20, 20, 0, 19, 1000, 8),
                (0, 20, 20, 0, 19, 2, 8), (0, 20, 20, 0, 19, 3, 8),
                (0, 20, 20, 0, 19, 19, 1), (0, 20, 20, 0, 19, 20, 1),
                (0, 10, 20, 5, 7, 1000, 8), (0, 10, 20, 5, 9, 1000, 8),
                (0, 3, 20, 5, 7, 1000, 8), (0, 4, 20, 5, 7, 1000, 8),
                (1, 0, 20, 0, 19, 0, 8)]


def test_recheck_zone_matches_jax():
    rng = np.random.default_rng(17)
    rand = [tuple(int(x) for x in (rng.integers(0, 3), rng.integers(0, 21),
                                   20, rng.integers(0, 20),
                                   rng.integers(0, 20), rng.integers(0, 40),
                                   rng.choice([1, 2, 5, 8])))
            for _ in range(300)]
    got_true = 0
    for dec, na, n, ts, te, tmin, S in ZONE_VECTORS + rand:
        for thr, a_max in ((10, 1), (3, 0)):
            want = bool(np.asarray(jeu.recheck_zone(
                jnp.int32(dec), jnp.int32(na), jnp.int32(n), jnp.int32(ts),
                jnp.int32(te), jnp.int32(tmin), S, thr, a_max)))
            got = teu.recheck_zone(dec, na, n, ts, te, tmin, S, thr, a_max)
            assert got == want, (dec, na, n, ts, te, tmin, S, thr, a_max)
            got_true += got
    assert 0 < got_true < 2 * (len(ZONE_VECTORS) + len(rand))


def test_tile_min_count_matches_jax():
    rng = np.random.default_rng(5)
    top = rng.integers(0, 60, (9, 7)).astype(np.int32)
    n = np.array([0, 1, 2, 3, 4, 5, 6, 7, 7], np.int32)
    want = np.asarray(jeu.tile_min_count(jnp.asarray(top), jnp.asarray(n)))
    got = teu.tile_min_count(torch.from_numpy(top), torch.from_numpy(n))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == teu.NO_TILE


@pytest.mark.parametrize("space", ["slots", "ranks"])
def test_optimistic_reset_keeps_counts(space):
    """The optimistic policy's silver reset: the direct filter keeps
    PRESENT (words & PRESENT_BIT, goldrush_tpu/path/engine.py:824-825), the
    compressed one zeroes ids only (:771-772); counts stay."""
    rng = np.random.default_rng(8)
    w = rng.integers(0, 1 << 31, 4096).astype(np.uint32)
    c = rng.integers(0, 9, 4096).astype(np.uint32)
    if space == "slots":
        st = tdm.reset_ids(tdm.state_from_numpy(w, c), counts=False)
        got_w, got_c = tdm.state_to_numpy(st)
        np.testing.assert_array_equal(
            got_w, np.asarray(jnp.asarray(w) & jdm.PRESENT_BIT))
    else:
        st = tcz.reset_ids(tcz.CompressedState(
            torch.zeros(1, dtype=torch.int64),
            torch.zeros(1, dtype=torch.int64),
            torch.from_numpy(w.view(np.int32).copy()),
            torch.from_numpy(c.view(np.int32).copy())), counts=False)
        got = tcz.state_to_numpy(st)
        got_w, got_c = got["ids"], got["counts"]
        assert not got_w.any()
    np.testing.assert_array_equal(got_c, c)
