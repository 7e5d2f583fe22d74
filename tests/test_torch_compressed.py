"""PyTorch port, rank-compressed miBF: the freeze, the slot -> rank map,
probe/vote on the id table, the rank-keyed reservoir insert and the reset
equal goldrush_tpu.mibf.compressed bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu_torch import hard_cases as hard
from goldrush_tpu.mibf import compressed as jcz
from goldrush_tpu.mibf import mibf as jdm
from goldrush_tpu.ops.nthash import build_seed_family as jfamily
from goldrush_tpu.ops.nthash import hash_positions as jhash

from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.ops.seeds import make_seed_pattern

SEEDS = make_seed_pattern("1011011110110111101101", 22, 16, 3)
JFAM = jfamily(SEEDS)
SIZE = 100003          # not a multiple of 32: the last word is masked
TL = 100
KW = dict(size=SIZE, h=3, k=22, spans=(22, 23, 24), tile_length=TL,
          threshold=4, block_size=3, vote_topk=8)
JP, TP = jdm.MibfParams(**KW), tdm.MibfParams(**KW)


def presence_words(size, rng, density=0.13):
    """Direct-layout words with PRESENT on a random tenth of the slots, on
    slot `size` (the JAX fill's dump) and with id bits to be ignored."""
    alloc = -(-(size + 1) // 1024) * 1024
    w = rng.integers(0, 1 << 30, alloc).astype(np.uint32)
    w |= np.where(rng.random(alloc) < density, np.uint32(jdm.PRESENT_BIT),
                  np.uint32(0))
    w[size] |= np.uint32(jdm.PRESENT_BIT)
    return w


def to_torch(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(
        np.int32 if a.dtype == np.uint32 else np.int64).copy())


def frozen_pair(size, rng):
    w = presence_words(size, rng)
    j = jcz.freeze_device_words(jnp.asarray(w), size)
    t = tcz.freeze(to_torch(w), size)
    return j, t


@pytest.mark.parametrize("size", [SIZE, 70_016, 31, 65_536 * 3 + 5])
def test_freeze_matches_jax(size):
    j, t = frozen_pair(size, np.random.default_rng(size))
    got = tcz.state_to_numpy(t)
    for name in ("bitrank", "supers", "ids", "counts"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(j, name)),
                                      err_msg=name)


def batch(rng, T, lengths):
    codes = np.zeros((len(lengths), T * TL + TL), dtype=np.uint8)
    for i, L in enumerate(lengths):
        codes[i, :L] = rng.integers(0, 4, L)
    return codes, np.array(lengths, np.int32)


def test_rank_grid_matches_jax():
    rng = np.random.default_rng(5)
    j, t = frozen_pair(SIZE, rng)
    codes, lens = batch(rng, 6, [600, 555, 99, 0])
    slots, _ = jdm.build_slot_grid(codes, lens, JFAM, JP, 6)
    s = np.array(slots, dtype=np.int64)
    s[0, 0, :50] = rng.integers(0, SIZE, 50)          # more present slots
    want = np.asarray(jcz.rank_grid(j, jnp.asarray(s), SIZE))
    got = tcz.rank_grid(t, torch.from_numpy(s), SIZE).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert (got < t.sentinel).sum() > 100 and (got == t.sentinel).any()


def filled_pair(rng, codes_lengths, T):
    """Both packages' compressed filters over the same reads' presence, with
    small ids on the present ranks so votes collide."""
    codes, lens = codes_lengths
    P = codes.shape[1] - 21
    jw = jdm.fill_presence(jnp.zeros(JP.alloc, jnp.uint32),
                           jhash(codes, JFAM, P),
                           jnp.ones((len(lens), 3, P), bool), SIZE)
    jw = np.array(jw)
    # plus random presence so ranks are not all the reads' own
    jw[rng.random(jw.size) < 0.05] |= np.uint32(jdm.PRESENT_BIT)
    j = jcz.freeze_device_words(jnp.asarray(jw), SIZE)
    t = tcz.freeze(to_torch(jw), SIZE)
    ids = rng.integers(0, 12, j.ids.shape[0]).astype(np.uint32)
    cnt = rng.integers(0, 4, j.ids.shape[0]).astype(np.uint32)
    ids[-1] = cnt[-1] = 0                              # the sentinel rank
    j = j._replace(ids=jnp.asarray(ids), counts=jnp.asarray(cnt))
    t = t._replace(ids=to_torch(ids), counts=to_torch(cnt))
    return j, t


@pytest.mark.parametrize("vote_min", [2, 0])
def test_probe_and_vote_matches_jax(vote_min):
    rng = np.random.default_rng(11 + vote_min)
    T = 6
    codes, lens = batch(rng, T, [600, 555, 320, 99, 0, 430])
    j, t = filled_pair(rng, (codes, lens), T)
    slots, ok = jdm.build_slot_grid(codes, lens, JFAM, JP, T)
    jpar = dataclasses.replace(JP, vote_min=vote_min)
    tpar = dataclasses.replace(TP, vote_min=vote_min)
    want = jcz.probe_and_vote(j, slots, ok, jpar, num_tiles=T)
    ranks = tcz.rank_grid(t, torch.from_numpy(np.array(slots, np.int64)),
                          SIZE)
    got = tcz.probe_and_vote(t, ranks, torch.from_numpy(np.array(ok)), tpar,
                             num_tiles=T)
    for name in got._fields:
        a = getattr(got, name).numpy()
        np.testing.assert_array_equal(a, np.asarray(getattr(want, name)
                                                    ).astype(a.dtype),
                                      err_msg=name)
    assert int(got.top_count.max()) > 2 and int(got.hits.sum()) > 0



@pytest.mark.parametrize("kind", hard.VOTE_KINDS)
def test_probe_and_vote_ranks_hard_cases_match_jax(kind):
    """The vote on a rank grid (kernel B on the id table) against the JAX
    package's probe_and_vote_ranks on the tiles kernel B's design branches
    on (goldrush_tpu_torch/hard_cases.py); the absent word's rank is the
    sentinel."""
    T = 4
    grid, ok = hard.vote_case(kind, 3, T, TL, 3, TP.vote_topk, TP.vote_min,
                              TP.threshold, seed=7 + len(kind))
    ids = np.append(hard.vote_words() & np.uint32(0xBFFFFFFF), np.uint32(0))
    ranks = np.where(grid == hard.ABSENT, ids.size - 1, grid)
    want = jcz.probe_and_vote_ranks(jnp.asarray(ids), jnp.asarray(ranks),
                                    jnp.asarray(ok), JP, num_tiles=T)
    state = tcz.CompressedState(torch.zeros(1, dtype=torch.int64),
                                torch.zeros(1, dtype=torch.int64),
                                to_torch(ids), to_torch(np.zeros_like(ids)))
    got = tcz.probe_and_vote(state, torch.from_numpy(ranks),
                             torch.from_numpy(ok), TP, num_tiles=T)
    for name in got._fields:
        a = getattr(got, name).numpy()
        np.testing.assert_array_equal(a, np.asarray(getattr(want, name)
                                                    ).astype(a.dtype),
                                      err_msg=name)
    if kind != "no_votes":
        assert int(got.top_count.max()) > 0


@pytest.mark.parametrize("lo,hi,trimmed", [(0, 11, False), (3, 9, True),
                                           (1, 0, False), (5, 5, True)])
def test_insert_matches_jax(lo, hi, trimmed):
    rng = np.random.default_rng(lo * 10 + hi)
    T = 12
    codes, lens = batch(rng, T, [T * TL + 50, 700])
    j, t = filled_pair(rng, (codes, lens), T)
    slots, _ = jdm.build_slot_grid(codes, lens, JFAM, JP, T)
    s = np.array(slots[0], dtype=np.int64)
    s[2, 500:540] = s[0, 100:140]          # same slots, a later block
    for base in (7, 40):
        keys = jcz.build_insert_keys(j, jnp.asarray(s), JP, T)
        j = jcz.insert_read_sorted(j, keys, jnp.int32(lo), jnp.int32(hi),
                                   jnp.uint32(base), jnp.asarray(trimmed),
                                   jnp.asarray(True), JP, num_tiles=T,
                                   assume_present=True)
        ranks = tcz.rank_grid(t, torch.from_numpy(s), SIZE)
        tcz.insert_read_sorted(t, ranks, lo, hi, base, trimmed, TP, T)
        got = tcz.state_to_numpy(t)
        np.testing.assert_array_equal(got["ids"], np.asarray(j.ids))
        np.testing.assert_array_equal(got["counts"], np.asarray(j.counts))


def test_reset_ids_matches_jax():
    rng = np.random.default_rng(3)
    codes, lens = batch(rng, 4, [400])
    j, t = filled_pair(rng, (codes, lens), 4)
    j = jcz.reset_ids(j)
    got = tcz.state_to_numpy(tcz.reset_ids(t))
    for name in ("bitrank", "supers", "ids", "counts"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(j, name)),
                                      err_msg=name)
