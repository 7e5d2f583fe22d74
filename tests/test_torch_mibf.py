"""PyTorch port, direct miBF: presence fill, slot grid, probe/vote, the
reservoir insert, reset and .npz interchange equal goldrush_tpu (and the
NumPy oracle) bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.mibf import mibf as jdm
from goldrush_tpu.mibf.mibf_np import MibfOracle
from goldrush_tpu.ops import nthash_np as onthash
from goldrush_tpu.ops.nthash import build_seed_family as jfamily
from goldrush_tpu.ops.nthash import hash_positions as jhash

from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.ops.nthash import build_seed_family
from goldrush_tpu_torch.ops.seeds import make_seed_pattern

RNG = np.random.default_rng(123)
SEEDS = make_seed_pattern("1011011110110111101101", 22, 16, 3)
FAM, JFAM = build_seed_family(SEEDS), jfamily(SEEDS)
SIZE = 100003          # deliberately not a power of two
TL = 100
KW = dict(size=SIZE, h=3, k=22, spans=(22, 23, 24), tile_length=TL,
          threshold=4, block_size=3, vote_topk=8)
JP, TP = jdm.MibfParams(**KW), tdm.MibfParams(**KW)


def make_batch(lengths, pad, rng=RNG):
    codes = np.zeros((len(lengths), pad), dtype=np.uint8)
    for i, L in enumerate(lengths):
        codes[i, :L] = rng.integers(0, 4, L)
    return codes, np.array(lengths, dtype=np.int32)


def words_np(state):
    return tdm.state_to_numpy(state)


def random_state(alloc, ids=50, present=0.6, rng=RNG):
    """A filter with presence bits and small ids (so votes collide)."""
    w = rng.integers(0, ids, alloc).astype(np.uint32)
    w |= np.where(rng.random(alloc) < present, np.uint32(jdm.PRESENT_BIT),
                  np.uint32(0))
    c = rng.integers(0, 5, alloc).astype(np.uint32)
    return w, c


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
def test_fill_presence_matches_jax(mode):
    codes, lengths = make_batch([505, 333, 30, 0, 1024], 1024)
    P = codes.shape[1] - 22 + 1
    valid = np.zeros((len(lengths), 3, P), dtype=bool)
    for b, L in enumerate(lengths):
        for s, span in enumerate(JP.spans):
            valid[b, s, : max(L - span + 1, 0)] = True
    jw = jdm.fill_presence(jnp.zeros(JP.alloc, jnp.uint32),
                           jhash(codes, JFAM, P), jnp.asarray(valid), SIZE,
                           slot_mode=mode)
    st = tdm.init_state(TP)
    tdm.fill_presence(st.words, torch.from_numpy(codes),
                      torch.from_numpy(lengths), FAM, SIZE, mode)
    # slot `size` is the JAX scatter's dump for invalid frames; real slots
    np.testing.assert_array_equal(words_np(st)[0][:SIZE],
                                  np.asarray(jw)[:SIZE])
    assert int((words_np(st)[0] != 0).sum()) > 1000


@pytest.mark.parametrize("lengths,T", [([505, 423, 150, 99, 0], 5),
                                       ([1000, 1021, 1099], 10),
                                       ([1100, 250], 12)])
def test_build_slot_grid_matches_jax(lengths, T):
    codes, lens = make_batch(lengths, T * TL + TL)
    js, jok = jdm.build_slot_grid(codes, lens, JFAM, JP, T)
    ts, tok = tdm.build_slot_grid(torch.from_numpy(codes),
                                  torch.from_numpy(lens), FAM, TP, T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_and_vote_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T = 6
    codes, lens = make_batch([600, 555, 320, 99, 0, 430], T * TL + TL, rng)
    # a JAX-filled filter, then small ids on its present slots
    P = codes.shape[1] - 21
    jw = jdm.fill_presence(jnp.zeros(JP.alloc, jnp.uint32),
                           jhash(codes, JFAM, P),
                           jnp.ones((len(lens), 3, P), bool), SIZE)
    jw = np.array(jw)
    ids = rng.integers(0, 12, jw.size).astype(np.uint32)
    jw |= np.where(jw != 0, ids, np.uint32(0))
    # saturated words exercise the unmask
    jw[rng.random(jw.size) < 0.05] |= np.uint32(jdm.SAT_BIT)
    slots, ok = jdm.build_slot_grid(codes, lens, JFAM, JP, T)
    for vote_min in (2, 0):
        jpar = dataclasses.replace(JP, vote_min=vote_min)
        tpar = dataclasses.replace(TP, vote_min=vote_min)
        want = jdm.probe_and_vote(jnp.asarray(jw), slots, ok, jpar,
                                  num_tiles=T)
        st = tdm.state_from_numpy(jw, np.zeros_like(jw))
        got = tdm.probe_and_vote(st.words, torch.from_numpy(
            np.array(slots, dtype=np.int64)), torch.from_numpy(
            np.array(ok)), tpar, num_tiles=T)
        for name in got._fields:
            a = getattr(got, name).numpy()
            b = np.asarray(getattr(want, name))
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)
        assert int(got.top_count.max()) > 2 and int(got.overflow.sum()) > 0


def _jax_insert(state, slots, lo, hi, base, trimmed, T):
    keys = jdm.build_insert_keys(jnp.asarray(slots), T)
    return jdm.insert_read_sorted(
        state, keys, jnp.int32(lo), jnp.int32(hi), jnp.uint32(base),
        jnp.asarray(trimmed), jnp.asarray(True), JP, num_tiles=T,
        assume_present=True)


@pytest.mark.parametrize("lo,hi,trimmed", [(0, 11, False), (3, 9, True),
                                           (1, 0, False), (5, 5, True),
                                           (0, 2, True)])
def test_insert_matches_jax(lo, hi, trimmed):
    T = 12
    slots = RNG.integers(0, SIZE // 50, (3, T * TL)).astype(np.int64)
    slots[:, -37:] = SIZE                             # sentinel padding
    slots[1, 100:140] = slots[0, 100:140]             # cross-seed duplicates
    slots[2, 500:540] = slots[0, 100:140]             # same slots, later block
    w, c = random_state(JP.alloc)
    st = tdm.state_from_numpy(w, c)
    js = jdm.MibfState(jnp.asarray(w), jnp.asarray(c))
    for base in (7, 40):
        js = _jax_insert(js, slots, lo, hi, base, trimmed, T)
        tdm.insert_read_sorted(st, torch.from_numpy(slots), lo, hi, base,
                               trimmed, TP, T)
        tw, tc = words_np(st)
        np.testing.assert_array_equal(tw[:SIZE], np.asarray(js.words)[:SIZE])
        np.testing.assert_array_equal(tc[:SIZE], np.asarray(js.counts)[:SIZE])


def test_insert_and_probe_match_oracle():
    """Through the real hashing pipeline: presence fill, probes and whole /
    trimmed inserts against mibf_np.MibfOracle."""
    pool = [RNG.integers(0, 4, 400).astype(np.uint8) for _ in range(5)]
    oracle = MibfOracle(SIZE)
    st = tdm.init_state(TP)
    for r in pool:
        oracle.fill_presence(onthash.multi_seed_canonical(r, SEEDS))
        tdm.fill_presence(st.words, torch.from_numpy(r[None]),
                          torch.tensor([len(r)], dtype=torch.int32), FAM,
                          SIZE)
    np.testing.assert_array_equal(words_np(st)[0][:SIZE], oracle.words[:SIZE])
    T, bs, base = 4, TP.block_size, 1
    for read in pool[:4]:
        slots, ok = tdm.build_slot_grid(
            torch.from_numpy(read[None]),
            torch.tensor([len(read)], dtype=torch.int32), FAM, TP, T)
        v = tdm.probe_and_vote(st.words, slots, ok, TP, num_tiles=T)
        tiles = onthash.tile_frame_hashes(read, SEEDS, TL)
        for t, flat in enumerate(tiles):
            votes = oracle.tile_votes(flat, 3)
            best = max(votes.items(), key=lambda kv: (kv[1], -kv[0]),
                       default=(0, 0))
            assert (int(v.curr_id[0, t]), int(v.top_count[0, t])) == best
        n = len(read) // TL
        for m in range(0, -(-n // bs)):
            oracle.insert_block(np.concatenate(tiles[m * bs:(m + 1) * bs]),
                                base + m)
        tdm.insert_read_sorted(st, slots[0], 0, n - 1, base, False, TP, T)
        base += -(-n // bs) + 2
        np.testing.assert_array_equal(words_np(st)[0][:SIZE],
                                      oracle.words[:SIZE])
        np.testing.assert_array_equal(words_np(st)[1][:SIZE],
                                      oracle.counts[:SIZE])
    # trimmed insert (goldrush_path.cpp:1041-1053): block ids (m*bs+1)/bs
    read = pool[0]
    tiles = onthash.tile_frame_hashes(read, SEEDS, TL)
    slots, _ = tdm.build_slot_grid(
        torch.from_numpy(read[None]),
        torch.tensor([len(read)], dtype=torch.int32), FAM, TP, T)
    start = 1
    while start <= 3:
        end = min(start + bs - 1, 3)
        oracle.insert_block(np.concatenate(tiles[start:end + 1]),
                            500 + (start - 1 + 1) // bs)
        start += bs
    tdm.insert_read_sorted(st, slots[0], 1, 3, 500, True, TP, T)
    np.testing.assert_array_equal(words_np(st)[0][:SIZE], oracle.words[:SIZE])
    np.testing.assert_array_equal(words_np(st)[1][:SIZE], oracle.counts[:SIZE])
    # rotation reset keeps presence only
    oracle.reset_ids()
    tdm.reset_ids(st)
    np.testing.assert_array_equal(words_np(st)[0][:SIZE], oracle.words[:SIZE])
    assert int(st.counts.abs().sum()) == 0


def test_reset_ids_matches_jax():
    w, c = random_state(JP.alloc, ids=1 << 20)
    w[::7] |= np.uint32(jdm.SAT_BIT)
    j = jdm.reset_ids(jdm.MibfState(jnp.asarray(w), jnp.asarray(c)))
    st = tdm.reset_ids(tdm.state_from_numpy(w, c))
    tw, tc = words_np(st)
    np.testing.assert_array_equal(tw, np.asarray(j.words))
    np.testing.assert_array_equal(tc, np.asarray(j.counts))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_npz_interchange(tmp_path, writer):
    w, c = random_state(JP.alloc, ids=1 << 29)
    w[::5] |= np.uint32(jdm.SAT_BIT)
    path = str(tmp_path / "filter.npz")
    if writer == "jax":
        jdm.save_state(jdm.MibfState(jnp.asarray(w), jnp.asarray(c)), JP,
                       path)
        st, meta = tdm.load_state(path)
        got = words_np(st)
    else:
        tdm.save_state(tdm.state_from_numpy(w, c), TP, path)
        st, meta = jdm.load_state(path)
        got = (np.asarray(st.words), np.asarray(st.counts))
    np.testing.assert_array_equal(got[0], w)
    np.testing.assert_array_equal(got[1], c)
    assert meta == dict(size=SIZE, h=3, k=22, spans=(22, 23, 24),
                        tile_length=TL)
