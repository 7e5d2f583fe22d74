"""PyTorch port, direct miBF: presence fill, slot grid, probe/vote, the
reservoir insert, reset and .npz interchange equal goldrush_tpu (and the
NumPy oracle) bit for bit."""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu_torch import hard_cases as hard
from goldrush_tpu.mibf import compressed as jcz
from goldrush_tpu.mibf import mibf as jdm
from goldrush_tpu.mibf.mibf_np import MibfOracle
from goldrush_tpu.ops import nthash_np as onthash
from goldrush_tpu.ops.nthash import build_seed_family as jfamily
from goldrush_tpu.ops.nthash import hash_positions as jhash

from goldrush_tpu_torch.mibf import compressed as tcz
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
    st = tdm.init_state(TP, device="cpu")
    tdm.fill_presence(st.words, torch.from_numpy(codes),
                      torch.from_numpy(lengths), FAM, SIZE, mode)
    # slot `size` is the JAX scatter's dump for invalid frames; real slots
    np.testing.assert_array_equal(words_np(st)[0][:SIZE],
                                  np.asarray(jw)[:SIZE])
    assert int((words_np(st)[0] != 0).sum()) > 1000


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
def test_fill_bits_then_merge_matches_jax(mode):
    """Several batches into one bitmap (fill_presence_bits), one merge,
    against goldrush_tpu's fill_presence batch after batch, on the real
    slots; the bitmap holds exactly the filled slots."""
    jw = jnp.zeros(JP.alloc, jnp.uint32)
    bits = tdm.presence_bitmap(SIZE, device="cpu")
    for i, lengths in enumerate([[505, 333, 30, 0, 1024], [700, 21, 22, 23],
                                 [1024] * 3]):
        codes, lens = hard.read_batch(lengths, 1024, seed=i)
        P = codes.shape[1] - 22 + 1
        valid = np.zeros((len(lens), 3, P), dtype=bool)
        for b, L in enumerate(lens):
            for s, span in enumerate(JP.spans):
                valid[b, s, : max(L - span + 1, 0)] = True
        jw = jdm.fill_presence(jw, jhash(codes, JFAM, P), jnp.asarray(valid),
                               SIZE, slot_mode=mode)
        tdm.fill_presence_bits(bits, torch.from_numpy(codes),
                               torch.from_numpy(lens), FAM, SIZE, mode)
    st = tdm.init_state(TP, device="cpu")
    tdm.merge_presence(st.words, bits, SIZE)
    want = np.asarray(jw)[:SIZE]
    np.testing.assert_array_equal(words_np(st)[0][:SIZE], want)
    assert int(words_np(st)[0][SIZE:].max()) == 0
    flat = np.unpackbits(bits.numpy().view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(flat[:SIZE], want != 0)
    assert int(flat[SIZE:].sum()) == 0 and int(flat.sum()) > 1000


def test_merge_keeps_the_other_bits():
    """A merge ORs PRESENT into the words of set slots and leaves every
    other bit (saturation, id) of every word, and the counters, as they
    were; slots at or past size are never written."""
    rng = np.random.default_rng(5)
    w, c = random_state(JP.alloc, ids=1 << 30, present=0.3, rng=rng)
    w[::3] |= np.uint32(jdm.SAT_BIT)
    set_ = rng.random(SIZE) < 0.4
    set_[-5:] = True
    bits = np.packbits(np.pad(set_, (0, -SIZE % 32)),
                       bitorder="little").view(np.int32)
    st = tdm.state_from_numpy(w, c, device="cpu")
    tdm.merge_presence(st.words, torch.from_numpy(bits.copy()), SIZE)
    want = w.copy()
    want[:SIZE][set_] |= np.uint32(jdm.PRESENT_BIT)
    got_w, got_c = words_np(st)
    np.testing.assert_array_equal(got_w, want)
    np.testing.assert_array_equal(got_c, c)


@pytest.mark.parametrize("size", [31, 33, 64, 1021, SIZE])
def test_first_write_merge_matches_or_on_zeros(size):
    """The merge that closes the direct filter's pass 1 stores every word of
    a dirty allocation: it equals the OR merge into zeroed words, for sizes
    that end inside a 4-slot group and inside a 32-slot word, with 0 on
    slot size and the padding; bitmap bits past size are ignored."""
    rng = np.random.default_rng(size)
    alloc = -(-(size + 1) // 1024) * 1024
    set_ = rng.random(size) < 0.4
    set_[-3:] = True
    bits = np.packbits(np.pad(set_, (0, -size % 32)),
                       bitorder="little").view(np.uint32)
    if size % 32:
        bits[-1] |= np.uint32(0xFFFFFFFF << (size % 32) & 0xFFFFFFFF)
    bits = torch.from_numpy(bits.view(np.int32).copy())
    dirty = rng.integers(-2**31, 2**31, alloc, dtype=np.int64)
    got = tdm.merge_presence(torch.from_numpy(dirty.astype(np.int32)), bits,
                             size, first_write=True)
    want = tdm.merge_presence(torch.zeros(alloc, dtype=torch.int32), bits,
                              size)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(want[:size].numpy() != 0, set_)
    assert int(want[size:].abs().sum()) == 0


@pytest.mark.parametrize("case", list(hard.grid_lengths(TL, 22)))
def test_build_slot_grid_clamp_cases_match_jax(case):
    """The grid against goldrush_tpu on the lengths kernel A's tiles and
    stale-tail clamp branch on (goldrush_tpu_torch/hard_cases.py)."""
    lengths, T = hard.grid_lengths(TL, 22)[case]
    codes, lens = hard.read_batch(lengths, T * TL + TL, seed=len(case))
    js, jok = jdm.build_slot_grid(codes, lens, JFAM, JP, T)
    ts, tok = tdm.build_slot_grid(torch.from_numpy(codes),
                                  torch.from_numpy(lens), FAM, TP, T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


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
        st = tdm.state_from_numpy(jw, np.zeros_like(jw), device="cpu")
        got = tdm.probe_and_vote(st.words, torch.from_numpy(
            np.array(slots, dtype=np.int64)), torch.from_numpy(
            np.array(ok)), tpar, num_tiles=T)
        for name in got._fields:
            a = getattr(got, name).numpy()
            b = np.asarray(getattr(want, name))
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)
        assert int(got.top_count.max()) > 2 and int(got.overflow.sum()) > 0



@pytest.mark.parametrize("kind", hard.VOTE_KINDS)
def test_probe_and_vote_hard_cases_match_jax(kind):
    """The vote against the JAX package on the tiles kernel B's design
    branches on (goldrush_tpu_torch/hard_cases.py): all H*F votes distinct,
    equal counts across rank K, counts at vote_min and at threshold, more
    than K candidates, saturated and plain ID_MASK ids with cross-seed
    duplicates, and tiles without votes; the last tile of each read has no
    frames."""
    T = 4
    grid, ok = hard.vote_case(kind, 3, T, TL, 3, TP.vote_topk, TP.vote_min,
                              TP.threshold, seed=len(kind))
    words = hard.vote_words()
    w = np.zeros(JP.alloc, np.uint32)
    w[:words.size] = words
    want = jdm.probe_and_vote(jnp.asarray(w), jnp.asarray(grid),
                              jnp.asarray(ok), JP, num_tiles=T)
    got = tdm.probe_and_vote(tdm.state_from_numpy(w, np.zeros_like(w), device="cpu").words,
                             torch.from_numpy(grid), torch.from_numpy(ok), TP,
                             num_tiles=T)
    for name in got._fields:
        a = getattr(got, name).numpy()
        np.testing.assert_array_equal(a, np.asarray(getattr(want, name)
                                                    ).astype(a.dtype),
                                      err_msg=name)
    live = got.top_count[:, :-1]
    assert int(got.top_count[:, -1].abs().sum()) == 0
    if kind == "distinct":
        assert bool((live == 1).all()) and int(got.overflow.sum()) == 0
    elif kind in ("ties_at_k", "overflow"):
        assert bool((got.overflow[:, :-1] > 0).all())
    elif kind == "at_gates":
        assert set(live.flatten().tolist()) == {TP.threshold,
                                                TP.threshold + 1}
        assert 0 < int(got.bool_init.sum()) < live.numel()
    elif kind == "id_mask":
        assert bool((got.curr_id[:, :-1] == hard.ID_MASK).any())
    else:
        assert int(live.sum()) == 0 and int(got.hits.sum()) == 0


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
    st = tdm.state_from_numpy(w, c, device="cpu")
    js = jdm.MibfState(jnp.asarray(w), jnp.asarray(c))
    for base in (7, 40):
        js = _jax_insert(js, slots, lo, hi, base, trimmed, T)
        tdm.insert_read_sorted(st, torch.from_numpy(slots), lo, hi, base,
                               trimmed, TP, T)
        tw, tc = words_np(st)
        np.testing.assert_array_equal(tw[:SIZE], np.asarray(js.words)[:SIZE])
        np.testing.assert_array_equal(tc[:SIZE], np.asarray(js.counts)[:SIZE])


RANKS = 20_480          # rank-indexed table length: the sentinel rank is last


def hard_grid(kind, limit, T, rng):
    """A read's [3, T*TL] key grid of the kind kernel D finds hard, with a
    sentinel-padded tail: one repeated k-mer (each seed probes one key at
    every frame), or every key owned by the kernel's first CTA."""
    if kind == "homopolymer":
        g = np.repeat(rng.integers(0, limit, (3, 1)), T * TL, axis=1)
    else:
        keys = torch.arange(limit)
        pool = keys[tdm.insert_part(keys) == 0].numpy()
        g = pool[rng.integers(0, len(pool), (3, T * TL))]
    g[:, -37:] = limit
    return g.astype(np.int64)


@pytest.mark.parametrize("near_max", [False, True])
@pytest.mark.parametrize("bs", [1, 3, 10, 20])
@pytest.mark.parametrize("kind", ["homopolymer", "one_partition"])
@pytest.mark.parametrize("space", ["slots", "ranks"])
def test_insert_hard_cases_match_jax(space, kind, bs, near_max):
    """The reservoir insert against build_insert_keys + insert_read_sorted
    on repeated keys and on keys one CTA of kernel D owns, in both filters'
    key spaces (slots of the direct filter, ranks of the compressed one): a
    whole recruit, then a trimmed one.  ``near_max`` presets the counters at 2^32 - 1 - {0..3},
    so they wrap to 0 (which never accepts), and sets the first key's
    counter and the base id so that it wraps in the key's last block, whose
    id makes u32(key) ^ id == 0xFFFFFFFF."""
    rng = np.random.default_rng([bs, int(near_max), len(kind), len(space)])
    T = 24
    jpar = dataclasses.replace(JP, block_size=bs)
    tpar = dataclasses.replace(TP, block_size=bs)
    slots = space == "slots"
    limit = SIZE if slots else RANKS - 1
    g = hard_grid(kind, limit, T, rng)
    n = JP.alloc if slots else RANKS
    w = rng.integers(0, 1 << 30, n).astype(np.uint32)
    if slots:
        w |= np.uint32(jdm.PRESENT_BIT)
    if near_max:
        c = (0xFFFFFFFF - rng.integers(0, 4, n)).astype(np.uint32)
        k0 = int(g[0, 0])
        blocks = np.unique(np.nonzero((g == k0).any(axis=0))[0] // TL // bs)
        c[k0] = 0xFFFFFFFF - (len(blocks) - 1)
        base = (~k0 - int(blocks[-1])) & 0xFFFFFFFF
    else:
        c = rng.integers(0, 5, n).astype(np.uint32)
        base = 7
    if slots:
        j = jdm.MibfState(jnp.asarray(w), jnp.asarray(c))
        t = tdm.state_from_numpy(w, c, device="cpu")
    else:
        empty = jnp.zeros(1, jnp.uint64)
        j = jcz.CompressedState(empty, empty, jnp.asarray(w), jnp.asarray(c))
        t = tcz.CompressedState(torch.zeros(1, dtype=torch.int64),
                                torch.zeros(1, dtype=torch.int64),
                                torch.from_numpy(w.view(np.int32).copy()),
                                torch.from_numpy(c.view(np.int32).copy()))
    # (rank << 16 | tile) keys are what jcz.build_insert_keys packs
    keys = jdm.build_insert_keys(jnp.asarray(g), T)
    for lo, hi, trimmed in [(0, T - 1, False), (2, T - 3, True)]:
        args = (jnp.int32(lo), jnp.int32(hi), jnp.uint32(base),
                jnp.asarray(trimmed), jnp.asarray(True))
        if slots:
            j = jdm.insert_read_sorted(j, keys, *args, jpar, num_tiles=T,
                                       assume_present=True)
            tdm.insert_read_sorted(t, torch.from_numpy(g), lo, hi, base,
                                   trimmed, tpar, T)
            got = words_np(t)
        else:
            j = jcz.insert_read_sorted(j, keys, *args, jpar, num_tiles=T,
                                       assume_present=True)
            tcz.insert_read_sorted(t, torch.from_numpy(g), lo, hi, base,
                                   trimmed, tpar, T)
            got = (tcz.state_to_numpy(t)["ids"],
                   tcz.state_to_numpy(t)["counts"])
        want = (np.asarray(j.words if slots else j.ids), np.asarray(j.counts))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        base = (base + 40) & 0xFFFFFFFF
    assert (got[1] != c).sum() >= 3 and (got[0] != w).any()


def test_insert_and_probe_match_oracle():
    """Through the real hashing pipeline: presence fill, probes and whole /
    trimmed inserts against mibf_np.MibfOracle."""
    pool = [RNG.integers(0, 4, 400).astype(np.uint8) for _ in range(5)]
    oracle = MibfOracle(SIZE)
    st = tdm.init_state(TP, device="cpu")
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
    st = tdm.reset_ids(tdm.state_from_numpy(w, c, device="cpu"))
    tw, tc = words_np(st)
    np.testing.assert_array_equal(tw, np.asarray(j.words))
    np.testing.assert_array_equal(tc, np.asarray(j.counts))


@pytest.mark.parametrize("fn", [
    tdm.init_state, tdm.load_state, tdm.state_from_numpy,
    tdm.side_from_numpy, tdm.presence_bitmap, tcz.state_from_numpy],
    ids=lambda fn: f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}")
def test_state_constructors_default_to_the_card(fn):
    """Every constructor of a filter's tables (the direct and compressed
    states, the wavefront's side table, the presence bitmap) places them
    on the card unless the caller asks for the CPU, as the JAX package's
    land on its accelerator: without a card, the default raises rather
    than falling back to the CPU."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available() or fn is tdm.load_state:
        return
    args = {tdm.init_state: (TP,),
            tdm.state_from_numpy: (np.zeros(8, np.uint32),) * 2,
            tdm.side_from_numpy: (np.zeros(8, np.uint32),),
            tdm.presence_bitmap: (64,),
            tcz.state_from_numpy: (np.zeros(3, np.uint64),
                                   np.zeros(1, np.uint64),
                                   np.zeros(8, np.uint32),
                                   np.zeros(8, np.uint32))}[fn]
    with pytest.raises((RuntimeError, AssertionError)):
        fn(*args)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_npz_interchange(tmp_path, writer):
    w, c = random_state(JP.alloc, ids=1 << 29)
    w[::5] |= np.uint32(jdm.SAT_BIT)
    path = str(tmp_path / "filter.npz")
    if writer == "jax":
        jdm.save_state(jdm.MibfState(jnp.asarray(w), jnp.asarray(c)), JP,
                       path)
        st, meta = tdm.load_state(path, device="cpu")
        got = words_np(st)
    else:
        tdm.save_state(tdm.state_from_numpy(w, c, device="cpu"), TP, path)
        st, meta = jdm.load_state(path)
        got = (np.asarray(st.words), np.asarray(st.counts))
    np.testing.assert_array_equal(got[0], w)
    np.testing.assert_array_equal(got[1], c)
    assert meta == dict(size=SIZE, h=3, k=22, spans=(22, 23, 24),
                        tile_length=TL)
