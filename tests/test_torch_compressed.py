"""PyTorch port, rank-compressed miBF: the freeze (from direct words and
from the fill's bitmap), the slot -> rank map and the batch's rank grid,
probe/vote on the id table, the rank-keyed reservoir insert and the reset
equal goldrush_tpu.mibf.compressed bit for bit; the compressed engine never
holds the direct words."""

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

from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.ops.nthash import build_seed_family
from goldrush_tpu_torch.ops.seeds import make_seed_pattern
from goldrush_tpu_torch.path.engine import GoldenPathEngine
from goldrush_tpu_torch.utils import synth

SEEDS = make_seed_pattern("1011011110110111101101", 22, 16, 3)
FAM, JFAM = build_seed_family(SEEDS), jfamily(SEEDS)
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


def bitmap(set_, size):
    """The uint32 bitmap of ceil(size / 32) words whose bit slot & 31 of word
    slot >> 5 is set_[slot]."""
    return np.packbits(np.pad(set_, (0, -size % 32)),
                       bitorder="little").view(np.uint32)


@pytest.mark.parametrize("size", [SIZE, 70_016, 31, 65_536 * 3 + 5])
def test_build_rank_from_bits_matches_jax(size):
    """The freeze of the main path: the fill's bitmap ranked by build_rank
    equals _freeze_from_bits (bitrank, supers, the present count), and bits
    at or past size, which the fill never sets, are ignored."""
    rng = np.random.default_rng(size + 1)
    set_ = rng.random(size) < 0.13
    bits = bitmap(set_, size)
    j = jcz._freeze_from_bits(bits, size)
    bitrank, supers, pop = tcz.build_rank(to_torch(bits), size)
    got = tcz.state_to_numpy(tcz.with_tables(bitrank, supers, pop, size))
    jbr = np.asarray(j.bitrank)
    np.testing.assert_array_equal(got["bitrank"], jbr)
    np.testing.assert_array_equal(got["supers"], np.asarray(j.supers))
    jpop = int(jbr[-2] >> np.uint64(32)) + bin(int(bits[-1])).count("1")
    assert pop == jpop == int(set_.sum())
    dirty = bits.copy()
    dirty[-1] |= np.uint32(0xFFFFFFFF << (size % 32) & 0xFFFFFFFF
                           if size % 32 else 0)
    again, _, pop2 = tcz.build_rank(to_torch(dirty), size)
    assert torch.equal(again, bitrank) and pop2 == pop


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


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
def test_fill_bits_then_build_rank_matches_jax(mode):
    """Several batches into one bitmap (fill_presence_bits), then build_rank
    and with_tables, against freeze_device_words of goldrush_tpu's fill of
    the same batches: the engine's compressed pass 1."""
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
    j = jcz.freeze_device_words(jw, SIZE)
    got = tcz.state_to_numpy(tcz.with_tables(*tcz.build_rank(bits, SIZE),
                                             SIZE))
    for name in ("bitrank", "supers", "ids", "counts"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert int(got["bitrank"][-2] >> np.uint64(32)) > 1000


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
@pytest.mark.parametrize("case", list(hard.grid_lengths(TL, 22)))
def test_build_rank_grid_matches_jax(case, mode):
    """The batch's rank grid (kernel A's rank entry on the card) against
    goldrush_tpu's hash + tile_slot_grid + rank_grid on the lengths the
    grid's tiles and stale-tail clamp branch on
    (goldrush_tpu_torch/hard_cases.py), over a filter holding the batch's
    own slots and a random 5%."""
    lengths, T = hard.grid_lengths(TL, 22)[case]
    codes, lens = hard.read_batch(lengths, T * TL + TL, seed=len(case))
    jpar = dataclasses.replace(JP, slot_map=mode)
    tpar = dataclasses.replace(TP, slot_map=mode)
    P = codes.shape[1] - 21
    jw = np.array(jdm.fill_presence(jnp.zeros(JP.alloc, jnp.uint32),
                                    jhash(codes, JFAM, P),
                                    jnp.ones((len(lens), 3, P), bool), SIZE,
                                    slot_mode=mode))
    rng = np.random.default_rng(len(case))
    jw[rng.random(jw.size) < 0.05] |= np.uint32(jdm.PRESENT_BIT)
    j = jcz.freeze_device_words(jnp.asarray(jw), SIZE)
    t = tcz.freeze(to_torch(jw), SIZE)
    slots, jok = jdm.build_slot_grid(codes, lens, JFAM, jpar, T)
    want = np.asarray(jcz.rank_grid(j, slots, SIZE)).astype(np.int64)
    got, ok = tcz.build_rank_grid(t, torch.from_numpy(codes),
                                  torch.from_numpy(lens), FAM, tpar, T)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    valid = np.asarray(jok)[:, None, :]
    assert (want[~np.broadcast_to(valid, want.shape)] == t.sentinel).all()
    if valid.any():
        assert (want < t.sentinel).sum() > valid.sum()


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


def test_compressed_engine_holds_no_direct_words(tmp_path):
    """A compressed engine allocates no direct words, before or after pass
    1, and freezes the filter a direct engine's pass 1 fills; the direct
    engine's first-write merge leaves every word past size at 0."""
    genome = synth.random_genome(20_000, seed=2)
    path = str(tmp_path / "reads.fq")
    synth.write_fastq(path, synth.simulate_reads(genome, 12, 3000, seed=3,
                                                 err_rate=0.0, phred=20))
    kw = dict(input=path, genome_size=20_000, kmer_size=22, weight=16,
              hash_num=3, seed_preset="1011011110110111101101",
              tile_length=250, min_length=1000, phred_min=15)
    comp = GoldenPathEngine(PathConfig(mibf_mode="compressed", **kw),
                            device="cpu")
    assert comp.state is None
    comp.fill(path)
    assert comp.state is None and comp.cstate is not None
    direct = GoldenPathEngine(PathConfig(**kw), device="cpu")
    direct.fill(path)
    words = direct.state.words
    assert int((words[direct.size:] != 0).sum()) == 0
    assert int((words != 0).sum()) > 1000
    want = tcz.state_to_numpy(tcz.freeze(words, direct.size))
    got = tcz.state_to_numpy(comp.cstate)
    for name in ("bitrank", "supers", "ids", "counts"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
