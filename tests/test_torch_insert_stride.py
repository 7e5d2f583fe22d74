"""PyTorch port, the sampled inserts: an insert grid at insert_stride > 1
and of insert_seeds < h seeds.  The plain reservoir insert (kernel D's) and
the max-id-wins insert at a stride against goldrush_tpu's
insert_read_sorted / insert_read_max with the insert grid's params, in both
filters' key spaces; then the engine in every policy and filter, bit for
bit against goldrush_tpu: files, counters, decision rows and the final
filter (tests/test_torch_throughput_gate.py holds the 1 Mbp gate dataset)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from tests.test_torch_throughput import (BENCH_SMALL, CFG, OPT,
                                         assert_engine_matches_jax)
from goldrush_tpu.config import PathConfig as JPathConfig
from goldrush_tpu.path.engine import GoldenPathEngine as JEngine
from goldrush_tpu.mibf import compressed as jcz
from goldrush_tpu.mibf import mibf as jdm
from goldrush_tpu.ops.nthash import build_seed_family as jfamily
from goldrush_tpu.utils import synth

from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.ops.seeds import make_seed_pattern
from goldrush_tpu_torch.path.engine import GoldenPathEngine

SEEDS = make_seed_pattern("1011011110110111101101", 22, 16, 3)
SIZE = 100_003
RANKS = 20_480          # rank-indexed table length: the sentinel rank is last
TL = 100
KW = dict(size=SIZE, h=3, k=22, spans=(22, 23, 24), tile_length=TL,
          threshold=10, block_size=3, vote_topk=8, vote_min=2)


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers; two
    intra-op threads run these engines at half the CPU time of one per
    core and little more wall time."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def stride_grid(stride, space, T, rng):
    """A read's insert grid [3, T*TL/stride] at ``stride``: the JAX
    package's sampled slot grid of random reads (direct filter), or its
    slots taken modulo the rank table's sentinel (ranks), with a read that
    ends inside the last tile so that the tail is sentinel-padded."""
    jp = jdm.MibfParams(**KW, frame_stride=stride)
    L = T * TL + TL // 2
    codes = np.zeros((1, L + TL), dtype=np.uint8)
    codes[0, :L] = rng.integers(0, 4, L)
    codes[0, 300:340] = codes[0, 100:140]         # a repeat, later block
    slots, _ = jdm.build_slot_grid(jnp.asarray(codes),
                                   jnp.asarray([L - TL], jnp.int32),
                                   jfamily(SEEDS), jp, T)
    g = np.asarray(slots)[0].astype(np.int64)
    if space == "ranks":
        g = np.where(g < SIZE, g % (RANKS // 8), RANKS - 1)
    return g


def states(space, rng):
    """The same filter as a JAX state and a port state: present words with
    small ids (direct) or a rank-indexed id table, and small counters."""
    n = jdm.MibfParams(**KW).alloc if space == "slots" else RANKS
    w = rng.integers(0, 50, n).astype(np.uint32)
    if space == "slots":
        w |= np.uint32(jdm.PRESENT_BIT)
    c = rng.integers(0, 5, n).astype(np.uint32)
    if space == "slots":
        return (jdm.MibfState(jnp.asarray(w), jnp.asarray(c)),
                tdm.state_from_numpy(w, c, device="cpu"))
    empty = jnp.zeros(1, jnp.uint64)
    zero = torch.zeros(1, dtype=torch.int64)
    return (jcz.CompressedState(empty, empty, jnp.asarray(w), jnp.asarray(c)),
            tcz.CompressedState(zero, zero,
                                torch.from_numpy(w.view(np.int32).copy()),
                                torch.from_numpy(c.view(np.int32).copy())))


def tables(j, t, space):
    if space == "slots":
        return ((np.asarray(j.words), np.asarray(j.counts)),
                tdm.state_to_numpy(t))
    got = tcz.state_to_numpy(t)
    return (np.asarray(j.ids), np.asarray(j.counts)), (got["ids"],
                                                       got["counts"])


@pytest.mark.parametrize("insert", ["sorted", "max"])
@pytest.mark.parametrize("space", ["slots", "ranks"])
@pytest.mark.parametrize("stride", [2, 4])
def test_plain_inserts_at_a_stride_match_jax(stride, space, insert):
    """Kernel D's plain reservoir insert and insert_max's plain version on
    an insert grid at ``stride`` (F = TL / stride frames per tile): a whole
    recruit, then a trimmed one, against insert_read_sorted and
    insert_read_max with the insert grid's params."""
    rng = np.random.default_rng([stride, len(space), len(insert)])
    T = 12
    jp = jdm.MibfParams(**KW, frame_stride=stride)
    tp = tdm.MibfParams(**KW, frame_stride=stride)
    g = stride_grid(stride, space, T, rng)
    assert g.shape == (3, T * TL // stride)
    j, t = states(space, rng)
    before = tables(j, t, space)[1]
    base = 7
    for lo, hi, trimmed in [(0, T - 1, False), (2, 8, True), (5, 5, True)]:
        args = (jnp.int32(lo), jnp.int32(hi), jnp.uint32(base),
                jnp.asarray(trimmed))
        gt = torch.from_numpy(g)
        if insert == "sorted":
            if space == "slots":
                keys = jdm.build_insert_keys(jnp.asarray(g), T)
                j = jdm.insert_read_sorted(j, keys, *args, jnp.asarray(True),
                                           jp, num_tiles=T,
                                           assume_present=True)
                tdm.insert_read_sorted(t, gt, lo, hi, base, trimmed, tp, T)
            else:
                keys = jdm.build_insert_keys(jnp.asarray(g), T)
                j = jcz.insert_read_sorted(j, keys, *args, jnp.asarray(True),
                                           jp, num_tiles=T,
                                           assume_present=True)
                tcz.insert_read_sorted(t, gt, lo, hi, base, trimmed, tp, T)
        elif space == "slots":
            j = jdm.MibfState(jdm.insert_read_max(j.words, jnp.asarray(g),
                                                  *args, jp, num_tiles=T),
                              j.counts)
            tdm.insert_read_max(t, gt, lo, hi, base, trimmed, tp, T)
        else:
            j = jcz.CompressedState(
                j.bitrank, j.supers,
                jcz.insert_ranks_max(j.ids, jnp.asarray(g.astype(np.int32)),
                                     *args, jp, num_tiles=T), j.counts)
            tcz.insert_read_max(t, gt, lo, hi, base, trimmed, tp, T)
        want, got = tables(j, t, space)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        base += 40
    assert (got[0] != before[0]).sum() > 50


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_insert_stride")
    genome = synth.random_genome(60_000, seed=3)
    reads = synth.simulate_reads(genome, n_reads=120, read_len=3000, seed=4,
                                 err_rate=0.0, phred=20)
    path = str(d / "reads.fq")
    synth.write_fastq(path, reads)
    return d, path


CASES = {
    # bench.py's throughput cell at this size with sampled inserts
    "bench-is2-compressed": dict(BENCH_SMALL, insert_stride=2),
    "bench-is8-direct": dict(BENCH_SMALL, insert_stride=8,
                             mibf_mode="direct"),
    # the exact policy inserting every 2nd / 5th frame (no recheck)
    "exact-is2-silver-b32": dict(insert_stride=2, batch_reads=32,
                                 silver_path=True),
    "exact-is5-golden-b1": dict(insert_stride=5, batch_reads=1),
    # two insert seeds over one probed seed: the recheck probes both
    "opt-p1-i2-silver-b32": dict(OPT, probe_seeds=1, insert_seeds=2,
                                 batch_reads=32, silver_path=True),
    # one seed everywhere, sampled queries, full-resolution inserts
    "opt-s5-p1-i1-compressed": dict(OPT, frame_stride=5, probe_seeds=1,
                                    insert_seeds=1, batch_reads=32,
                                    silver_path=True,
                                    mibf_mode="compressed"),
    # the exact policy on two of three seeds (query grid = insert grid)
    "exact-p2-i2-silver-b32": dict(probe_seeds=2, insert_seeds=2,
                                   batch_reads=32, silver_path=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sampled_insert_engine_matches_jax(dataset, case):
    assert_engine_matches_jax(*dataset, case, CASES[case])


@pytest.mark.parametrize("stride", [3, 8])
def test_insert_stride_must_divide_tile_length(stride):
    """An insert stride that does not divide tile_length (250) raises at
    construction in both packages."""
    kw = {**CFG, "insert_stride": stride}
    with pytest.raises(ValueError, match="insert_stride must divide"):
        JEngine(JPathConfig(**kw))
    with pytest.raises(ValueError, match="insert_stride must divide"):
        GoldenPathEngine(PathConfig(**kw), device="cpu")
