"""PyTorch port, ntCard's sizing (--ntcard): the plain sample-and-count,
the F0 estimate, estimate_genome_size and the engine sized by it, against
goldrush_tpu/utils/ntcard.py and the JAX engine, exactly.  The counters
compare on the two banks the estimate reads (the JAX function's discard
slot past them has no counterpart in the port)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from tests.test_torch_throughput import assert_engine_matches_jax
from goldrush_tpu.config import calc_optimal_size as jcalc
from goldrush_tpu.mibf import mibf as jdm
from goldrush_tpu.ops.seeds import make_seed_pattern as jseeds
from goldrush_tpu.utils import ntcard as jnt
from goldrush_tpu.utils import synth

from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.ops.seeds import make_seed_pattern
from goldrush_tpu_torch.path import engine as tengine
from goldrush_tpu_torch.utils import ntcard as tnt
from tests.test_torch_direct_2_32 import (first_filter_allocation,
                                          least_universe_of_2_32)

PRESET = "1011011110110111101101"
SEEDS = make_seed_pattern(PRESET, 22, 16, 3)
# tests/test_torch_engine.py's configuration
CFG = dict(genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
           seed_preset=PRESET, tile_length=250, min_length=1000,
           threshold=10, block_size=4, unassigned_min=5, assigned_max=1,
           occupancy=0.1, phred_min=15)


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers; two
    intra-op threads run these engines at half the CPU time of one per
    core and little more wall time."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def edge_hashes(rbits, sbits, rng):
    """uint64 hashes at and beside both banks' edges, with low bits that
    collide, plus random ones."""
    smask = (1 << (sbits - 1)) - 1
    b0, b1 = 1 << (63 - sbits), smask << (64 - sbits)
    edges = [b0 - 1, b0, b0 + 1, 2 * b0 - 1, 2 * b0, b1 - 1, b1, b1 + 1,
             b1 + (1 << (64 - sbits)) - 1, b1 + (1 << (64 - sbits)), 0,
             (1 << 64) - 1, 1 << 63]
    low = rng.integers(0, 1 << rbits, 64, dtype=np.uint64)
    in0 = np.uint64(b0) | low          # bank 0, colliding low bits
    in1 = np.uint64(b1) | low          # bank 1, the same slots
    rand = rng.integers(0, 1 << 64, 50_000, dtype=np.uint64,
                        endpoint=False)
    return np.concatenate([np.array(edges, dtype=np.uint64), in0, in0, in0,
                           in0, in1, rand])


@pytest.mark.parametrize("rbits,sbits", [(10, 3), (18, 5), (22, 7)])
def test_sample_and_count_matches_jax(rbits, sbits):
    """_sample_and_count's plain version against the JAX function on
    seeded random hashes and hashes at the bank edges, with valid masks,
    over two calls; compared on the two banks."""
    rng = np.random.default_rng([rbits, sbits])
    rbuck = 1 << rbits
    j = jnp.zeros(2 * rbuck + 1, dtype=jnp.uint32)
    t = torch.zeros(2 * rbuck, dtype=torch.int32)
    for _ in range(2):
        h = edge_hashes(rbits, sbits, rng)
        valid = rng.random(h.shape[0]) < 0.8
        valid[:13] = True
        j = jnt._sample_and_count(j, jnp.asarray(h), jnp.asarray(valid),
                                  rbits, sbits)
        tnt._sample_and_count(t, torch.from_numpy(h.view(np.int64)),
                              torch.from_numpy(valid), rbits, sbits)
    want = np.asarray(j)[: 2 * rbuck]
    np.testing.assert_array_equal(t.numpy().view(np.uint32), want)
    assert want.max() >= 3 and want[:rbuck].sum() > 0 and \
        want[rbuck:].sum() > 0


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_estimate_f0_matches_jax(kind):
    """_estimate_f0 against the JAX function, F0 and spectrum: the JAX
    function on a uint32 numpy counter, the port's on the int32 tensor of
    its bits (counters past 65,535 and past 2^31 included)."""
    rng = np.random.default_rng(len(kind))
    rbits, sbits = 14, 7
    n = 2 << rbits
    if kind == "sparse":
        c = np.where(rng.random(n) < 0.05, rng.geometric(0.4, n), 0)
    else:
        c = rng.poisson(3.0, n)
    c = c.astype(np.uint32)
    c[:4] = [65534, 65535, 70_000, 0xFFFFFFF0]
    jf0, jspec = jnt._estimate_f0(c, rbits, sbits, 10000)
    f0, spec = tnt._estimate_f0(torch.from_numpy(c.view(np.int32).copy()),
                                rbits, sbits, 10000)
    assert f0 == jf0 and type(f0) is float
    np.testing.assert_array_equal(spec, jspec)


def write_reads(path, genome, genome_seed, n, length, seed, **kw):
    g = synth.random_genome(genome, seed=genome_seed)
    synth.write_fastq(path, synth.simulate_reads(g, n, length, seed=seed,
                                                 **kw))


def write_odd_reads(path):
    """Reads with N and other non-ACGT bases, lower case, shorter than k,
    of length k .. k + 2 (shorter than the longer seeds' spans), and
    empty."""
    rng = np.random.default_rng(5)
    seqs = []
    for L in (0, 5, 21, 22, 23, 24, 25, 300, 1000, 2500):
        s = bytearray(rng.choice(list(b"ACGT"), L))
        for i in rng.integers(0, max(L, 1), L // 40 + (L > 0)):
            if L:
                s[i] = ord("N")
        seqs.append(bytes(s))
    seqs.append(b"acgtRYnnACGT" * 40)
    seqs.append(b"N" * 60)
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@r%d x\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))


def counters_of(monkeypatch, module, run):
    """Run ``run`` and return the per-seed counters it hands
    ``module._estimate_f0``, as uint32 numpy arrays."""
    seen = []
    real = module._estimate_f0

    def spy(counter, *args):
        c = counter.numpy().view(np.uint32) if isinstance(
            counter, torch.Tensor) else np.asarray(counter)
        seen.append(c.copy())
        return real(counter, *args)
    monkeypatch.setattr(module, "_estimate_f0", spy)
    out = run()
    monkeypatch.undo()
    return out, seen


DATASETS = {
    # tests/test_ntcard.py's two datasets, each at the params it uses
    "f0": (dict(genome=80_000, genome_seed=91, n=160, length=3000,
                seed=92, err_rate=0.0), (18, 5)),
    "engine": (dict(genome=30_000, genome_seed=93, n=60, length=3000,
                    seed=94), (22, 7)),
    "odd": (None, (10, 3)),
}


@pytest.mark.parametrize("name", list(DATASETS))
def test_estimate_genome_size_matches_jax(tmp_path, monkeypatch, name):
    """estimate_genome_size(device="cpu") returns the JAX package's integer,
    from the same counters, on tests/test_ntcard.py's datasets and on a
    file of N bases and reads shorter than the spans."""
    ds, (rbits, sbits) = DATASETS[name]
    path = str(tmp_path / "r.fq")
    if ds is None:
        write_odd_reads(path)
    else:
        write_reads(path, **ds)
    jp, tp = jnt.NtCardParams(rbits=rbits, sbits=sbits), \
        tnt.NtCardParams(rbits=rbits, sbits=sbits)
    want, jc = counters_of(monkeypatch, jnt, lambda: jnt.estimate_genome_size(
        path, jseeds(PRESET, 22, 16, 3), jp))
    got, tc = counters_of(monkeypatch, tnt, lambda: tnt.estimate_genome_size(
        path, SEEDS, tp, device="cpu"))
    assert type(got) is int and got == want and got > 0
    assert len(tc) == len(jc) == 3
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch_bases", [1, 5000, 1 << 24])
def test_port_batching_matches_jax_blocks(tmp_path, monkeypatch,
                                          batch_bases):
    """The port packs reads into batches by bases (one read per batch,
    a few, all of them), the JAX package in blocks of 64 records: the same
    counters and estimate."""
    path = str(tmp_path / "r.fq")
    write_reads(path, genome=20_000, genome_seed=7, n=150, length=1500,
                seed=8, err_rate=0.02)
    with open(path, "ab") as f:          # a short and an N-rich record
        f.write(b"@s\nACGTN\n+\nIIIII\n@t\n" + b"ACGTNACGTA" * 9
                + b"\n+\n" + b"I" * 90 + b"\n")
    p = (12, 4)
    want, jc = counters_of(monkeypatch, jnt, lambda: jnt.estimate_genome_size(
        path, jseeds(PRESET, 22, 16, 3), jnt.NtCardParams(*p)))
    batches = []
    real = tnt.ntcard_count

    def count(counters, batch, *rest):
        batches.append(batch.offsets.shape[0] - 1)
        return real(counters, batch, *rest)
    monkeypatch.setattr(tnt, "BATCH_BASES", batch_bases)
    monkeypatch.setattr(tnt, "ntcard_count", count)
    got, tc = counters_of(monkeypatch, tnt, lambda: tnt.estimate_genome_size(
        path, SEEDS, tnt.NtCardParams(*p), device="cpu"))
    assert got == want and sum(batches) == 152
    assert len(batches) == {1: 152, 5000: 38, 1 << 24: 1}[batch_bases]
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_ntcard")
    genome = synth.random_genome(60_000, seed=3)
    reads = synth.simulate_reads(genome, n_reads=120, read_len=3000, seed=4,
                                 err_rate=0.0, phred=20)
    path = str(d / "reads.fq")
    synth.write_fastq(path, reads)
    return d, path


@pytest.mark.parametrize("silver", [True, False])
@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_engine_with_ntcard_matches_jax(dataset, mode, silver):
    """The engine sized by ntCard: the JAX engine's universe and size, and
    its files, counters, rows and final filter, with either filter, silver
    and golden."""
    over = dict(ntcard=True, mibf_mode=mode, batch_reads=32,
                silver_path=silver)
    je, te = assert_engine_matches_jax(*dataset, f"nt-{mode}-{silver}",
                                       over)
    assert (te.universe, te.size) == (je.universe, je.size)
    assert te.universe != PathConfig(**CFG).derived_hash_universe()
    assert te.stats.wall_ntcard_s > 0


def test_explicit_universe_wins_over_ntcard(dataset, monkeypatch):
    """hash_universe set beside ntcard=True: no estimate runs."""
    def boom(*a, **k):
        raise AssertionError("ntCard ran")
    monkeypatch.setattr(tengine, "estimate_genome_size", boom)
    d, path = dataset
    te = tengine.GoldenPathEngine(PathConfig(
        input=path, **{**CFG, "ntcard": True, "hash_universe": 123_457}),
        device="cpu")
    assert te.universe == 123_457 and te.stats.wall_ntcard_s == 0


@pytest.mark.parametrize("how", ["estimate", "occupancy"])
def test_ntcard_sized_direct_filter_past_2_32_raises(dataset, monkeypatch,
                                                      how):
    """An ntCard estimate that sizes the direct filter at 2^32 slots or
    more is taken: the estimator stubbed to the least universe that
    reaches 2^32 slots, or the real estimate at a tiny occupancy.  The
    engine goes on to allocate its tables at the JAX package's
    ``MibfParams(size).alloc`` for the size both packages' closed form
    gives; a spy raises there, before anything of 2^27 entries or more is
    allocated (ntCard's counters are 3 x 2^23).  The wavefront at that
    size is still refused."""
    d, path = dataset
    kw = dict(CFG, ntcard=True)
    if how == "estimate":
        u = least_universe_of_2_32(0.1)
        monkeypatch.setattr(tengine, "estimate_genome_size",
                            lambda *a, **k: u)
    else:
        kw["occupancy"] = 1e-5
    sized = []
    real_size = tengine.calc_optimal_size

    def calc(universe, h, occupancy):
        sized.append((universe, real_size(universe, h, occupancy)))
        return sized[-1][1]
    monkeypatch.setattr(tengine, "calc_optimal_size", calc)
    alloc, sizes = first_filter_allocation(
        monkeypatch,
        lambda: tengine.GoldenPathEngine(PathConfig(input=path, **kw),
                                         device="cpu"))
    (universe, size), = sized
    assert size >= 1 << 32
    assert size == jcalc(universe, 1, kw.get("occupancy", 0.1))
    assert alloc == jdm.MibfParams(size=size, h=3, k=22,
                                   spans=(22, 23, 24)).alloc
    if how == "occupancy":
        # ntCard's counters are the largest allocation before the filter's
        assert sizes[0] == 3 << 23
    # the wavefront at that size is refused; the compressed filter is not
    with pytest.raises(NotImplementedError, match="2\\^31"):
        tengine._check_size(dataclasses.replace(
            PathConfig(input=path, **kw), recheck="optimistic",
            wavefront=True), size)
    tengine._check_size(dataclasses.replace(
        PathConfig(input=path, **kw), mibf_mode="compressed"), 1 << 33)
