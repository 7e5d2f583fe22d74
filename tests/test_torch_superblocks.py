"""PyTorch port, the compressed filter at 2^32 slots and more: the slot
maps, the freeze with several superblocks, the slot -> rank map and both
engines end to end at 4,603,242,496 slots (two superblocks) equal the JAX
package exactly, and the engine takes a filter of 2^32 slots or more of
either layout (the direct one at the JAX package's allocation).

The JAX package's fastrange wraps its uint64 products past 2^32 slots, so
its slots stay below 2^32 there; the port mirrors the wrap (ROADMAP queue
3).  ``slot_map="mod"`` spreads slots over every superblock."""

import dataclasses
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.config import PathConfig as JPathConfig
from goldrush_tpu.mibf import compressed as jcz
from goldrush_tpu.mibf import mibf as jdm
from goldrush_tpu.path import engine as jengine
from goldrush_tpu.utils import synth

from goldrush_tpu_torch.config import PathConfig, calc_optimal_size
from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.path import engine as tengine
from tests.test_torch_direct_2_32 import (first_filter_allocation,
                                          least_universe_of_2_32)

# hash_universe=485,000,000 sizes the filter at 4,603,242,496 slots
UNIVERSE = 485_000_000
SIZE = 4_603_242_496
SIZES = [(1 << 32) - 64, SIZE, 3 << 32, 56_947_329_536]


# the test_engine_e2e.py configuration, as tests/test_torch_engine.py runs
# it, with the universe of a filter of SIZE slots
CFG = dict(genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
           seed_preset="1011011110110111101101", tile_length=250,
           min_length=1000, threshold=10, block_size=4, unassigned_min=5,
           assigned_max=1, occupancy=0.1, phred_min=15, silver_path=True,
           max_paths=2, ratio=0.5, batch_reads=32, mibf_mode="compressed",
           hash_universe=UNIVERSE)


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_universe_sizes_two_superblocks():
    assert calc_optimal_size(UNIVERSE, 1, 0.1) == SIZE
    assert tcz.n_supers(SIZE) == 2 and tcz.n_supers(SIZES[-1]) == 14


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mode", ["fastrange", "mod"])
def test_slot_of_matches_jax(mode, size):
    """Both packages' slot maps on 200,000 seeded hashes; past 2^32 slots
    fastrange keeps every slot below 2^32, as the JAX function's wrapped
    products do, and mod spreads them over the whole filter."""
    h = np.random.default_rng(size).integers(0, 1 << 64, 200_000,
                                             dtype=np.uint64)
    want = np.asarray(jdm.slot_of(jnp.asarray(h), size, mode))
    got = tdm.slot_of(torch.from_numpy(h.view(np.int64)), size, mode)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got.min() >= 0 and got.max() < size
    if size > 1 << 32:
        assert (got.max() < 1 << 32) == (mode == "fastrange")


class TestTwoSuperblocks:
    """The freeze and the rank map of a seeded ~11%-dense bitmap of SIZE
    slots; its arrays (~4 GB) live for this class's tests only."""

    @pytest.fixture(scope="class")
    def frozen(self):
        """The bitmap frozen by the JAX package's _freeze_from_bits and by
        the port's plain freeze: (bits, the JAX bitrank and supers, the JAX
        sentinel rank, the port's bitrank, supers and pop)."""
        nw = -(-SIZE // 32)
        rng = np.random.default_rng(9)

        def word():
            return rng.integers(0, 1 << 32, nw, dtype=np.uint32)
        bits = word() & word() & word() & (word() | word() | word())
        j = jcz._freeze_from_bits(bits, SIZE)
        jax_arrays = (np.asarray(j.bitrank), np.asarray(j.supers))
        sentinel = j.ids.shape[0] - 1
        del j
        t = tcz.build_rank(torch.from_numpy(bits.view(np.int32)), SIZE)
        return bits, jax_arrays, sentinel, t

    def test_freeze_superblocks_matches_jax(self, frozen):
        """bitrank, supers and pop of the plain freeze (rank_pack,
        rank_scan, rank_carry) against _freeze_from_bits, two
        superblocks."""
        bits, (jbitrank, jsupers), _, (bitrank, supers, pop) = frozen
        assert supers.shape == (2,) and int(supers[1]) > 0
        np.testing.assert_array_equal(supers.numpy().view(np.uint64),
                                      jsupers)
        np.testing.assert_array_equal(bitrank.numpy(),
                                      jbitrank.view(np.int64))
        last = (int(jbitrank[-2] >> np.uint64(32))
                + bin(int(bits[-1])).count("1"))
        assert pop == int(jsupers[-1]) + last
        assert pop == int(jcz._popcount_u32(bits).sum())

    def test_rank_grid_superblocks_matches_jax(self, frozen):
        """The plain slot -> rank map against _rank_lookup on slots of both
        superblocks, either side of 2^32, the last slot and the
        sentinel."""
        _, (jbitrank, jsupers), sentinel, (bitrank, supers, _) = frozen
        rng = np.random.default_rng(10)
        edge = np.arange(-2_000, 2_000, dtype=np.int64) + (1 << 32)
        slots = np.concatenate([
            rng.integers(0, SIZE, 1 << 20), edge,
            np.arange(SIZE - 2_000, SIZE), [SIZE, SIZE, 0]]).astype(np.int64)
        js = jcz.CompressedState(
            bitrank=jnp.asarray(jbitrank), supers=jnp.asarray(jsupers),
            ids=jnp.zeros(sentinel + 1, jnp.uint32),
            counts=jnp.zeros(1, jnp.uint32))
        present, rank = jcz._rank_lookup(
            js, jnp.asarray(slots.view(np.uint64)), SIZE)
        want = np.where(np.asarray(present), np.asarray(rank), sentinel)
        # the map reads the tables' length only: the sentinel rank
        ts = tcz.CompressedState(bitrank, supers,
                                 torch.empty(sentinel + 1, dtype=torch.int32),
                                 torch.empty(0, dtype=torch.int32))
        got = tcz.rank_grid(ts, torch.from_numpy(slots), SIZE).numpy()
        np.testing.assert_array_equal(got, want)
        high = slots >= 1 << 32
        assert (got[high] < sentinel).sum() > 5_000
        assert got[high][got[high] < sentinel].min() >= int(supers[1])
        assert got[-3] == got[-2] == sentinel


@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_check_slice_refuses_direct_filter_at_2_32_slots(monkeypatch, mode):
    """Nothing refuses a filter of 2^32 slots or more of either layout any
    more: ``_check_size`` takes the size of the least universe that reaches
    2^32 slots and 3 << 32 slots, the direct engine goes on to allocate its
    tables at the JAX package's ``MibfParams(size).alloc`` (a spy raises
    before anything of 2^27 entries or more is allocated), and the
    compressed engine allocates nothing at construction.  The wavefront is
    still refused from 2^31 slots on."""
    lo = least_universe_of_2_32(0.1)
    cfg = PathConfig(input="reads.fq", **{**CFG, "mibf_mode": mode,
                                          "hash_universe": lo})
    size = calc_optimal_size(lo, 1, 0.1)
    assert calc_optimal_size(lo - 1, 1, 0.1) < 1 << 32 <= size
    for s in (size, 3 << 32):
        tengine._check_size(cfg, s)
    wave = dataclasses.replace(cfg, recheck="optimistic", wavefront=True)
    for s in (1 << 31, size):
        with pytest.raises(NotImplementedError, match="2\\^31"):
            tengine._check_size(wave, s)
    if mode == "compressed":
        te = tengine.GoldenPathEngine(cfg, device="cpu")
        assert te.size == size and te.state is None
        return
    alloc, _ = first_filter_allocation(
        monkeypatch, lambda: tengine.GoldenPathEngine(cfg, device="cpu"))
    assert alloc == jdm.MibfParams(size=size, h=3, k=22,
                                   spans=(22, 23, 24)).alloc


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_superblocks")
    genome = synth.random_genome(60_000, seed=3)
    reads = synth.simulate_reads(genome, n_reads=120, read_len=3000, seed=4,
                                 err_rate=0.0, phred=20)
    path = str(d / "reads.fq")
    synth.write_fastq(path, reads)
    return d, path


_JAX_INIT_STATE = jdm.init_state


def lean_init_state(params):
    """The JAX engine's init_state without its direct words and counters
    (36.8 GB at SIZE slots): a compressed filter of 2^32 slots or more
    fills its byte transient instead (goldrush_tpu/path/engine.py:366-376)
    and drops the state unread at the freeze, so no output changes."""
    if params.size >= 1 << 32:
        return jdm.MibfState(words=jnp.zeros(0, jnp.uint32),
                             counts=jnp.zeros(0, jnp.uint32))
    return _JAX_INIT_STATE(params)


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("mode", ["mod", "fastrange"])
def test_engine_at_two_superblocks_matches_jax(dataset, monkeypatch, mode):
    """Both engines at SIZE slots (K12's byte fill and freeze_device in the
    JAX package, the bitmap fill and the superblock freeze here), silver
    with two rotations: rows, path files and the final filter equal."""
    d, path = dataset
    monkeypatch.setattr(jengine.dm, "init_state", lean_init_state)
    je = jengine.GoldenPathEngine(JPathConfig(
        input=path, prefix_file=str(d / f"j{mode}"), keep_filter=True,
        slot_map=mode, **CFG))
    js = je.run()
    want = {name: digest(np.asarray(getattr(je.cstate, name)))
            for name in ("bitrank", "supers", "ids", "counts")}
    jrows = je.last_rows
    del je
    te = tengine.GoldenPathEngine(PathConfig(
        input=path, prefix_file=str(d / f"t{mode}"), slot_map=mode, **CFG),
        device="cpu")
    ts = te.run()
    assert te.size == SIZE and te.cstate.supers.shape == (2,)
    assert (ts.recruits, ts.paths_completed) == (js.recruits, 2)
    np.testing.assert_array_equal(te.last_rows, jrows)
    got = {name: digest(a) for name, a in
           tcz.state_to_numpy(te.cstate).items()}
    assert got == want
    for i in (1, 2, 3):
        j, t = d / f"j{mode}_{i}.fq", d / f"t{mode}_{i}.fq"
        assert os.path.exists(j) == os.path.exists(t)
        if os.path.exists(j):
            assert open(j, "rb").read() == open(t, "rb").read()
