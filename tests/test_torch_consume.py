"""PyTorch port, the consume scan (K9) of one batch: ``consume_batch_plain``
against the JAX engine's per-batch executable
(``GoldenPathEngine._consume_for(B, T)``), both starting from one filter
filled by the JAX package and carried across to the port, on the same
batches of the test_torch_engine.py dataset: the rows of every read of the
padded batch, ``scal`` and the filter, bit for bit, in exact and
optimistic mode with either filter, around an in-batch silver rotation,
the ``done`` latch and the trim recheck's boundary zone
(tests/test_torch_kernels.py holds the consume kernel to the same plain
version on the card)."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp
from goldrush_tpu.config import PathConfig as JPathConfig
from goldrush_tpu.path.engine import GoldenPathEngine as JEngine
from goldrush_tpu.utils import synth

from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.path import consume as tcons
from goldrush_tpu_torch.path import engine as teng
from goldrush_tpu_torch.path.engine_util import recheck_zone

# tests/test_torch_engine.py's configuration (60 kb genome, 3 kb reads)
CFG = dict(genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
           seed_preset="1011011110110111101101", tile_length=250,
           min_length=1000, threshold=10, block_size=4, unassigned_min=5,
           assigned_max=1, occupancy=0.1, phred_min=15, silver_path=True,
           max_paths=2, ratio=0.5, batch_reads=32)
OPT = dict(recheck="optimistic")
# the throughput mode's sampled query tier with the trim recheck
S5 = dict(OPT, frame_stride=5, probe_seeds=1)
S2 = dict(frame_stride=2)
TARGET = int(0.5 * 60_000)       # bases per silver path at ratio 0.5
ROT = dict(max_paths=4, ratio=2.0)   # no rotation before the bump below
ROT_TARGET = int(2.0 * 60_000)

# case: (config, scal at the first batch's start, batches, bases inserted
# set at the last batch's start or None, event)
CASES = {
    "exact-direct": ({}, [0, 0, 1, 0], 2, None, None),
    "exact-compressed": (dict(mibf_mode="compressed"), [0, 0, 1, 0], 2,
                         None, None),
    "opt-direct": (OPT, [0, 0, 1, 0], 2, None, None),
    "opt-compressed": (dict(OPT, mibf_mode="compressed"), [0, 0, 1, 0], 2,
                       None, None),
    # the second batch's first recruit fills the silver path: a rotation
    # (reset) inside it, then its later reads, some of them drops at batch
    # time (the first batch inserted reads they overlap), against the reset
    # filter
    "exact-rotation": (ROT, [0, 0, 1, 0], 2, ROT_TARGET - 1, "rotation"),
    "opt-compressed-rotation": (dict(OPT, mibf_mode="compressed", **ROT),
                                [0, 0, 1, 0], 2, ROT_TARGET - 1,
                                "rotation"),
    "opt-direct-rotation": (dict(OPT, **ROT), [0, 0, 1, 0], 2,
                            ROT_TARGET - 1, "rotation"),
    # the third recruit (3 kb reads) fills the last silver path: done
    # turns on inside the batch
    "exact-done": ({}, [7, TARGET - 6001, 2, 0], 1, None, "done"),
    "opt-compressed-done": (dict(OPT, mibf_mode="compressed"),
                            [7, TARGET - 6001, 2, 0], 1, None, "done"),
    # sampled query tiers: reads in the boundary zone re-classify at full
    # resolution
    "s5-p1-opt-compressed-recheck": (dict(S5, mibf_mode="compressed"),
                                     [0, 0, 1, 0], 2, None, "recheck"),
    "s5-p1-opt-direct-recheck": (S5, [0, 0, 1, 0], 2, None, "recheck"),
    "s2-exact-direct-recheck": (S2, [0, 0, 1, 0], 2, None, "recheck"),
    # the sampled inserts: an insert grid of every 2nd (5th) frame (F =
    # TL / insert_stride, no recheck), or of two insert seeds over one
    # probed seed (the recheck probes both)
    "is2-exact-direct": (dict(insert_stride=2), [0, 0, 1, 0], 2, None,
                         None),
    "is2-exact-compressed-rotation": (
        dict(insert_stride=2, mibf_mode="compressed", **ROT), [0, 0, 1, 0],
        2, ROT_TARGET - 1, "rotation"),
    "s5-is5-p1-opt-compressed": (dict(S5, insert_stride=5,
                                      mibf_mode="compressed"),
                                 [0, 0, 1, 0], 2, None, None),
    "p1-i2-opt-direct-recheck": (dict(OPT, probe_seeds=1, insert_seeds=2),
                                 [0, 0, 1, 0], 2, None, "recheck"),
}


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_consume")
    genome = synth.random_genome(60_000, seed=3)
    reads = synth.simulate_reads(genome, n_reads=120, read_len=3000, seed=4,
                                 err_rate=0.0, phred=20)
    path = str(d / "reads.fq")
    synth.write_fastq(path, reads)
    return d, path


def batches(te, path, n):
    """The first n batches of the submit pass (every read has the same
    length, so each holds batch_reads reads), packed as both engines pack
    them: (codes, lengths, full_lengths, T)."""
    recs = list(te._eligible(path))
    k = te.batch_reads
    return [te._pack_batch(recs[b * k: (b + 1) * k]) for b in range(n)]


def port_state(je, compressed):
    """The JAX engine's filled filter as the port's (numpy in between)."""
    if compressed:
        c = je.cstate
        return tcz.state_from_numpy(*(np.asarray(getattr(c, k)) for k in
                                      ("bitrank", "supers", "ids",
                                       "counts")))
    return tdm.state_from_numpy(np.asarray(je.state.words),
                                np.asarray(je.state.counts))


def assert_same_filter(state, jfilt, size):
    if isinstance(state, tcz.CompressedState):
        got = tcz.state_to_numpy(state)
        for k in ("bitrank", "supers", "ids", "counts"):
            np.testing.assert_array_equal(got[k],
                                          np.asarray(getattr(jfilt, k)),
                                          err_msg=k)
        return
    words, counts = tdm.state_to_numpy(state)
    # slot `size` is the sentinel the JAX fill scatter dumps invalid frames
    # on; every real slot must agree
    np.testing.assert_array_equal(words[:size], np.asarray(jfilt.words)[:size])
    np.testing.assert_array_equal(counts[:size],
                                  np.asarray(jfilt.counts)[:size])


@pytest.mark.parametrize("case", list(CASES))
def test_consume_plain_matches_jax_batch(dataset, case):
    d, path = dataset
    over, scal0, n_batches, bump, event = CASES[case]
    kw = {**CFG, **over}
    je = JEngine(JPathConfig(input=path, prefix_file=str(d / f"j{case}"),
                             **kw))
    je.calc_phred_threshold(path)
    je.fill(path)
    te = teng.GoldenPathEngine(PathConfig(input=path,
                                          prefix_file=str(d / f"t{case}"),
                                          **kw), device="cpu")
    te.phred_min = je.phred_min
    te.filter_out = set(je.filter_out)
    compressed = kw.get("mibf_mode") == "compressed"
    state = port_state(je, compressed)
    if compressed:
        te.cstate = state
    else:
        te.state = state
    scal_j = jnp.asarray(scal0, dtype=jnp.int64)
    scal_t = torch.tensor(scal0, dtype=torch.int64)
    counters = tcons.new_counters("cpu")
    for b, (codes, lengths, full, T) in enumerate(batches(te, path,
                                                          n_batches)):
        if b == n_batches - 1:
            # the last batch's event is counted from its start
            start, counts0 = scal_t.tolist(), counters.tolist()
            if bump is not None:
                scal_t[1] = bump
                scal_j = scal_j.at[1].set(bump)
        Bpad = codes.shape[0]
        fn = je._consume_for(Bpad, T)
        jfilt = je.cstate if compressed else je.state
        jfilt, rows_j, scal_j = fn(jfilt, jnp.asarray(codes),
                                   jnp.asarray(lengths), jnp.asarray(full),
                                   scal_j, jnp.zeros((Bpad, 8), jnp.int64))
        if compressed:
            je.cstate = jfilt
        else:
            je.state = jfilt
        rows_t = torch.empty((Bpad, 8), dtype=torch.int64)
        tcons.consume_batch_plain(
            te.spec, state, *te._batch_inputs(codes, lengths, full, T),
            scal_t, rows_t, counters, T)
        np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
        assert scal_t.tolist() == np.asarray(scal_j).tolist()
        assert_same_filter(state, jfilt, te.size)
    after = scal_t.tolist()
    assert counters[0] > 0 and counters[2] > 0      # live probes, inserts
    resets = counters[3] - counts0[3]       # in the last batch
    if event == "rotation":
        assert after[2] > start[2] and resets > 0 and after[3] == 0
    elif event == "done":
        assert start[3] == 0 and after[3] == 1 and after[2] > kw["max_paths"]
    elif event == "recheck":
        assert counters[1] > 0


def test_consume_batch_dispatch(dataset):
    """consume_batch raises for tensors on several devices."""
    d, path = dataset
    te = teng.GoldenPathEngine(PathConfig(input=path, **CFG), device="cpu")
    args = [torch.zeros(1)] * 10
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="several devices"):
        tcons.consume_batch(te.spec, tdm.MibfState(torch.zeros(4),
                                                    torch.zeros(4)),
                            *args[:9], torch.zeros(4, device=meta), 1)


@pytest.mark.parametrize("stride,tile_min,weak", [
    (1, 1 << 30, False), (2, 1 << 30, True), (4, 1 << 30, True),
    (5, 1 << 30, False), (8, 1 << 30, True), (8, 2, True), (8, 3, False)])
def test_recheck_zone_wraps_as_int32(stride, tile_min, weak):
    """A fully assigned read's margin term multiplies tile_min by the
    stride in int32, as the JAX predicate does: a read without in-read
    tiles (tile_min 1 << 30) is weak exactly where the product wraps below
    the gate."""
    from goldrush_tpu.path.engine_util import recheck_zone as jzone
    want = bool(np.asarray(jzone(jnp.int32(0), jnp.int32(0), jnp.int32(0),
                                 jnp.int32(0), jnp.int32(0),
                                 jnp.int32(tile_min), stride, 10, 1)))
    assert want == weak
    assert recheck_zone(0, 0, 0, 0, 0, tile_min, stride, 10, 1) == weak


def test_zone_batch_on_cpu_matches_jax():
    """zone_batch on CPU tensors (the plain predicate row by row) against
    the JAX predicate on hard_cases.ZONE_ROWS, every stride."""
    from goldrush_tpu.path.engine_util import recheck_zone as jzone
    from goldrush_tpu_torch import hard_cases as hard
    from goldrush_tpu_torch.path.engine_util import zone_batch
    for stride in sorted({r[6] for r in hard.ZONE_ROWS}):
        rows = [r[:6] for r in hard.ZONE_ROWS if r[6] == stride]
        got = zone_batch(torch.tensor(rows, dtype=torch.int64), stride, 10, 1)
        want = [bool(np.asarray(jzone(*(jnp.int32(v) for v in r), stride,
                                      10, 1))) for r in rows]
        assert got.tolist() == want
