"""PyTorch port, the wavefront consume (K23) under the engine's mesh: each
data row resolves every window against its own replica of the filter and
its own side table, both banked over the row's devices when
model_shards > 1, after the rows have computed the grids of their shares
of the window and the adjacency of the whole window has been computed
once.  Held on logical CPU devices to the JAX package's mesh engine of the
same layout (its 8 virtual CPU devices, tests/conftest.py) with the direct
filter, and with the compressed filter to the JAX single-device wavefront
engine (the JAX banked compressed mesh aborts on the CPU in its freeze,
tests/test_torch_mesh.py): the path files byte for byte, the rows, the
stats, the wave counters, the gathered filter and side table, and every
row's replica and side table equal.  Then the plain round loop on tables
banked over 1, 2 and 4 devices (banks of lengths that are not multiples
of 4) against the unbanked run, a banked window started from the JAX
engine's side table, and the refusal of a remote bank without peer
access.  On test_torch_mesh.py's 60 kb dataset with the throughput
settings and windows of 64 reads (two windows a pass)."""

import dataclasses

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp
from goldrush_tpu.config import PathConfig as JPathConfig
from goldrush_tpu.path.engine import GoldenPathEngine as JEngine

from goldrush_tpu_torch import kernels
from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.parallel import mesh as tmesh
from goldrush_tpu_torch.path import wavefront as wave
from goldrush_tpu_torch.path.engine import GoldenPathEngine
from tests.test_torch_mesh import (  # noqa: F401
    CFG, TP, dataset, out_files, two_torch_threads)

WAVE = dict(TP, wavefront=True, wave_window=64)
# (data, model) -> the engine's devices and model_shards
LAYOUTS = {"2x1": dict(devices=2), "1x2": dict(devices=2, model_shards=2),
           "2x2": dict(devices=4, model_shards=2)}
TARGET = int(CFG["ratio"] * CFG["genome_size"])

_RUNS: dict = {}


def cached(key, make):
    """One run per key in this module (several cases compare with it)."""
    if key not in _RUNS:
        _RUNS[key] = make()
    return _RUNS[key]


def jax_run(d, path, **over):
    """The JAX engine (a mesh engine when ``over`` names one) on the
    dataset: (engine, stats, files)."""
    def make():
        prefix = str(d / f"jax_{len(_RUNS)}")
        je = JEngine(JPathConfig(input=path, prefix_file=prefix,
                                 keep_filter=True, **{**CFG, **WAVE, **over}))
        st = je.run()
        assert je._wave
        return je, st, out_files(prefix, over.get("silver_path", True))
    return cached(("jax", path, tuple(sorted(over.items()))), make)


def port_run(d, path, **over):
    """The port's engine on logical CPU devices: (engine, stats, files)."""
    def make():
        prefix = str(d / f"port_{len(_RUNS)}")
        te = GoldenPathEngine(PathConfig(input=path, prefix_file=prefix,
                                         **{**CFG, **WAVE, **over}),
                              device="cpu")
        st = te.run()
        assert te.wave
        return te, st, out_files(prefix, over.get("silver_path", True))
    return cached(("port", path, tuple(sorted(over.items()))), make)


def table_of(filt):
    """The id table of either filter, the port's or the JAX package's."""
    return filt.ids if hasattr(filt, "ids") else filt.words


def assert_rows_equal(te):
    """Every data row's filter and side table equal row 0's, banks
    gathered; banked over the row's devices when the filter is."""
    first = [tdm.whole(t) for t in te.replicas[0]] + [tdm.whole(
        te.wave_sides[0])]
    assert len(te.wave_sides) == len(te.replicas) == te.mesh.data
    for rep, side in zip(te.replicas, te.wave_sides):
        want = te.mesh.model if te.banked else 1
        assert getattr(side, "n", 1) == getattr(table_of(rep), "n", 1) == want
        for a, b in zip(first, [*rep, side]):
            assert torch.equal(a, tdm.whole(b))


def assert_matches(te, ts, tfiles, je, js, jfiles):
    """Files, rows, stats, the gathered id table and side table."""
    assert tfiles == jfiles and jfiles
    jst, tst = dataclasses.asdict(js), dataclasses.asdict(ts)
    for k, v in jst.items():
        if not k.startswith("wall_"):
            assert tst[k] == v, k
    np.testing.assert_array_equal(te.last_rows, np.asarray(je.last_rows))
    jfilt = je.cstate if te.compressed else je.state
    n = None if te.compressed else te.size
    np.testing.assert_array_equal(
        tdm.whole(table_of(te.replicas[0])).numpy().view(np.uint32)[:n],
        np.asarray(table_of(jfilt))[:n])
    np.testing.assert_array_equal(
        tdm.whole(te.wave_side).numpy().view(np.uint32),
        np.asarray(je._wave_side))


# ----------------------------------------------------------------- engine

@pytest.mark.parametrize("layout,silver", [
    ("2x1", True), ("1x2", True), ("2x2", True), ("2x2", False)],
    ids=["2x1-silver", "1x2-silver", "2x2-silver", "2x2-golden"])
def test_direct_wave_mesh_matches_jax_mesh(dataset, layout, silver):
    """The direct filter's wave under a mesh against the JAX mesh engine
    of the same layout; its wave counters are the single-device port's
    (the JAX engine keeps none); every row's tables equal (c)."""
    d, path = dataset
    over = dict(LAYOUTS[layout], silver_path=silver)
    te, ts, tfiles = port_run(d, path, **over)
    assert (te.mesh.data, te.mesh.model) == tuple(map(int,
                                                      layout.split("x")))
    assert_matches(te, ts, tfiles, *jax_run(d, path, **over))
    assert_rows_equal(te)
    single = port_run(d, path, silver_path=silver)[0]
    assert te.consume_counts == single.consume_counts
    c = te.consume_counts
    assert c["commits"] == ts.recruits > 0 and c["faults"] == 0
    assert c["rotations"] >= 1 if silver else c["rotations"] == 0
    assert ts.num_batches == 2


@pytest.mark.parametrize("layout", ["1x2", "2x2"])
def test_compressed_wave_mesh_matches_jax_single(dataset, layout):
    """The compressed filter's wave under a mesh against the JAX
    single-device wavefront engine, every row's tables equal (c)."""
    d, path = dataset
    over = dict(mibf_mode="compressed")
    te, ts, tfiles = port_run(d, path, **over, **LAYOUTS[layout])
    assert_matches(te, ts, tfiles, *jax_run(d, path, **over))
    assert_rows_equal(te)
    assert te.consume_counts == port_run(d, path, **over)[0].consume_counts
    assert te.consume_counts["rotations"] >= 1


# -------------------------------------------------- the plain rounds on banks

def padded_filter(te, extra):
    """The engine's filled filter with ``extra`` zero entries appended to
    its per-slot (or per-rank) tables, which makes banks of lengths that
    are not multiples of 4; the compressed filter's sentinel moves with
    them, so the engine takes it before it builds its grids."""
    filt = te.cstate if te.compressed else te.state
    pad = [torch.cat([t, t.new_zeros(extra)]) for t in (table_of(filt),
                                                         filt.counts)]
    if te.compressed:
        te.cstate = tcz.CompressedState(filt.bitrank, filt.supers, *pad)
    else:
        te.state = tdm.MibfState(*pad)
    return te.cstate if te.compressed else te.state


def banked(filt, row):
    """A copy of ``filt`` with its per-slot tables banked over ``row``."""
    if isinstance(filt, tcz.CompressedState):
        return tcz.CompressedState(filt.bitrank, filt.supers,
                                   tdm.to_banks(filt.ids, row),
                                   tdm.to_banks(filt.counts, row))
    return tdm.MibfState(*(tdm.to_banks(t, row) for t in filt))


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_window_plain_on_banks(dataset, mode, m):
    """wave_window (the plain rounds, with the row's devices) on tables
    banked over m devices equals the unbanked run over both windows of the
    dataset, the first with a silver rotation inside it: rows, scal,
    counters and both tables gathered.  The tables are 4 entries longer
    than the engine's: banks of 2 and 4 hold lengths that are not
    multiples of 4 (the kernel resets those tails entry by entry)."""
    d, path = dataset
    te = GoldenPathEngine(PathConfig(input=path, prefix_file=str(d / "pw"),
                                     mibf_mode=mode, **{**CFG, **WAVE}),
                          device="cpu")
    te.calc_phred_threshold(path)
    te.fill(path)
    filt = padded_filter(te, 4)
    n = table_of(filt).shape[0]
    assert m == 1 or (n // m) % 4
    row = ["cpu"] * m
    runs = []
    recs = list(te._eligible(path))
    wins = [te._pack_batch(recs[i: i + 64]) for i in range(0, len(recs), 64)]
    assert len(wins) == 2
    for f, r in ((type(filt)(*(t.clone() for t in filt)), None),
                 (banked(filt, row), row)):
        side = tdm.new_banks(n, row) if r else torch.zeros(n,
                                                           dtype=torch.int32)
        scal = torch.tensor([0, TARGET - 1, 1, 0])
        counters = wave.new_counters("cpu")
        out = []
        _, _, ranked, limit, _ = wave._filter_view(f, te.size)
        for codes, lengths, full, T in wins:
            codes_d, *inputs = te._window_inputs(codes, lengths, full, T)
            adj = wave.wave_adjacency(te.wave_spec, inputs[2], codes_d, limit,
                                      ranked, T)
            rows = torch.empty((codes.shape[0], 8), dtype=torch.int64)
            wave.wave_window(te.wave_spec, f, side, *inputs, adj, scal, rows,
                             counters, T, row=r)
            out.append(rows)
        if m > 1 and r:
            assert isinstance(table_of(f), tdm.Banks)
            assert isinstance(side, tdm.Banks) and side.n == m
        runs.append((out, scal, counters, [tdm.whole(t) for t in f],
                     tdm.whole(side)))
    (rows1, *rest1), (rows_m, *rest_m) = runs
    for a, b in zip(rows1 + list(rest1[:2]), rows_m + list(rest_m[:2])):
        assert torch.equal(a, b)
    for a, b in zip(rest1[2] + [rest1[3]], rest_m[2] + [rest_m[3]]):
        assert torch.equal(a, b)
    counts = dict(zip(wave.WAVE_COUNTS, rest1[1].tolist()))
    assert counts["rotations"] >= 1 and counts["commits"] > 0
    assert rest1[3].any()                # the side table holds ids


@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_banked_window_from_jax_side(dataset, mode):
    """The JAX engine's filter and side table after the dataset's first
    window (its window executable, single device), banked over a 1x2 row
    by ``state_from_numpy`` and ``mesh.shard_side``: the port's second
    window on those banks equals the JAX engine's, rows, scal and both
    tables."""
    d, path = dataset
    kw = dict(CFG, **WAVE, input=path, mibf_mode=mode)
    je = JEngine(JPathConfig(prefix_file=str(d / f"jw{mode}"), **kw))
    je.calc_phred_threshold(path)
    je.fill(path)
    te = GoldenPathEngine(PathConfig(prefix_file=str(d / f"tw{mode}"), **kw,
                                     model_shards=2), device="cpu")
    te.phred_min, te.filter_out = je.phred_min, set(je.filter_out)
    recs = list(te._eligible(path))
    wins = [te._pack_batch(recs[i: i + 64]) for i in range(0, len(recs), 64)]
    jfilt = je.cstate if te.compressed else je.state
    jside = jnp.zeros(table_of(jfilt).shape, jnp.uint32)
    scal_j = jnp.asarray([0, 0, 1, 0], dtype=jnp.int64)
    outs = []
    for codes, lengths, full, T in wins:
        B = codes.shape[0]
        jfilt, rows_j, scal_j, jside = je._consume_for(B, T)(
            jfilt, jnp.array(codes), jnp.array(lengths), jnp.array(full),
            scal_j, jnp.zeros((B, 8), jnp.int64), jside)
        # the next call donates these buffers: keep them as numpy
        outs.append(({k: np.asarray(v) for k, v in jfilt._asdict().items()},
                     np.asarray(rows_j), np.asarray(scal_j),
                     np.asarray(jside)))
    first, second = outs
    # the port takes the JAX state after the first window, banked
    row = te.mesh.rows[0]
    if te.compressed:
        filt = tcz.state_from_numpy(**first[0], device=row)
    else:
        filt = tdm.state_from_numpy(first[0]["words"], first[0]["counts"],
                                    row)
    te.replicas = [filt]
    side = tmesh.shard_side(first[3], te.mesh, True)[0]
    assert isinstance(side, tdm.Banks) and side.n == 2
    assert isinstance(table_of(filt), tdm.Banks)
    scal = torch.from_numpy(first[2].copy())
    codes, lengths, full, T = wins[1]
    codes_d, *inputs = te._window_inputs(codes, lengths, full, T)
    _, _, ranked, limit, _ = wave._filter_view(filt, te.size)
    adj = wave.wave_adjacency(te.wave_spec, inputs[2], codes_d, limit,
                              ranked, T)
    rows = torch.empty((codes.shape[0], 8), dtype=torch.int64)
    wave.wave_window(te.wave_spec, filt, side, *inputs, adj, scal, rows,
                     wave.new_counters("cpu"), T, row=row)
    np.testing.assert_array_equal(rows.numpy(), second[1])
    assert scal.tolist() == second[2].tolist()
    n = None if te.compressed else te.size
    key = "ids" if te.compressed else "words"
    np.testing.assert_array_equal(
        tdm.whole(table_of(filt)).numpy().view(np.uint32)[:n],
        second[0][key][:n])
    np.testing.assert_array_equal(tdm.whole(side).numpy().view(np.uint32),
                                  second[3])


# --------------------------------------------------------------- refusals

class CardTensor:
    """Stands for an int32 tensor on card ``index``: what the wrappers read
    of their arguments before the first launch."""

    def __init__(self, n: int, index: int, shape=None):
        self.shape = torch.Size(shape or [n])
        self.dtype = torch.int32
        self.device = torch.device("cuda", index)
        self.is_cuda = True

    def dim(self) -> int:
        return len(self.shape)


@pytest.mark.parametrize("attrs", [(False, True), (True, False)])
def test_wave_banks_across_cards_need_peer_access_and_atomics(
        dataset, attrs, monkeypatch):
    """wave_window with its tables banked across two cards, one without
    peer access or without native peer atomics: the launch raises before
    anything is allocated, for the id table's or the side table's bank;
    the banks are not copied instead."""
    d, path = dataset
    te = GoldenPathEngine(PathConfig(input=path, **{**CFG, **WAVE}),
                          device="cpu")
    monkeypatch.setattr(kernels, "peer_attributes", lambda a, b: attrs)
    monkeypatch.setattr(kernels, "_PEERS", set())
    monkeypatch.setattr(kernels, "check", lambda *a, **k: None)
    for remote in ("table", "side"):
        parts = {k: tdm.Banks([CardTensor(8, 0),
                               CardTensor(8, 1 if k == remote else 0)])
                 for k in ("table", "side")}
        state = tdm.MibfState(words=parts["table"], counts=parts["table"])
        batch = [CardTensor(1, 0) for _ in range(10)]
        with pytest.raises(RuntimeError,
                           match="cudaDeviceCanAccessPeer" if not attrs[0]
                           else "NativeAtomic"):
            wave.wave_window(te.wave_spec, state, parts["side"], *batch, 1)
