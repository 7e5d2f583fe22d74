"""PyTorch port, the engine's mesh mode (parallel/mesh.py): a data-parallel
batched classify and a filter banked over a (data, model) mesh of devices
in one process, held to the JAX package's mesh (its 8 virtual CPU devices,
tests/conftest.py) and to its single-device engine: the bank map, the mesh
layout, the plain probe, inserts, reset and consume scan routed through
banks, whole engine runs on the dataset of ``dryrun_multichip``
(__graft_entry__.py) and the saved filter handed between the packages."""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import tests.conftest  # noqa: F401
from goldrush_tpu.config import PathConfig as JPathConfig
from goldrush_tpu.parallel import mesh as jmesh
from goldrush_tpu.path.engine import GoldenPathEngine as JEngine
from goldrush_tpu.utils import synth

from goldrush_tpu_torch import kernels
from goldrush_tpu_torch.config import PathConfig, calc_optimal_size
from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.parallel import mesh as tmesh
from goldrush_tpu_torch.path import consume as tcons
from goldrush_tpu_torch.path.engine import GoldenPathEngine

# __graft_entry__.py dryrun_multichip's engine: a 60 kb genome, 80 reads of
# 6 kb at 2% error, an explicit universe, batches of 16
CFG = dict(genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
           seed_preset="1011011110110111101101", silver_path=True,
           max_paths=2, min_length=4_000, ratio=0.5,
           hash_universe=3_000_000, batch_reads=16)
TP = dict(frame_stride=8, probe_seeds=1, recheck="optimistic")
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mesh")
    genome = synth.random_genome(60_000, seed=7)
    reads = synth.simulate_reads(genome, 80, 6_000, seed=8, err_rate=0.02)
    path = str(d / "reads.fq")
    synth.write_fastq(path, reads)
    return d, path


def out_files(prefix, silver=True):
    names = ([f"{prefix}_{i}.fq" for i in (1, 2, 3)] if silver
             else [f"{prefix}.fa"])
    return {n[len(prefix):]: open(n, "rb").read()
            for n in names if os.path.exists(n)}


_JAX_RUNS: dict = {}


def jax_single(d, path, **over):
    """The JAX single-device engine on the dataset (one run per config,
    shared by the cases that compare with it): (engine, its files)."""
    key = tuple(sorted(over.items()))
    if key not in _JAX_RUNS:
        prefix = str(d / f"jax_{len(_JAX_RUNS)}")
        je = JEngine(JPathConfig(input=path, prefix_file=prefix,
                                 keep_filter=True, **{**CFG, **over}))
        je.run()
        _JAX_RUNS[key] = (je, out_files(prefix, over.get("silver_path",
                                                          True)))
    return _JAX_RUNS[key]


def assert_filter_equals_jax(te, je):
    """The port's filter, gathered from row 0's banks, against the JAX
    engine's arrays; every row's replica equal to row 0's."""
    if te.compressed:
        got = tcz.state_to_numpy(te.cstate)
        for name in ("bitrank", "supers", "ids", "counts"):
            np.testing.assert_array_equal(
                got[name], np.asarray(getattr(je.cstate, name)),
                err_msg=name)
    else:
        words, counts = tdm.state_to_numpy(te.state)
        # slot `size` is the sentinel the JAX fill dumps invalid frames on
        np.testing.assert_array_equal(words[: te.size],
                                      np.asarray(je.state.words)[: te.size])
        np.testing.assert_array_equal(counts[: te.size],
                                      np.asarray(je.state.counts)[: te.size])
    first = [tdm.whole(t) for t in te.replicas[0]]
    for rep in te.replicas[1:]:
        for a, b in zip(first, rep):
            assert torch.equal(a, tdm.whole(b))


# ---------------------------------------------------------------- layout

@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("kind", ["alloc", "rank_alloc"])
def test_bank_bounds_match_jax(m, kind):
    """Bank j covers the index range JAX gives the j-th model device."""
    size = calc_optimal_size(3_000_000, 1, 0.1)
    L = (tdm.MibfParams(size=size, h=3, k=22, spans=(22, 23, 24)).alloc
         if kind == "alloc" else tcz.rank_alloc(size))
    mesh = jmesh.make_mesh(8, data=8 // m, model=m)
    idx = NamedSharding(mesh, PartitionSpec("model")).devices_indices_map(
        (L,))
    got = tmesh.bank_bounds(L, m)
    for row in mesh.devices:
        want = [(idx[dev][0].start or 0, idx[dev][0].stop or L)
                for dev in row]
        assert got == want


def test_bank_bounds_refuse_what_jax_refuses():
    """Three banks of 1,024 entries: JAX's placement refuses them, so does
    the port; 3,072 entries split."""
    mesh = jmesh.make_mesh(6, data=2, model=3)
    with pytest.raises(ValueError):
        jax.device_put(np.zeros(1024, np.uint32),
                       NamedSharding(mesh, PartitionSpec("model")))
    with pytest.raises(ValueError, match="evenly"):
        tmesh.bank_bounds(1024, 3)
    assert tmesh.bank_bounds(3072, 3) == [(0, 1024), (1024, 2048),
                                          (2048, 3072)]


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4)])
def test_make_mesh_order_matches_jax(data, model, monkeypatch):
    """Row-major [data, model], as JAX's make_mesh lays out its devices
    (distinct card indices stand for its device ids; nothing is
    allocated)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    want = [[d.id for d in row]
            for row in jmesh.make_mesh(8, data=data, model=model).devices]
    m = tmesh.make_mesh(8, data=data, model=model,
                        devices=[f"cuda:{i}" for i in range(8)])
    assert (m.data, m.model) == (data, model)
    assert [[d.index for d in row] for row in m.rows] == want
    assert [m.lead(i).index for i in range(data)] == [r[0] for r in want]
    with pytest.raises(AssertionError):
        tmesh.make_mesh(8, data=3, model=model, devices=CPU8)


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    """make_mesh without devices takes the cards, as JAX's make_mesh takes
    jax.devices(): with no card it raises, and it never falls back to the
    CPU; the CPU is asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_mesh(2)
    m = tmesh.make_mesh(2, devices="cpu")
    assert [d.type for row in m.rows for d in row] == ["cpu", "cpu"]
    assert (m.data, m.model) == (2, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for row in tmesh.make_mesh(2, model=2).rows
            for d in row] == ["cuda:0", "cuda:1"]


@pytest.mark.parametrize("m", [1, 2])
def test_classify_step_matches_jax(m):
    """mesh.classify_step (A's grid, B, C) on a filter banked over m
    devices gives the JAX classify_step's slots, votes and decisions on
    __graft_entry__.py's entry shapes (4 reads of 4 tiles of 100)."""
    import jax.numpy as jnp
    from goldrush_tpu.mibf import mibf as jdm
    from goldrush_tpu.ops.nthash import build_seed_family as jfam
    from goldrush_tpu.ops.seeds import make_seed_pattern as jseeds
    from goldrush_tpu_torch.ops.nthash import build_seed_family
    from goldrush_tpu_torch.ops.seeds import make_seed_pattern
    B, T, TL = 4, 4, 100
    geo = dict(size=100_003, h=3, k=22, spans=(22, 23, 24), tile_length=TL,
               threshold=10, block_size=4, vote_topk=8)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (B, T * TL + TL)).astype(np.uint8)
    lengths = np.full(B, T * TL, dtype=np.int32)
    jp = jdm.MibfParams(**geo)
    # a filter whose slots are present with a few ids, so tiles vote
    words = np.where(rng.random(jp.alloc) < 0.9,
                     tdm.PRESENT_BIT | rng.integers(1, 4, jp.alloc),
                     0).astype(np.uint32)
    pattern = ("1011011110110111101101", 22, 16, 3)
    jres, jslots, jvotes = jmesh.classify_step(
        jnp.asarray(words), jnp.asarray(codes), jnp.asarray(lengths),
        jfam(jseeds(*pattern)), jp, T, 10, 5, 1)
    banked = tdm.state_from_numpy(words, np.zeros_like(words), ["cpu"] * m)
    res, slots, votes = tmesh.classify_step(
        banked.words, torch.from_numpy(codes), torch.from_numpy(lengths),
        build_seed_family(make_seed_pattern(*pattern)),
        tdm.MibfParams(**geo), T, 10, 5, 1)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))
    for name in ("curr_id", "top_count", "cand_ids", "cand_counts"):
        np.testing.assert_array_equal(getattr(votes, name).numpy(),
                                      np.asarray(getattr(jvotes, name)))
    for name in ("decision", "trim_start", "trim_end", "num_assigned"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(jres, name)))
    assert (res.num_assigned > 0).any()


# --------------------------------------------- plain versions through banks

def random_filter(rng, size, ranked):
    """A filter of random contents at ``size`` slots: direct words with
    PRESENT on 70% of the slots and ids below 50, or rank-indexed ids."""
    p = tdm.MibfParams(size=size, h=3, k=22, spans=(22, 23, 24),
                       tile_length=100, block_size=2, vote_topk=8)
    n = tcz.rank_alloc(size) if ranked else p.alloc
    ids = rng.integers(0, 50, n)
    words = ids if ranked else np.where(rng.random(n) < 0.7,
                                        tdm.PRESENT_BIT | ids, ids)
    counts = rng.integers(0, 5, n)
    return p, words, counts


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("op", ["bank_of", "probe", "insert", "insert_max",
                                "reset"])
def test_plain_versions_route_through_banks(op, m):
    """The plain probe, inserts and reset on a filter banked over m
    devices equal the same on the unbanked filter, and the kernels'
    multiply-shift bank of a key equals its quotient."""
    rng = np.random.default_rng(5 + m)
    size, T = 200_003, 6
    for ranked in (False, True):
        p, words, counts = random_filter(rng, size, ranked)
        st = tdm.state_from_numpy(words, counts, device="cpu")
        banked = tdm.state_from_numpy(words, counts, ["cpu"] * m)
        if m > 1:
            assert all(isinstance(t, tdm.Banks) for t in banked)
        n = st.words.shape[0]
        limit = n - 1 if ranked else size
        or_bits = 0 if ranked else tdm.PRESENT_BIT
        grid = torch.from_numpy(rng.integers(0, limit + 1, (3, T * 100)))
        grid[:, ::7] = limit            # sentinel entries
        if op == "bank_of":
            L = n // m
            keys = [0, L - 1, L, 2 * L - 1, n - 1, (1 << 48) - 1,
                    *rng.integers(0, n, 200).tolist()]
            assert [tdm.bank_of(k, L) for k in keys] == [k // L for k in keys]
            assert tdm.bank_of((1 << 62) + 12_345, 3) == \
                ((1 << 62) + 12_345) // 3
            continue
        if op == "probe":
            ok = torch.from_numpy(rng.random((1, T * 100)) < 0.9)
            want = tdm._probe_and_vote_plain(st.words, grid[None], ok, p, T,
                                             ranked)
            got = tdm._probe_and_vote_plain(banked.words, grid[None], ok, p,
                                            T, ranked)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            continue
        if op == "insert":
            for s in (st, banked):
                tdm._insert_plain(s.words, s.counts, grid, 1, T - 1, 7, True,
                                  p, T, limit, or_bits)
        elif op == "insert_max":
            for s in (st, banked):
                tdm._insert_max_plain(s.words, grid, 0, T - 2, 9, False,
                                      p.block_size, T, limit, or_bits)
        elif ranked:
            for s in (st, banked):
                tcz.reset_ids(tcz.CompressedState(None, None, *s),
                              counts=True)
        else:
            for s in (st, banked):
                tdm.reset_ids(s, counts=True)
        for a, b in zip(st, banked):
            assert torch.equal(a, tdm.whole(b))


def test_presence_merge_banks_match_unbanked():
    """The first-write merge bank by bank, banks past the last slot
    included, equals the unbanked merge."""
    rng = np.random.default_rng(3)
    size = 1_500
    bits = torch.from_numpy(rng.integers(0, 1 << 32, -(-size // 32))
                            .astype(np.uint32).view(np.int32))
    alloc = tdm.MibfParams(size=size, h=1, k=22, spans=(22,)).alloc
    want = tdm.merge_presence(torch.full((alloc,), 7, dtype=torch.int32),
                              bits, size, first_write=True)
    for m in (1, 2, 4, 8):
        words = tdm.to_banks(torch.full((alloc,), 7, dtype=torch.int32),
                             ["cpu"] * m)
        tdm.merge_presence_banks(words, bits, size)
        assert torch.equal(tdm.whole(words), want)


def small_engine(d, path, **over):
    """A single-device port engine filled on the dataset, and the inputs of
    its first batch."""
    te = GoldenPathEngine(PathConfig(input=path, prefix_file=str(d / "e"),
                                     **{**CFG, **over}), device="cpu")
    te.calc_phred_threshold(path)
    te.fill(path)
    recs = list(te._eligible(path))[:16]
    codes, lengths, full, T = te._pack_batch(recs)
    return te, te._batch_inputs(codes, lengths, full, T), T


@pytest.mark.parametrize("mode,over", [
    ("direct", {}), ("compressed", {}), ("direct", TP), ("compressed", TP)],
    ids=["exact-direct", "exact-compressed", "throughput-direct",
         "throughput-compressed"])
def test_consume_plain_on_banks(dataset, mode, over):
    """consume_batch_plain on a filter banked over 4 devices as it comes
    from the host's arrays (``state_from_numpy`` on a mesh row), through
    consume_batch with the row's devices, equals the unbanked scan: rows,
    scal, counters and the gathered filter."""
    d, path = dataset
    te, inputs, T = small_engine(d, path, mibf_mode=mode,
                                 **{**over, "max_paths": 1, "ratio": 0.05})
    filt = te.cstate or te.state
    runs = []
    for m in (1, 4):
        row = ["cpu"] * m
        if te.compressed:
            f = tcz.state_from_numpy(**tcz.state_to_numpy(filt), device=row)
        else:
            f = tdm.state_from_numpy(*tdm.state_to_numpy(filt), row)
        scal = torch.tensor([0, 0, 1, 0])
        rows = torch.empty((inputs[0].shape[0], 8), dtype=torch.int64)
        ck = tcons.new_counters("cpu")
        tcons.consume_batch(te.spec, f, *inputs, scal, rows, ck, T, row=row)
        runs.append((f, scal, rows, ck))
    (f1, *out1), (f4, *out4) = runs
    assert out1[2][2] > 0                    # the batch inserted
    for a, b in zip(out1, out4):
        assert torch.equal(a, b)
    for a, b in zip(f1, f4):
        assert torch.equal(tdm.whole(a), tdm.whole(b))


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("over", [
    dict(devices=8),
    dict(devices=8, model_shards=2),
    dict(devices=8, model_shards=2, **TP),
    dict(devices=8, model_shards=2, mibf_mode="compressed"),
    dict(devices=8, model_shards=4, mibf_mode="compressed", **TP),
    dict(devices=4, model_shards=4, silver_path=False)],
    ids=["dp8-exact-direct", "banked4x2-exact-direct",
         "banked4x2-throughput-direct", "banked4x2-exact-compressed",
         "banked2x4-throughput-compressed", "banked1x4-golden-direct"])
def test_mesh_engine_matches_jax(dataset, over):
    """The port's mesh engine on logical CPU devices writes the JAX
    single-device engine's files byte for byte, its filter gathered from
    the banks equals the JAX filter, and its rows' replicas are equal; the
    exact banked direct case also runs the JAX mesh engine (the JAX
    package's banked compressed mesh aborts on the CPU: its freeze's
    collective permute never completes the XLA:CPU rendezvous)."""
    d, path = dataset
    mesh = {k: over[k] for k in ("devices", "model_shards") if k in over}
    conf = {k: v for k, v in over.items() if k not in mesh}
    je, jfiles = jax_single(d, path, **conf)
    tag = "_".join(f"{k}{v}" for k, v in over.items())
    te = GoldenPathEngine(PathConfig(input=path, prefix_file=str(d / tag),
                                     **{**CFG, **over}), device="cpu")
    assert te.mesh.data * te.mesh.model == over["devices"]
    st = te.run()
    assert st.recruits > 0 and jfiles
    assert out_files(str(d / tag), conf.get("silver_path", True)) == jfiles
    assert_filter_equals_jax(te, je)
    if over == dict(devices=8, model_shards=2):
        prefix = str(d / f"jmesh_{tag}")
        jm = JEngine(JPathConfig(input=path, prefix_file=prefix,
                                 keep_filter=True, **{**CFG, **over}))
        jm.run()
        assert out_files(prefix) == jfiles
        assert_filter_equals_jax(te, jm)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_saved_filter_crosses_packages_under_the_mesh(dataset, direction):
    """A filter saved by one package's engine (the port's on a 4x2 mesh,
    gathered from its banks; the JAX package's on one device) loads into
    the other's (banked on load), and the loading run writes the saving
    run's files."""
    d, path = dataset
    ckpt = str(d / f"{direction}.npz")
    mesh = dict(devices=8, model_shards=2)
    save_p, load_p = str(d / f"{direction}_save"), str(d / f"{direction}_load")
    if direction == "port_to_jax":
        GoldenPathEngine(PathConfig(input=path, prefix_file=save_p,
                                    save_mibf=ckpt, **CFG, **mesh),
                         device="cpu").run()
        JEngine(JPathConfig(input=path, prefix_file=load_p, load_mibf=ckpt,
                            **CFG)).run()
    else:
        JEngine(JPathConfig(input=path, prefix_file=save_p, save_mibf=ckpt,
                            **CFG)).run()
        te = GoldenPathEngine(PathConfig(input=path, prefix_file=load_p,
                                         load_mibf=ckpt, **CFG, **mesh),
                              device="cpu")
        te.run()
        assert isinstance(te.state.words, tdm.Banks)
        assert te.state.words.n == 2
    saved = out_files(save_p)
    assert saved and out_files(load_p) == saved


# -------------------------------------------------------------- refusals

@pytest.mark.parametrize("cards", [0, 1])
def test_cuda_mesh_without_enough_cards_raises(dataset, cards, monkeypatch):
    """device="cuda" with devices=2: no card, or one card, raises before
    anything is allocated, naming the cards there are."""
    d, path = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(RuntimeError, match="cuda"):
        GoldenPathEngine(PathConfig(input=path, **{**CFG, "devices": 2}),
                         device="cuda")


@pytest.mark.parametrize("attrs", [(False, True), (True, False)])
def test_banks_across_cards_need_peer_access_and_atomics(attrs,
                                                         monkeypatch):
    """A bank on another card without peer access, or without native peer
    atomics, raises at the launch; the banks are not copied instead."""
    monkeypatch.setattr(kernels, "peer_attributes", lambda a, b: attrs)
    monkeypatch.setattr(kernels, "_PEERS", set())
    with pytest.raises(RuntimeError,
                       match="cudaDeviceCanAccessPeer" if not attrs[0]
                       else "NativeAtomic"):
        kernels.require_peer(torch.device("cuda", 0), torch.device("cuda", 1))


@pytest.mark.parametrize("m", [3, 5])
def test_bank_counts_jax_takes_or_refuses(dataset, m):
    """The filter of the dataset's sizing (28,474,368 entries, 27,807
    blocks of 1,024) splits into 3 banks, which both packages take, and
    not into 5, which both refuse with ValueError at construction."""
    d, path = dataset
    over = {**CFG, "devices": m, "model_shards": m}
    if m == 3:
        te = GoldenPathEngine(PathConfig(input=path, **over), device="cpu")
        assert te.state.words.n == 3
        assert te.state.words.bank_len * 3 == te.params.alloc
        JEngine(JPathConfig(input=path, **over))
        return
    with pytest.raises(ValueError, match="evenly"):
        GoldenPathEngine(PathConfig(input=path, **over), device="cpu")
    with pytest.raises(ValueError):
        JEngine(JPathConfig(input=path, **over))
