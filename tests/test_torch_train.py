"""PyTorch port, the state-mutating step of the JAX package's mesh module:
the blockwise reservoir insert of both filters (``mibf.insert_read``,
``compressed.insert_read``: kernel D with its keep mask, block limit and,
for the compressed filter, its rank map), ``train_step`` and
``sharded_train_step`` (parallel/mesh.py), held bit for bit to the JAX
functions on the CPU (goldrush_tpu/mibf/mibf.py:449,
goldrush_tpu/mibf/compressed.py:338, goldrush_tpu/parallel/mesh.py:77 and
:110; JAX's mesh on its 8 virtual CPU devices, tests/conftest.py), and
``make_mesh`` without a device count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.io.fastq import encode
from goldrush_tpu.mibf import compressed as jcz
from goldrush_tpu.mibf import mibf as jdm
from goldrush_tpu.ops.nthash import build_seed_family as jfam
from goldrush_tpu.ops.nthash import hash_positions
from goldrush_tpu.ops.seeds import make_seed_pattern as jseeds
from goldrush_tpu.parallel import mesh as jmesh
from goldrush_tpu.utils import synth

from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.ops.nthash import build_seed_family
from goldrush_tpu_torch.ops.seeds import make_seed_pattern
from goldrush_tpu_torch.parallel import mesh as tmesh

PATTERN = ("1011011110110111101101", 22, 16, 3)
# 16 reads of 2 kb from a 20 kb genome; batches of 8 reads of 8 tiles of
# 250, blocks of 2 tiles
TL, T, BATCH = 250, 8, 8
GEO = dict(size=200_003, h=3, k=22, spans=(22, 23, 24), tile_length=TL,
           block_size=2)


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- insert_read

TL_INSERT = 50


def insert_params(bs: int):
    geo = dict(size=10_007, h=3, k=22, spans=(22, 23, 24),
               tile_length=TL_INSERT, threshold=3, block_size=bs,
               vote_topk=8)
    return jdm.MibfParams(**geo), tdm.MibfParams(**geo)


def slot_grid(rng, size: int, TF: int, span: int) -> np.ndarray:
    """A duplicate-heavy [3, TF] slot grid over [0, span) with sentinel
    padding and a run repeated across seeds."""
    slots = rng.integers(0, span, (3, TF)).astype(np.int64)
    slots[:, -37:] = size
    slots[1, 100:140] = slots[0, 100:140]
    return slots


def random_words(rng, n: int) -> np.ndarray:
    """Words with ids below 2^20 and SAT / PRESENT each on about half."""
    return (rng.integers(0, 1 << 20, n, dtype=np.uint32)
            | (rng.integers(0, 2, n, dtype=np.uint32) << 31)
            | (rng.integers(0, 2, n, dtype=np.uint32) << 30))


# (first tile, last tile, trimmed) of a 12-tile read
RANGES = [(0, 11, False), (2, 10, True)]


@pytest.mark.parametrize("lo,hi,trimmed", RANGES)
@pytest.mark.parametrize("bs", [1, 3])
@pytest.mark.parametrize("at_count", [False, True])
def test_insert_read_direct_matches_jax(lo, hi, trimmed, bs, at_count):
    """mibf.insert_read against JAX's (words, counters): blocks of 1 and 3
    tiles, max_blocks below and at the range's block count, over words
    whose SAT and PRESENT bits are set at random (SAT kept, a slot
    without PRESENT taking a bare id)."""
    jp, tp = insert_params(bs)
    Tn, F = 12, 50
    rng = np.random.default_rng(bs * 10 + lo)
    slots = slot_grid(rng, jp.size, Tn * F, jp.size // 50)
    words = random_words(rng, jp.alloc)
    counts = rng.integers(0, 5, jp.alloc, dtype=np.uint32)
    blocks = -(-(hi - lo + 1) // bs)
    mb = blocks if at_count else max(1, blocks // 2)
    ref = jdm.insert_read(
        jdm.MibfState(jnp.asarray(words), jnp.asarray(counts)),
        jnp.asarray(slots.astype(np.int32)), jnp.int32(lo), jnp.int32(hi),
        np.uint32(7), jnp.asarray(trimmed), jp, max_blocks=mb, num_tiles=Tn)
    st = tdm.state_from_numpy(words, counts, device="cpu")
    got = tdm.insert_read(st, torch.from_numpy(slots), lo, hi, 7, trimmed,
                          tp, mb, Tn)
    assert got is st
    w, c = tdm.state_to_numpy(got)
    np.testing.assert_array_equal(w, np.asarray(ref.words))
    np.testing.assert_array_equal(c, np.asarray(ref.counts))
    changed = w != words
    assert changed.any()
    # an accepted word keeps its SAT and PRESENT bits
    np.testing.assert_array_equal(w[changed] >> 30, words[changed] >> 30)


@pytest.mark.parametrize("lo,hi,trimmed", RANGES)
@pytest.mark.parametrize("bs", [1, 3])
@pytest.mark.parametrize("at_count", [False, True])
def test_insert_read_compressed_matches_jax(lo, hi, trimmed, bs, at_count):
    """compressed.insert_read (the slot grid mapped to ranks, absent slots
    and invalid frames to the sentinel) against JAX's, over ids with SAT
    set at random."""
    jp, tp = insert_params(bs)
    Tn, F = 12, 50
    rng = np.random.default_rng(100 + bs * 10 + lo)
    presence = np.zeros(jp.size + 1, dtype=np.uint8)
    presence[rng.choice(jp.size, size=jp.size // 3, replace=False)] = 1
    frozen = jcz.freeze(presence, jp.size)
    n = frozen.ids.shape[0]
    ids = (rng.integers(0, 1 << 20, n, dtype=np.uint32)
           | (rng.integers(0, 2, n, dtype=np.uint32) << 31))
    counts = rng.integers(0, 5, n, dtype=np.uint32)
    slots = slot_grid(rng, jp.size, Tn * F, jp.size // 8)
    blocks = -(-(hi - lo + 1) // bs)
    mb = blocks if at_count else max(1, blocks // 2)
    ref = jcz.insert_read(
        jcz.CompressedState(frozen.bitrank, frozen.supers, jnp.asarray(ids),
                            jnp.asarray(counts)),
        jnp.asarray(slots.astype(np.int32)), jnp.int32(lo), jnp.int32(hi),
        np.uint32(11), jnp.asarray(trimmed), jp, max_blocks=mb,
        num_tiles=Tn)
    st = tcz.state_from_numpy(np.asarray(frozen.bitrank),
                              np.asarray(frozen.supers), ids, counts,
                              device="cpu")
    got = tcz.insert_read(st, torch.from_numpy(slots), lo, hi, 11, trimmed,
                          tp, mb, Tn)
    out = tcz.state_to_numpy(got)
    np.testing.assert_array_equal(out["ids"], np.asarray(ref.ids))
    np.testing.assert_array_equal(out["counts"], np.asarray(ref.counts))
    changed = out["ids"] != ids
    assert changed.any()
    np.testing.assert_array_equal(out["ids"][changed] >> 31,
                                  ids[changed] >> 31)


# ---------------------------------------------------------- insert_batch

@pytest.mark.parametrize("bs", [1, 3])
@pytest.mark.parametrize("mb", [1, 2])
def test_insert_batch_matches_jax_recruits(bs, mb):
    """train_step's insert of a whole classified batch (mibf.insert_batch,
    its plain version here) against JAX's scan body, insert_read a recruit
    at a time in batch order (goldrush_tpu/parallel/mesh.py:86-108), and
    against the port's own per-recruit loop (mibf.insert_read): batches
    whose reads share slots (one read repeated, a read and its trimmed
    copy, drops between them), max_blocks 1 and 2, blocks of 1 tile (a
    trimmed read's ids start at base + 1) and 3; then the Python model of
    the card's launch (tests/test_torch_insert_batch_model.py) in one
    launch and in chunks of two reads."""
    from tests.test_torch_insert_batch_model import model_batch, shared_batch
    jp, tp = insert_params(bs)
    B, Tn, F = 8, 12, 50
    rng = np.random.default_rng([bs, mb])
    slots, dec, ts, te, lengths = shared_batch(rng, B, Tn, F, jp.size // 40)
    slots[slots == jp.size // 40] = jp.size
    base = (3 + 30 * np.arange(B)).astype(np.uint32)
    words = random_words(rng, jp.alloc)
    counts = rng.integers(0, 5, jp.alloc, dtype=np.uint32)
    ref = jdm.MibfState(jnp.asarray(words), jnp.asarray(counts))
    mine = tdm.state_from_numpy(words, counts, device="cpu")
    for i in range(B):
        if dec[i] == 0:
            continue
        lo, hi = ((0, int(lengths[i]) // TL_INSERT - 1) if dec[i] == 1
                  else (int(ts[i]), int(te[i])))
        ref = jdm.insert_read(ref, jnp.asarray(slots[i].astype(np.int32)),
                              jnp.int32(lo), jnp.int32(hi), base[i],
                              jnp.asarray(dec[i] == 2), jp, max_blocks=mb,
                              num_tiles=Tn)
        tdm.insert_read(mine, torch.from_numpy(slots[i]), lo, hi,
                        int(base[i]), dec[i] == 2, tp, mb, Tn)
    want = (np.asarray(ref.words), np.asarray(ref.counts))
    st = tdm.state_from_numpy(words, counts, device="cpu")
    got = tdm.insert_batch(st, torch.from_numpy(slots), *(
        torch.from_numpy(a) for a in (dec, ts, te, lengths)),
        torch.from_numpy(base.astype(np.int64)), tp, mb, Tn)
    assert got is st
    for state in (got, mine):
        w, c = tdm.state_to_numpy(state)
        np.testing.assert_array_equal(w, want[0])
        np.testing.assert_array_equal(c, want[1])
    assert (want[1] != counts).sum() > 100
    for window in (tdm.BATCH_WINDOW, 2 * 3 * Tn * F):
        w, c = words.copy(), counts.copy()
        launches = model_batch(w, c, slots, dec, ts, te, lengths, base, Tn,
                               TL_INSERT, mb, bs, jp.size, 0,
                               tdm.SAT_BIT | tdm.PRESENT_BIT, window)
        assert launches == (1 if window == tdm.BATCH_WINDOW else B // 2)
        np.testing.assert_array_equal(w, want[0])
        np.testing.assert_array_equal(c, want[1])


# ------------------------------------------------------------ train_step

@pytest.fixture(scope="module")
def batch():
    """16 reads of 2 kb from a 20 kb genome, packed as the engine packs a
    batch of 8-tile reads: codes uint8 [16, 2,250], lengths int32 [16]."""
    genome = synth.random_genome(20_000, seed=7)
    reads = synth.simulate_reads(genome, 16, 2_000, seed=8, err_rate=0.02)
    L = T * TL + TL
    codes = np.zeros((16, L), np.uint8)
    lengths = np.zeros(16, np.int32)
    for i, (_, seq, _) in enumerate(reads):
        c = encode(seq)[: L - 1]
        codes[i, : len(c)] = c
        lengths[i] = len(c)
    return codes, lengths


def jax_fill(words, codes, lengths, jp, fam):
    """The JAX engine's pass-1 fill of the batch (engine.py:459-470)."""
    n, L = codes.shape
    P = L - jp.k + 1
    valid = np.zeros((n, len(jp.spans), P), bool)
    for j in range(n):
        for s, span in enumerate(jp.spans):
            valid[j, s, : max(int(lengths[j]) - span + 1, 0)] = True
    return jdm.fill_presence(words, hash_positions(jnp.asarray(codes), fam, P),
                             jnp.asarray(valid), jp.size, jp.idx_dtype)


def base_ids(step: int) -> np.ndarray:
    return (1 + 10 * np.arange(step * BATCH, (step + 1) * BATCH)
            ).astype(np.uint32)


def jax_states(batch, filled: bool, mb: int, devices=None):
    """JAX's train_step (or its sharded_train_step over ``devices`` =
    (data, model, shard_filter)) for two steps of 8 reads: per step
    (words, counts, decisions) as numpy."""
    codes, lengths = batch
    jp, fam = jdm.MibfParams(**GEO), jfam(jseeds(*PATTERN))
    state = jdm.init_state(jp)
    if filled:
        state = jdm.MibfState(jax_fill(state.words, codes, lengths, jp, fam),
                              state.counts)
    if devices is None:
        def step(st, c, ln, b):
            return jmesh.train_step(st, c, ln, b, fam, jp, T, mb)
    else:
        data, model, shard = devices
        m = jmesh.make_mesh(data * model, data=data, model=model)
        state = jmesh.shard_state(state, m, shard)
        step = jmesh.sharded_train_step(m, fam, jp, T, mb, shard)
    out = []
    for k in range(2):
        sl = slice(k * BATCH, (k + 1) * BATCH)
        state, dec = step(state, jnp.asarray(codes[sl]),
                          jnp.asarray(lengths[sl]), jnp.asarray(base_ids(k)))
        out.append((np.asarray(state.words), np.asarray(state.counts),
                    np.asarray(dec)))
    return out


def torch_start(batch, filled: bool):
    codes, lengths = batch
    tp = tdm.MibfParams(**GEO)
    fam = build_seed_family(make_seed_pattern(*PATTERN))
    state = tdm.init_state(tp, device="cpu")
    if filled:
        tdm.fill_presence(state.words, torch.from_numpy(codes),
                          torch.from_numpy(lengths), fam, tp.size)
    return state, tp, fam


def assert_step_equal(words, counts, dec, want):
    """The port's step against JAX's: the real slots' words (JAX's fill
    also sets the sentinel slot, the port's does not), the counters and
    the decisions."""
    size = GEO["size"]
    jw, jc, jd = want
    np.testing.assert_array_equal(words[:size], jw[:size])
    np.testing.assert_array_equal(counts, jc)
    np.testing.assert_array_equal(dec, jd)


@pytest.mark.parametrize("mb", [4, 2])
@pytest.mark.parametrize("filled", [False, True])
def test_train_step_matches_jax(batch, filled, mb):
    """Two train_steps of 8 reads on a fresh filter and on one
    presence-filled with all 16 reads, at max_blocks 4 (the whole read)
    and 2: words, counters and decisions bit for bit.  A fresh filter's
    inserts write bare ids (no PRESENT), so its probes see nothing and
    every read recruits whole at both steps; the filled one reaches all
    three decisions at max_blocks 4."""
    codes, lengths = batch
    want = jax_states(batch, filled, mb)
    state, tp, fam = torch_start(batch, filled)
    decs = []
    for k in range(2):
        sl = slice(k * BATCH, (k + 1) * BATCH)
        state, dec = tmesh.train_step(
            state, torch.from_numpy(codes[sl]), torch.from_numpy(lengths[sl]),
            base_ids(k), fam, tp, T, mb)
        w, c = tdm.state_to_numpy(state)
        assert_step_equal(w, c, dec.numpy(), want[k])
        decs.append(dec.numpy())
    if not filled:
        assert (np.concatenate(decs) == 1).all()
        assert not (w >> 30 & 1).any()
    else:
        assert (decs[0] == 1).all()
        if mb == 4:
            assert set(np.concatenate(decs)) == {0, 1, 2}


@pytest.fixture(scope="module")
def jax_sharded(batch):
    """JAX's sharded_train_step on the presence-filled filter at
    max_blocks 4, keyed (data, model, shard_filter)."""
    return {(d, m, s): jax_states(batch, True, 4, (d, m, s))
            for d, m in ((2, 1), (1, 2), (2, 2)) for s in (False, True)}


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("data,model", [(2, 1), (1, 2), (2, 2)])
def test_sharded_train_step_matches_jax(batch, jax_sharded, data, model,
                                        shard):
    """sharded_train_step over a (data, model) mesh of logical CPU
    devices, the filter replicated or banked over each row
    (``shard_filter``), against JAX's on its virtual CPU mesh: every
    row's replica and the decisions bit for bit, two steps."""
    codes, lengths = batch
    state, tp, fam = torch_start(batch, True)
    mesh = tmesh.make_mesh(data * model, data=data, model=model,
                           devices="cpu")
    reps = tmesh.shard_state(state, mesh, shard)
    step = tmesh.sharded_train_step(mesh, fam, tp, T, 4, shard)
    for k in range(2):
        sl = slice(k * BATCH, (k + 1) * BATCH)
        reps, dec = step(reps, torch.from_numpy(codes[sl]),
                         torch.from_numpy(lengths[sl]), base_ids(k))
        assert len(reps) == data
        for rep in reps:
            w, c = tdm.state_to_numpy(rep)
            assert_step_equal(w, c, dec.numpy(),
                              jax_sharded[(data, model, shard)][k])


def test_sharded_train_step_needs_whole_rows(batch):
    """A batch that the data rows do not split evenly raises, as JAX's
    P("data") refuses it."""
    codes, lengths = batch
    state, tp, fam = torch_start(batch, False)
    mesh = tmesh.make_mesh(3, devices="cpu")
    step = tmesh.sharded_train_step(mesh, fam, tp, T, 4, False)
    with pytest.raises(ValueError, match="data rows"):
        step(tmesh.shard_state(state, mesh, False),
             torch.from_numpy(codes[:8]), torch.from_numpy(lengths[:8]),
             base_ids(0))


# ------------------------------------------------------------- make_mesh

def test_make_mesh_takes_every_device(monkeypatch):
    """make_mesh() without a count takes every device, as JAX's
    make_mesh(n_devices=None) takes jax.devices(): every card, or a
    sequence's length; the CPU has no count to take and raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = tmesh.make_mesh()
    assert [str(d) for row in m.rows for d in row] == [
        f"cuda:{i}" for i in range(4)]
    assert (m.data, m.model) == (4, 1)
    assert (tmesh.make_mesh(model=2).data, tmesh.make_mesh(model=2).model) \
        == (2, 2)
    m = tmesh.make_mesh(devices=["cpu"] * 3)
    assert (m.data, m.model) == (3, 1)
    with pytest.raises(ValueError, match="n_devices"):
        tmesh.make_mesh(devices="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_mesh()
