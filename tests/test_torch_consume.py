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

import types

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
                                       "counts")), device="cpu")
    return tdm.state_from_numpy(np.asarray(je.state.words),
                                np.asarray(je.state.counts), device="cpu")


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


# --- the consume kernel's launch arithmetic (path/consume.py), which the
# kernel computes alike: its tiles, its scatter slices and key owners, the
# key buckets of its exact insert, its scratch -----------------------------

@pytest.mark.parametrize("ctas,T,tiers", [
    (132, 20, 1), (132, 20, 2), (132, 80, 2), (132, 2048, 1), (5, 7, 2),
    (3, 1, 1)])
def test_gather_ctas_cover_each_tile_once(ctas, T, tiers):
    """Every (tier, tile, seed, frame) of a probe is gathered by exactly
    one CTA: job j (tier-major) on CTA (j + RUNNERS) % ctas, which is the
    job loop each CTA runs in csrc/consume.cu gather; the owners take the
    first jobs, and the runners only jobs past the owners (T not a multiple
    of the CTAs)."""
    H, F = 3, 4
    jobs = tiers * T
    cta_of = tcons.gather_ctas(ctas, jobs)
    seen = {}
    for rank in range(ctas):
        j = (rank - tcons.RUNNERS) % ctas
        while j < jobs:
            assert cta_of[j] == rank
            tier, t = divmod(j, T)
            for s in range(H):
                for f in range(F):
                    assert (tier, t, s, f) not in seen
                    seen[(tier, t, s, f)] = rank
            j += ctas
    assert len(seen) == jobs * H * F
    owners = ctas - tcons.RUNNERS
    assert all(c >= tcons.RUNNERS for c in cta_of[:owners])


@pytest.mark.parametrize("ctas,jobs", [
    (132, 0), (132, 20), (132, 40), (132, 65), (132, 66), (132, 280),
    (5, 1)])
def test_scatter_sources_skip_the_busy_ctas(ctas, jobs):
    """Beside a probe whose tiles take at most half the owners, the CTAs
    with a tile job do not scatter: the sources are the rest, each once;
    otherwise every CTA scatters; the rank map is the kernel's."""
    src = tcons.scatter_sources(ctas, jobs)
    busy = set(tcons.gather_ctas(ctas, jobs)) - set(range(tcons.RUNNERS))
    assert len(set(src)) == len(src)
    small = 2 * jobs <= ctas - tcons.RUNNERS
    assert set(src) == (set(range(ctas)) - busy if small
                        else set(range(ctas)))
    b = jobs if small else 0
    for k, rank in enumerate(src):
        assert k == (rank if rank < tcons.RUNNERS else rank - b)


@pytest.mark.parametrize("ctas,entries", [
    (132, 60_000), (132, 7), (130, 3 * 80 * 1000), (3, 0), (4, 4), (5, 23)])
def test_scatter_slices_partition_the_window(ctas, entries):
    """The scatter's slices (csrc/insert.cuh slice_of) cover every window
    entry exactly once, in order, at most ceil(entries / ctas) each."""
    sl = tcons.scatter_slices(ctas, entries)
    assert len(sl) == ctas
    covered = [e for lo, hi in sl for e in range(lo, hi)]
    assert covered == list(range(entries))
    assert max(hi - lo for lo, hi in sl) <= -(-entries // ctas)


def test_key_owners_hash_the_low_bits():
    """Key owners hash the key's low 32 bits, so ranks at or above 2^32
    fall where their low bits do, and every owner lies in [0, parts), for
    the consume kernel's owners (the SMs less the runners) and kernel D's
    standalone parts."""
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 1 << 40, 4096, dtype=np.int64))
    keys = torch.cat([keys, keys % (1 << 32), torch.tensor([0, (1 << 32)])])
    assert torch.equal(tdm.insert_part(keys, tdm.INSERT_PARTS),
                       tdm.insert_part(keys))
    for parts in (1, 130, 132):
        own = tdm.insert_part(keys, parts)
        assert int(own.min()) >= 0 and int(own.max()) < parts
        assert torch.equal(own, tdm.insert_part(keys % (1 << 32), parts))


def bucket_insert_model(words, counts, slots, t0, t1, lo, hi, base, trimmed,
                        bs, T, limit, or_bits, ctas, parts, cap, shift=0):
    """Kernel D as the consume kernel runs it (csrc/insert.cuh), in Python:
    the window's tiles t0..t1-1 scattered slice by slice to the key owners'
    buckets (cap entries each, all counted), an owner past its bucket
    re-reading the window and keeping its distinct entries (all of them
    past cap / 2 distinct), each owner's entries (key << 16 | tile) sorted
    and the reservoir rule applied to the tiles lo..min(hi, T - 1).  Keys
    are offset by `shift` inside (a rank past 2^32 keeps its low bits);
    words/counts are dicts of the touched keys.  Returns how many owners
    overflowed, and how many of them kept only distinct entries."""
    H, TF = slots.shape
    F = TF // T
    cols = max(0, t1 - t0) * F
    W = H * cols
    bucket = [[] for _ in range(parts)]
    count = [0] * parts

    def entries(e):
        s, col = e // cols, t0 * F + e % cols
        key = int(slots[s, col])
        if not 0 <= key < limit:
            return None
        key += shift
        return int(tdm.insert_part(torch.tensor([key]), parts)), \
            (key << 16) | (col // F)

    for a, b in tcons.scatter_slices(ctas, W):   # one per source CTA
        for e in range(a, b):
            got = entries(e)
            if got is None:
                continue
            p, ent = got
            if count[p] < cap:
                bucket[p].append(ent)
            count[p] += 1
    last = min(hi, T - 1)
    mask = 0xFFFFFFFF
    over = distinct = 0
    for p in range(parts):
        ents = bucket[p]
        if count[p] > cap:          # the owner re-reads the window
            ents = [g[1] for g in map(entries, range(W))
                    if g is not None and g[0] == p]
            over += 1
            if len(set(ents)) <= cap // 2:
                ents = list(set(ents))
                distinct += 1
        else:
            assert len(ents) == count[p]
        ents.sort()
        i = 0
        while i < len(ents):
            key = ents[i] >> 16
            k = i
            run = []
            while k < len(ents) and ents[k] >> 16 == key:
                run.append(ents[k] & 0xFFFF)
                k += 1
            i = k
            ms = sorted({(t - lo) // bs for t in run if lo <= t <= last})
            if not ms:
                continue
            before = counts.get(key, 0)
            won = None
            for j, m in enumerate(ms, 1):
                bid = (base + ((m * bs + 1) // bs if trimmed else m)) & mask
                cnt = (before + j) & mask
                if ((key & mask) ^ bid) % max(cnt, 1) == (cnt - 1) & mask:
                    won = bid
            counts[key] = (before + len(ms)) & mask
            if won is not None:
                words[key] = or_bits | won
    return over, distinct


# (T, F, H, window tiles t0..t1-1, lo, hi, trimmed, cap, shift, owners
# past their bucket, of them keeping distinct entries): a whole recruit's
# window; a probed read's whole read applied to its trim; a repeated
# k-mer over 8 tiles past its owner's bucket, whose few distinct entries
# it keeps; the same past every bucket (a small cap), all of them spilling
# every entry; ranks past 2^32; the insert grid at insert stride 8 (F =
# TL / 8 frames a tile)
BUCKET_CASES = {
    "whole": (20, 50, 3, 0, 20, 0, 19, False, 1024, 0, 0, 0),
    "probed_trim": (20, 50, 3, 0, 20, 4, 12, True, 1024, 0, 0, 0),
    "overflow": (12, 40, 3, 0, 12, 0, 11, False, 256, 0, 1, 1),
    "overflow_spill": (12, 40, 3, 0, 12, 0, 11, False, 64, 0, 5, 0),
    "ranks_past_2_32": (10, 40, 2, 2, 9, 2, 8, True, 256, 1 << 32, 0, 0),
    "stride8": (20, 125 // 8, 3, 0, 20, 0, 19, False, 256, 0, 0, 0),
}


@pytest.mark.parametrize("case", list(BUCKET_CASES))
def test_bucket_insert_matches_plain(case):
    """Every window entry reaches exactly one owner, and the bucketed insert
    (its slices, bucket offsets, overflow re-read and per-owner sort)
    writes the words and counters that the plain insert does, on the same
    inputs, under 7 scattering CTAs and 5 owners."""
    (T, F, H, t0, t1, lo, hi, trimmed, cap, shift, want_over,
     want_distinct) = BUCKET_CASES[case]
    rng = np.random.default_rng(len(case))
    universe, limit, bs, base = 3000, 2900, 4, 77
    slots = rng.integers(0, universe, (H, T * F), dtype=np.int64)
    if case.startswith("overflow"):
        slots[:, : 8 * F] = 7          # one k-mer repeated over 8 tiles
    words0 = rng.integers(0, 1 << 30, universe, dtype=np.int64)
    counts0 = rng.integers(0, 5, universe, dtype=np.int64)
    counts0[:10] = 0xFFFFFFFF          # counters about to wrap
    words_t = torch.from_numpy(words0).to(torch.int32)
    counts_t = tdm._as_int32(torch.from_numpy(counts0))
    params = types.SimpleNamespace(block_size=bs)   # all the insert reads
    tdm._insert_plain(words_t, counts_t, torch.from_numpy(slots), lo, hi,
                      base, trimmed, params, T, limit, tdm.PRESENT_BIT)
    words = {k + shift: int(v) for k, v in enumerate(words0)}
    counts = {k + shift: int(v) for k, v in enumerate(counts0)}
    over = bucket_insert_model(words, counts, slots, t0, t1, lo, hi, base,
                               trimmed, bs, T, limit, tdm.PRESENT_BIT, 7, 5,
                               cap, shift)
    assert over == (want_over, want_distinct)
    got_w = np.array([words[k + shift] for k in range(universe)], np.int64)
    got_c = np.array([counts[k + shift] for k in range(universe)], np.int64)
    np.testing.assert_array_equal(got_w & 0xFFFFFFFF,
                                  words_t.numpy().astype(np.int64)
                                  & 0xFFFFFFFF)
    np.testing.assert_array_equal(got_c & 0xFFFFFFFF,
                                  counts_t.numpy().astype(np.int64)
                                  & 0xFFFFFFFF)
    assert (got_c != counts0).any()


def test_scratch_sizes_and_growth():
    """The scratch holds a vote buffer per tier, the outcome slots and,
    under the exact policy, two rounds of buckets and the spill; it grows
    only when a batch needs more, and new counters start at zero."""
    sz = tcons.ConsumeScratch.sizes(20, 32, 3 * 20 * 1000, 130, 8192, True)
    assert sz == dict(sums=120, vals=2 * (60 + 1280), binit=40,
                      outcome=2 * tcons.OUTCOME_SLOT, bucket_count=260,
                      bucket=2 * 130 * 8192, spill=2 + 2 * 60_000)
    fast = tcons.ConsumeScratch.sizes(20, 32, 60_000, 130, 8192, False)
    assert set(fast) == {"sums", "vals", "binit", "outcome"}
    sc = tcons.ConsumeScratch()
    small = tcons.ConsumeScratch.sizes(4, 2, 30, 3, 8, True)
    sc.ensure(small, "cpu")
    kept = sc.bucket
    for name, n in small.items():
        assert getattr(sc, name).numel() == n
    assert int(sc.bucket_count.abs().sum()) == 0
    assert int(sc.spill.abs().sum()) == 0
    sc.ensure(tcons.ConsumeScratch.sizes(2, 2, 30, 3, 8, True), "cpu")
    assert sc.bucket is kept
    sc.ensure(tcons.ConsumeScratch.sizes(8, 2, 90, 3, 8, True), "cpu")
    assert sc.spill.numel() == 2 + 180 and sc.vals.numel() == 2 * (24 + 32)
    assert int(sc.spill.abs().sum()) == 0


# --- the runner's lane-parallel forms of kernel C's walks (csrc/classify.cuh
# reconcile_runs, neighbor_fill_scan, flank_top2_lanes), as Python models,
# against the walks of the JAX package's oracle ----------------------------

def oracle_passes_1_4(all_id, ids, bools, thr):
    """Passes 1-4 of goldrush_tpu/path/oracle.py smooth_tiles (:46-88),
    walk by walk, on copies of the rows."""
    ids, bools, n = list(ids), list(bools), len(ids)
    for i in range(1, n):
        if ids[i] != ids[i - 1]:
            for pid, c in all_id[i]:
                if pid == ids[i - 1]:
                    ids[i], bools[i] = pid, int(c > thr)
    for i in range(n - 2, -1, -1):
        if ids[i] != ids[i + 1]:
            for pid, c in all_id[i]:
                if pid == ids[i + 1]:
                    ids[i], bools[i] = pid, int(c > thr)
    for order in (range(1, n - 1), range(n - 2, 0, -1)):
        for i in order:
            ids[i], bools[i] = fill_step(ids[i - 1], bools[i - 1], ids[i],
                                         bools[i], ids[i + 1], bools[i + 1])
    return ids, bools


def fill_step(pi, pa, ci, ca, ni, na):
    """One neighbour-fill step (oracle.py:66-76; classify.cuh fill_step)."""
    if ca:
        return ci, ca
    if (ci == pi and pa) or (ci == ni and na):
        return ci, 1
    if (ci == pi + 1 and pa) or (ci == ni + 1 and na):
        return ci, 1
    if (pi and ci == pi - 1 and pa) or (ni and ci == ni - 1 and na):
        return ci, 1
    if pi == ni and pa and na:
        return pi, pa
    return ci, ca


def lane_passes_1_4(all_id, ids, bools, thr):
    """The same passes as reconcile_runs and neighbor_fill_scan compute
    them, a tile a lane: the candidate masks, then per pass each tile's
    next break from two masks, the chain of run starts, and each tile's
    run value; then passes 3-4 as a scan of boolean maps."""
    n = len(ids)
    id0, ids, bools = list(ids), list(ids), list(bools)
    valid = (1 << n) - 1
    mcol, scol = [0] * n, [0] * n       # candidate_masks
    for i in range(n):
        for cid, c in all_id[i]:
            m = sum(1 << x for x in range(n) if id0[x] == cid)
            mcol[i] |= m
            scol[i] |= m if c > thr else 0
    row = [sum(1 << j for j in range(n) if mcol[j] >> x & 1)
           for x in range(n)]
    src = list(range(n))
    for back in (False, True):
        v = list(ids)
        nxt = []
        for t in range(n):
            same = sum(1 << j for j in range(n) if v[j] == v[t])
            cont = (same | row[src[t]]) & valid
            beyond = (1 << t) - 1 if back else valid & ~((2 << t) - 1)
            brk = ~cont & beyond & valid
            nxt.append((brk.bit_length() - 1 if back else
                        (brk & -brk).bit_length() - 1) if brk
                       else (-1 if back else n))
        starts, s = 0, n - 1 if back else 0
        while 0 <= s < n:
            starts |= 1 << s
            s = nxt[s]
        new_src = list(src)
        for t in range(n):
            if back:
                m = starts & ~((1 << t) - 1)
                rs = (m & -m).bit_length() - 1
            else:
                rs = (starts & ((2 << t) - 1)).bit_length() - 1
            if rs != t and v[t] != v[rs]:
                ids[t], bools[t] = v[rs], scol[t] >> src[rs] & 1
                new_src[t] = src[rs]
        src = new_src
    for back in (False, True):
        ci, ca = list(ids), list(bools)
        maps = []
        for t in range(n):
            if 1 <= t <= n - 2:
                m = 0
                for x in range(2):
                    _, b = (fill_step(ci[t - 1], ca[t - 1], ci[t], ca[t],
                                      ci[t + 1], x) if back else
                            fill_step(ci[t - 1], x, ci[t], ca[t], ci[t + 1],
                                      ca[t + 1]))
                    m |= int(b != 0) << x
                maps.append(m)
            elif t == (n - 1 if back else 0):
                maps.append(3 if ca[t] else 0)
            else:
                maps.append(2)
        seen, acc = [0] * n, None
        for t in (range(n - 1, -1, -1) if back else range(n)):
            acc = maps[t] if acc is None else (
                (maps[t] >> (acc & 1) & 1) | (maps[t] >> (acc >> 1 & 1) & 1)
                << 1)
            seen[t] = acc & 1
        for t in range(1, n - 1):
            ids[t], bools[t] = (
                fill_step(ci[t - 1], ca[t - 1], ci[t], ca[t], ci[t + 1],
                          seen[t + 1]) if back else
                fill_step(ci[t - 1], seen[t - 1], ci[t], ca[t], ci[t + 1],
                          ca[t + 1]))
    return ids, bools


def lane_top2(ids):
    """flank_top2_lanes: each position's count is its match group's size;
    the top two (count desc, then id asc) come from a max and a min
    reduction each.  Returns [(id, count)] as the oracle lists them."""
    counts = [sum(1 for w in ids if w == v) for v in ids]
    c1 = max(counts, default=0)
    i1 = min((v for v, c in zip(ids, counts) if c == c1), default=0)
    rest = [c if v != i1 else 0 for v, c in zip(ids, counts)]
    c2 = max(rest, default=0)
    i2 = min((v for v, c in zip(ids, rest) if c and c == c2), default=0)
    return [(i1, c1), (i2, c2)][:(c1 > 0) + (c2 > 0)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lane_passes_match_the_oracle_walks(seed):
    """The lane forms of C's passes 1-4 and of the flank top-2 give the
    walks' rows and pairs on random reads of 3-32 tiles whose ids and
    candidates come from a few values (so that runs, holes, adjacent ids
    and repeats are common), 2,500 reads per seed."""
    from goldrush_tpu.path import oracle
    rng = np.random.default_rng(seed)
    for _ in range(2_500):
        n = int(rng.integers(3, 33))
        alpha = int(rng.integers(1, 7))
        ids = [int(x) for x in rng.integers(0, alpha + 1, n)]
        bools = [int(x) if rng.random() < 0.7 else 0
                 for x in rng.integers(0, 2, n)]
        thr = int(rng.integers(0, 4))
        all_id = [[(int(c), int(rng.integers(1, 6))) for c in
                   rng.choice(np.arange(1, alpha + 2),
                              size=min(int(rng.integers(0, 5)), alpha + 1),
                              replace=False)] for _ in range(n)]
        assert lane_passes_1_4(all_id, ids, bools, thr) == \
            oracle_passes_1_4(all_id, ids, bools, thr)
        lo = int(rng.integers(0, n))
        hi = int(rng.integers(lo, min(n, lo + 14) + 1))
        assert lane_top2(ids[lo:hi]) == oracle._flank_counts(ids[lo:hi])[:2]
