"""PyTorch port, the direct filter at 2^32 slots and more: the plain
probe/vote, the reservoir insert and the max-id-wins insert at keys of 2^32
and more, the plain fill's bitmap words at that size and the chunked merge
equal the JAX package exactly, and the fixture's "direct_2_32" sizing is
the same in both packages.

The tables of a filter past 2^32 slots hold 8 B a slot (37 GB at
4,603,242,496 slots), so these tests hold them as numpy zeros wrapped by
``torch.from_numpy``: the pages stay unallocated until written, and nothing
of 2^27 entries or more becomes resident (``resident_growth``).  The JAX
reference runs on a small table whose keys are the port's translated down
by 2^32; the reservoir rule reads only a key's low 32 bits, so both must
agree entry for entry.

The ``slow`` test runs the port's CPU engine at the fixture's size (~37 GB
of host memory) against the JAX package's digests; tier-1 deselects it."""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from tests.conftest import FIXTURES
from goldrush_tpu.config import calc_optimal_size as jcalc
from goldrush_tpu.mibf import mibf as jdm
from goldrush_tpu.ops.nthash import build_seed_family as jfamily
from goldrush_tpu.ops.nthash import hash_positions as jhash
from goldrush_tpu.utils import synth

from goldrush_tpu_torch import hard_cases as hard
from goldrush_tpu_torch.config import PathConfig, calc_optimal_size
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.ops.nthash import build_seed_family
from goldrush_tpu_torch.ops.seeds import make_seed_pattern
from goldrush_tpu_torch.path.engine import GoldenPathEngine

FX = json.loads((FIXTURES / "torch_port_digests.json").read_text())
SEEDS = make_seed_pattern("1011011110110111101101", 22, 16, 3)
FAM, JFAM = build_seed_family(SEEDS), jfamily(SEEDS)
# the fixture's size (hash_universe=485,000,000)
SIZE = 4_603_242_496
OFF = 1 << 32                    # the port's keys less the JAX table's
SMALL = 100_003                  # the JAX table's size
TL = 100
KW = dict(h=3, k=22, spans=(22, 23, 24), tile_length=TL, threshold=4,
          block_size=3, vote_topk=8)
JP = jdm.MibfParams(size=SMALL, **KW)
TP = tdm.MibfParams(size=OFF + SMALL, **KW)
# the most a test may add to the resident set: less than 2^27 int32 entries
RESIDENT_LIMIT = 4 << 27


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def least_universe_of_2_32(occupancy):
    """The least universe the closed form sizes at 2^32 slots or more."""
    lo, hi = 1, 1 << 40
    while lo < hi:
        mid = (lo + hi) // 2
        if calc_optimal_size(mid, 1, occupancy) >= 1 << 32:
            hi = mid
        else:
            lo = mid + 1
    return lo


class Reached(Exception):
    pass


def first_filter_allocation(monkeypatch, make):
    """Call ``make`` with ``torch.empty`` and ``torch.zeros`` spied on: the
    first call for 2^27 entries or more raises before it allocates.
    Returns (that call's entry count, the entry counts allocated before
    it)."""
    sizes = []
    for name in ("empty", "zeros"):
        real = getattr(torch, name)

        def spy(*args, _real=real, **kwargs):
            shape = args[0] if len(args) == 1 else args
            n = int(np.prod(shape))
            if n >= 1 << 27:
                raise Reached(n)
            sizes.append(n)
            return _real(*args, **kwargs)
        monkeypatch.setattr(torch, name, spy)
    with pytest.raises(Reached) as got:
        make()
    monkeypatch.undo()
    return got.value.args[0], sizes


def resident_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


@pytest.fixture
def resident_growth():
    """Fails the test if the process's resident set grew by 2^27 int32
    entries or more: the lazy tables must stay unallocated but for the
    pages a test writes."""
    before = resident_bytes()
    yield
    grown = resident_bytes() - before
    assert grown < RESIDENT_LIMIT, f"resident set grew by {grown} B"


def lazy_table(n: int) -> torch.Tensor:
    """A zeroed int32 table of ``n`` entries whose pages stay unallocated
    until written."""
    return torch.from_numpy(np.zeros(n, np.int32))


def lifted(small: np.ndarray, n: int) -> torch.Tensor:
    """A lazy table of ``n`` entries holding ``small`` (uint32) from entry
    OFF on: the JAX table translated up by 2^32."""
    t = lazy_table(n)
    t[OFF: OFF + small.size] = torch.from_numpy(small.view(np.int32))
    return t


def assert_lifted_equal(t: torch.Tensor, want: np.ndarray) -> None:
    """``t`` holds ``want`` from entry OFF on, and zeros on either side."""
    n = want.size
    np.testing.assert_array_equal(t[OFF: OFF + n].numpy().view(np.uint32),
                                  want)
    assert int(t[OFF - 4096: OFF].abs().sum()) == 0
    assert int(t[OFF + n: OFF + n + 4096].abs().sum()) == 0


def random_words(n, rng, present=0.6, ids=50):
    w = rng.integers(0, ids, n).astype(np.uint32)
    w |= np.where(rng.random(n) < present, np.uint32(jdm.PRESENT_BIT),
                  np.uint32(0))
    return w


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_and_vote_above_2_32_matches_jax(resident_growth, seed):
    """The plain probe/vote on a lazy table of 2^32 + 100,004 entries whose
    keys all lie at 2^32 and more, the sentinel (its size) among them,
    against goldrush_tpu's probe_and_vote on the table translated down by
    2^32."""
    rng = np.random.default_rng(seed)
    B, T = 4, 6
    w = random_words(JP.alloc, rng)
    w[SMALL:] = 0
    slots = rng.integers(0, SMALL, (B, 3, T * TL)).astype(np.int64)
    frame_ok = rng.random((B, T * TL)) < 0.9
    slots = np.where(frame_ok[:, None, :], slots, SMALL)
    want = jdm.probe_and_vote(jnp.asarray(w), jnp.asarray(slots),
                              jnp.asarray(frame_ok), JP, num_tiles=T)
    table = lifted(w, TP.alloc)
    got = tdm.probe_and_vote(table, torch.from_numpy(slots + OFF),
                             torch.from_numpy(frame_ok), TP, T)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.hits.sum()) > 0


def _jax_insert(state, slots, lo, hi, base, trimmed, T):
    keys = jdm.build_insert_keys(jnp.asarray(slots), T)
    return jdm.insert_read_sorted(
        state, keys, jnp.int32(lo), jnp.int32(hi), jnp.uint32(base),
        jnp.asarray(trimmed), jnp.asarray(True), JP, num_tiles=T,
        assume_present=True)


def recruit_slots(rng, T):
    """A recruit's [3, T*TL] grid of the JAX table's slots with repeats
    across seeds and blocks, and a sentinel-padded tail."""
    slots = rng.integers(0, SMALL // 50, (3, T * TL)).astype(np.int64)
    slots[:, -37:] = SMALL
    slots[1, 100:140] = slots[0, 100:140]
    slots[2, 500:540] = slots[0, 100:140]
    return slots


@pytest.mark.parametrize("lo,hi,trimmed", [(0, 11, False), (3, 9, True)])
def test_insert_sorted_above_2_32_matches_jax(resident_growth, lo, hi,
                                              trimmed):
    """The plain reservoir insert at keys of 2^32 and more, two recruits
    in turn, against goldrush_tpu's insert_read_sorted on the tables
    translated down by 2^32: words and counters entry for entry (the
    accept rule keys on the slot's low 32 bits in both)."""
    rng = np.random.default_rng([lo, hi])
    T = 12
    slots = recruit_slots(rng, T)
    w = random_words(JP.alloc, rng) | np.uint32(jdm.PRESENT_BIT)
    c = rng.integers(0, 5, JP.alloc).astype(np.uint32)
    w[SMALL:] = c[SMALL:] = 0
    js = jdm.MibfState(jnp.asarray(w), jnp.asarray(c))
    st = tdm.MibfState(lifted(w, TP.alloc), lifted(c, TP.alloc))
    for base in (7, 40):
        js = _jax_insert(js, slots, lo, hi, base, trimmed, T)
        tdm.insert_read_sorted(st, torch.from_numpy(slots + OFF), lo, hi,
                               base, trimmed, TP, T)
    assert_lifted_equal(st.words, np.asarray(js.words))
    assert_lifted_equal(st.counts, np.asarray(js.counts))
    assert not np.array_equal(np.asarray(js.words), w)


@pytest.mark.parametrize("lo,hi,trimmed", [(0, 11, False), (2, 7, True)])
def test_insert_max_above_2_32_matches_jax(resident_growth, lo, hi, trimmed):
    """The plain max-id-wins insert at keys of 2^32 and more against
    goldrush_tpu's insert_read_max on the table translated down by
    2^32."""
    rng = np.random.default_rng([lo, hi, 1])
    T = 12
    slots = recruit_slots(rng, T)
    w = random_words(JP.alloc, rng, present=1.0)
    w[SMALL:] = 0
    jw = jnp.asarray(w)
    st = tdm.MibfState(lifted(w, TP.alloc), lazy_table(TP.alloc))
    for base in (7, 40):
        jw = jdm.insert_read_max(jw, jnp.asarray(slots), jnp.int32(lo),
                                 jnp.int32(hi), jnp.uint32(base),
                                 jnp.asarray(trimmed), JP, num_tiles=T)
        tdm.insert_read_max(st, torch.from_numpy(slots + OFF), lo, hi, base,
                            trimmed, TP, T)
    assert_lifted_equal(st.words, np.asarray(jw))
    assert not np.array_equal(np.asarray(jw), w)


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
def test_fill_bits_at_2_32_slots_matches_jax(resident_growth, mode):
    """The plain fill of reads into the lazy bitmap of a 4,603,242,496-slot
    filter (143,851,328 words) sets exactly the bits of the slots that
    goldrush_tpu's slot map gives at that size: with "mod" words of index
    2^27 and more among them, with "fastrange" (whose products wrap, as
    the JAX function's do) none."""
    codes, lengths = hard.read_batch([2_000, 1_500, 700, 21], 2_048, seed=7)
    P = codes.shape[1] - 22 + 1
    bits = lazy_table(-(-SIZE // 32))
    tdm.fill_presence_bits(bits, torch.from_numpy(codes),
                           torch.from_numpy(lengths), FAM, SIZE, mode)
    slots = np.asarray(jdm.position_slots(jhash(codes, JFAM, P), SIZE,
                                          jnp.int64, mode))
    valid = np.zeros(slots.shape, bool)
    for b, L in enumerate(lengths):
        for s, span in enumerate(FAM.spans):
            valid[b, s, : max(L - span + 1, 0)] = True
    want = np.unique(slots[valid])
    words = np.unique(want >> 5)
    expect = np.zeros(words.size, np.uint32)
    np.bitwise_or.at(expect, np.searchsorted(words, want >> 5),
                     np.uint32(1) << (want & 31).astype(np.uint32))
    got = bits.numpy()
    np.testing.assert_array_equal(got[words].view(np.uint32), expect)
    assert np.count_nonzero(got) == words.size
    high = int((words >= 1 << 27).sum())
    assert high > 100 if mode == "mod" else high == 0
    assert want.max() < (SIZE if mode == "mod" else 1 << 32)


@pytest.mark.parametrize("chunk", [1, 7, 32, 33, 96, 1_000])
@pytest.mark.parametrize("size", [31, 100, 1_021, 4_099])
@pytest.mark.parametrize("first_write", [True, False])
def test_chunked_merge_matches_jax_fill(size, chunk, first_write):
    """The plain merge, chunk by chunk of ``chunk`` slots (edges inside
    32-slot words and across them), against goldrush_tpu's fill_presence
    of the same slots (hashes below the size under the "mod" map are their
    own slots): as the first write into words holding garbage (0 on slot
    ``size`` and the padding), and as the OR into words whose set entries
    hold PRESENT (where the JAX max equals the OR)."""
    rng = np.random.default_rng([size, chunk])
    alloc = tdm.MibfParams(size=size, **KW).alloc
    slots = np.flatnonzero(rng.random(size) < 0.3).astype(np.uint64)
    if first_write:
        before = rng.integers(0, 1 << 32, alloc, dtype=np.uint64
                              ).astype(np.uint32)
        base = np.zeros(alloc, np.uint32)
    else:
        before = random_words(alloc, rng, present=1.0, ids=1 << 30)
        before[rng.random(alloc) < 0.5] = 0
        base = before
    want = np.asarray(jdm.fill_presence(
        jnp.asarray(base), jnp.asarray(slots), jnp.ones(slots.size, bool),
        size, slot_mode="mod"))
    set_ = np.zeros(size, bool)
    set_[slots.astype(np.int64)] = True
    bits = np.packbits(np.pad(set_, (0, -size % 32)),
                       bitorder="little").view(np.int32)
    words = torch.from_numpy(before.view(np.int32).copy())
    tdm._merge_plain(words, torch.from_numpy(bits), size, first_write,
                     chunk=chunk)
    got = words.numpy().view(np.uint32)
    np.testing.assert_array_equal(got[:size], want[:size])
    np.testing.assert_array_equal(got[size:],
                                  0 if first_write else before[size:])


def test_fixture_sizing_matches_both_packages():
    """The fixture's "direct_2_32" engine settings size the filter at 2^32
    slots or more, the same in both packages' closed form, and each case's
    recorded size is that size."""
    fx = FX["direct_2_32"]
    universe = fx["engine"]["hash_universe"]
    size = calc_optimal_size(universe, 1, 0.1)
    assert size == jcalc(universe, 1, 0.1) == SIZE >= 1 << 32
    assert fx["engine"]["mibf_mode"] == "direct"
    for tag in fx["cases"]:
        assert (fx[tag]["universe"], fx[tag]["size"]) == (universe, size)
    assert {c["slot_map"] for c in fx["cases"].values()} == {"fastrange",
                                                             "mod"}


def silver_golden(fq: str, prefix: str, extra: dict) -> dict:
    """The port's silver paths on ``fq`` on the CPU and its golden path
    over their concatenation, as tools/torch_port_digests.py records
    them."""
    engine = FX["engine"]
    eng = GoldenPathEngine(PathConfig(input=fq, prefix_file=prefix,
                                      **engine, **extra), device="cpu")
    size = {"universe": eng.universe, "size": eng.size}
    st = eng.run()
    del eng
    silver = {}
    with open(prefix + "_all.fq", "wb") as cat:
        for i in range(1, engine["max_paths"] + 1):
            p = f"{prefix}_{i}.fq"
            if os.path.exists(p):
                with open(p, "rb") as f:
                    data = f.read()
                silver[str(i)] = hashlib.sha256(data).hexdigest()
                cat.write(data)
    gold = GoldenPathEngine(PathConfig(
        input=prefix + "_all.fq", prefix_file=prefix + "_golden",
        **{**engine, "silver_path": False, "min_length": 0}, **extra),
        device="cpu").run()
    with open(prefix + "_golden.fa", "rb") as f:
        golden = hashlib.sha256(f.read()).hexdigest()
    return {**size, "recruits": st.recruits,
            "paths_completed": st.paths_completed, "silver": silver,
            "golden": golden, "golden_recruits": gold.recruits}


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(FX["direct_2_32"]["cases"]))
def test_cpu_engine_at_2_32_slots_matches_jax_digests(tmp_path, case):
    """The port's CPU engine with the direct filter at 4,603,242,496 slots
    (~37 GB of host memory), silver then golden on the 1 Mbp gate dataset,
    against the JAX package's "direct_2_32" digests."""
    fx = FX["direct_2_32"]
    ds = FX["dataset"]
    genome = synth.random_genome(ds["genome"], seed=ds["genome_seed"])
    fq = str(tmp_path / "qgate.fq")
    synth.write_fastq(fq, synth.simulate_reads(
        genome, ds["n_reads"], ds["read_len"], seed=ds["reads_seed"],
        err_rate=ds["err_rate"], indel_frac=ds["indel_frac"]))
    got = silver_golden(fq, str(tmp_path / case),
                        {**fx["engine"], **fx["cases"][case]})
    assert got == fx[case]
