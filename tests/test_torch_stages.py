"""PyTorch port, the stages after polish: tigmint, ntLink (scaffolds and
gap regions), targeted polish (with and without its mapper), the racon
equivalent and assembly_stats against goldrush_tpu on
tests/test_stages.py's and tests/test_ntlink_targeted.py's inputs, bit for
bit (the port's plain K20/K21 on the CPU)."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.stages import ntlink as jntl
from goldrush_tpu.stages import racon as jrac
from goldrush_tpu.stages import targeted as jtgt
from goldrush_tpu.stages import tigmint as jtig
from goldrush_tpu.utils import synth
from goldrush_tpu.utils.stats import assembly_stats as jstats

from goldrush_tpu_torch.stages import ntlink as tntl
from goldrush_tpu_torch.stages import racon as trac
from goldrush_tpu_torch.stages import targeted as ttgt
from goldrush_tpu_torch.stages import tigmint as ttig
from goldrush_tpu_torch.utils.stats import assembly_stats as tstats


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tigmint_cases():
    """tests/test_stages.py's chimera and clean contig."""
    a = synth.random_genome(12_000, seed=41)
    b = synth.random_genome(12_000, seed=42)
    good = a[:5000] + synth.random_genome(50, seed=43)
    chim_reads = [r for src in (a, b) for r in
                  synth.simulate_reads(src, 40, 4000, seed=len(src),
                                       err_rate=0.01)]
    g = synth.random_genome(20_000, seed=44)
    return {
        "chimera": ([("chim", a + b), ("good", good)], chim_reads,
                    dict(span=2, dist=500, cut=250, k=24, w=64,
                         min_piece=1000)),
        "clean": ([("c", g)], synth.simulate_reads(g, 60, 4000, seed=45,
                                                   err_rate=0.01),
                  dict(span=2, dist=500, cut=250, k=24, w=64)),
        # the pipeline's defaults (k=20, w=16)
        "defaults": ([("chim", a + b), ("good", good)], chim_reads,
                     dict(span=2, dist=500, cut=250)),
    }


@pytest.mark.parametrize("case", ["chimera", "clean", "defaults"])
def test_tigmint_matches_jax(case):
    contigs, reads, kw = tigmint_cases()[case]
    want = jtig.run_tigmint(contigs, reads, jtig.TigmintParams(**kw))
    got = ttig.run_tigmint(contigs, reads, ttig.TigmintParams(**kw),
                           device="cpu")
    assert got == want
    if case == "chimera":
        assert sum(n.startswith("chim") for n, _ in got) >= 2


def fragmented(genome, breaks, gap):
    """tests/test_ntlink_targeted.py's make_fragmented_assembly."""
    contigs, prev = [], 0
    for i, b in enumerate(breaks + [len(genome)]):
        contigs.append((f"c{i}", genome[prev + (gap if prev else 0): b]))
        prev = b
    return contigs


def ntlink_cases():
    genome = synth.random_genome(36_000, seed=51)
    contigs = fragmented(genome, [12_000, 24_000], 300)
    contigs[1] = (contigs[1][0], jntl.revcomp(contigs[1][1]))
    a = synth.random_genome(15_000, seed=53)
    b = synth.random_genome(15_000, seed=54)
    g57 = synth.random_genome(20_000, seed=57)
    return {
        "gapfill": (contigs, [s for _, s, _ in synth.simulate_reads(
            genome, 80, 5000, seed=52, err_rate=0.0)],
            dict(k=24, w=100, z=1000, a=1, rounds=3, end_margin=3000,
                 min_anchors=3)),
        "no_joins": ([("a", a), ("b", b)],
                     [s for _, s, _ in synth.simulate_reads(a, 30, 4000,
                                                            seed=55)]
                     + [s for _, s, _ in synth.simulate_reads(b, 30, 4000,
                                                              seed=56)],
                     dict(k=24, w=100, z=1000, a=1, rounds=2,
                          end_margin=2000, min_anchors=3)),
        "noisy_fill": (fragmented(g57, [10_000], 250),
                       [s for _, s, _ in synth.simulate_reads(
                           g57, 120, 4000, seed=58, err_rate=0.02)],
                       dict(k=24, w=100, z=1000, a=1, rounds=2,
                            end_margin=3000, min_anchors=3)),
    }


def scaffolds_equal(got, want):
    assert [(s.name, s.seq, s.filled) for s in got] == \
        [(s.name, s.seq, s.filled) for s in want]


@pytest.mark.parametrize("case", ["gapfill", "no_joins", "noisy_fill"])
def test_ntlink_matches_jax(case):
    contigs, reads, kw = ntlink_cases()[case]
    want = jntl.run_ntlink(contigs, reads, jntl.NtLinkParams(**kw))
    got = tntl.run_ntlink(contigs, reads, tntl.NtLinkParams(**kw),
                          device="cpu")
    scaffolds_equal(got, want)
    if case != "no_joins":
        assert len(got) == 1 and got[0].filled


@pytest.mark.parametrize("mapper_k", [None, 88])
def test_targeted_polish_matches_jax(mapper_k):
    """tests/test_ntlink_targeted.py::test_targeted_polish_cleans_fill:
    ntLink's scaffold, then its fills polished against one global table or
    against the reads its mapper assigns (k 32 of --k-ntlink 88, w 1000:
    the pipeline's setting)."""
    contigs, reads, kw = ntlink_cases()["noisy_fill"]
    scaffolds = tntl.run_ntlink(contigs, reads, tntl.NtLinkParams(**kw),
                                device="cpu")
    jsc = [jntl.Scaffold(s.name, s.seq, list(s.filled)) for s in scaffolds]
    tp = dict(flank=64, k=24, solid_min=3)
    want = jtgt.polish_targets(jsc, reads, jtgt.TargetParams(**tp),
                               mapper_k=mapper_k)
    got = ttgt.polish_targets(scaffolds, reads, ttgt.TargetParams(**tp),
                              mapper_k=mapper_k, device="cpu")
    assert got == want


def test_racon_matches_jax():
    g = synth.random_genome(20_000, seed=49)
    reads = [s for _, s, _ in synth.simulate_reads(g, 50, 5000, seed=50,
                                                   err_rate=0.03)]
    draft = bytearray(g)
    rng = np.random.default_rng(23)
    for b in rng.integers(500, len(g) - 500, 30):
        draft[b] = ord("A") if draft[b] != ord("A") else ord("C")
    contigs = [("c", bytes(draft)), ("d", g[:3_000])]
    want = jrac.polish_with_racon(contigs, reads)
    got = trac.polish_with_racon(contigs, reads, device="cpu")
    assert got == want and want[1] > 0


@pytest.mark.parametrize("lengths", [[], [100, 499], [500], [56_821],
                                     [12_000, 9_000, 700, 20_000, 501],
                                     [1_000] * 7])
def test_assembly_stats_match_jax(lengths):
    assert tstats(lengths) == jstats(lengths)
    assert tstats(lengths, min_len=0) == jstats(lengths, min_len=0)
