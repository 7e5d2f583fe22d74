"""PyTorch port, the throughput mode end to end: sampled query grids
(frame_stride, probe_seeds), the optimistic staleness policy with the
max-id-wins insert, and the full-resolution trim recheck write the same
silver/golden files, counters, decision rows and final filter as
goldrush_tpu under the same config, with either filter
(tests/test_torch_throughput_gate.py holds the 1 Mbp gate dataset)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.config import PathConfig as JPathConfig
from goldrush_tpu.path.engine import GoldenPathEngine as JEngine
from goldrush_tpu.utils import synth

from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.path.engine import GoldenPathEngine


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers; two
    intra-op threads run these engines at half the CPU time of one per
    core and little more wall time."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# tests/test_torch_engine.py's configuration (60 kb genome, 3 kb reads);
# a stride must divide tile_length, and vote_topk must not exceed the
# probed frames of a tile (h_active * tile_length / stride)
CFG = dict(genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
           seed_preset="1011011110110111101101", tile_length=250,
           min_length=1000, threshold=10, block_size=4, unassigned_min=5,
           assigned_max=1, occupancy=0.1, phred_min=15)
SILVER = dict(max_paths=2, ratio=0.5)
OPT = dict(recheck="optimistic")
# four silver paths of 0.7 G: resets fall inside later batches, where the
# optimistic policy must re-probe the batch-time drops after them
ROTATE = dict(silver_path=True, max_paths=4, ratio=0.7)
# bench.py's throughput cell at this size: tile_length 256 so that the
# stride divides it, vote_topk 32 = the 32 probed frames of a tile
BENCH_SMALL = dict(OPT, frame_stride=8, probe_seeds=1, batch_reads=64,
                   tile_length=256, vote_topk=32, mibf_mode="compressed",
                   silver_path=True)

CASES = {
    # 7a: optimistic at stride 1 with all seeds (no recheck, query grid =
    # insert grid)
    "opt-golden-b1": dict(OPT, batch_reads=1),
    "opt-silver-b32": dict(OPT, batch_reads=32, **ROTATE),
    "opt-compressed-silver-b32": dict(OPT, batch_reads=32, **ROTATE,
                                      mibf_mode="compressed"),
    # 7b/7c: the exact policy on the general sampled grid (S < h), recheck on
    "exact-s2-silver-b32": dict(frame_stride=2, batch_reads=32,
                                silver_path=True),
    # the last-tile sampled grid (S >= h), one probed seed
    "opt-s5-p1-compressed-silver-b32": dict(OPT, frame_stride=5,
                                            probe_seeds=1, batch_reads=32,
                                            silver_path=True,
                                            mibf_mode="compressed"),
    "opt-s5-p1-golden-b32": dict(OPT, frame_stride=5, probe_seeds=1,
                                 batch_reads=32),
    "bench-cell-small": BENCH_SMALL,
    # the recheck turned on by the probed seeds alone
    "opt-s1-p1-silver-b32": dict(OPT, probe_seeds=1, batch_reads=32,
                                 silver_path=True),
    "opt-s5-p1-norecheck-silver-b32": dict(OPT, frame_stride=5,
                                           probe_seeds=1, batch_reads=32,
                                           silver_path=True,
                                           trim_recheck=False),
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_throughput")
    genome = synth.random_genome(60_000, seed=3)
    reads = synth.simulate_reads(genome, n_reads=120, read_len=3000, seed=4,
                                 err_rate=0.0, phred=20)
    path = str(d / "reads.fq")
    synth.write_fastq(path, reads)
    return d, path


def out_files(prefix, silver):
    names = ([f"{prefix}_{i}.fq" for i in range(1, 6)] if silver
             else [f"{prefix}.fa"])
    return {n[len(prefix):]: open(n, "rb").read()
            for n in names if os.path.exists(n)}


def counters(stats):
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if not f.name.startswith("wall_")}


@pytest.mark.parametrize("case", list(CASES))
def test_throughput_engine_matches_jax(dataset, case):
    d, path = dataset
    over = CASES[case]
    silver = over.get("silver_path", False)
    kw = {**CFG, **(SILVER if silver else {}), **over}
    je = JEngine(JPathConfig(input=path, prefix_file=str(d / f"j{case}"),
                             keep_filter=True, **kw))
    js = je.run()
    te = GoldenPathEngine(PathConfig(input=path,
                                     prefix_file=str(d / f"t{case}"), **kw),
                          device="cpu")
    ts = te.run()
    jf = out_files(str(d / f"j{case}"), silver)
    assert jf and out_files(str(d / f"t{case}"), silver) == jf
    assert counters(ts) == counters(js) and ts.recruits > 0
    np.testing.assert_array_equal(te.last_rows, je.last_rows)
    if over.get("mibf_mode") == "compressed":
        got = tcz.state_to_numpy(te.cstate)
        for name in ("bitrank", "supers", "ids", "counts"):
            np.testing.assert_array_equal(
                got[name], np.asarray(getattr(je.cstate, name)),
                err_msg=name)
        return
    words, counts = tdm.state_to_numpy(te.state)
    np.testing.assert_array_equal(words[: te.size],
                                  np.asarray(je.state.words)[: te.size])
    np.testing.assert_array_equal(counts[: te.size],
                                  np.asarray(je.state.counts)[: te.size])
