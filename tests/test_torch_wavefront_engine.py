"""PyTorch port, the wavefront consume (K23) end to end: GoldenPathEngine
with wavefront=True on the CPU against the JAX wavefront engine, on
tests/test_wavefront.py's dataset and settings (60 kb genome, 80 x 6 kb
reads at 2% error, stride 8, one probed seed, optimistic staleness,
batches of 16): the path files byte for byte, the per-read rows,
EngineStats, the final filter and the side table, with either filter, in
silver mode here and golden mode in test_torch_wavefront_golden.py, at
windows of 16 and 256 reads.  test_wavefront.py's own checks (the two
filters agree; bounded drift from the scan) then hold for the port by
identity.

The JAX wavefront cannot run a window of fewer than 64 reads: its
classify chunk (CLASSIFY_CHUNK, 64 rows) is sliced out of the window's
row list (goldrush_tpu/path/wavefront.py:384; ROADMAP queue 3).  Chunking
changes no output, so the JAX side runs with its chunks cut to 16 rows,
patched here, never in the package."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import goldrush_tpu.path.wavefront as jwave
from goldrush_tpu.config import PathConfig as JPathConfig
from goldrush_tpu.path.engine import GoldenPathEngine as JEngine
from goldrush_tpu.utils import synth

from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.path.engine import GoldenPathEngine

G = 60_000
# tests/test_wavefront.py's engine settings
CFG = dict(genome_size=G, kmer_size=22, weight=16, hash_num=3,
           seed_preset="1011011110110111101101", max_paths=2,
           min_length=4_000, ratio=0.5, hash_universe=3_000_000,
           batch_reads=16, frame_stride=8, probe_seeds=1,
           recheck="optimistic", wavefront=True)


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wave_reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_wave")
    genome = synth.random_genome(G, seed=7)
    reads = synth.simulate_reads(genome, 80, 6_000, seed=8, err_rate=0.02)
    path = str(d / "reads.fq")
    synth.write_fastq(path, reads)
    return d, path


@pytest.fixture
def small_jax_chunks(monkeypatch):
    for name in ("CLASSIFY_CHUNK", "CONFLICT_CHUNK", "RECHECK_CHUNK",
                 "INSERT_CHUNK"):
        monkeypatch.setattr(jwave, name, min(getattr(jwave, name), 16))


def path_files(prefix: str, silver: bool) -> dict:
    names = ([f"{prefix}_{i}.fq" for i in (1, 2, 3)] if silver
             else [f"{prefix}.fa"])
    return {n[len(prefix):]: open(n, "rb").read()
            for n in names if os.path.exists(n)}


def run_both(d, path, mode: str, silver: bool, window: int) -> None:
    """Both engines on one configuration; everything compared."""
    tag = f"{mode}_{int(silver)}_{window}"
    kw = dict(CFG, input=path, mibf_mode=mode, silver_path=silver,
              wave_window=window)
    je = JEngine(JPathConfig(prefix_file=str(d / f"j{tag}"),
                             keep_filter=True, **kw))
    js = je.run()
    te = GoldenPathEngine(PathConfig(prefix_file=str(d / f"t{tag}"), **kw),
                          device="cpu")
    ts = te.run()
    assert te.wave and je._wave
    jfiles = path_files(str(d / f"j{tag}"), silver)
    assert path_files(str(d / f"t{tag}"), silver) == jfiles and jfiles
    jstats, tstats = dataclasses.asdict(js), dataclasses.asdict(ts)
    for k, v in jstats.items():
        if not k.startswith("wall_"):
            assert tstats[k] == v, k
    assert ts.recruits > 0
    np.testing.assert_array_equal(te.last_rows, np.asarray(je.last_rows))
    if mode == "compressed":
        for k in ("ids", "counts"):
            np.testing.assert_array_equal(
                getattr(te.cstate, k).numpy().view(np.uint32),
                np.asarray(getattr(je.cstate, k)), err_msg=k)
    else:
        n = te.size
        np.testing.assert_array_equal(
            te.state.words.numpy().view(np.uint32)[:n],
            np.asarray(je.state.words)[:n])
    np.testing.assert_array_equal(te.wave_side.numpy().view(np.uint32),
                                  np.asarray(je._wave_side))
    c = te.consume_counts
    assert c["rounds"] >= ts.num_batches and c["commits"] == ts.recruits
    assert c["faults"] == 0
    if silver:
        assert ts.paths_completed == 2 and c["rotations"] >= 1


@pytest.mark.parametrize("window", [16, 256])
@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_wavefront_silver_matches_jax(wave_reads, small_jax_chunks, mode,
                                      window):
    d, path = wave_reads
    run_both(d, path, mode, True, window)
