"""PyTorch port, host layer: config, seeds, glibc rand, phred, FASTQ ingest
(native and Python readers) and synth give the JAX package's outputs
exactly; the port imports neither jax nor goldrush_tpu."""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import tests.conftest  # noqa: F401
from tests.conftest import FIXTURES, REPO

from goldrush_tpu import config as jcfg
from goldrush_tpu.io import fastq as jfastq
from goldrush_tpu.io.ingest import ReadStream as JReadStream
from goldrush_tpu.utils import synth as jsynth

from goldrush_tpu_torch import config as tcfg
from goldrush_tpu_torch.io import fastq as tfastq
from goldrush_tpu_torch.io.ingest import ReadStream as TReadStream
from goldrush_tpu_torch.io.native import build as tnative
from goldrush_tpu_torch.io.native_reader import native_available
from goldrush_tpu_torch.ops.cxx_rand import GlibcRand
from goldrush_tpu_torch.ops.phred import (calc_median_phred, phred_stats,
                                          phred_stats_block, sum_phred)
from goldrush_tpu_torch.ops.seeds import make_seed_pattern
from goldrush_tpu_torch.utils import synth as tsynth


def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("cls", ["PathConfig", "PipelineConfig"])
def test_config_fields_and_defaults_match(cls):
    assert _defaults(getattr(tcfg, cls)) == _defaults(getattr(jcfg, cls))


@pytest.mark.parametrize("G,w,h,H,occ", [(5_000_000, 16, 3, 0, 0.1),
                                         (60_000, 16, 3, 0, 0.1),
                                         (3_000_000_000, 16, 3, 0, 0.1),
                                         (1_000_000, 12, 4, 0, 0.2),
                                         (1_000_000, 16, 3, 777_777, 0.1)])
def test_filter_sizing_matches(G, w, h, H, occ):
    kw = dict(genome_size=G, kmer_size=22, weight=w, hash_num=h,
              hash_universe=H, occupancy=occ)
    a, b = jcfg.PathConfig(**kw), tcfg.PathConfig(**kw)
    assert a.derived_hash_universe() == b.derived_hash_universe()
    assert a.target_bases() == b.target_bases()
    u = a.derived_hash_universe()
    assert jcfg.calc_optimal_size(u, 1, occ) == \
        tcfg.calc_optimal_size(u, 1, occ)


def test_bench_scale_filter_size():
    # the slice's filter at G = 5 Mbp (config.py:206-231)
    cfg = tcfg.PathConfig(genome_size=5_000_000, kmer_size=22, weight=16)
    assert cfg.derived_hash_universe() == 15_000_000
    assert tcfg.calc_optimal_size(15_000_000, 1, 0.1) == 142_368_384


@pytest.mark.parametrize("silver", [True, False])
def test_pipeline_config_forwarding_matches(silver):
    kw = dict(reads="r", G=1_000_000, k=22, w=16, tile=500, b=4, M=3, m=5000)
    a = jcfg.PipelineConfig(**kw)
    b = tcfg.PipelineConfig(**kw)
    assert dataclasses.asdict(a.path_config(silver)) == \
        dataclasses.asdict(b.path_config(silver))
    assert jcfg.stage_filenames(a) == tcfg.stage_filenames(b)


def test_glibc_rand_golden():
    golden = json.load(open(FIXTURES / "glibc_rand_123.json"))
    rng = GlibcRand(123)
    assert [rng.rand() for _ in range(len(golden))] == golden


def test_seed_patterns_golden():
    for line in open(FIXTURES / "seed_fixtures.jsonl"):
        c = json.loads(line)
        assert make_seed_pattern(c["preset"], c["k"], c["w"], c["h"]) == \
            c["seeds"], c


def test_phred_golden():
    cases = json.load(open(FIXTURES / "phred_fixtures.json"))
    quals = [np.frombuffer(c["qual"].encode(), dtype=np.uint8) for c in cases]
    for c, q in zip(cases, quals):
        assert phred_stats(q) == (c["avg"], c["delta"]), c
        assert sum_phred(q) == pytest.approx(c["sum"], rel=1e-14)
    lengths = np.array([len(q) for q in quals])
    block = np.zeros((len(quals), lengths.max()), dtype=np.uint8)
    for i, q in enumerate(quals):
        block[i, : len(q)] = q
    avg, delta, total = phred_stats_block(block, lengths)
    for i, c in enumerate(cases):
        assert (int(avg[i]), int(delta[i])) == (c["avg"], c["delta"])
        assert float(total[i]) == pytest.approx(c["sum"], rel=1e-14)
    assert calc_median_phred(np.array([1, 9, 5, 7, 3], np.uint32), 4) == 5


@pytest.fixture(scope="module")
def fq(tmp_path_factory):
    d = tmp_path_factory.mktemp("thost")
    genome = jsynth.random_genome(30_000, seed=3)
    reads = jsynth.simulate_reads(genome, 60, 900, seed=4, err_rate=0.02)
    # one read with an invalid base exercises the ACGT gate
    reads.append(("bad", b"ACGTNACGT" * 50, b"I" * 450))
    path = str(d / "r.fq")
    jsynth.write_fastq(path, reads)
    return path


@pytest.mark.parametrize("use_native", [False, True])
def test_ingest_matches_jax_package(fq, use_native):
    if use_native and not native_available():
        pytest.skip("g++/zlib unavailable for the native reader")
    with JReadStream(fq, block_records=17, prefetch=0,
                     use_native=use_native) as a, \
            TReadStream(fq, block_records=17, prefetch=3,
                        use_native=use_native) as b:
        ra, rb = list(a.records()), list(b.records())
    assert len(ra) == len(rb) == 61
    for x, y in zip(ra, rb):
        assert (x.id, x.length, x.phred_avg, x.phred_delta, x.invalid) == \
            (y.id, y.length, y.phred_avg, y.phred_delta, y.invalid)
        assert x.phred_sum == pytest.approx(y.phred_sum, rel=1e-12)
        assert x.seq_bytes() == y.seq_bytes()
        assert x.qual_bytes() == y.qual_bytes()
        np.testing.assert_array_equal(np.asarray(x.codes), np.asarray(y.codes))


def test_native_reader_builds_from_the_shared_source(fq):
    """The port builds its reader from its own copy of the source, which
    is byte for byte the JAX package's, into its own build directory, and
    reads the fixture as the JAX package's reader does."""
    if not native_available():
        pytest.skip("g++/zlib unavailable for the native reader")
    pkg = REPO / "goldrush_tpu_torch"
    assert tnative.SRC == str(pkg / "io" / "native" / "seqio.cpp")
    assert (pkg / "io" / "native" / "seqio.cpp").read_bytes() == \
        (REPO / "goldrush_tpu" / "io" / "native" / "seqio.cpp").read_bytes()
    lib = tnative.get_lib()
    assert os.path.dirname(lib._name) == tnative.BUILD_DIR == \
        str(pkg / "_build")
    with JReadStream(fq, block_records=17, prefetch=0, use_native=True) as a, \
            TReadStream(fq, block_records=17, prefetch=0,
                        use_native=True) as b:
        assert [(r.id, r.seq_bytes(), r.qual_bytes()) for r in a.records()] \
            == [(r.id, r.seq_bytes(), r.qual_bytes()) for r in b.records()]


def test_fastq_records_and_writer(fq, tmp_path):
    a = list(jfastq.read_records(fq))
    b = list(tfastq.read_records(fq))
    assert [(r.id, r.seq, r.qual) for r in a] == \
        [(r.id, r.seq, r.qual) for r in b]
    for mod, name in ((jfastq, "j"), (tfastq, "t")):
        w = mod.PathWriter(str(tmp_path / f"{name}.fq"), True)
        for r in a[:5]:
            w.write(r.id, "_trimmed", r.seq[:100], r.qual[:100])
        w.close()
    assert (tmp_path / "j.fq").read_bytes() == (tmp_path / "t.fq").read_bytes()


@pytest.mark.parametrize("kw", [
    dict(err_rate=0.0),
    dict(err_rate=0.05, indel_frac=0.4),
    dict(err_rate=0.05, indel_frac=0.4, homopolymer_bias=0.6),
])
def test_synth_matches_jax_package(kw):
    g1 = jsynth.random_genome(50_000, seed=9)
    assert tsynth.random_genome(50_000, seed=9) == g1
    assert tsynth.repeat_genome(60_000, seed=5) == \
        jsynth.repeat_genome(60_000, seed=5)
    assert tsynth.simulate_reads(g1, 20, 3000, seed=10, **kw) == \
        jsynth.simulate_reads(g1, 20, 3000, seed=10, **kw)


def test_synth_regenerates_digest_dataset(tmp_path):
    """The port's synth rebuilds the 1 Mbp dataset whose JAX silver digests
    chip_smoke.py checks (tools/torch_port_digests.py)."""
    fx = json.load(open(FIXTURES / "torch_port_digests.json"))
    ds = fx["dataset"]
    genome = tsynth.random_genome(ds["genome"], seed=ds["genome_seed"])
    reads = tsynth.simulate_reads(genome, ds["n_reads"], ds["read_len"],
                                  seed=ds["reads_seed"],
                                  err_rate=ds["err_rate"],
                                  indel_frac=ds["indel_frac"])
    path = tmp_path / "qgate.fq"
    tsynth.write_fastq(str(path), reads)
    assert hashlib.sha256(path.read_bytes()).hexdigest() == ds["sha256"]
    assert set(fx["silver"]) == {"1", "2", "3"}


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import goldrush_tpu_torch, goldrush_tpu_torch.cli\n"
            "import goldrush_tpu_torch.pipeline, goldrush_tpu_torch.kernels\n"
            "import goldrush_tpu_torch.path.engine\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'goldrush_tpu.')) or m == 'goldrush_tpu']\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
