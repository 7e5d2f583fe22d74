"""PyTorch port, the exact-mode slice end to end: the goldrush-path engine
and pipeline write the same silver/golden files, counters, decision rows
and final filter as goldrush_tpu on the test_engine_e2e.py dataset, with
the direct and the rank-compressed filter; the card is never silently
replaced and out-of-slice configs raise."""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from tests.conftest import FIXTURES
from goldrush_tpu.config import PathConfig as JPathConfig
from goldrush_tpu.config import PipelineConfig as JPipelineConfig
from goldrush_tpu.path.engine import GoldenPathEngine as JEngine
from goldrush_tpu.pipeline import run_pipeline as jrun_pipeline
from goldrush_tpu.utils import synth

from goldrush_tpu_torch import cli
from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.path.engine import GoldenPathEngine

# the test_engine_e2e.py configuration: 60 kb genome, 3 kb reads, small
# tiles so smoothing engages
CFG = dict(genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
           seed_preset="1011011110110111101101", tile_length=250,
           min_length=1000, threshold=10, block_size=4, unassigned_min=5,
           assigned_max=1, occupancy=0.1, phred_min=15)
SILVER = dict(max_paths=2, ratio=0.5)


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers; two
    intra-op threads run these engines at half the CPU time of one per
    core and little more wall time."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_e2e")
    genome = synth.random_genome(60_000, seed=3)
    reads = synth.simulate_reads(genome, n_reads=120, read_len=3000, seed=4,
                                 err_rate=0.0, phred=20)
    path = str(d / "reads.fq")
    synth.write_fastq(path, reads)
    return d, path


def out_files(prefix, silver):
    names = ([f"{prefix}_{i}.fq" for i in (1, 2, 3)] if silver
             else [f"{prefix}.fa"])
    return {n[len(prefix):]: open(n, "rb").read()
            for n in names if os.path.exists(n)}


def run_both(d, path, tag, **over):
    """Run both engines on one config; return (jax engine, jax stats,
    port engine, port stats)."""
    silver = over.get("silver_path", False)
    kw = {**CFG, **(SILVER if silver else {}), **over}
    je = JEngine(JPathConfig(input=path, prefix_file=str(d / f"j{tag}"),
                             keep_filter=True, **kw))
    js = je.run()
    te = GoldenPathEngine(PathConfig(input=path,
                                     prefix_file=str(d / f"t{tag}"), **kw),
                          device="cpu")
    ts = te.run()
    jf, tf = out_files(str(d / f"j{tag}"), silver), \
        out_files(str(d / f"t{tag}"), silver)
    assert jf and tf == jf
    return je, js, te, ts


def counters(stats):
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if not f.name.startswith("wall_")}


@pytest.mark.parametrize("over", [
    dict(batch_reads=1), dict(batch_reads=32),
    dict(batch_reads=1, silver_path=True),
    dict(batch_reads=32, silver_path=True),
    dict(batch_reads=32, silver_path=True, slot_map="mod"),
    dict(batch_reads=1, mibf_mode="compressed"),
    dict(batch_reads=32, silver_path=True, mibf_mode="compressed"),
    dict(batch_reads=32, silver_path=True, slot_map="mod",
         mibf_mode="compressed")],
    ids=["golden-b1", "golden-b32", "silver-b1", "silver-b32",
         "silver-b32-mod", "compressed-golden-b1",
         "compressed-silver-b32", "compressed-silver-b32-mod"])
def test_engine_matches_jax(dataset, over):
    d, path = dataset
    tag = "".join(f"{v}" for v in over.values())
    je, js, te, ts = run_both(d, path, tag, **over)
    assert counters(ts) == counters(js)
    assert ts.recruits > 0
    assert ts.paths_completed == (2 if over.get("silver_path") else 0)
    np.testing.assert_array_equal(te.last_rows, je.last_rows)
    if over.get("mibf_mode") == "compressed":
        got = tcz.state_to_numpy(te.cstate)
        for name in ("bitrank", "supers", "ids", "counts"):
            np.testing.assert_array_equal(
                got[name], np.asarray(getattr(je.cstate, name)),
                err_msg=name)
        return
    words, counts = tdm.state_to_numpy(te.state)
    # slot `size` is the sentinel the JAX fill scatter dumps invalid frames
    # on; every real slot must agree
    np.testing.assert_array_equal(words[: te.size],
                                  np.asarray(je.state.words)[: te.size])
    np.testing.assert_array_equal(counts[: te.size],
                                  np.asarray(je.state.counts)[: te.size])


@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_gate_dataset_silver_digests_match_jax(tmp_path, mode):
    """The 1 Mbp quality-gate dataset at exact defaults: the port's silver
    paths hash to the JAX package's digests (the same check chip_smoke.py
    makes on the card), with either filter layout."""
    fx = json.load(open(FIXTURES / "torch_port_digests.json"))
    want = fx if mode == "direct" else fx["compressed"]
    ds = fx["dataset"]
    genome = synth.random_genome(ds["genome"], seed=ds["genome_seed"])
    reads = synth.simulate_reads(genome, ds["n_reads"], ds["read_len"],
                                 seed=ds["reads_seed"],
                                 err_rate=ds["err_rate"],
                                 indel_frac=ds["indel_frac"])
    fq = str(tmp_path / "qgate.fq")
    synth.write_fastq(fq, reads)
    prefix = str(tmp_path / "exact")
    st = GoldenPathEngine(PathConfig(input=fq, prefix_file=prefix,
                                     mibf_mode=mode, **fx["engine"]),
                          device="cpu").run()
    got = {str(i): hashlib.sha256(open(f"{prefix}_{i}.fq", "rb").read()
                                  ).hexdigest()
           for i in (1, 2, 3) if os.path.exists(f"{prefix}_{i}.fq")}
    assert got == want["silver"]
    assert (st.recruits, st.paths_completed) == \
        (want["recruits"], want["paths_completed"])


def test_debug_dumps_and_filter_file_match_jax(dataset, capsys):
    d, path = dataset
    ff = d / "exclude.txt"
    names = [line[1:].split()[0] for line in open(path) if
             line.startswith("@read")][:12]
    ff.write_text("\n".join(names[::3]) + "\n")
    capsys.readouterr()
    kw = {**CFG, "debug": True, "filter_file": str(ff)}
    JEngine(JPathConfig(input=path, prefix_file=str(d / "jdbg"),
                        **kw)).run()
    jerr = capsys.readouterr().err
    GoldenPathEngine(PathConfig(input=path, prefix_file=str(d / "tdbg"),
                                **kw), device="cpu").run()
    terr = capsys.readouterr().err
    assert terr == jerr and terr.count("\n") > 9 * 2 * 50
    assert out_files(str(d / "tdbg"), False) == \
        out_files(str(d / "jdbg"), False)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_saved_filter_resumes_in_the_other_package(dataset, tmp_path,
                                                   writer):
    d, path = dataset
    ckpt = str(tmp_path / "filter.npz")
    kw = dict(CFG, batch_reads=8)
    straight = str(tmp_path / "straight")
    resumed = str(tmp_path / "resumed")
    if writer == "jax":
        JEngine(JPathConfig(input=path, prefix_file=straight, save_mibf=ckpt,
                            **kw)).run()
        GoldenPathEngine(PathConfig(input=path, prefix_file=resumed,
                                    load_mibf=ckpt, **kw), device="cpu").run()
    else:
        GoldenPathEngine(PathConfig(input=path, prefix_file=straight,
                                    save_mibf=ckpt, **kw), device="cpu").run()
        JEngine(JPathConfig(input=path, prefix_file=resumed, load_mibf=ckpt,
                            **kw)).run()
    a, b = out_files(straight, False), out_files(resumed, False)
    assert a and a == b


def test_cli_goldrush_path_matches_jax_pipeline(dataset, tmp_path):
    d, path = dataset
    reads = os.path.splitext(path)[0]
    params = dict(G=60_000, t=2, k=22, w=16, tile=250, b=4, m=1000, M=2,
                  r=0.5, P=15, x=10, u=5, a=1)
    jcfg = JPipelineConfig(reads=reads, p="jgold", **params)
    jout = jrun_pipeline(jcfg, workdir=str(tmp_path / "j"), until="golden")
    argv = ["goldrush-path", f"reads={reads}", f"prefix={tmp_path / 't'}",
            "p=tgold", "device=cpu"] + [f"{k}={v}" for k, v in params.items()]
    assert cli.main(argv) == 0
    want = (tmp_path / "j" / jout["golden"]).read_bytes()
    got = (tmp_path / "t" / "tgold_golden_path.fa").read_bytes()
    assert got == want and want.count(b">") > 5
    # dev=False removed the silver intermediates, as the JAX pipeline does
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        ["tgold_golden_path.fa"]


def test_cuda_without_a_card_raises(dataset, monkeypatch):
    d, path = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        GoldenPathEngine(PathConfig(input=path, **CFG), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["goldrush-path", f"reads={os.path.splitext(path)[0]}",
                  "G=60000", f"prefix={d / 'nocard'}"])


@pytest.mark.parametrize("over", [
    dict(insert_stride=2), dict(insert_seeds=2, probe_seeds=1),
    dict(wavefront=True), dict(ntcard=True), dict(devices=2),
    dict(model_shards=2)])
def test_out_of_slice_config_raises(over):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GoldenPathEngine(PathConfig(**{**CFG, **over}), device="cpu")


@pytest.mark.parametrize("stride", [3, 8])
def test_stride_must_divide_tile_length(stride):
    """A frame stride that does not divide tile_length (250) raises, as the
    JAX engine's construction does."""
    with pytest.raises(ValueError, match="frame_stride must divide"):
        GoldenPathEngine(PathConfig(**{**CFG, "frame_stride": stride}),
                         device="cpu")


@pytest.mark.parametrize("cmd", ["run", "path-polish",
                                 "path-tigmint-ntLink-target"])
def test_stages_past_golden_raise(dataset, cmd, tmp_path, monkeypatch,
                                  capsys):
    """The commands past the golden path no longer raise: each reaches
    run_pipeline with its stage and prints that stage's output
    (tests/test_torch_pipeline.py runs them end to end)."""
    from goldrush_tpu_torch import pipeline
    d, path = dataset
    seen = []

    def fake_run(cfg, workdir, until, **kw):
        seen.append((until, kw["device"]))
        return {until: f"{until}.fa"}
    monkeypatch.setattr(pipeline, "run_pipeline", fake_run)
    monkeypatch.chdir(tmp_path)
    assert cli.main([cmd, f"reads={os.path.splitext(path)[0]}", "G=60000",
                     "device=cpu", f"prefix={tmp_path / cmd}"]) == 0
    assert seen == [(cli.COMMANDS[cmd], "cpu")]
    want = {"polished": "Polished assembly: polished.fa",
            "final": "Final assembly: final.fa"}[cli.COMMANDS[cmd]]
    assert capsys.readouterr().out.splitlines()[-1] == want
