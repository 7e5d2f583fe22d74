"""PyTorch port, `goldrush run` end to end on the CPU: both packages'
run_pipeline(until="final") on tests/test_pipeline.py's 60 kb dataset and
configuration write byte-identical stage files (silver, golden, polished,
tigmint, ntLink with its .gaps.json, final), and the JAX package's match
the digests of tests/fixtures/torch_port_digests.json, which chip_smoke.py
holds the port's run on the card to.  Also the port's resume rules, dev
cleanup, its CLI, and that no module of the port imports jax or
goldrush_tpu."""

import hashlib
import json
import pathlib
import re

import pytest
import torch

import tests.conftest  # noqa: F401
from tests.conftest import FIXTURES, REPO
from goldrush_tpu.config import PipelineConfig as JPipelineConfig
from goldrush_tpu.pipeline import run_pipeline as jrun_pipeline
from goldrush_tpu.utils import synth

from goldrush_tpu_torch import cli
from goldrush_tpu_torch.config import PipelineConfig, stage_filenames
from goldrush_tpu_torch.pipeline import ORDER, run_pipeline

FX = json.loads(
    (FIXTURES / "torch_port_digests.json").read_text())["pipeline"]
STAGES = ("polished", "tigmint", "ntlink", "final")


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def sha256(path) -> str:
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


def digests(workdir, files) -> dict:
    out = {s: sha256(workdir / files[s]) for s in STAGES}
    out["gaps"] = sha256(workdir / (files["ntlink"] + ".gaps.json"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dataset, then the JAX package's and the port's run."""
    d = tmp_path_factory.mktemp("pipe")
    ds = FX["dataset"]
    genome = synth.random_genome(ds["genome"], seed=ds["genome_seed"])
    synth.write_fastq(str(d / "reads.fq"), synth.simulate_reads(
        genome, ds["n_reads"], ds["read_len"], seed=ds["reads_seed"],
        err_rate=ds["err_rate"], phred=ds["phred"]))
    assert sha256(d / "reads.fq") == ds["sha256"]
    reads = str(d / "reads")
    jout = jrun_pipeline(JPipelineConfig(reads=reads, **FX["config"]),
                         workdir=str(d / "j"), until="final")
    cfg = PipelineConfig(reads=reads, **FX["config"])
    tout = run_pipeline(cfg, workdir=str(d / "t"), until="final",
                        device="cpu")
    return d, cfg, jout, tout


def test_stage_files_match_jax(runs):
    d, cfg, jout, tout = runs
    files = stage_filenames(cfg)
    names = sorted(p.name for p in (d / "j").iterdir())
    assert names == sorted(p.name for p in (d / "t").iterdir())
    assert files["final"] in names and len(names) == 6 + 4
    for name in names:
        got = (d / "t" / name).read_bytes()
        assert got == (d / "j" / name).read_bytes(), name
    assert tout["final"] == jout["final"] == files["final"]
    assert tout["assembly_stats"] == jout["stats"]
    # the demo-equivalent acceptance of tests/test_pipeline.py
    st = tout["assembly_stats"]
    assert 0.8 * 60_000 <= st["total"] <= 1.8 * 60_000 and st["L50"] <= 4
    assert set(tout["seconds"]) == {
        "goldrush-path (silver)", "goldrush-path (golden)", "polish",
        "tigmint", "ntLink", "targeted polish"}


def test_jax_digests_match_fixture(runs):
    """A stale fixture fails here, before the card is held to it."""
    d, cfg, jout, _ = runs
    assert digests(d / "j", stage_filenames(cfg)) == FX["files"]
    assert jout["stats"] == FX["assembly_stats"]
    assert digests(d / "t", stage_filenames(cfg)) == FX["files"]


def test_pipeline_resume(runs):
    """Existing stage outputs are not recomputed; a removed final stage is,
    alone and to the same bytes."""
    d, cfg, _, _ = runs
    files = stage_filenames(cfg)
    t = d / "t"
    before = {s: (t / files[s]).stat().st_mtime_ns for s in ORDER[1:]}
    final = (t / files["final"]).read_bytes()
    out = run_pipeline(cfg, workdir=str(t), until="final", device="cpu")
    assert {s: (t / files[s]).stat().st_mtime_ns
            for s in ORDER[1:]} == before
    assert out["seconds"] == {}
    (t / files["final"]).unlink()
    out = run_pipeline(cfg, workdir=str(t), until="final", device="cpu")
    assert list(out["seconds"]) == ["targeted polish"]
    assert (t / files["final"]).read_bytes() == final
    for stage in ORDER[1:]:
        assert run_pipeline(cfg, workdir=str(t), until=stage,
                            device="cpu")[stage] == files[stage]
    with pytest.raises(ValueError, match="unknown stage"):
        run_pipeline(cfg, workdir=str(t), until="scaffold", device="cpu")


def test_dev_cleanup(runs):
    """dev=False removes the silver intermediates after the golden pass
    (bin/goldrush:202-206), and a resume from the golden file does not
    rebuild them; the stages after it go on from the golden file."""
    d, cfg, _, _ = runs
    cfg = cfg.replace(dev=False, p="goldrush_dev0")
    files = stage_filenames(cfg)
    w = d / "dev0"
    run_pipeline(cfg, workdir=str(w), until="golden", device="cpu")
    golden = w / files["golden"]
    assert golden.exists()
    for f in files["silver"] + [files["silver_all"]]:
        assert not (w / f).exists(), f
    before = golden.stat().st_mtime_ns
    out = run_pipeline(cfg, workdir=str(w), until="polished", device="cpu")
    assert golden.stat().st_mtime_ns == before
    assert list(out["seconds"]) == ["polish"]
    assert sha256(w / files["polished"]) == FX["files"]["polished"]
    for f in files["silver"]:
        assert not (w / f).exists(), f


def test_cli_run(runs, tmp_path, monkeypatch, capsys):
    """`run` links the reads into its prefix, writes the same final
    assembly, prints its line and links it into the working directory, as
    goldrush_tpu.cli does."""
    d, cfg, jout, _ = runs
    monkeypatch.chdir(tmp_path)
    argv = ["run", f"reads={d / 'reads'}", "prefix=out", "device=cpu"] + [
        f"{k}={int(v) if isinstance(v, bool) else v}"
        for k, v in FX["config"].items()]
    assert cli.main(argv) == 0
    final = jout["final"]
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"Final assembly: {final}"
    assert (tmp_path / "out" / "reads.fq").is_symlink()
    assert (tmp_path / final).is_symlink()
    assert (tmp_path / final).read_bytes() == \
        (d / "j" / final).read_bytes()


def test_cli_version_and_help(capsys):
    assert cli.main(["version"]) == 0
    assert "goldrush-tpu-torch version" in capsys.readouterr().out
    assert cli.main(["help"]) == 0
    out = capsys.readouterr().out
    assert "Commands:" in out and "NotImplementedError" not in out
    for cmd in ("run", "path-polish", "path-tigmint-ntLink-target"):
        assert cmd in out
    with pytest.raises(SystemExit):
        cli.main(["nope"])


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|goldrush_tpu)\b",
                     re.M)


def test_port_sources_import_no_jax():
    """No module of the port and not chip_smoke.py names jax or the JAX
    package in an import statement (tests/test_torch_host.py checks the
    modules a run loads)."""
    sources = sorted((REPO / "goldrush_tpu_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    assert len(sources) > 30
    bad = [str(p.relative_to(REPO)) for p in sources
           if _IMPORT.search(p.read_text())]
    assert not bad, bad
