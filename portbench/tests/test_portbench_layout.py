"""The harness finds a cell's files by name: an added configuration,
traffic mix and per-layer metric need new files and entries only.  And
nothing it runs imports the JAX package or JAX."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import lib, run


def _outcome():
    return dict(attempted=2, failed=0, memory_peak_bytes=123,
                e2e=dict(path_Mbp_per_s=40.0, device_peak_GB=66.8,
                         setup_s=13.0),
                checks=dict(rows_mismatched=(0, 0)),
                profile=dict(busy_s=1.0, window_s=4.0,
                             kernel_s={"gr::consume_kernel": 0.5},
                             device_ops=[["gr::consume_kernel", 0.5]],
                             idle_gaps=[["engine.assign", 0.2]]),
                layer=dict(jobs=[dict(wall_fill_s=0.4, wall_submit_s=0.5,
                                      wall_replay_s=0.1, wall_job_s=1.5)] * 3,
                           job_bases=60_000_000, profiled=1,
                           tables_bytes=22_778_937_344,
                           consume_bound_s=0.005))


def test_added_files_are_found_without_an_edit(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(lib.ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = lib.benchmark()
    conf = lib.load_json(os.path.join(lib.ROOT, bench["configs"][0]["file"]))
    conf["name"] = "new-config"
    with open(os.path.join(root, "portbench", "configs", "new-config.json"),
              "w") as f:
        json.dump(conf, f)
    traffic = lib.resolve(bench["workloads"][0]["name"])["traffic"]
    traffic["config"] = "new-config"
    with open(os.path.join(root, "portbench", "workloads", "new.mix.json"),
              "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(root, "portbench", "metrics", "new.metric.py"),
              "w") as f:
        f.write("def read(out):\n    return out['attempted'] * 2.0\n")
    bench["configs"].append(dict(bench["configs"][0], name="new-config",
                                 file="portbench/configs/new-config.json"))
    bench["workloads"].append(dict(name="new.cell", config="new-config",
                                   traffic="new.mix", chips=1, why="x"))
    bench["per_layer"].append(dict(name="new.metric", unit="%",
                                   better="higher", source="program_counter",
                                   layer="device", moves="path_Mbp_per_s",
                                   workloads=["new.cell"]))
    bench["end_to_end"][0]["workloads"].append("new.cell")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    spec = lib.resolve("new.cell", root=root)
    assert spec["config"]["name"] == "new-config"
    assert spec["traffic"]["driver"] == traffic["driver"]
    assert [m["name"] for m in spec["per_layer"]] == ["new.metric"]
    reader = lib.load_module("metrics", "new.metric", root=root)
    assert reader.read(_outcome()) == 4.0


def test_result_line_takes_the_cells_metrics():
    spec = lib.resolve("hs-cz.silver")
    res = run.assemble(spec, _outcome(), trace=False)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {"path_Mbp_per_s", "device_peak_GB",
                                   "setup_s"}
    assert res["correct"] is True
    traced = run.assemble(spec, _outcome(), trace=True)
    assert list(traced)[-1] == "checks" and "breakdown" in traced
    assert traced["metrics"]["device.idle_pct.path"]["value"] == 75.0
    assert traced["metrics"]["consume.roofline_pct"]["value"] == 1.0
    assert traced["metrics"]["fill.s_per_Gbp"]["value"] == \
        pytest.approx(0.4 / 0.06)
    bad = _outcome()
    bad["checks"]["rows_mismatched"] = (3, 0)
    assert run.assemble(spec, bad, trace=False)["correct"] is False


def test_direct_cell_reports_the_job_rate_per_layer():
    """ce-direct.silver carries the jobs' rate per layer, not end to end
    (PERF.md, section 2), and both cells the filter's tables."""
    spec = lib.resolve("ce-direct.silver")
    res = run.assemble(spec, _outcome(), trace=False)
    assert set(res["metrics"]) == {"device_peak_GB", "setup_s"}
    traced = run.assemble(spec, _outcome(), trace=True)
    assert set(traced["metrics"]) == {"job.Mbp_per_s.direct",
                                      "filter.tables_GB"}
    assert traced["metrics"]["job.Mbp_per_s.direct"]["value"] == \
        pytest.approx(60.0 * 2 / 3.0)
    assert traced["metrics"]["filter.tables_GB"]["value"] == \
        pytest.approx(22.778937344)
    hs = run.assemble(lib.resolve("hs-cz.silver"), _outcome(), trace=True)
    assert "filter.tables_GB" in hs["metrics"]
    assert "job.Mbp_per_s.direct" not in hs["metrics"]


def test_nothing_imports_jax_or_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import lib, run\n"
        "from portbench.tests import small\n"
        "lib.load_module('drivers', 'engine_jobs')\n"
        "for m in lib.benchmark()['per_layer']:\n"
        "    lib.load_module('metrics', m['name'])\n"
        "small.run('hs-cz.silver', seed=3)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print('FORBIDDEN', lib.forbidden_modules())\n") % lib.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=lib.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
    tops = eval(out.stdout.splitlines()[-2])
    assert "goldrush_tpu_torch" in tops
    assert not set(tops) & {"jax", "jaxlib", "flax", "goldrush_tpu"}


def test_no_result_without_a_card_or_the_program(tmp_path):
    """run.py prints no result where there is no card, or where the
    checkout holds only BENCHMARK.json and the harness."""
    shutil.copytree(os.path.join(lib.ROOT, "portbench"),
                    os.path.join(tmp_path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(lib.ROOT, "BENCHMARK.json"), tmp_path)
    for cwd in (lib.ROOT, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", "hs-cz.silver",
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=300, cwd=cwd)
        assert out.returncode != 0
        assert out.stdout.strip() == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_one_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hs-cz.silver",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=lib.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
