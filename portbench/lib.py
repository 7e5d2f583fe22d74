"""What the harness shares: finding a cell's files by name, the device's
description, the profiler's reduction to busy time, kernel time and idle
gaps, and the guard against the JAX package in the process."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that must never be in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "goldrush_tpu")
# the window marker of a traced run, and the prefixes of the harness's own
# spans (record_function: never device work)
WINDOW = "portbench.window"
SPANS = ("portbench.", "engine.", "job.")


def span(on: bool, name: str):
    """A profiler span around the calls into one layer (record_function),
    or nothing outside a traced window."""
    if not on:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


def pin_cores() -> list:
    """Hold the process to four cores, the third to the sixth it may use
    (where it may use six or more), before any thread starts: threads
    inherit it.  On an 8-core H100 host the jobs' rate spread several
    times wider across runs on all cores than on these four, and was
    slower (PERF.md, section 2).  Returns the cores it runs on."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) >= 6:
        os.sched_setaffinity(0, cpus[2:6])
    return sorted(os.sched_getaffinity(0))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def resolve(name: str, root: str = ROOT) -> dict:
    """A cell of BENCHMARK.json with its configuration and traffic files
    read: {"cell", "config", "traffic", "end_to_end", "per_layer"}, the
    metrics those the cell reports."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(root, "portbench", "workloads",
                                     cell["traffic"] + ".json"))
    if traffic["config"] != cell["config"]:
        raise ValueError(f"traffic {cell['traffic']!r} is for "
                         f"{traffic['config']!r}, the cell for "
                         f"{cell['config']!r}")
    return dict(cell=cell, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _in(m, name)],
                per_layer=[m for m in bench["per_layer"] if _in(m, name)])


def _in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_module(kind: str, name: str, root: str = ROOT):
    """portbench/<kind>/<name>.py as a module (a driver or a metric's
    reader)."""
    path = os.path.join(root, "portbench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Top-level names of FORBIDDEN in sys.modules, compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def device_facts(torch) -> dict:
    """The card's name and power limit, the host's CPU, load and the cores
    the run holds, the versions: printed before the result."""
    facts = dict(torch=torch.__version__, cuda=torch.version.cuda,
                 python=sys.version.split()[0],
                 load_average=list(os.getloadavg()),
                 cores=sorted(os.sched_getaffinity(0)))
    try:
        with open("/proc/cpuinfo") as f:
            facts["cpu"] = next((ln.split(":", 1)[1].strip() for ln in f
                                 if ln.startswith("model name")), "")
    except OSError:
        facts["cpu"] = ""
    if torch.cuda.is_available():
        facts["card"] = torch.cuda.get_device_name(0)
        try:
            import subprocess
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20)
            facts["nvidia_smi"] = out.stdout.strip()
        except (OSError, subprocess.SubprocessError):
            facts["nvidia_smi"] = ""
    return facts


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------

def _union(intervals: list) -> tuple[float, list]:
    """Length of the union of (start, end) intervals, and the gaps between
    them, in the units given."""
    total, gaps = 0.0, []
    end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total, gaps


def profile_summary(prof) -> dict:
    """The traced window (``WINDOW``'s span) reduced: busy_s (the union of
    the device's kernels, copies and sets inside it), window_s, device time
    a kernel name (kernel_s), the ten device operations that took most time
    and the ten longest idle gaps, each named by the innermost host
    operation under its middle."""
    from torch.autograd import DeviceType
    evs = prof.events()
    win = [e for e in evs if e.name == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window marker")
    w0 = min(e.time_range.start for e in win)
    w1 = max(e.time_range.end for e in win)
    dev, host = [], []
    for e in evs:
        a, b = e.time_range.start, e.time_range.end
        if b <= w0 or a >= w1:
            continue
        annotation = getattr(e, "is_user_annotation", False) or \
            e.name.startswith(SPANS)
        if e.device_type == DeviceType.CUDA and not annotation:
            dev.append((max(a, w0), min(b, w1), e.name))
        elif e.device_type != DeviceType.CUDA and e.name != WINDOW:
            host.append((a, b, e.name))
    busy, gaps = _union([(a, b) for a, b, _ in dev])
    if dev:
        first, last = min(a for a, _, _ in dev), max(b for _, b, _ in dev)
        gaps = [(w0, first)] + gaps + [(last, w1)]
    kernel_s: dict = {}
    for a, b, n in dev:
        kernel_s[n] = kernel_s.get(n, 0.0) + (b - a) * 1e-6
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        over = [(hb - ha, n) for ha, hb, n in host if ha <= mid <= hb]
        label = min(over)[1] if over else "host (no operation recorded)"
        named.append([label, (b - a) * 1e-6])
    return dict(busy_s=busy * 1e-6, window_s=(w1 - w0) * 1e-6,
                kernel_s=kernel_s, device_ops=[[n, s] for n, s in top],
                idle_gaps=named)


def kernel_time(summary: dict, *fragments: str) -> float:
    """Device seconds of the kernels whose name holds any of
    ``fragments``."""
    return sum(s for n, s in summary["kernel_s"].items()
               if any(f in n for f in fragments))
