"""Run one cell of the benchmark of goldrush_tpu_torch once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration and its traffic
are found by name (BENCHMARK.json, portbench/configs/, portbench/
workloads/); the traffic names the driver (portbench/drivers/<kind>.py)
that sets up, measures for ``--seconds`` and checks the outputs against
the plain reference.  With --trace 0 the result carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, each read by
portbench/metrics/<name>.py from the traced run.  The last line of
standard output is the result, one JSON object; the numbers compared
with the reference end standard error and the result.  ``--control 1``
runs the cell's control, which must come out not correct; the benchmark's
own runs never pass it.

Exit codes: 0 with a result; 2 without a card (or too few); 3 if the JAX
package or JAX is in the process after the window; 1 on any other fault.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import lib  # noqa: E402


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = lib.resolve(args.workload)
    chips = spec["cell"]["chips"]
    lib.pin_cores()
    import torch
    # one thread in torch's CPU pool: the program's host path is the read
    # stream's thread and the main thread, and the pool's OpenMP workers,
    # spinning after each small CPU copy, slowed it by ~12% and widened the
    # spread of runs on an 8-core host (PERF.md, section 2)
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"portbench: {args.workload} needs {chips} CUDA card(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 2
    say("portbench facts " + json.dumps(lib.device_facts(torch)))
    driver = lib.load_module("drivers", spec["traffic"]["driver"])
    out = driver.run(spec["cell"], spec["config"], spec["traffic"],
                     args.seed, args.seconds, bool(args.trace),
                     bool(args.control), "cuda:0", T0)
    bad = lib.forbidden_modules()
    if bad:
        say(f"portbench: forbidden modules in the process: {bad}")
        return 3
    result = assemble(spec, out, bool(args.trace), torch)
    checks = result["checks"]
    for name, c in checks.items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


def assemble(spec: dict, out: dict, trace: bool, torch=None) -> dict:
    """The result line from a driver's outcome: the end-to-end metrics, or
    the per-layer metrics each reader finds (a reader that finds nothing
    leaves its metric out), the device, the breakdown and the checks."""
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            v = lib.load_module("metrics", m["name"]).read(out)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        for m in spec["end_to_end"]:
            if m["name"] in out["e2e"]:           # a control measures none
                metrics[m["name"]] = dict(value=out["e2e"][m["name"]],
                                          unit=m["unit"])
    device = dict(platform="gpu", kind="cpu", count=spec["cell"]["chips"],
                  memory_peak_bytes=int(out["memory_peak_bytes"]))
    if torch is not None and torch.cuda.is_available():
        device["kind"] = torch.cuda.get_device_name(0)
    result = dict(correct=all(v <= lim for v, lim in out["checks"].values()),
                  attempted=out["attempted"], failed=out["failed"],
                  metrics=metrics, device=device)
    prof = out.get("profile")
    if trace and prof is not None:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        result["breakdown"] = dict(device_ops=prof["device_ops"],
                                   idle_gaps=prof["idle_gaps"])
    result["checks"] = {k: dict(value=v, limit=lim)
                        for k, (v, lim) in out["checks"].items()}
    return result


if __name__ == "__main__":
    sys.exit(main())
