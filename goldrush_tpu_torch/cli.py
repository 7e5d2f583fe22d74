"""Command-line interface mirroring the reference's make-style front end.

Usage (same command/parameter names as bin/goldrush and goldrush_tpu.cli):

    python -m goldrush_tpu_torch.cli goldrush-path reads=r G=1e6 device=cuda
    python -m goldrush_tpu_torch.cli version | help

Parameters are make-style key=value pairs with the reference defaults
(bin/goldrush:60-97).  ``device=cuda|cpu`` picks where the engine runs
(default cuda; a missing card is an error, never a silent CPU run), and
``mibf_mode=direct|compressed`` the filter layout of both goldrush-path
stages (default direct).  The
commands that go past the golden path are recognised but raise
``NotImplementedError`` until their stages are ported.
"""

from __future__ import annotations

import dataclasses
import sys

from .config import PipelineConfig

VERSION = "0.1.0 (goldrush-tpu-torch; capabilities of GoldRush v1.2.2 " \
          "goldrush-path)"

COMMANDS = {
    "run": "final",
    "run-in-dir": "final",
    "goldrush-path": "golden",
    "path-polish": "polished",
    "path-tigmint": "tigmint",
    "path-tigmint-ntLink": "ntlink",
    "path-tigmint-ntLink-target": "final",
}

_FLOATS = {"o", "r"}
_STRS = {"reads", "p", "prefix", "s", "polisher", "polisher_mapper"}
_BOOLS = {"track_time", "dev", "soft_mask"}


def parse_args(argv: list[str]) -> tuple[str, PipelineConfig, dict]:
    if not argv or argv[0] in ("help", "--help", "-h"):
        return "help", PipelineConfig(), {}
    if argv[0] in ("version", "--version"):
        return "version", PipelineConfig(), {}
    cmd = argv[0]
    if cmd not in COMMANDS:
        raise SystemExit(f"Unknown command: {cmd} (see 'help')")
    cfg = PipelineConfig()
    extra = {"device": "cuda"}
    fields = {f.name for f in dataclasses.fields(PipelineConfig)}
    for arg in argv[1:]:
        if "=" not in arg:
            raise SystemExit(f"Parameters are key=value pairs, got: {arg}")
        k, v = arg.split("=", 1)
        if k in ("frame_stride", "probe_seeds"):
            extra[k] = int(v)
            continue
        if k in ("save_mibf", "load_mibf", "trace_dir", "device",
                 "mibf_mode"):
            extra[k] = v
            continue
        if k not in fields:
            raise SystemExit(f"Unknown parameter: {k}")
        if k in _STRS:
            val = v
        elif k in _BOOLS:
            val = v in ("1", "True", "true")
        elif k in _FLOATS:
            val = float(v)
        else:
            val = int(float(v))
        setattr(cfg, k, val)
    return cmd, cfg, extra


def print_help() -> None:
    print(__doc__)
    print("Commands:", ", ".join(COMMANDS))
    print("Key parameters: reads=<prefix> G=<genome size> t=<threads> "
          "k w tile b u a o x h s m M r P d p device=cuda|cpu "
          "mibf_mode=direct|compressed "
          "save_mibf=<npz> load_mibf=<npz> trace_dir=<dir>")


def run(cmd: str, cfg: PipelineConfig, extra: dict) -> dict:
    """Run a pipeline command parsed by ``parse_args``; returns the
    ``run_pipeline`` result (stage paths and per-stage EngineStats)."""
    from .pipeline import run_pipeline
    workdir = "." if cmd == "run-in-dir" else cfg.prefix
    return run_pipeline(cfg, workdir=workdir, until=COMMANDS[cmd],
                        device=extra["device"],
                        frame_stride=extra.get("frame_stride", 1),
                        probe_seeds=extra.get("probe_seeds", 0),
                        mibf_mode=extra.get("mibf_mode", "direct"),
                        engine_extra={k: v for k, v in extra.items()
                                      if k in ("save_mibf", "load_mibf",
                                               "trace_dir")})


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmd, cfg, extra = parse_args(argv)
    if cmd == "help":
        print_help()
        return 0
    if cmd == "version":
        print(f"goldrush-tpu-torch version: {VERSION}")
        return 0
    out = run(cmd, cfg, extra)
    print(f"Golden path: {out['golden']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
