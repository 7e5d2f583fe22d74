"""Command-line interface mirroring the reference's make-style front end.

Usage (same command/parameter names as bin/goldrush and goldrush_tpu.cli):

    python -m goldrush_tpu_torch.cli run reads=myreads G=1e6 device=cuda
    python -m goldrush_tpu_torch.cli goldrush-path reads=r G=1e6 device=cuda
    python -m goldrush_tpu_torch.cli path-tigmint-ntLink-target reads=r G=1e6
    python -m goldrush_tpu_torch.cli version | help

Commands map to pipeline depth exactly like the make targets
(bin/goldrush:220-224); parameters are make-style key=value pairs with the
reference defaults (bin/goldrush:60-97).  ``device=cuda|cpu`` picks where
every stage runs (default cuda; a missing card is an error, never a silent
CPU run), and ``mibf_mode=direct|compressed`` the filter layout of both
goldrush-path stages (default direct).
"""

from __future__ import annotations

import dataclasses
import os
import sys

from .config import PipelineConfig

VERSION = "0.1.0 (goldrush-tpu-torch; capabilities of GoldRush v1.2.2)"

COMMANDS = {
    "run": "final",
    "run-in-dir": "final",
    "goldrush-path": "golden",
    "path-polish": "polished",
    "path-tigmint": "tigmint",
    "path-tigmint-ntLink": "ntlink",
    "path-tigmint-ntLink-target": "final",
}
# the line `main` prints for the stage a command stops at
_OUTPUT = {"golden": "Golden path", "polished": "Polished assembly",
           "tigmint": "Tigmint assembly", "ntlink": "ntLink scaffolds",
           "final": "Final assembly"}

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
          "k w tile b u a o x h s m M r P d span dist cut k_ntLink "
          "w_ntLink rounds z p frame_stride probe_seeds device=cuda|cpu "
          "mibf_mode=direct|compressed "
          "save_mibf=<npz> load_mibf=<npz> trace_dir=<dir>")


def run(cmd: str, cfg: PipelineConfig, extra: dict) -> dict:
    """Run a pipeline command parsed by ``parse_args``; returns the
    ``run_pipeline`` result (stage paths, per-stage EngineStats and
    seconds).  ``run`` links the reads into its working directory first,
    as bin/goldrush:210-211 does."""
    from .pipeline import run_pipeline
    workdir = "." if cmd == "run-in-dir" else cfg.prefix
    if cmd == "run":
        os.makedirs(workdir, exist_ok=True)
        for ext in (".fq", ".fastq", ".fq.gz", ".fastq.gz"):
            src = cfg.reads + ext
            if os.path.exists(src):
                dst = os.path.join(workdir, os.path.basename(src))
                if not os.path.exists(dst):
                    os.symlink(os.path.abspath(src), dst)
                cfg = cfg.replace(reads=os.path.basename(cfg.reads))
                break
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
    stage = COMMANDS[cmd]
    if stage == "final":
        workdir = "." if cmd == "run-in-dir" else cfg.prefix
        link = os.path.basename(out["final"])
        if cmd == "run" and not os.path.exists(link):
            os.symlink(os.path.join(workdir, out["final"]), link)
    print(f"{_OUTPUT[stage]}: {out[stage]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
