"""Pipeline orchestrator: the silver and golden goldrush-path stages with
make-style resume (bin/goldrush:209-308).

Every stage writes a file whose name encodes its parameters
(``stage_filenames``); a stage is skipped when its output exists, and a
partial output is removed on failure.  The stages after ``golden`` (polish,
tigmint, ntLink, targeted polish) are ROADMAP queue 1 item 8 and raise
``NotImplementedError``.
"""

from __future__ import annotations

import os
import time

from .config import PipelineConfig, stage_filenames
from .path.engine import GoldenPathEngine

ORDER = ("silver", "golden", "polished", "tigmint", "ntlink", "final")


def _log(msg: str) -> None:
    print(msg, flush=True)


class _AtomicStage:
    """Write a stage output under a temporary name, rename on success and
    delete on failure (.DELETE_ON_ERROR equivalent)."""

    def __init__(self, final: str):
        self.final = final
        self.tmp = final + ".partial"

    def __enter__(self) -> str:
        return self.tmp

    def __exit__(self, et, ev, tb):
        if et is None:
            os.replace(self.tmp, self.final)
        elif os.path.exists(self.tmp):
            os.remove(self.tmp)
        return False


def run_pipeline(cfg: PipelineConfig, workdir: str = ".",
                 until: str = "golden", device="cuda",
                 frame_stride: int = 1, probe_seeds: int = 0,
                 mibf_mode: str = "direct",
                 engine_extra: dict | None = None) -> dict:
    """Run the pipeline up to stage ``until`` (silver or golden) on
    ``device``, both goldrush-path stages with the ``mibf_mode`` filter.
    Returns stage -> path, plus "stats": the EngineStats of each
    goldrush-path stage that ran.  ``engine_extra``
    (save_mibf/load_mibf/trace_dir) applies to the silver stage, as in
    ``goldrush_tpu.pipeline``."""
    if until not in ORDER:
        raise ValueError(f"unknown stage {until!r}")
    if ORDER.index(until) > ORDER.index("golden"):
        raise NotImplementedError(
            f"stage {until!r} is not ported yet (ROADMAP.md queue 1 item 8)")
    cwd = os.getcwd()
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    try:
        return _run(cfg, until, device, frame_stride, probe_seeds,
                    mibf_mode, engine_extra or {})
    finally:
        os.chdir(cwd)


def _run(cfg: PipelineConfig, until: str, device, frame_stride: int,
         probe_seeds: int, mibf_mode: str, engine_extra: dict) -> dict:
    files = stage_filenames(cfg)
    reads_file = None
    for ext in (".fq", ".fastq", ".fq.gz", ".fastq.gz"):
        if os.path.exists(cfg.reads + ext):
            reads_file = cfg.reads + ext
            break
    if reads_file is None:
        raise FileNotFoundError(
            f"Reads file not found. Expected {cfg.reads}.fq or "
            f"{cfg.reads}.fastq")
    if not cfg.G:
        raise ValueError("G is a required parameter")
    stop = ORDER.index(until)
    stats = {}

    def engine(silver: bool, reads: str):
        pc = cfg.path_config(silver=silver)
        pc.input = reads
        pc.frame_stride = frame_stride
        pc.probe_seeds = probe_seeds
        pc.mibf_mode = mibf_mode
        for k, v in (engine_extra.items() if silver else ()):
            setattr(pc, k, v)
        stats["silver" if silver else "golden"] = \
            GoldenPathEngine(pc, device=device).run()

    def stage_time(name, fn, out_path=None):
        t0 = time.time()
        fn()
        dt = time.time() - t0
        _log(f"[goldrush-tpu-torch] {name}: {dt:.1f}s")
        if cfg.track_time and out_path:
            # track_time=1 parity (bin/goldrush:116-129): wall seconds and
            # the process peak RSS so far, per stage
            import resource
            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            with open(out_path + ".time", "w") as f:
                f.write(f"stage\t{name}\nwall_s\t{dt:.2f}\n"
                        f"peak_rss_kb\t{peak}\n")

    # --- stage 1: silver paths (goldrush-path --silver_path) -------------
    # skipped when the golden path exists (dev=False removed the silver
    # intermediates; .SECONDARY semantics, bin/goldrush:133), unless the
    # silver output itself is requested
    last_silver = files["silver"][-1]
    want_silver = stop == ORDER.index("silver")
    if not os.path.exists(files["silver_all"]) and \
            (want_silver or not os.path.exists(files["golden"])):
        if not os.path.exists(last_silver):
            stage_time("goldrush-path (silver)",
                       lambda: engine(True, reads_file), last_silver)
        with _AtomicStage(files["silver_all"]) as tmp:
            with open(tmp, "wb") as out:
                for f in files["silver"]:
                    if os.path.exists(f):
                        with open(f, "rb") as src:
                            out.write(src.read())
    if stop <= ORDER.index("silver"):
        return {"silver_all": files["silver_all"], "stats": stats}

    # --- stage 2: golden path --------------------------------------------
    if not os.path.exists(files["golden"]):
        stage_time("goldrush-path (golden)",
                   lambda: engine(False, files["silver_all"]),
                   files["golden"])
        # the silver files are intermediates once the golden pass consumed
        # them, removed unless dev=True (bin/goldrush:202-206)
        if not cfg.dev:
            for f in files["silver"] + [files["silver_all"]]:
                if os.path.exists(f):
                    os.remove(f)
    return {"golden": files["golden"], "stats": stats}
