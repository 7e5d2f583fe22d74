"""Pipeline orchestrator: the GoldRush flow with make-style resume
(bin/goldrush:209-308; goldrush_tpu/pipeline.py).

Every stage writes a file whose name encodes its parameters
(``stage_filenames``); a stage is skipped when its output exists, and a
partial output is removed on failure.  Stage chain (bin/goldrush:220-224):

  silver paths -> concat -> golden path -> polish -> tigmint -> ntLink x
  rounds -> targeted polish

The goldrush-path stages run the engine on ``device``; the later stages
run their minimizers (K20) and k-mer tables (K21) there and the rest on the
host.
"""

from __future__ import annotations

import json
import os
import time

from .config import PipelineConfig, stage_filenames
from .io import fastq
from .path.engine import GoldenPathEngine
from .stages import ntlink, polish, targeted, tigmint
from .utils.stats import assembly_stats

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


def _read_fasta(path: str) -> list[tuple[str, bytes]]:
    return [(r.id, r.seq) for r in fastq.read_records(path)]


def _load_reads(path: str) -> list[bytes]:
    return [r.seq for r in fastq.read_records(path)]


def run_pipeline(cfg: PipelineConfig, workdir: str = ".",
                 until: str = "final", device="cuda",
                 frame_stride: int = 1, probe_seeds: int = 0,
                 mibf_mode: str = "direct",
                 engine_extra: dict | None = None) -> dict:
    """Run the pipeline up to stage ``until`` (one of ``ORDER``) on
    ``device``, both goldrush-path stages with the ``mibf_mode`` filter.
    Returns stage -> path, plus "stats": the EngineStats of each
    goldrush-path stage that ran, "seconds": the wall time of each stage
    that ran, and for ``until="final"`` "assembly_stats".
    ``engine_extra`` (save_mibf/load_mibf/trace_dir) applies to the silver
    stage, as in ``goldrush_tpu.pipeline``."""
    if until not in ORDER:
        raise ValueError(f"unknown stage {until!r}")
    t_start = time.time()
    cwd = os.getcwd()
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    try:
        return _run(cfg, until, device, frame_stride, probe_seeds,
                    mibf_mode, engine_extra or {}, t_start)
    finally:
        os.chdir(cwd)


def _run(cfg: PipelineConfig, until: str, device, frame_stride: int,
         probe_seeds: int, mibf_mode: str, engine_extra: dict,
         t_start: float) -> dict:
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
    stats, seconds = {}, {}

    def result(key: str, **more) -> dict:
        return {key: files[key], "stats": stats, "seconds": seconds, **more}

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
        seconds[name] = dt
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
        return result("silver_all")

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
    if stop <= ORDER.index("golden"):
        return result("golden")

    # --- stage 3: polish (GoldPolish equivalent, or racon-equivalent when
    # polisher=racon, bin/goldrush:262-277) -------------------------------
    if not os.path.exists(files["polished"]):
        def do_polish():
            contigs = _read_fasta(files["golden"])
            # bounded memory: from this input size on (or when forced via
            # GOLDRUSH_POLISH_STREAM_BYTES) the k-mer polisher streams the
            # reads from disk and spills per-goldtig read sets instead of
            # holding every read; the output is the same.  The size is the
            # file's own, compressed for .gz, as in the JAX package
            stream_bytes = int(os.environ.get(
                "GOLDRUSH_POLISH_STREAM_BYTES", str(2 << 30)))
            streaming = (cfg.polisher != "racon"
                         and os.path.getsize(reads_file) >= stream_bytes)
            reads = None if streaming else _load_reads(reads_file)
            if cfg.polisher == "racon":
                from .stages import racon
                out, edits = racon.polish_with_racon(contigs, reads,
                                                     device=device)
            else:
                # the read -> goldtig mapping of goldpolish --minimap2, or
                # --ntlink --k-ntlink $(polish_k) --w-ntlink $(polish_w)
                # (bin/goldrush:35-41)
                if cfg.polisher_mapper == "ntlink":
                    mk, mw = min(32, cfg.polish_k), cfg.polish_w
                else:
                    mk, mw = 15, 10
                # large k, smaller ks, a final large-k refine, a candidate
                # at every absent sub-run end (goldrush_tpu/pipeline.py:
                # 190-205)
                pk = min(32, cfg.polish_k)
                sched = (((pk, 12), (20, 16), (16, 10), (pk, 8))
                         if pk > 20 else ((pk, 14), (16, 10), (pk, 6)))
                pp = polish.PolishParams(k=pk, schedule=sched,
                                         site_spacing=2)
                if streaming:
                    out, edits = polish.run_polish_streaming(
                        contigs, reads_file, pp, mapper_k=mk, mapper_w=mw,
                        device=device)
                else:
                    out, edits = polish.run_polish(contigs, reads, pp,
                                                   mapper_k=mk, mapper_w=mw,
                                                   device=device)
            with _AtomicStage(files["polished"]) as tmp:
                fastq.write_fasta(tmp, out)
            _log(f"[goldrush-tpu-torch] polish edits: {edits}")
        stage_time("polish", do_polish, files["polished"])
    if stop <= ORDER.index("polished"):
        return result("polished")

    # --- stage 4: tigmint-long equivalent ---------------------------------
    if not os.path.exists(files["tigmint"]):
        def do_tigmint():
            contigs = _read_fasta(files["polished"])
            reads = [(r.id, r.seq, r.qual)
                     for r in fastq.read_records(reads_file)]
            tp = tigmint.TigmintParams(span=cfg.span, dist=cfg.dist,
                                       cut=cfg.cut)
            out = tigmint.run_tigmint(contigs, reads, tp, device=device)
            with _AtomicStage(files["tigmint"]) as tmp:
                fastq.write_fasta(tmp, out)
        stage_time("tigmint", do_tigmint, files["tigmint"])
    if stop <= ORDER.index("tigmint"):
        return result("tigmint")

    # --- stage 5: ntLink rounds + gap fill --------------------------------
    gaps_file = files["ntlink"] + ".gaps.json"
    if not os.path.exists(files["ntlink"]):
        def do_ntlink():
            contigs = _read_fasta(files["tigmint"])
            reads = _load_reads(reads_file)
            np_ = ntlink.NtLinkParams(k=cfg.k_ntLink, w=cfg.w_ntLink,
                                      z=cfg.z, a=1, rounds=cfg.rounds,
                                      soft_mask=cfg.soft_mask)
            scaffolds = ntlink.run_ntlink(contigs, reads, np_, device=device)
            with _AtomicStage(files["ntlink"]) as tmp:
                fastq.write_fasta(tmp, [(s.name, s.seq) for s in scaffolds])
            with open(gaps_file, "w") as f:
                json.dump({s.name: s.filled for s in scaffolds}, f)
        stage_time("ntLink", do_ntlink, files["ntlink"])
    if stop <= ORDER.index("ntlink"):
        return result("ntlink")

    # --- stage 6: targeted polish (GoldPolish-Target equivalent) ----------
    if not os.path.exists(files["final"]):
        def do_target():
            entries = _read_fasta(files["ntlink"])
            gaps = {}
            if os.path.exists(gaps_file):
                with open(gaps_file) as f:
                    gaps = json.load(f)
            scaffolds = [ntlink.Scaffold(name=n, seq=s,
                                         filled=[tuple(x) for x in
                                                 gaps.get(n, [])])
                         for n, s in entries]
            reads = _load_reads(reads_file)
            tp = targeted.TargetParams(flank=cfg.target_flank_length)
            out, edits = targeted.polish_targets(
                scaffolds, reads, tp, mapper_k=cfg.target_k_ntlink,
                mapper_w=cfg.target_w_ntlink, device=device)
            with _AtomicStage(files["final"]) as tmp:
                fastq.write_fasta(tmp, out)
            _log(f"[goldrush-tpu-torch] targeted polish edits: {edits}")
        stage_time("targeted polish", do_target, files["final"])

    st = assembly_stats([len(s) for _, s in _read_fasta(files["final"])])
    _log(f"[goldrush-tpu-torch] final assembly: {st} "
         f"({time.time() - t_start:.1f}s total)")
    return result("final", assembly_stats=st)
