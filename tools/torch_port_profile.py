"""Where the time goes in the PyTorch port's silver pass, on one GPU.

Runs goldrush-path's silver stage (GoldenPathEngine, exact mode, or with
`throughput` bench.py's throughput settings: frame stride 8, one probed
seed, optimistic staleness, batches of 64 reads) over bench.py's dataset
(3,000 x 20 kb reads of a 5 Mbp genome at 5% error, seeds 11/12, M=5)
with the chosen filter: twice unprofiled for the wall
times, then once under torch.profiler.  Prints the card and its power
limit, the engine's construction time (init_s: the direct filter
allocates its words there), the EngineStats times and launch counts of
each run, and, for the profiled run, device time per kernel (the 15
largest, then every other kernel of csrc/, whose names are in namespace
gr), the largest host-side costs, and the device busy share (summed
kernel time over the profiled assign time).  Copied into an earlier
tree's tools/, it profiles that tree's port.

With `pipeline` it runs `goldrush run` (chip_smoke.py's phase 6(b): the
1 Mbp quality-gate dataset of tests/fixtures/torch_port_digests.json,
G=1e6, M=3, r=0.75) stage by stage, each stage resumed from the files of
the one before it: once unprofiled for each stage's wall seconds, then
again with each stage under its own torch.profiler, which gives per stage
the device time of each kernel of csrc/ and of the largest other device
ops, and the busy share (summed device time over the stage's profiled
wall time).

    python3 tools/torch_port_profile.py [direct|compressed] [throughput]
    python3 tools/torch_port_profile.py pipeline
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
WORK = os.path.join(REPO, "smoke_work", "profile")
# bench.py:173-180's throughput cell, over the exact defaults
THROUGHPUT = dict(frame_stride=8, probe_seeds=1, recheck="optimistic",
                  batch_reads=64)


def pipeline() -> None:
    """`goldrush run` stage by stage on the card (module docstring)."""
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import PipelineConfig
    from goldrush_tpu_torch.pipeline import ORDER, run_pipeline
    from goldrush_tpu_torch.utils import synth

    with open(os.path.join(REPO, "tests", "fixtures",
                           "torch_port_digests.json")) as f:
        ds = json.load(f)["dataset"]
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    fq = os.path.join(WORK, "qgate.fq")
    genome = synth.random_genome(ds["genome"], seed=ds["genome_seed"])
    synth.write_fastq(fq, synth.simulate_reads(
        genome, ds["n_reads"], ds["read_len"], seed=ds["reads_seed"],
        err_rate=ds["err_rate"], indel_frac=ds["indel_frac"]))
    cfg = PipelineConfig(reads=os.path.join(WORK, "qgate"), G=1_000_000,
                         M=3, r=0.75)

    def stage(workdir, name):
        t0 = time.time()
        out = run_pipeline(cfg, workdir=workdir, until=name, device="cuda")
        torch.cuda.synchronize()
        return time.time() - t0, out

    kernels.lib()                      # the build is not a stage's time
    try:
        for k in kernels.ALL:
            k.launches = 0
        for name in ORDER:
            wall, out = stage(os.path.join(WORK, "plain"), name)
            print(f"unprofiled stage={name} wall_s={wall:.4f}", flush=True)
        print("assembly_stats=" + json.dumps(out["assembly_stats"]))
        print("launches=" + ",".join(f"{k.name}:{k.launches}"
                                     for k in kernels.ALL))
        for name in ORDER:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall, _ = stage(os.path.join(WORK, "profiled"), name)
            dev = [e for e in prof.key_averages()
                   if e.self_device_time_total > 0]
            total = sum(e.self_device_time_total for e in dev) / 1e6
            print(f"profiled stage={name} wall_s={wall:.4f} "
                  f"device_s={total:.4f} busy_share={total / wall:.4f}",
                  flush=True)
            ranked = sorted(dev, key=lambda e: e.self_device_time_total,
                            reverse=True)
            for e in ranked[:6] + [e for e in ranked[6:] if "gr::" in e.key]:
                print(f"  {e.key[:56]:56s} calls={e.count:7d} device_s="
                      f"{e.self_device_time_total / 1e6:9.4f}")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    from goldrush_tpu_torch.utils import synth

    args = sys.argv[1:]
    if args == ["pipeline"]:
        if not torch.cuda.is_available():
            raise SystemExit("torch_port_profile: needs a CUDA card")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip())
        pipeline()
        return
    if any(a not in ("direct", "compressed", "throughput") for a in args):
        raise SystemExit(__doc__)
    mode = "compressed" if "compressed" in args else "direct"
    cell = THROUGHPUT if "throughput" in args else {}
    if not torch.cuda.is_available():
        raise SystemExit("torch_port_profile: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    fq = os.path.join(WORK, "bench.fq")
    genome = synth.random_genome(5_000_000, seed=11)
    synth.write_fastq(fq, synth.simulate_reads(genome, 3000, 20_000,
                                               seed=12, err_rate=0.05))

    def engine(tag):
        return GoldenPathEngine(PathConfig(
            input=fq, genome_size=5_000_000, kmer_size=22, weight=16,
            hash_num=3, seed_preset="1011011110110111101101",
            silver_path=True, max_paths=5, min_length=20_000,
            mibf_mode=mode, prefix_file=os.path.join(WORK, tag), **cell),
            device="cuda")

    def timed_run(tag):
        t0 = time.time()
        eng = engine(tag)
        init_s = time.time() - t0
        return eng.run(), init_s

    def report(tag, st, init_s):
        print(f"{tag} filter={mode} cell={'throughput' if cell else 'exact'} "
              f"init_s={init_s:.4f} "
              f"fill_s={st.wall_fill_s:.4f} "
              f"fill_stream_s={st.wall_fill_stream_s:.4f} "
              f"assign_s={st.wall_assign_s:.4f} "
              f"submit_s={st.wall_submit_s:.4f} "
              f"replay_s={st.wall_replay_s:.4f} recruits={st.recruits} "
              f"paths={st.paths_completed} launches="
              + ",".join(f"{k.name}:{k.launches}" for k in kernels.ALL),
              flush=True)

    try:
        for rep in range(2):
            for k in kernels.ALL:
                k.launches = 0
            report(f"run{rep}", *timed_run(f"run{rep}"))
        for k in kernels.ALL:
            k.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st, init_s = timed_run("profiled")
            torch.cuda.synchronize()
        report("profiled", st, init_s)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    events = prof.key_averages()
    dev = [e for e in events if e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in dev)
    print(f"device_time_s={total_us / 1e6:.4f} "
          f"busy_share_of_assign={total_us / 1e6 / st.wall_assign_s:.4f}")
    print("--- device time by kernel / op")
    ranked = sorted(dev, key=lambda e: e.self_device_time_total,
                    reverse=True)
    for e in ranked[:15] + [e for e in ranked[15:] if "gr::" in e.key]:
        print(f"{e.key[:60]:60s} calls={e.count:7d} "
              f"device_s={e.self_device_time_total / 1e6:9.4f} "
              f"share={e.self_device_time_total / total_us:.4f}")
    print("--- host self time")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:12]:
        print(f"{e.key[:60]:60s} calls={e.count:7d} "
              f"host_s={e.self_cpu_time_total / 1e6:9.4f}")


if __name__ == "__main__":
    main()
