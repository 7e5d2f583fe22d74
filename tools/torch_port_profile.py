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

    python3 tools/torch_port_profile.py [direct|compressed] [throughput]
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


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    from goldrush_tpu_torch.utils import synth

    args = sys.argv[1:]
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
