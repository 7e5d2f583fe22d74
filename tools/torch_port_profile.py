"""Where the time goes in the PyTorch port's silver pass, on one GPU.

Runs goldrush-path's silver stage (GoldenPathEngine, exact mode) over
bench.py's dataset (3,000 x 20 kb reads of a 5 Mbp genome at 5% error,
seeds 11/12, M=5) with the chosen filter: twice unprofiled for the wall
times, then once under torch.profiler.  Prints the card and its power
limit, the EngineStats times and launch counts of each run, and, for the
profiled run, device time per kernel, the largest host-side costs, and the
device busy share (summed kernel time over the profiled assign time).

    python3 tools/torch_port_profile.py [direct|compressed]
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


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    from goldrush_tpu_torch.utils import synth

    mode = sys.argv[1] if len(sys.argv) > 1 else "direct"
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
            mibf_mode=mode, prefix_file=os.path.join(WORK, tag)),
            device="cuda")

    def report(tag, st):
        print(f"{tag} filter={mode} fill_s={st.wall_fill_s:.4f} "
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
            report(f"run{rep}", engine(f"run{rep}").run())
        for k in kernels.ALL:
            k.launches = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st = engine("profiled").run()
            torch.cuda.synchronize()
        report("profiled", st)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    events = prof.key_averages()
    dev = [e for e in events if e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in dev)
    print(f"device_time_s={total_us / 1e6:.4f} "
          f"busy_share_of_assign={total_us / 1e6 / st.wall_assign_s:.4f}")
    print("--- device time by kernel / op")
    for e in sorted(dev, key=lambda e: e.self_device_time_total,
                    reverse=True)[:15]:
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
