#!/usr/bin/env python3
"""Time wave_adjacency on a full window of 8,192 one-tile reads and on the
same window padded with empty rows to 8,193 and 8,199 reads (a mesh of 3
or 7 data rows pads a window to a multiple of its rows), each filter, in
turns (8,192, 8,193, 8,199, 8,199, 8,193, 8,192), on one card:

    python3 tools/torch_port_adjacency_padded.py

The reads are the fixture's "wave_8192" dataset (written under
smoke_work/work), the engine its throughput cell; times are chip_smoke.py's
cuda_ms (CUDA events, mean of 5 launches).  Prints one line per filter."""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path import wavefront as wave
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    cs.WORK = os.path.join(REPO, "smoke_work", "work")
    os.makedirs(cs.WORK, exist_ok=True)
    cs.phase_device()
    cs.phase_build()
    with open(os.path.join(REPO, "tests", "fixtures",
                           "torch_port_digests.json")) as f:
        fx = json.load(f)
    fq = cs.wave_8192_fastq(fx)
    for mode in ("direct", "compressed"):
        te = GoldenPathEngine(PathConfig(
            input=fq, mibf_mode=mode,
            **{**fx["engine"], **fx["wave_8192"]["engine"]}), device="cuda")
        te.calc_phred_threshold(fq)
        te.fill(fq)
        filt = te.cstate if te.compressed else te.state
        _, _, ranked, limit, _ = wave._filter_view(filt, te.size)
        te.batch_reads = 8_192
        packed = te._pack_batch(list(te._eligible(fq))[:8_192])
        T = packed[3]
        inputs = {}
        for B in (8_192, 8_193, 8_199):
            arrays = [np.pad(a, ((0, B - 8_192),) + ((0, 0),) * (a.ndim - 1))
                      for a in packed[:3]]
            codes_d, _, _, gi, *_ = te._window_inputs(*arrays, T)
            inputs[B] = (codes_d, gi)
        times = {B: [] for B in inputs}
        for B in (8_192, 8_193, 8_199, 8_199, 8_193, 8_192):
            codes_d, gi = inputs[B]
            times[B].append(cs.cuda_ms(lambda: wave.wave_adjacency(
                te.wave_spec, gi, codes_d, limit, ranked, T), 5, hold=4))
        print(json.dumps({"filter": mode, "ms": {
            str(B): [round(t, 4) for t in v] for B, v in times.items()}}),
            flush=True)
        del te, filt, inputs
        cs.gc_cuda()


if __name__ == "__main__":
    main()
