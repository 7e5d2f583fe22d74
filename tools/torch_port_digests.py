"""Write tests/fixtures/torch_port_digests.json: the JAX package's silver
paths on the 1 Mbp quality-gate dataset, as sha256 digests, with the
direct filter (top level) and the rank-compressed one ("compressed"), in
exact mode; and under "throughput", both filters in the throughput mode
that bench.py ships (stride 8, one probed seed, optimistic staleness, the
full-resolution trim recheck; "engine" holds those settings).

Under "pipeline": the JAX package's `run` (run_pipeline until "final") on
tests/test_pipeline.py's dataset and configuration (a 60 kb genome, seed
71; 300 x 4 kb reads at 1% error, seed 72, phred 20; make_cfg's
parameters), as the sha256 of every stage file after the golden path:
polished, tigmint, ntlink, its .gaps.json and final.  Both
tests/test_torch_pipeline.py (on the CPU) and chip_smoke.py (on the card)
hold the port's stage files to these digests.

The dataset and engine settings are those of the exact run in
tests/test_quality_gate.py (600 x 20 kb reads at 5% error, 40% indels,
seeds 51/52; exact defaults, max_paths=3, ratio=0.75, min_length=15000,
batch_reads=64).  ``chip_smoke.py`` runs the PyTorch port on the card over
the same dataset and requires the same digests, and
tests/test_torch_host.py checks that the port's synth regenerates the
dataset byte for byte, so the two cannot drift apart.

    JAX_PLATFORMS=cpu python tools/torch_port_digests.py            # all
    JAX_PLATFORMS=cpu python tools/torch_port_digests.py pipeline   # ~1 min
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "fixtures", "torch_port_digests.json")

DATASET = dict(genome=1_000_000, genome_seed=51, n_reads=600,
               read_len=20_000, reads_seed=52, err_rate=0.05, indel_frac=0.4)
ENGINE = dict(genome_size=1_000_000, kmer_size=22, weight=16, hash_num=3,
              seed_preset="1011011110110111101101", silver_path=True,
              max_paths=3, ratio=0.75, min_length=15_000, batch_reads=64)
# bench.py:173-180's throughput settings, over ENGINE
THROUGHPUT = dict(frame_stride=8, probe_seeds=1, recheck="optimistic")
# tests/test_pipeline.py's dataset and make_cfg (dev=True)
PIPE_DATASET = dict(genome=60_000, genome_seed=71, n_reads=300,
                    read_len=4000, reads_seed=72, err_rate=0.01, phred=20)
PIPE_CFG = dict(G=60_000, t=2, k=22, w=16, tile=250, b=4, m=2000, M=3, r=0.5,
                P=15, x=10, u=5, a=1, span=2, dist=500, cut=250,
                k_ntLink=24, w_ntLink=100, rounds=3, z=500, dev=True)
PIPE_STAGES = ("polished", "tigmint", "ntlink", "final")


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_pipe_dataset(path: str, synth) -> None:
    """tests/test_pipeline.py's reads, written by ``synth`` (either
    package's; they are byte-identical)."""
    ds = PIPE_DATASET
    genome = synth.random_genome(ds["genome"], seed=ds["genome_seed"])
    synth.write_fastq(path, synth.simulate_reads(
        genome, ds["n_reads"], ds["read_len"], seed=ds["reads_seed"],
        err_rate=ds["err_rate"], phred=ds["phred"]))


def stage_digests(workdir: str, files: dict) -> dict:
    """sha256 of each stage file after the golden path, and of ntLink's
    .gaps.json, in `workdir`."""
    out = {s: sha256_file(os.path.join(workdir, files[s]))
           for s in PIPE_STAGES}
    out["gaps"] = sha256_file(os.path.join(workdir,
                                           files["ntlink"] + ".gaps.json"))
    return out


def pipeline_entry() -> dict:
    """The "pipeline" key: the JAX package's run on the 60 kb dataset."""
    from goldrush_tpu.config import PipelineConfig, stage_filenames
    from goldrush_tpu.pipeline import run_pipeline
    from goldrush_tpu.utils import synth
    with tempfile.TemporaryDirectory(prefix="torch_port_pipeline_") as d:
        fq = os.path.join(d, "reads.fq")
        write_pipe_dataset(fq, synth)
        cfg = PipelineConfig(reads="reads", **PIPE_CFG)
        out = run_pipeline(cfg, workdir=d, until="final")
        return {"dataset": {**PIPE_DATASET, "sha256": sha256_file(fq)},
                "config": PIPE_CFG, "assembly_stats": out["stats"],
                "files": stage_digests(d, stage_filenames(cfg))}


def main() -> None:
    if sys.argv[1:] == ["pipeline"]:
        with open(OUT) as f:
            out = json.load(f)
        out["pipeline"] = pipeline_entry()
        write(out)
        return
    if sys.argv[1:]:
        raise SystemExit(__doc__)
    from goldrush_tpu.config import PathConfig
    from goldrush_tpu.path.engine import GoldenPathEngine
    from goldrush_tpu.utils import synth
    genome = synth.random_genome(DATASET["genome"],
                                 seed=DATASET["genome_seed"])
    reads = synth.simulate_reads(
        genome, DATASET["n_reads"], DATASET["read_len"],
        seed=DATASET["reads_seed"], err_rate=DATASET["err_rate"],
        indel_frac=DATASET["indel_frac"])
    with tempfile.TemporaryDirectory(prefix="torch_port_digests_") as d:
        fq = os.path.join(d, "reads.fq")
        synth.write_fastq(fq, reads)
        runs = {}
        for mode, tag, extra in (("direct", "direct", {}),
                                 ("compressed", "compressed", {}),
                                 ("direct", "tp_direct", THROUGHPUT),
                                 ("compressed", "tp_compressed", THROUGHPUT)):
            prefix = os.path.join(d, tag)
            stats = GoldenPathEngine(PathConfig(
                input=fq, prefix_file=prefix, mibf_mode=mode,
                **ENGINE, **extra)).run()
            silver = {}
            for i in range(1, ENGINE["max_paths"] + 1):
                p = f"{prefix}_{i}.fq"
                if os.path.exists(p):
                    silver[str(i)] = sha256_file(p)
            runs[tag] = {"recruits": stats.recruits,
                          "paths_completed": stats.paths_completed,
                          "silver": silver}
        out = {"dataset": {**DATASET, "sha256": sha256_file(fq)},
               "engine": ENGINE, **runs["direct"],
               "compressed": runs["compressed"],
               "throughput": {"engine": THROUGHPUT,
                              "direct": runs["tp_direct"],
                              "compressed": runs["tp_compressed"]},
               "pipeline": pipeline_entry()}
    write(out)


def write(out: dict) -> None:
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
