"""Write tests/fixtures/torch_port_digests.json: the JAX package's silver
paths on the 1 Mbp quality-gate dataset, as sha256 digests, with the
direct filter (top level) and the rank-compressed one ("compressed").

The dataset and engine settings are those of the exact run in
tests/test_quality_gate.py (600 x 20 kb reads at 5% error, 40% indels,
seeds 51/52; exact defaults, max_paths=3, ratio=0.75, min_length=15000,
batch_reads=64).  ``chip_smoke.py`` runs the PyTorch port on the card over
the same dataset and requires the same digests, and
tests/test_torch_host.py checks that the port's synth regenerates the
dataset byte for byte, so the two cannot drift apart.

    JAX_PLATFORMS=cpu python tools/torch_port_digests.py
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


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def main() -> None:
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
        for mode in ("direct", "compressed"):
            prefix = os.path.join(d, mode)
            stats = GoldenPathEngine(PathConfig(
                input=fq, prefix_file=prefix, mibf_mode=mode,
                **ENGINE)).run()
            silver = {}
            for i in range(1, ENGINE["max_paths"] + 1):
                p = f"{prefix}_{i}.fq"
                if os.path.exists(p):
                    silver[str(i)] = sha256_file(p)
            runs[mode] = {"recruits": stats.recruits,
                          "paths_completed": stats.paths_completed,
                          "silver": silver}
        out = {"dataset": {**DATASET, "sha256": sha256_file(fq)},
               "engine": ENGINE, **runs["direct"],
               "compressed": runs["compressed"]}
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
