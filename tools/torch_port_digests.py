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

Under "superblocks": the JAX package's compressed filter at 2^32 slots
and more, on the same 1 Mbp dataset and ENGINE settings with
hash_universe=485,000,000 (4,603,242,496 slots, two superblocks; the
JAX engine takes K12's byte-per-slot fill and freeze_device there): the
silver paths and the golden path over their concatenation (as
pipeline.py runs it: silver_path off, min_length 0), in three cases,
exact with slot_map "mod", exact with "fastrange" (whose slots the JAX
function keeps below 2^32 by its wrapped products) and the throughput
cell with "mod".  ``chip_smoke.py`` phase 7(a) holds the port on the card
to them.  The JAX engine allocates a direct-layout state at construction
(dm.init_state: 8 B per slot, 36.8 GB here) that the compressed filter at
this size never reads and drops at its freeze; this tool gives it empty
arrays instead, which changes no output.

Under "direct_2_32": the JAX package's DIRECT filter at the same size
(hash_universe=485,000,000: 4,603,242,496 slots, words and counters of
18.4 GB each), on the same dataset and ENGINE settings: the silver paths
and the golden path over their concatenation, with each engine's universe
and size, in three cases, exact with slot_map "fastrange" (its slots wrap
below 2^32, the sentinel slot lies above), exact with "mod" (slots span
past 2^32) and the throughput cell with "mod".  The JAX engine runs in
place on its donated tables, so one engine holds ~37 GB of host memory;
the engines run one at a time, and the tool prints its peak resident set
after each case.  ``chip_smoke.py`` phase 7(d) holds the port on the card
to them, and a ``slow``-marked test of tests/test_torch_direct_2_32.py the
port's CPU engine.

The dataset and engine settings are those of the exact run in
tests/test_quality_gate.py (600 x 20 kb reads at 5% error, 40% indels,
seeds 51/52; exact defaults, max_paths=3, ratio=0.75, min_length=15000,
batch_reads=64).  ``chip_smoke.py`` runs the PyTorch port on the card over
the same dataset and requires the same digests, and
tests/test_torch_host.py checks that the port's synth regenerates the
dataset byte for byte, so the two cannot drift apart.

Under "ntcard": the JAX engine with ntcard=True (the universe from
ntCard's F0 estimate of the reads, rbits 22, sbits 7) in exact mode on the
same dataset and ENGINE settings, for each filter: the silver engine's
universe and size, the silver paths and the golden path over their
concatenation (whose engine estimates its own universe from that file).
The ntCard-sized direct filter of this dataset fits the host: its
universe, 21,869,816, is about seven times the closed-form one (207,571,328
slots, 1.7 GB of words and counters).

Under "insert": the sampled inserts on the same dataset and ENGINE
settings, the silver paths of each case of INSERT_CASES: the throughput
cell with insert_stride 2 and 8 (both filters), the throughput cell with
two insert seeds over one probed seed, and the exact policy at
insert_stride 2.  tests/test_torch_throughput_gate.py (on the CPU) and
chip_smoke.py phase 8 (on the card) hold the port to both keys.

Under "wavefront": the wavefront consume (path/wavefront.py) on the same
dataset and ENGINE settings in the throughput cell with wavefront=True and
windows of 256 reads (WAVE), the silver paths of each filter.
chip_smoke.py phase 9 holds the port on the card to them.

Under "wave_8192": the wavefront at the largest windows its tile budget
makes, 8,192 one-tile reads: a dataset of its own (WAVE_8192_DATASET,
1,500-base reads at tiles of 1,000) and the throughput cell with
wavefront=True, windows of 8,192 reads and a recruit whenever a read's one
tile is unassigned (WAVE_8192), the silver paths of each filter.
tests/test_torch_wave_8192.py (on the CPU) and chip_smoke.py phase 9 (on
the card, where such a window's per-read state leaves shared memory) hold
the port to them.

    JAX_PLATFORMS=cpu python tools/torch_port_digests.py            # all
    JAX_PLATFORMS=cpu python tools/torch_port_digests.py pipeline   # ~1 min
    JAX_PLATFORMS=cpu python tools/torch_port_digests.py superblocks
    JAX_PLATFORMS=cpu python tools/torch_port_digests.py direct_2_32  # ~37 GB
    JAX_PLATFORMS=cpu python tools/torch_port_digests.py ntcard insert
    JAX_PLATFORMS=cpu python tools/torch_port_digests.py wavefront
    JAX_PLATFORMS=cpu python tools/torch_port_digests.py wave_8192  # ~40 s
    JAX_PLATFORMS=cpu python tools/torch_port_digests.py train_step
    JAX_PLATFORMS=cpu python tools/torch_port_digests.py wave_long
    JAX_PLATFORMS=cpu python tools/torch_port_digests.py wave_8192_d3

Under "train_step": the JAX package's ``train_step``
(goldrush_tpu/parallel/mesh.py:77) at the bench cell's width: bench.py's
reads (BENCH_DATASET: 3,000 x 20 kb of a 5 Mbp genome), the engine's
direct filter for them (TRAIN_ENGINE: 142,368,384 slots, h = 3, tiles of
1,000, every frame, K = 32, blocks of 10), presence-filled with every
read (the pass-1 fill), then, from that filter, four steps of 64 reads
(reads 0-255 in file order, base ids 1 + 2 i for read i) at each
max_blocks of TRAIN_STEPS: after each step the sha256 of the words and
counters of the real slots (the JAX fill also sets the sentinel slot,
which the port's fill leaves) and of the decisions (int32), and the
decisions' counts.  chip_smoke.py phase 11 holds the port's
``train_step`` and ``sharded_train_step`` on the card to them.

Under "wave_long": the JAX wavefront engine on reads of the 1,024-tile
bucket (WAVE_LONG_DATASET: 24 reads of 240,000 bases; WAVE_LONG: tiles of
256 at stride 8, so a window is 8 reads), the silver paths of each
filter.  The JAX wavefront slices its classify and conflict passes in
chunks of up to 64 rows; a window of 8 reads needs chunks of 8, which
change no output (tests/test_torch_wavefront_engine.py patches them
alike).  chip_smoke.py phase 9 holds the port on the card to them.

Under "wave_8192_d3": the "wave_8192" case at three data rows (devices=3),
whose windows of 8,192 reads the port pads to 8,193.  The JAX mesh engine
cannot run three rows (its pass-1 fill shards batches of 64 reads), so
the key states that the files are "wave_8192"'s and holds its digests.
chip_smoke.py phase 10 holds the port's engine on ["cuda:0"] * 3 to them.
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
# the compressed filter at 4,603,242,496 slots, and its three cases
SUPER = dict(hash_universe=485_000_000, mibf_mode="compressed")
SUPER_CASES = {"exact_mod": dict(slot_map="mod"),
               "exact_fastrange": dict(slot_map="fastrange"),
               "throughput_mod": dict(THROUGHPUT, slot_map="mod")}
# the direct filter at the same size, in the same three cases
DIRECT_2_32 = dict(SUPER, mibf_mode="direct")
# the sampled inserts: insert_stride > 1 and insert_seeds < h
INSERT_CASES = {
    "tp_s2_direct": dict(THROUGHPUT, insert_stride=2, mibf_mode="direct"),
    "tp_s2_compressed": dict(THROUGHPUT, insert_stride=2,
                             mibf_mode="compressed"),
    "tp_s8_direct": dict(THROUGHPUT, insert_stride=8, mibf_mode="direct"),
    "tp_s8_compressed": dict(THROUGHPUT, insert_stride=8,
                             mibf_mode="compressed"),
    "tp_i2_direct": dict(THROUGHPUT, insert_seeds=2, mibf_mode="direct"),
    "exact_s2_direct": dict(insert_stride=2, mibf_mode="direct"),
}
# the wavefront consume over the throughput cell
WAVE = dict(THROUGHPUT, wavefront=True, wave_window=256)
# the wavefront's windows of 8,192 one-tile reads: the gate genome, 9,000
# reads of 1,500 bases (a window of 8,192 reads, then one of 808 padded to
# 8,192), over ENGINE
WAVE_8192_DATASET = dict(genome=1_000_000, genome_seed=51, n_reads=9_000,
                         read_len=1_500, reads_seed=53, err_rate=0.05,
                         indel_frac=0.4)
WAVE_8192 = dict(THROUGHPUT, min_length=1_000, unassigned_min=1,
                 assigned_max=0, wavefront=True, wave_window=8_192)
# bench.py's dataset and the train steps' engine geometry at its width
BENCH_DATASET = dict(genome=5_000_000, genome_seed=11, n_reads=3_000,
                     read_len=20_000, reads_seed=12, err_rate=0.05)
TRAIN_ENGINE = dict(genome_size=5_000_000, kmer_size=22, weight=16,
                    hash_num=3, seed_preset="1011011110110111101101")
# four steps of 64 reads at each max_blocks
TRAIN_STEPS = dict(steps=4, batch=64, max_blocks=[2, 1])
# reads of the 1,024-tile bucket at tiles of 256 (937 tiles a read)
WAVE_LONG_DATASET = dict(genome=1_000_000, genome_seed=51, n_reads=24,
                         read_len=240_000, reads_seed=54, err_rate=0.05,
                         indel_frac=0.4)
WAVE_LONG = dict(THROUGHPUT, tile_length=256, wavefront=True,
                 wave_window=8)


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


def silver_golden(engine, config, fq: str, prefix: str, extra: dict,
                  sizing: bool = False) -> dict:
    """One package's silver paths on `fq` and the golden path over their
    concatenation, as pipeline.py runs the two stages: the digests of
    every file, the silver run's recruits and paths, the golden run's
    recruits; with ``sizing`` also the silver engine's universe and
    filter size."""
    eng = engine(config(input=fq, prefix_file=prefix, **ENGINE, **extra))
    size = {"universe": eng.universe, "size": eng.size} if sizing else {}
    stats = eng.run()
    del eng
    silver = {}
    with open(prefix + "_all.fq", "wb") as cat:
        for i in range(1, ENGINE["max_paths"] + 1):
            p = f"{prefix}_{i}.fq"
            if os.path.exists(p):
                silver[str(i)] = sha256_file(p)
                with open(p, "rb") as f:
                    cat.write(f.read())
    golden = engine(config(input=prefix + "_all.fq",
                           prefix_file=prefix + "_golden",
                           **{**ENGINE, "silver_path": False,
                              "min_length": 0}, **extra)).run()
    return {**size, "recruits": stats.recruits,
            "paths_completed": stats.paths_completed, "silver": silver,
            "golden": sha256_file(prefix + "_golden.fa"),
            "golden_recruits": golden.recruits}


def superblocks_entry(fq: str, workdir: str) -> dict:
    """The "superblocks" key: the JAX package's silver and golden paths at
    4,603,242,496 slots, each case of SUPER_CASES, with the engine's
    unread direct-layout state left empty (see the module docstring)."""
    import jax.numpy as jnp
    from goldrush_tpu.config import PathConfig
    from goldrush_tpu.mibf import mibf as jdm
    from goldrush_tpu.path import engine as jengine
    real = jdm.init_state

    def lean(params):
        if params.size >= 1 << 32:
            return jdm.MibfState(words=jnp.zeros(0, jnp.uint32),
                                 counts=jnp.zeros(0, jnp.uint32))
        return real(params)
    jengine.dm.init_state = lean
    try:
        cases = {tag: silver_golden(jengine.GoldenPathEngine, PathConfig, fq,
                                    os.path.join(workdir, f"super_{tag}"),
                                    {**SUPER, **case})
                 for tag, case in SUPER_CASES.items()}
    finally:
        jengine.dm.init_state = real
    return {"engine": SUPER, "cases": SUPER_CASES, **cases}


def peak_rss_bytes() -> int:
    """This process's peak resident set so far (Linux reports KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def direct_2_32_entry(fq: str, workdir: str) -> dict:
    """The "direct_2_32" key: the JAX package's silver and golden paths
    with the direct filter at 4,603,242,496 slots, each case of
    SUPER_CASES, one engine at a time."""
    import gc
    import time
    from goldrush_tpu.config import PathConfig
    from goldrush_tpu.path.engine import GoldenPathEngine
    cases = {}
    for tag, case in SUPER_CASES.items():
        t0 = time.time()
        cases[tag] = silver_golden(GoldenPathEngine, PathConfig, fq,
                                   os.path.join(workdir, f"d232_{tag}"),
                                   {**DIRECT_2_32, **case}, sizing=True)
        gc.collect()
        print(f"direct_2_32 {tag}: {time.time() - t0:.1f} s, peak RSS "
              f"{peak_rss_bytes()} B", file=sys.stderr, flush=True)
    return {"engine": DIRECT_2_32, "cases": SUPER_CASES, **cases}


def silver_run(engine, config, fq: str, prefix: str, extra: dict) -> dict:
    """One package's silver paths on `fq`: their digests, the recruits and
    the paths completed."""
    stats = engine(config(input=fq, prefix_file=prefix,
                          **{**ENGINE, **extra})).run()
    silver = {}
    for i in range(1, ENGINE["max_paths"] + 1):
        p = f"{prefix}_{i}.fq"
        if os.path.exists(p):
            silver[str(i)] = sha256_file(p)
    return {"recruits": stats.recruits,
            "paths_completed": stats.paths_completed, "silver": silver}


def ntcard_entry(fq: str, workdir: str) -> dict:
    """The "ntcard" key: the JAX engine sized by ntCard, exact mode, each
    filter: its universe and size, silver and golden digests."""
    from goldrush_tpu.config import PathConfig
    from goldrush_tpu.path.engine import GoldenPathEngine
    return {"engine": {"ntcard": True},
            **{mode: silver_golden(GoldenPathEngine, PathConfig, fq,
                                   os.path.join(workdir, f"nt_{mode}"),
                                   {"ntcard": True, "mibf_mode": mode},
                                   sizing=True)
               for mode in ("direct", "compressed")}}


def insert_entry(fq: str, workdir: str) -> dict:
    """The "insert" key: silver digests of each case of INSERT_CASES."""
    from goldrush_tpu.config import PathConfig
    from goldrush_tpu.path.engine import GoldenPathEngine
    return {"cases": INSERT_CASES,
            **{tag: silver_run(GoldenPathEngine, PathConfig, fq,
                               os.path.join(workdir, f"ins_{tag}"), case)
               for tag, case in INSERT_CASES.items()}}


def wavefront_entry(fq: str, workdir: str) -> dict:
    """The "wavefront" key: silver digests of the wavefront consume over
    the throughput cell, each filter."""
    from goldrush_tpu.config import PathConfig
    from goldrush_tpu.path.engine import GoldenPathEngine
    return {"engine": WAVE,
            **{mode: silver_run(GoldenPathEngine, PathConfig, fq,
                                os.path.join(workdir, f"wave_{mode}"),
                                {**WAVE, "mibf_mode": mode})
               for mode in ("direct", "compressed")}}


def wave_8192_entry(fq: str, workdir: str) -> dict:
    """The "wave_8192" key: its dataset (written here, beside `fq`) and the
    silver digests of the wavefront over it in windows of 8,192 reads,
    each filter."""
    from goldrush_tpu.config import PathConfig
    from goldrush_tpu.path.engine import GoldenPathEngine
    from goldrush_tpu.utils import synth
    d = WAVE_8192_DATASET
    fq = os.path.join(workdir, "one_tile.fq")
    synth.write_fastq(fq, synth.simulate_reads(
        synth.random_genome(d["genome"], seed=d["genome_seed"]),
        d["n_reads"], d["read_len"], seed=d["reads_seed"],
        err_rate=d["err_rate"], indel_frac=d["indel_frac"]))
    return {"dataset": {**d, "sha256": sha256_file(fq)}, "engine": WAVE_8192,
            **{mode: silver_run(GoldenPathEngine, PathConfig, fq,
                                os.path.join(workdir, f"w8k_{mode}"),
                                {**WAVE_8192, "mibf_mode": mode})
               for mode in ("direct", "compressed")}}


def digest(a) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def bench_codes():
    """BENCH_DATASET's reads as the engine packs a batch of 20-tile reads:
    codes uint8 [n, 21,000], lengths int32 [n], and the FASTQ's sha256
    (written to a temporary file)."""
    import numpy as np
    from goldrush_tpu.io.fastq import encode
    from goldrush_tpu.utils import synth
    d = BENCH_DATASET
    reads = synth.simulate_reads(
        synth.random_genome(d["genome"], seed=d["genome_seed"]),
        d["n_reads"], d["read_len"], seed=d["reads_seed"],
        err_rate=d["err_rate"])
    with tempfile.TemporaryDirectory(prefix="torch_port_bench_") as tmp:
        fq = os.path.join(tmp, "bench_reads.fq")
        synth.write_fastq(fq, reads)
        sha = sha256_file(fq)
    L = 21 * 1_000
    codes = np.zeros((len(reads), L), np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, (_, seq, _) in enumerate(reads):
        c = encode(seq)[: L - 1]
        codes[i, : len(c)] = c
        lengths[i] = len(c)
    return codes, lengths, sha


def train_step_entry(fq: str, workdir: str) -> dict:
    """The "train_step" key: the JAX train_step at the bench width."""
    import jax.numpy as jnp
    import numpy as np
    from goldrush_tpu.config import PathConfig, calc_optimal_size
    from goldrush_tpu.mibf import mibf as dm
    from goldrush_tpu.ops.nthash import build_seed_family, hash_positions
    from goldrush_tpu.ops.seeds import make_seed_pattern
    from goldrush_tpu.parallel import mesh
    codes, lengths, sha = bench_codes()
    cfg = PathConfig(input=fq, **TRAIN_ENGINE)
    size = calc_optimal_size(cfg.derived_hash_universe(), 1, cfg.occupancy)
    seeds = make_seed_pattern(cfg.seed_preset, cfg.kmer_size, cfg.weight,
                              cfg.hash_num)
    fam = build_seed_family(seeds)
    params = dm.MibfParams(
        size=size, h=cfg.hash_num, k=cfg.kmer_size,
        spans=tuple(len(s) for s in seeds), tile_length=cfg.tile_length,
        threshold=cfg.threshold, block_size=cfg.block_size,
        vote_topk=cfg.vote_topk)
    T = 20
    # the pass-1 fill, 64 reads a batch at the engine's padded width
    Lb, FB = 1 << 15, 64
    P = Lb - params.k + 1
    words = dm.init_state(params).words
    for i in range(0, len(codes), FB):
        n = len(codes[i: i + FB])
        c = np.zeros((FB, Lb), np.uint8)
        c[:n, : codes.shape[1]] = codes[i: i + n]
        valid = np.zeros((FB, len(params.spans), P), bool)
        for j in range(n):
            for s, span in enumerate(params.spans):
                valid[j, s, : max(int(lengths[i + j]) - span + 1, 0)] = True
        words = dm.fill_presence(words, hash_positions(jnp.asarray(c), fam,
                                                       P),
                                 jnp.asarray(valid), size, params.idx_dtype)
    filled = np.asarray(words)
    out = {"dataset": {**BENCH_DATASET, "sha256": sha},
           "engine": TRAIN_ENGINE, "size": size, "num_tiles": T,
           "steps": TRAIN_STEPS,
           "filled": digest(filled[:size]),
           "present": int(((filled[:size] >> 30) & 1).sum())}
    B = TRAIN_STEPS["batch"]
    for mb in TRAIN_STEPS["max_blocks"]:
        state = dm.MibfState(words=jnp.asarray(filled),
                             counts=dm.init_state(params).counts)
        steps = []
        for k in range(TRAIN_STEPS["steps"]):
            sl = slice(k * B, (k + 1) * B)
            base = (1 + 2 * np.arange(k * B, (k + 1) * B)).astype(np.uint32)
            state, dec = mesh.train_step(
                state, jnp.asarray(codes[sl]), jnp.asarray(lengths[sl]),
                jnp.asarray(base), fam, params, T, mb)
            dec = np.asarray(dec).astype(np.int32)
            steps.append({
                "words": digest(np.asarray(state.words)[:size]),
                "counts": digest(np.asarray(state.counts)[:size]),
                "decisions": digest(dec),
                "decision_counts": [int((dec == v).sum()) for v in (0, 1,
                                                                    2)]})
            print(f"train_step max_blocks={mb} step {k}: "
                  f"{steps[-1]['decision_counts']}", flush=True)
        out[f"max_blocks_{mb}"] = steps
    return out


def small_wave_chunks(rows: int) -> None:
    """Cap the JAX wavefront's chunk slices at ``rows`` (chunking changes
    no output): a window smaller than a chunk cannot be sliced."""
    from goldrush_tpu.path import wavefront as jwave
    for name in ("CLASSIFY_CHUNK", "CONFLICT_CHUNK", "RECHECK_CHUNK",
                 "INSERT_CHUNK"):
        setattr(jwave, name, min(getattr(jwave, name), rows))


def wave_long_entry(fq: str, workdir: str) -> dict:
    """The "wave_long" key: its dataset (written here) and the silver
    digests of the wavefront over reads of the 1,024-tile bucket, each
    filter."""
    from goldrush_tpu.config import PathConfig
    from goldrush_tpu.path.engine import GoldenPathEngine
    from goldrush_tpu.utils import synth
    small_wave_chunks(WAVE_LONG["wave_window"])
    d = WAVE_LONG_DATASET
    fq = os.path.join(workdir, "long_reads.fq")
    synth.write_fastq(fq, synth.simulate_reads(
        synth.random_genome(d["genome"], seed=d["genome_seed"]),
        d["n_reads"], d["read_len"], seed=d["reads_seed"],
        err_rate=d["err_rate"], indel_frac=d["indel_frac"]))
    return {"dataset": {**d, "sha256": sha256_file(fq)}, "engine": WAVE_LONG,
            **{mode: silver_run(GoldenPathEngine, PathConfig, fq,
                                os.path.join(workdir, f"wl_{mode}"),
                                {**WAVE_LONG, "mibf_mode": mode})
               for mode in ("direct", "compressed")}}


def wave_8192_d3_entry(fq: str, workdir: str) -> dict:
    """The "wave_8192_d3" key: the "wave_8192" case on three data rows.
    The JAX mesh engine cannot run it: its pass-1 fill splits batches of
    64 reads over the data axis (goldrush_tpu/path/engine.py:456), which
    three rows do not divide (a ValueError from its fill's sharding).  The
    mesh changes no output of the JAX engine (one replica per row, each
    running the whole window), so the key states that the case's files
    are "wave_8192"'s and holds that key's digests, computed here."""
    base = wave_8192_entry(fq, workdir)
    return {"engine": dict(WAVE_8192, devices=3), "same_as": "wave_8192",
            "direct": base["direct"], "compressed": base["compressed"]}


def write_gate_dataset(path: str) -> None:
    from goldrush_tpu.utils import synth
    genome = synth.random_genome(DATASET["genome"],
                                 seed=DATASET["genome_seed"])
    synth.write_fastq(path, synth.simulate_reads(
        genome, DATASET["n_reads"], DATASET["read_len"],
        seed=DATASET["reads_seed"], err_rate=DATASET["err_rate"],
        indel_frac=DATASET["indel_frac"]))


def main() -> None:
    if sys.argv[1:] == ["pipeline"]:
        with open(OUT) as f:
            out = json.load(f)
        out["pipeline"] = pipeline_entry()
        write(out)
        return
    if sys.argv[1:] == ["superblocks"]:
        with open(OUT) as f:
            out = json.load(f)
        with tempfile.TemporaryDirectory(prefix="torch_port_super_") as d:
            fq = os.path.join(d, "reads.fq")
            write_gate_dataset(fq)
            if sha256_file(fq) != out["dataset"]["sha256"]:
                raise SystemExit("the gate dataset does not regenerate")
            out["superblocks"] = superblocks_entry(fq, d)
        write(out)
        return
    keys = {"ntcard": ntcard_entry, "insert": insert_entry,
            "wavefront": wavefront_entry, "direct_2_32": direct_2_32_entry,
            "wave_8192": wave_8192_entry, "train_step": train_step_entry,
            "wave_long": wave_long_entry,
            "wave_8192_d3": wave_8192_d3_entry}
    if sys.argv[1:] and set(sys.argv[1:]) <= set(keys):
        with open(OUT) as f:
            out = json.load(f)
        with tempfile.TemporaryDirectory(prefix="torch_port_ins_") as d:
            fq = os.path.join(d, "reads.fq")
            write_gate_dataset(fq)
            if sha256_file(fq) != out["dataset"]["sha256"]:
                raise SystemExit("the gate dataset does not regenerate")
            for key in sys.argv[1:]:
                out[key] = keys[key](fq, d)
        write(out)
        return
    if sys.argv[1:]:
        raise SystemExit(__doc__)
    from goldrush_tpu.config import PathConfig
    from goldrush_tpu.path.engine import GoldenPathEngine
    with tempfile.TemporaryDirectory(prefix="torch_port_digests_") as d:
        fq = os.path.join(d, "reads.fq")
        write_gate_dataset(fq)
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
               "pipeline": pipeline_entry(),
               "superblocks": superblocks_entry(fq, d),
               "ntcard": ntcard_entry(fq, d),
               "insert": insert_entry(fq, d),
               "wavefront": wavefront_entry(fq, d),
               "direct_2_32": direct_2_32_entry(fq, d),
               "wave_8192": wave_8192_entry(fq, d),
               "train_step": train_step_entry(fq, d),
               "wave_long": wave_long_entry(fq, d),
               "wave_8192_d3": wave_8192_d3_entry(fq, d)}
    write(out)


def write(out: dict) -> None:
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
