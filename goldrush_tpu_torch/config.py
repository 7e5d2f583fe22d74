"""Typed configuration for the goldrush-path engine and pipeline.

Field names and defaults are those of ``goldrush_tpu.config`` (which mirror
the reference's goldrush_path/opt.cpp:7-32 and bin/goldrush:60-97), so one
set of keyword arguments configures both packages.  ``GoldenPathEngine``
raises ``NotImplementedError`` for the engine knobs not ported yet (see
ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass
class PathConfig:
    """Parameters of the golden/silver path engine (goldrush-path)."""

    # required
    input: str = ""                 # -i reads file (fastq[.gz])
    genome_size: int = 0            # -g estimated genome size (bp)
    kmer_size: int = 0              # -k span of base spaced seed
    weight: int = 0                 # -w weight (number of 1s) of spaced seed

    # engine knobs (reference defaults)
    assigned_max: int = 1           # -a max assigned tiles for read to stay unassigned
    unassigned_min: int = 5         # -u min unassigned tiles for read to be unassigned
    tile_length: int = 1000         # -t tile length (bp)
    hash_universe: int = 0          # -H explicit hash universe (0 = derive)
    min_length: int = 20000         # -m min read length
    hash_num: int = 3               # -h number of spaced-seed patterns
    occupancy: float = 0.1          # -o target occupancy of the miBF
    ratio: float = 0.9              # -r silver path terminates at ratio*G bases
    jobs: int = 48                  # -j host-side ingest prefetch depth
    block_size: int = 10            # -b consecutive tiles sharing one inserted ID
    max_paths: int = 5              # -M number of silver paths
    threshold: int = 10             # -x hits needed for a tile to be assigned
    phred_min: int = 0              # -P min avg phred (0 = auto via median)
    phred_delta: int = 5            # -d max |phred(first half)-phred(second half)|
    prefix_file: str = "goldrush_out"   # -p output prefix
    seed_preset: str = ""           # -s explicit base seed pattern
    filter_file: str = ""           # -f file listing read names to exclude
    ntcard: bool = False            # --ntcard: estimate hash universe by ntCard
    silver_path: bool = False       # --silver_path mode
    verbose: bool = False
    debug: bool = False

    # execution knobs without a reference equivalent
    batch_reads: int = 32           # reads classified per device batch
    max_tiles: int = 2048           # largest tile bucket
    vote_topk: int = 32             # per-tile candidate (id, count) slots kept
    mibf_mode: str = "direct"       # "direct" | "compressed"
    slot_map: str = "fastrange"     # "fastrange" | "mod" (the reference's map)
    frame_stride: int = 1           # probe every Nth frame (1 = exact)
    probe_seeds: int = 0            # probe only the first N seeds (0 = all h)
    insert_stride: int = 1          # insert every Nth frame (1 = exact)
    insert_seeds: int = 0           # insert only the first N seeds (0 = all h)
    trim_recheck: bool = True       # sampled modes: full-res boundary recheck
    wavefront: bool = False         # batched wavefront consume (throughput)
    wave_window: int = 256          # reads per wavefront window
    recheck: str = "exact"          # batch-staleness policy: exact | optimistic
    save_mibf: str = ""             # persist the filled filter to this .npz
    load_mibf: str = ""             # skip pass 1, resume from a saved filter
    trace_dir: str = ""             # torch.profiler trace dir for run()
    keep_filter: bool = False       # accepted for config compatibility: the
                                    # PyTorch engine always keeps its filter
                                    # until the engine object is dropped
    devices: int = 0                # 0 = all local devices
    model_shards: int = 1           # filter banks over a 'model' axis

    def validate(self) -> None:
        if self.kmer_size == 0:
            raise ValueError("span of spaced seed (-k) cannot be 0")
        if self.weight == 0:
            raise ValueError("weight of spaced seed (-w) cannot be 0")
        if self.genome_size == 0:
            raise ValueError("genome size (-g) cannot be 0")
        if self.seed_preset:
            if len(self.seed_preset) != self.kmer_size:
                raise ValueError("seed preset must be the same size as k")
            if self.seed_preset.count("1") != self.weight:
                raise ValueError("seed preset must have the same weight as w")
        if self.mibf_mode not in ("direct", "compressed"):
            raise ValueError(f"unknown mibf_mode {self.mibf_mode!r}")
        if self.slot_map not in ("fastrange", "mod"):
            raise ValueError(f"unknown slot_map {self.slot_map!r}")
        if self.probe_seeds < 0 or self.probe_seeds > self.hash_num:
            raise ValueError(
                f"probe_seeds ({self.probe_seeds}) must be in "
                f"[0, hash_num={self.hash_num}]")
        if self.frame_stride < 1:
            raise ValueError("frame_stride must be >= 1")
        if self.insert_stride < 1:
            raise ValueError("insert_stride must be >= 1")
        if self.insert_seeds < 0 or self.insert_seeds > self.hash_num:
            raise ValueError(
                f"insert_seeds ({self.insert_seeds}) must be in "
                f"[0, hash_num={self.hash_num}]")
        if self.insert_seeds and \
                (self.probe_seeds or self.hash_num) > self.insert_seeds:
            raise ValueError("probed seeds must be a subset of insert_seeds")
        if self.recheck not in ("exact", "optimistic"):
            raise ValueError(f"unknown recheck {self.recheck!r}")
        if self.wave_window < 1:
            raise ValueError("wave_window must be >= 1")
        if self.model_shards < 1:
            raise ValueError("model_shards must be >= 1")
        if (self.save_mibf or self.load_mibf) and \
                self.mibf_mode != "direct":
            raise ValueError("mibf save/load requires mibf_mode='direct'")
        if self.devices > 1 and self.devices % self.model_shards:
            raise ValueError(
                f"devices ({self.devices}) must be divisible by "
                f"model_shards ({self.model_shards})")

    def derived_hash_universe(self) -> int:
        """Hash-universe sizing heuristic (goldrush_path.cpp:1109-1123):
        min(4^w, 2*G) * 0.5 * h unless -H is given."""
        if self.hash_universe:
            return self.hash_universe
        bases, coeff, gmult = 4, 0.5, 2
        base = min(bases ** self.weight, gmult * self.genome_size)
        return int(base * coeff * self.hash_num)

    def target_bases(self) -> int:
        """Silver path rotation target r*G (goldrush_path.cpp:1223)."""
        return int(self.ratio * self.genome_size)


def calc_optimal_size(entries: int, hash_num: int, occupancy: float) -> int:
    """Bloom size for target occupancy (MIBloomFilter.hpp:94-101):
    -entries*hash_num/ln(1-occupancy), rounded up to a multiple of 64 the
    way the reference does (adds 64 - size%64)."""
    approx = int(-float(entries) * float(hash_num) / math.log(1.0 - occupancy))
    return approx + (64 - approx % 64)


@dataclass
class PipelineConfig:
    """Pipeline parameters (bin/goldrush:60-97)."""

    reads: str = "reads"            # reads file prefix (.fq/.fastq appended)
    G: int = 0                      # haploid genome size
    t: int = 48                     # threads
    z: int = 1000                   # min contig size to scaffold
    prefix: str = "goldrush_intermediate_files"
    p: str = "goldrush_asm"         # output path prefix
    track_time: bool = False
    dev: bool = False               # keep intermediate files

    # GoldRush-Path stage params (forwarded into PathConfig)
    k: int = 22
    w: int = 16
    tile: int = 1000
    b: int = 10
    u: int = 5
    a: int = 1
    o: float = 0.1
    x: int = 10
    h: int = 3
    s: str = "1011011110110111101101"   # default preset (bin/goldrush:70)
    r: float = 0.9
    M: int = 5
    P: int = 0
    d: int = 5
    m: int = 20000

    # later stages (named for the stage file names)
    polisher: str = "goldpolish"
    polisher_mapper: str = "minimap2"
    polish_k: int = 32
    polish_w: int = 100
    span: int = 2
    dist: int = 500
    cut: int = 250
    k_ntLink: int = 40
    w_ntLink: int = 250
    rounds: int = 5
    soft_mask: bool = True
    target_flank_length: int = 64
    target_k_ntlink: int = 88
    target_w_ntlink: int = 1000

    def silver_prefix(self) -> str:
        return f"{self.p}_silver_path"

    def golden_prefix(self) -> str:
        return f"{self.p}_golden_path"

    def path_config(self, silver: bool) -> PathConfig:
        """Engine config for the silver or golden invocation, mirroring the
        flag forwarding at bin/goldrush:240-260."""
        # the default preset is only used when k and w are at their defaults
        # (bin/goldrush:241-246)
        preset = self.s if (self.k == 22 and self.w == 16) else ""
        cfg = PathConfig(
            genome_size=self.G,
            kmer_size=self.k,
            weight=self.w,
            tile_length=self.tile,
            block_size=self.b,
            unassigned_min=self.u,
            assigned_max=self.a,
            occupancy=self.o,
            threshold=self.x,
            hash_num=self.h,
            seed_preset=preset,
            ratio=self.r,
            max_paths=self.M,
            phred_min=self.P,
            phred_delta=self.d,
            jobs=self.t,
        )
        if silver:
            cfg.silver_path = True
            cfg.min_length = self.m
            cfg.prefix_file = self.silver_prefix()
        else:
            cfg.silver_path = False
            cfg.min_length = 0
            cfg.prefix_file = self.golden_prefix()
        return cfg

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def stage_filenames(cfg: PipelineConfig) -> dict:
    """Stage file names encoding the dataflow like the make pipeline
    (bin/goldrush:209-308), which gives resume-from-file semantics."""
    p1, p2 = cfg.silver_prefix(), cfg.golden_prefix()
    polished_infix = f"{cfg.polisher}-polished"
    tig = f"{p2}.{polished_infix}.span{cfg.span}.dist{cfg.dist}.tigmint.fa"
    ntl = (f"{tig}.k{cfg.k_ntLink}.w{cfg.w_ntLink}."
           f"ntLink-{cfg.rounds}rounds.fa")
    return {
        "silver": [f"{p1}_{i}.fq" for i in range(1, cfg.M + 1)],
        "silver_all": f"{p1}_all.fq",
        "golden": f"{p2}.fa",
        "polished": f"{p2}.{polished_infix}.fa",
        "tigmint": tig,
        "ntlink": ntl,
        "final": ntl[: -len(".fa")] + ".polished.fa",
    }
