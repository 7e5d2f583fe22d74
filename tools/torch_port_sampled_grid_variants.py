"""Kernel A's standalone sampled grid entries (seed_hash_grid and
seed_hash_rank_grid at a frame stride S > 1 with no query grid beside
them, csrc/seed_hash.cu) split by step and timed in variants, in turns on
one GPU.

The trees: this one (`this`: a thread a sampled frame at S >= h, as slots
or as ranks of one seed, its codes packed in registers, the family's
block table staged; the CTA per (read, tile) elsewhere, so its s2 cases
run the parent's kernel),
the tree named by --parent (for example a `git archive` of the parent
commit: a CTA per (read, tile) that stages the tile's codes window and its
right-half partials), and copies of either with anchored edits in
smoke_work/sampled_grid_variants/<name>/ (the tool stops naming an anchor
it does not find once):

  parent_empty     the parent's sampled CTAs return at once: the launch and
                   the CTAs' scheduling;
  parent_staged    ... after staging the codes, constants and partials;
  parent_no_store  every step, its grid stores made conditional on a value
                   no slot takes (frame_ok still stored);
  parent_no_gather the rank entry with the slot in place of its bitrank
                   word (no gather);
  this_empty, this_staged (after the constants), this_no_store,
  this_no_gather   the same cuts of this tree's kernel;
  this_lb6         this tree's kernel at 6 CTAs an SM (40 registers).

Each run is a process of its own that imports the port from its variant's
tree (so it builds that tree's kernels) and times, with chip_smoke.py's
helpers (CUDA events, 20 launches), on 64 simulated 20 kb reads (phase 3's
batch) against a filter frozen from their fill: the throughput mode's
query grid alone (B=64, h=1, S=8) and S=2 with h=3 at B=32, as slots and
as ranks; and, to show that they stay level, the S=1 grid (B=64, h=3) and
that grid with the S=8 query grid written by its launch (`fused`).  `this`
and `parent` are held to the plain versions bit for bit.  The variants
(--only NAME,...; default all of them that the trees given allow) run in
order and then back.  Prints the card and its power limit, one JSON line
per run, then each time by variant.

    python3 tools/torch_port_sampled_grid_variants.py [--parent DIR]
        [--only NAME,NAME,...]
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, "smoke_work", "sampled_grid_variants")

# the parent's grid kernel (a CTA per (read, tile))
P_START = ("  const Stage st(smem, f, frames_t);\n"
           "  if (frames_t > 0) stage(f, codes + b * L, L, pos0, frames_t, S, "
           "st);\n")
P_SLOT_STORE = "        out[s * TF + j] = v;\n"
P_RANK_STORE = "            out[(s0 + g) * TF + j] = v;\n"
P_GATHER = "            e[g] = bitrank[slot >> 5];\n"
# this tree's sampled kernel (a thread a frame)
T_START = "  if (g >= frames) return;\n"
T_SLOT_STORE = ("          out[(s0 + g2) * TF] = "
                "static_cast<int64_t>(slot[g2]);\n")
T_RANK_STORE = ("          out[(s0 + g2) * TF] = rank_in(\n")
T_GATHER = "          e[g2] = bitrank[slot[g2] >> 5];\n"
NO_SLOT = "0x7FFFFFFFFFFFFFFFll"
# name: (base tree, {file: [(anchor, replacement)]})
VARIANTS = {
    "this": ("this", {}),
    "parent": ("parent", {}),
    "parent_empty": ("parent", {"seed_hash.cu": [
        (P_START, "  if (S > 1 && !kQuery) return;\n" + P_START)]}),
    "parent_staged": ("parent", {"seed_hash.cu": [
        (P_START, P_START + "  if (S > 1 && !kQuery) return;\n")]}),
    "parent_no_store": ("parent", {"seed_hash.cu": [
        (P_SLOT_STORE, f"        if (v == {NO_SLOT}) " + P_SLOT_STORE[8:]),
        (P_RANK_STORE, f"            if (v == {NO_SLOT}) "
         + P_RANK_STORE[12:])]}),
    "parent_no_gather": ("parent", {"seed_hash.cu": [
        (P_GATHER, "            e[g] = slot;\n")]}),
    "this_empty": ("this", {"seed_hash.cu": [
        ("  const uint32_t g = blockIdx.x * blockDim.x + threadIdx.x;\n",
         "  return;\n"
         "  const uint32_t g = blockIdx.x * blockDim.x + threadIdx.x;\n")]}),
    "this_staged": ("this", {"seed_hash.cu": [
        (T_START, "  if (g >= frames || frames) return;\n")]}),
    "this_no_store": ("this", {"seed_hash.cu": [
        (T_SLOT_STORE, f"          if (slot[g2] == {NO_SLOT}u) "
         + T_SLOT_STORE[10:]),
        (T_RANK_STORE, f"          if (slot[g2] == {NO_SLOT}u) "
         + T_RANK_STORE[10:])]}),
    "this_no_gather": ("this", {"seed_hash.cu": [
        (T_GATHER, "          e[g2] = slot[g2];\n")]}),
    # this tree's kernel held to 40 registers a thread (6 CTAs an SM)
    "this_lb6": ("this", {"seed_hash.cu": [
        ("__launch_bounds__(kThreads) seed_hash_sampled_kernel(",
         "__launch_bounds__(kThreads, 6) seed_hash_sampled_kernel(")]}),
}
CASES = {"s8": (64, 1, 8), "s2": (32, 3, 2)}


def make_tree(name: str, base: str, edits: dict) -> str:
    tree = os.path.join(WORK, name)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(base, "goldrush_tpu_torch"),
                    os.path.join(tree, "goldrush_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for fname, pairs in edits.items():
        path = os.path.join(tree, "goldrush_tpu_torch", "csrc", fname)
        with open(path) as f:
            text = f.read()
        for old, new in pairs:
            if text.count(old) != 1:
                raise SystemExit(f"{name} {fname}: anchor not found once: "
                                 f"{old!r}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    return tree


def measure(check: bool) -> dict:
    """One run's times (the port imported from sys.path[0]'s tree); with
    `check`, each timed grid is first held to its plain version."""
    import dataclasses

    import numpy as np
    import torch
    import chip_smoke as cs
    from goldrush_tpu_torch.config import calc_optimal_size
    from goldrush_tpu_torch.io.fastq import encode
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.ops.nthash import build_seed_family
    from goldrush_tpu_torch.ops.seeds import make_seed_pattern
    from goldrush_tpu_torch.utils import synth
    dev = torch.device("cuda", 0)
    cs.phase_build()
    seeds = make_seed_pattern(cs.PRESET, 22, 16, 3)
    fams = {h: build_seed_family(seeds[:h]) for h in (1, 3)}
    size = calc_optimal_size(15_000_000, 1, 0.1)
    T, TL = 20, 1000
    genome = synth.random_genome(400_000, seed=7)
    reads = synth.simulate_reads(genome, 64, 20_000, seed=8, err_rate=0.05)
    codes = np.zeros((64, T * TL + TL), np.uint8)
    lengths = np.zeros(64, np.int32)
    for i, (_, seq, _) in enumerate(reads):
        c = encode(seq)[: T * TL + TL - 1]
        codes[i, :len(c)] = c
        lengths[i] = len(c)
    qc, ql = torch.from_numpy(codes).to(dev), torch.from_numpy(lengths).to(dev)
    base = dm.MibfParams(size=size, h=3, k=22, spans=fams[3].spans,
                         tile_length=TL, threshold=10, block_size=10,
                         vote_topk=32, vote_min=2)
    bits = dm.fill_presence_bits(dm.presence_bitmap(size, dev), qc, ql,
                                 fams[3], size)
    frozen = cz.with_tables(*cz.build_rank(bits, size), size)

    def par(h, S):
        return dataclasses.replace(base, h=h, spans=fams[h].spans,
                                   frame_stride=S,
                                   threshold=max(1, base.threshold // S),
                                   vote_min=2 if S == 1 else max(1, 2 // S))
    out = {}
    runs = {f"{tag}_{kind}": (B, h, S, kind)
            for tag, (B, h, S) in {**CASES, "s1": (64, 3, 1)}.items()
            for kind in ("slots", "ranks")}
    for name, (B, h, S, kind) in runs.items():
        p, fam, c, n = par(h, S), fams[h], qc[:B], ql[:B]
        if kind == "slots":
            fn = lambda: dm.build_slot_grid(c, n, fam, p, T)       # noqa
            plain = lambda: dm._build_slot_grid_plain(c, n, fam, p, T)  # noqa
        else:
            fn = lambda: cz.build_rank_grid(frozen, c, n, fam, p, T)  # noqa
            plain = lambda: cz._build_rank_grid_plain(  # noqa
                frozen, c, n, fam, p, T)
        if check and cs.max_abs_err(zip(fn(), plain())):
            raise AssertionError(f"{name} differs from its plain version")
        out[name] = cs.cuda_ms(fn, 20)
    if hasattr(dm, "build_slot_grids"):
        pi, pq = par(3, 1), par(1, 8)
        out["fused_slots"] = cs.cuda_ms(
            lambda: dm.build_slot_grids(qc, ql, fams[3], pi, pq, T), 20)
        out["fused_ranks"] = cs.cuda_ms(
            lambda: cz.build_rank_grids(frozen, qc, ql, fams[3], pi, pq, T),
            20)
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--run"]:
        sys.path.insert(0, argv[1])
        sys.path.insert(1, REPO)
        print(json.dumps(measure(argv[2] == "check")))
        return 0
    bases, only = {"this": REPO}, None
    while argv:
        if argv[0] == "--parent" and len(argv) > 1:
            bases["parent"] = os.path.abspath(argv[1])
        elif argv[0] == "--only" and len(argv) > 1:
            only = argv[1].split(",")
        else:
            raise SystemExit(__doc__)
        argv = argv[2:]
    names = only or [n for n, (b, _) in VARIANTS.items() if b in bases]
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    cs.phase_device()
    trees = {}
    for name in names:
        base, edits = VARIANTS[name]
        trees[name] = (bases[base] if not edits
                       else make_tree(name, bases[base], edits))
    order = list(trees) + list(trees)[::-1]
    runs = {name: [] for name in trees}
    for name in order:
        check = "check" if name in ("this", "parent") else "time"
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--run", trees[name], check],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise SystemExit(f"{name} failed:\n{r.stdout[-2000:]}"
                             f"{r.stderr[-3000:]}")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        runs[name].append(rec)
        print(json.dumps({"variant": name, **rec}), flush=True)
    for key in runs[order[0]][0]:
        print(key + " " + " ".join(
            f"{name}=" + ",".join(f"{r[key]:.4f}" for r in recs)
            for name, recs in runs.items() if key in recs[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
