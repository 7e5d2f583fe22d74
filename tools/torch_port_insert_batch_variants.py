"""Kernel D's batch entry (train_step's insert, csrc/insert_sorted.cu
insert_batch, code in csrc/insert.cuh) split by step and timed in variants
and launch shapes, in turns on one GPU.

Trees: this one (`this`), and copies of it with anchored edits in
smoke_work/insert_batch_variants/<name>/ (the tool stops naming an anchor
it does not find once):

  scatter   the launch returns after step 1 (each CTA's worked-out reads
            and its slice of the window scattered to the owners' buckets)
            and the grid barrier;
  group     every step but the reservoir rule's reads and writes of the
            tables (`apply_key` returns at once): the owners' grouping
            of their buckets by key and the sort of the repeated keys.

Each run is a process of its own that imports the port from its variant's
tree (so it builds that tree's kernels) and times, with chip_smoke.py's
helpers (CUDA events, 20 launches), the insert of the first step of the
fixture's "train_step" case (64 bench reads, 20 tiles of 1,000, h = 3,
max_blocks 2, 142,368,384 slots; chip_smoke.py `train_filled`) at 512
and 1,024 threads a CTA (mibf.BATCH_THREADS).  `this` also holds each
shape's words and counters to the plain version and times kernel D
launched once a recruit (the design the batch entry replaces).  The
variants (--only NAME,...; default all) run in order and then back.  Prints the card and its power limit, one JSON line per run,
then each time by variant.

    python3 tools/torch_port_insert_batch_variants.py [--only NAME,...]
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, "smoke_work", "insert_batch_variants")

BARRIER = ("  scatter_window<kBatchParts>(w, blockIdx.x, gridDim.x, parts, cap,\n"
           "                              bucket_count, bucket);\n"
           "  cg::this_grid().sync();\n")
APPLY = "  uint32_t cnt = __ldcg(filt.count(key)), word = 0;\n"
VARIANTS = {
    "this": {},
    "scatter": {"insert_sorted.cu": [(BARRIER, BARRIER + "  return;\n")]},
    "group": {"insert.cuh": [(APPLY, "  return;\n" + APPLY)]},
}
SHAPES = {"threads_512": 512, "threads_1024": 1024}


def make_tree(name: str, edits: dict) -> str:
    tree = os.path.join(WORK, name)
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "goldrush_tpu_torch"),
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
    """One run's times (the port imported from sys.path[0]'s tree)."""
    import torch
    import chip_smoke as cs
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.parallel import mesh as tmesh
    dev = torch.device("cuda", 0)
    cs.phase_build()
    tr, codes, lengths, params, fam, words, bits = cs.train_filled(dev)
    del bits
    T, B, size = tr["num_tiles"], tr["steps"]["batch"], params.size
    res, slots, _ = tmesh.classify_step(words, codes[:B], lengths[:B], fam,
                                        params, T, 10, 5, 1)
    verdicts = (res.decision, res.trim_start, res.trim_end)
    base = torch.arange(1, 1 + 2 * B, 2, dtype=torch.int64, device=dev)
    keep = dm.SAT_BIT | dm.PRESENT_BIT
    out = {}
    if check:
        want = dm.MibfState(words.clone(), torch.zeros_like(words))
        dm._insert_batch_plain(want.words, want.counts, slots, *verdicts,
                               lengths[:B], base, params, T, 2, size, 0, keep)
    for name, threads in SHAPES.items():
        dm.BATCH_THREADS = threads
        st = dm.MibfState(words.clone(), torch.zeros_like(words))
        dm.insert_batch(st, slots, *verdicts, lengths[:B], base, params, 2, T)
        if check and not (torch.equal(st.words, want.words)
                          and torch.equal(st.counts, want.counts)):
            raise AssertionError(f"{name} differs from the plain version")
        out[name] = cs.cuda_ms(lambda: dm.insert_batch(
            st, slots, *verdicts, lengths[:B], base, params, 2, T), 20)
    if check:
        wins = cs.recruit_windows(*verdicts, lengths[:B], params, T, 2)
        rows = [(i, w, b, bool(d == 2)) for i, (w, b, d) in enumerate(
            zip(wins, base.tolist(), verdicts[0].tolist())) if w is not None]
        st = dm.MibfState(words.clone(), torch.zeros_like(words))

        def per_recruit():
            for i, w, b, trimmed in rows:
                dm.insert_read(st, slots[i], w[0], w[1], b, trimmed, params,
                               2, T)
        out["per_recruit"] = cs.cuda_ms(per_recruit, 5, len(rows) // 6 + 1)
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--run"]:
        sys.path.insert(0, argv[1])
        sys.path.insert(1, REPO)
        print(json.dumps(measure(argv[2] == "check")))
        return 0
    only = list(VARIANTS)
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = argv[1].split(",")
    elif argv:
        raise SystemExit(__doc__)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    cs.phase_device()
    cs.bench_fastq()
    trees = {name: REPO if not VARIANTS[name] else
             make_tree(name, VARIANTS[name]) for name in only}
    order = list(trees) + list(trees)[::-1]
    runs = {name: [] for name in trees}
    for name in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--run", trees[name],
                            "check" if name == "this" else "time"],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise SystemExit(f"{name} failed:\n{r.stdout[-2000:]}"
                             f"{r.stderr[-3000:]}")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        runs[name].append(rec)
        print(json.dumps({"variant": name, **rec}), flush=True)
    keys = {k for recs in runs.values() for k in recs[0]}
    for key in sorted(keys):
        print(key + " " + " ".join(
            f"{name}=" + ",".join(f"{r[key]:.4f}" for r in recs)
            for name, recs in runs.items() if key in recs[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
