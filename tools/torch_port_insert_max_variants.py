"""insert_max (K15, csrc/insert.cuh) and the consume kernel that runs it,
in variants of the tree, timed in turns on one GPU: the tree (a key a
thread, the consume kernel's owners staging a probed read's keys),
`vector` (two keys a thread by 16-byte loads over a CTA's slice of the
window), `no_staging` (the consume kernel without its staging code) and
`noinline` (the consume kernel's insert and staging out of line).

Each variant is a copy of this tree's goldrush_tpu_torch in
smoke_work/insert_max_variants/<name>/ with anchored edits (the tool stops
naming an anchor it does not find once), or the tree named by --parent
(for example a `git archive` of the parent commit) as it is.  Each run is
a process of its own that imports the port from its variant's tree (so it
builds that tree's kernels) and times, with chip_smoke.py's helpers:

  - insert_max launched alone on a 20-tile recruit of h = 3 at F = 1,000
    and at F = 125 (an insert stride of 8), random slots of a
    142,368,384-slot direct filter with 5% sentinel entries, held to its
    plain version (CUDA events, 20 launches);
  - the consume kernel in bench.py's throughput cell (compressed filter)
    on the bench reads' first batch: a batch of batch-time drops (no
    probe, no insert: the scan's per-read cost), one whole-read insert
    that was not probed (chip_smoke.py insert_in_kernel_ms), and the
    first 8 batches of a silver pass (bench_batches_ms).

The variants (all of VARIANTS, or those --only names) run in order and
then back.  Prints the card and its power limit, one JSON line per run,
then each time by variant.

    python3 tools/torch_port_insert_max_variants.py [--parent DIR]
        [--only NAME,NAME,...]
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, "smoke_work", "insert_max_variants")

LOADED = """\
  const MaxWindow w(H, last - lo + 1, F, bs, base, trimmed, or_bits);
  const int64_t* g0 = g + static_cast<int64_t>(lo) * F;
  for (uint32_t e = j; e < w.W; e += threads) {
    uint32_t s, c;
    w.at(e, s, c);
    raise_max(filt, __ldg(g0 + s * TF + c), limit, w.value(c));
  }
"""
# the design the tree's replaced: a CTA takes a slice of the window and
# walks the spans it meets, two keys a thread by 16-byte loads
VECTOR = """\
  const MaxWindow w(H, last - lo + 1, F, bs, base, trimmed, or_bits);
  const int rank = static_cast<int>(j / blockDim.x);
  const int n = static_cast<int>(threads / blockDim.x);
  int64_t e0, e1;
  slice_of(w.W, rank, n, e0, e1);
  for (int64_t ss = 0; ss < e1; ss += w.L) {
    if (ss + w.L <= e0) continue;
    const int64_t s = ss / w.L;
    const int c0 = static_cast<int>(max64(e0 - ss, 0));
    const int c1 = static_cast<int>(min64(e1 - ss, w.L));
    const int64_t* p = g + s * TF + static_cast<int64_t>(lo) * F;
    const int cb = c0 - static_cast<int>(
        (reinterpret_cast<uintptr_t>(p + c0) >> 3) & 1u);
    for (int c = cb + 2 * static_cast<int>(threadIdx.x); c < c1;
         c += 2 * static_cast<int>(blockDim.x)) {
      if (c >= c0 && c + 1 < c1) {
        const longlong2 v =
            __ldg(reinterpret_cast<const longlong2*>(p + c));
        raise_max(filt, v.x, limit, w.value(c));
        raise_max(filt, v.y, limit, w.value(c + 1));
      } else {
        if (c >= c0) raise_max(filt, __ldg(p + c), limit, w.value(c));
        if (c + 1 < c1)
          raise_max(filt, __ldg(p + c + 1), limit, w.value(c + 1));
      }
    }
  }
"""
STANDALONE_BLOCKS = (
    "      (total + gr::kMaxThreads - 1) / gr::kMaxThreads);\n")
# name: {file: [(anchor, replacement)]}; "this" is the tree as it is
VARIANTS = {
    "this": {},
    # two keys a thread by 16-byte loads over a CTA's slice, half the
    # standalone CTAs
    "vector": {
        "insert.cuh": [(LOADED, VECTOR)],
        "insert_max.cu": [(STANDALONE_BLOCKS,
                           "      (total + 2 * gr::kMaxThreads - 1) / "
                           "(2 * gr::kMaxThreads));\n")]},
    # the consume kernel without its staging code (the compiler drops it)
    "no_staging": {"consume.cu": [
        ("        a.fast && probe &&\n",
         "        false && a.fast && probe &&\n")]},
    # the consume kernel's insert and staging out of line
    "noinline": {
        "consume.cu": [("__device__ void insert_max_read(",
                        "__device__ __noinline__ void insert_max_read(")],
        "insert.cuh": [("__device__ __forceinline__ void stage_max_slice(",
                        "static __device__ __noinline__ void "
                        "stage_max_slice(")]},
}


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
                raise SystemExit(f"{fname}: anchor not found once: {old!r}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    return tree


def measure() -> dict:
    """One run's times (the port imported from sys.path[0]'s tree)."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    dev = torch.device("cuda", 0)
    cs.phase_build()
    out = {}
    size, T = 142_368_384, 20
    rng = np.random.default_rng(7)
    table = torch.zeros(-(-(size + 1) // 1024) * 1024, dtype=torch.int32,
                        device=dev)
    for F in (1000, 125):
        g = rng.integers(0, size, (3, T * F))
        g[rng.random(g.shape) < 0.05] = size
        grid = torch.from_numpy(g).to(dev)
        params = dm.MibfParams(size=size, h=3, k=22, spans=(22, 23, 24),
                               tile_length=F, block_size=10)
        want = table.clone()
        dm._insert_max_plain(want, grid, 0, T - 1, 17, False, 10, T, size,
                             dm.PRESENT_BIT)
        got = table.clone()
        dm.insert_max(got, grid, 0, T - 1, 17, False, params, T, size,
                      dm.PRESENT_BIT)
        if not torch.equal(got, want):
            raise AssertionError(f"insert_max at F={F} differs from plain")
        out[f"insert_max_f{F}"] = cs.cuda_ms(lambda: dm.insert_max(
            got, grid, 0, T - 1, 17, False, params, T, size,
            dm.PRESENT_BIT), 20)
    del table, got, want
    genome, reads = cs.bench_reads(dev)
    te = GoldenPathEngine(PathConfig(
        **{**cs.BENCH_ENGINE, "max_paths": 2, "ratio": 0.02},
        mibf_mode="compressed", **cs.THROUGHPUT), device=dev)
    bits = dm.presence_bitmap(te.size, dev)
    for c, n in cs.fill_pass_batches(dev, reads):
        dm.fill_presence_bits(bits, c, n, te.fam_ins, te.size,
                              te.cfg.slot_map)
    te.cstate = cz.with_tables(*cz.build_rank(bits, te.size), te.size)
    del bits
    filt = te.cstate
    B, L = 64, cs.BENCH["read_len"]
    codes = np.zeros((B, (T + 1) * te.cfg.tile_length), np.uint8)
    codes[:, :L] = reads[:B].cpu().numpy()
    inputs = list(te._batch_inputs(codes, np.full(B, L, np.int32),
                                   np.full(B, L, np.int64), T))
    out["consume_no_recruit"] = cs.timed_consume(
        te, filt, inputs, cs.quiet_rows(inputs[-1]), T, dev, [0, 0, 0, 0])
    out["consume_insert"], _ = cs.insert_in_kernel_ms(te, filt, inputs, T,
                                                      dev)
    out["consume_bench_batch"] = cs.bench_batches_ms(
        te, filt, reads[200:], T, dev, 8)["ms"]
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--run"]:
        sys.path.insert(0, argv[1])
        sys.path.insert(1, REPO)
        print(json.dumps(measure()))
        return 0
    trees, only = {}, list(VARIANTS)
    while argv:
        if argv[0] == "--parent" and len(argv) > 1:
            trees["parent"] = os.path.abspath(argv[1])
        elif argv[0] == "--only" and len(argv) > 1:
            only = argv[1].split(",")
        else:
            raise SystemExit(__doc__)
        argv = argv[2:]
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    cs.phase_device()
    for name in only:
        trees[name] = make_tree(name, VARIANTS[name])
    order = list(trees) + list(trees)[::-1]
    runs = {name: [] for name in trees}
    for name in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--run", trees[name]], capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            raise SystemExit(f"{name} failed:\n{r.stdout[-2000:]}"
                             f"{r.stderr[-3000:]}")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        runs[name].append(rec)
        print(json.dumps({"variant": name, **rec}), flush=True)
    for key in runs[order[0]][0]:
        print(key + " " + " ".join(
            f"{name}=" + ",".join(f"{r[key]:.4f}" for r in recs)
            for name, recs in runs.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
