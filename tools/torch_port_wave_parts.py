"""Where the wavefront kernels' time goes (wave_adjacency, wave_rounds), on
one GPU.

Builds variants of a tree's csrc/wavefront.cu (this checkout's, or with
--tree DIR another checkout's, such as the parent's from `git archive`)
into smoke_work/wave_parts/<variant>/: the tree's other sources are
compiled once, each variant's wavefront.cu by an nvcc of its own, all at
once, and each variant is linked into a library with the tree's C entry
points.  Then, on chip_smoke.py's 9(a) windows (bench.py's throughput cell
with wavefront=True, windows of 256 reads, each filter, the filter filled
from the bench reads), the tree's own Python wrappers are called with each
variant's library in place of the built one:

  wave_adjacency  every variant timed in turns (each once, then again in
                  the reverse order), each a prefix of the launch's steps,
                  the variants that compute the whole function held to the
                  plain version; and the window's histogram of distinct
                  read orders per (conflict key, fingerprint) group;
  wave_rounds     the launch as shipped, a variant that stamps
                  %globaltimer in CTA 0 (thread 0) where each step ends,
                  summed over the launch by step, and the design's other
                  variants (cta256: CTAs of 256 threads, two an SM), each
                  run twice in turns from the same saved tables and held
                  to the first run's outputs; the stamps' own cost is the
                  difference of the shipped and the stamped times.

    python3 tools/torch_port_wave_parts.py [--tree DIR]

The variants are those of the source's design, whichever design's edits
all match the source once; otherwise the tool stops with the text of the
newest design's edit that it missed.  Adjacency steps:
  sort design (one CTA per (read, tile) keys each frame into a 123 MB key
  array with a global atomic per key; a scan of the partition counts; a
  scatter with a global atomic per key; one CTA per partition sorts it):
    keys, offsets, scatter   the launch up to and with that kernel;
    load      and the partitions' keys loaded into shared memory;
    sort      and sorted: no pair counted;
    full      the launch as shipped.
  group design (count, scan, scatter, split, group; csrc/wavefront.cu's
  header):
    count     the per-CTA bucket counts;
    scan      and the (bucket, CTA) offset scan;
    scatter   and the scatter into the buckets' slices;
    split     and each bucket split into its partitions' slices;
    load      and the partitions loaded (their distinct keys, past the
              shared-memory capacity);
    group     and grouped by (key, fingerprint), the pairs of groups of
              two and three orders counted: no group of more sorted;
    full      the launch as shipped;
    round512  the launch with staged rounds of 512 keys (a round of
              frames in the scatter, 512 keys in the split), not 4,096.
Rounds steps (the stamps): other (the per-read bookkeeping, its scans and
block barriers), q_probe and q_classify (the query tier's tiles and kernel
C, each to its grid barrier), r_probe and r_classify (the recheck tier's),
insert, reset, and write_wait (the grid barrier that orders an insert or a
reset before what reads the tables next).
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "smoke_work", "wave_parts")
MAGIC = "0x9E3779B97F4A7C15ull"
STEPS = ("other", "q_probe", "q_classify", "r_probe", "r_classify", "insert",
         "reset", "write_wait")
ST = {n: i for i, n in enumerate(STEPS)}

# the stamps: CTA 0's thread 0 adds the time since its last stamp to the
# step that just ended
STAMP_HEAD = (
    "__device__ unsigned long long gr_wstamp[8];\n"
    "__device__ unsigned long long gr_wlast;\n"
    "__device__ __forceinline__ unsigned long long gr_gtime() {\n"
    "  unsigned long long t;\n"
    "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
    "  return t;\n}\n"
    "__device__ __forceinline__ void wstamp(int k) {\n"
    "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
    "    const unsigned long long t = gr_gtime();\n"
    "    gr_wstamp[k] += t - gr_wlast;\n    gr_wlast = t;\n  }\n}\n")
STAMP_TAIL = (
    "\nextern \"C\" int gr_wave_stamps(unsigned long long* out) {\n"
    "  cudaDeviceSynchronize();\n"
    "  cudaMemcpyFromSymbol(out, gr::gr_wstamp, sizeof(gr::gr_wstamp));\n"
    "  const unsigned long long zero[8] = {};\n"
    "  return cudaMemcpyToSymbol(gr::gr_wstamp, zero, sizeof(zero));\n}\n")


def s(name: str) -> str:
    return f"wstamp({ST[name]});"


def ret_before(anchor: str) -> tuple:
    """End the adjacency's entry point before `anchor`."""
    return (anchor, "  return cudaGetLastError();\n" + anchor)


def fold_return(anchor: str, fold: str) -> tuple:
    """End a kernel before `anchor`, keeping `fold` alive."""
    return (anchor, f"  if ({fold}) cnt[0] = 1;\n  return;\n" + anchor)


# ------------------------------------------------------------------ sort
SORT_ADJ = {
    "keys": [ret_before("  gr::adj_offsets_kernel<<<1, 1024, 0, stream>>>(")],
    "offsets": [ret_before("  const int64_t n = static_cast<int64_t>(B) * H "
                           "* T * F;\n")],
    "scatter": [ret_before("  const size_t smem_pairs = ")],
    "load": [fold_return("  block_bitonic_sort(a, n2);\n",
                         f"a[threadIdx.x % n2] == {MAGIC}")],
    "sort": [fold_return("  const unsigned long long mask = (1ull << ob) - "
                         "1ull;\n", f"a[threadIdx.x % n2] == {MAGIC}")],
    "full": [],
}
SORT_STAMPS = [
    ("constexpr int kWaveWarps = 4;\n",
     "constexpr int kWaveWarps = 4;\n" + STAMP_HEAD),
    ("  cg::grid_group grid = cg::this_grid();\n  __shared__ unsigned long "
     "long scan[kThreads];\n",
     "  cg::grid_group grid = cg::this_grid();\n  if (blockIdx.x == 0 && "
     "threadIdx.x == 0) gr_wlast = gr_gtime();\n  __shared__ unsigned long "
     "long scan[kThreads];\n"),
    ("  grid.sync();\n  const int warp = threadIdx.x >> 5, lane = "
     "threadIdx.x & 31;\n",
     "  grid.sync();\n  wstamp(query ? 1 : 3);\n  const int warp = "
     "threadIdx.x >> 5, lane = threadIdx.x & 31;\n"),
    ("  grid.sync();\n}\n\n// A read's commit geometry",
     "  grid.sync();\n  wstamp(query ? 2 : 4);\n}\n\n// A read's commit "
     "geometry"),
    ("      if (dirty) grid.sync();\n      dirty = 0;\n      probe_rows("
     "a, tq,",
     f"      {s('other')}\n      if (dirty) grid.sync();\n      "
     f"{s('write_wait')}\n      dirty = 0;\n      probe_rows(a, tq,"),
    ("        if (dirty) grid.sync();\n        dirty = 0;\n        "
     "probe_rows(a, tf,",
     f"        {s('other')}\n        if (dirty) grid.sync();\n        "
     f"{s('write_wait')}\n        dirty = 0;\n        probe_rows(a, tf,"),
    ("        if (dirty == 2) grid.sync();\n        insert_rows(a, list, n, "
     "ceil);\n",
     f"        {s('other')}\n        if (dirty == 2) grid.sync();\n        "
     f"{s('write_wait')}\n        insert_rows(a, list, n, ceil);\n        "
     f"{s('insert')}\n"),
    ("      if (dirty) grid.sync();\n      reset_tables(a);\n",
     f"      {s('other')}\n      if (dirty) grid.sync();\n      "
     f"{s('write_wait')}\n      reset_tables(a);\n      {s('reset')}\n"),
    ("  if (blockIdx.x == 0 && tid == 0) {\n    a.scal[0] =",
     f"  {s('other')}\n  if (blockIdx.x == 0 && tid == 0) {{\n    "
     "a.scal[0] ="),
    ("}  // extern \"C\"\n", "}  // extern \"C\"\n" + STAMP_TAIL),
]

# ----------------------------------------------------------------- group
GROUP_ADJ = {
    "count": [ret_before("  gr::adj_scan_cols_kernel<<<")],
    "scan": [ret_before("  gr::adj_keys_kernel<true><<<")],
    "scatter": [ret_before("  gr::adj_split_kernel<<<")],
    "split": [ret_before("  gr::adj_group_kernel<<<")],
    "load": [fold_return("  // 2. the group table: a group's entry holds "
                         "the key that claimed it\n",
                         f"A[threadIdx.x % max(n, 1)] == {MAGIC}")],
    "group": [fold_return("  // 3. the keys of groups of four or more "
                          "orders, sorted\n",
                          f"A[threadIdx.x % max(n, 1)] == {MAGIC}")],
    "full": [],
    "round512": [("constexpr int kRoundKeys = 4096;\n",
                  "constexpr int kRoundKeys = 512;\n")],
}
GROUP_STAMPS = [
    ("constexpr int kMaxParts = 1 << 12;  // a CTA's counters (count, split)"
     "\n", "constexpr int kMaxParts = 1 << 12;  // a CTA's counters (count, "
     "split)\n" + STAMP_HEAD),
    ("  cg::grid_group grid = cg::this_grid();\n  __shared__ long long "
     "scan[32];\n",
     "  cg::grid_group grid = cg::this_grid();\n  if (blockIdx.x == 0 && "
     "threadIdx.x == 0) gr_wlast = gr_gtime();\n  __shared__ long long "
     "scan[32];\n"),
    ("  grid.sync();\n  for (int j = blockIdx.x * warps + warp; j < n; "
     "j += gridDim.x * warps) {\n",
     "  grid.sync();\n  wstamp(query ? 1 : 3);\n  for (int j = blockIdx.x * "
     "warps + warp; j < n; j += gridDim.x * warps) {\n"),
    ("        if (dirty == 2) grid.sync();\n        insert_rows(a, list, n, "
     "ceil, reinterpret_cast<uint32_t*>(gr_smem),\n                    "
     "scan);\n",
     f"        {s('other')}\n        if (dirty == 2) grid.sync();\n        "
     f"{s('write_wait')}\n        insert_rows(a, list, n, ceil, "
     "reinterpret_cast<uint32_t*>(gr_smem),\n                    scan);\n"
     f"        {s('insert')}\n"),
] + [e for e in SORT_STAMPS[3:] if "insert_rows" not in e[0]]

# the group design on banked tables (PR 18): the barriers after a table
# store are tables_barrier, the steps templates on the tables' view
BANKED_STAMPS = GROUP_STAMPS[:3] + [
    ("        if (dirty == 2) tables_barrier<Tab>(a, grid);\n        "
     "insert_rows<Tab>(",
     f"        {s('other')}\n        if (dirty == 2) tables_barrier<Tab>(a, "
     f"grid);\n        {s('write_wait')}\n        insert_rows<Tab>("),
    ("                         reinterpret_cast<uint32_t*>(gr_smem), scan);"
     "\n        dirty = 1;\n",
     "                         reinterpret_cast<uint32_t*>(gr_smem), scan);"
     f"\n        {s('insert')}\n        dirty = 1;\n"),
    SORT_STAMPS[3],
    ("      if (dirty) tables_barrier<Tab>(a, grid);\n      dirty = 0;\n      "
     "probe_rows<Tab>(a, tq,",
     f"      {s('other')}\n      if (dirty) tables_barrier<Tab>(a, grid);"
     f"\n      {s('write_wait')}\n      dirty = 0;\n      "
     "probe_rows<Tab>(a, tq,"),
    ("        if (dirty) tables_barrier<Tab>(a, grid);\n        dirty = 0;\n"
     "        probe_rows<Tab>(a, tf,",
     f"        {s('other')}\n        if (dirty) tables_barrier<Tab>(a, "
     f"grid);\n        {s('write_wait')}\n        dirty = 0;\n        "
     "probe_rows<Tab>(a, tf,"),
    ("      if (dirty) tables_barrier<Tab>(a, grid);\n      "
     "reset_tables<Tab>(a);\n",
     f"      {s('other')}\n      if (dirty) tables_barrier<Tab>(a, grid);\n"
     f"      {s('write_wait')}\n      reset_tables<Tab>(a);\n      "
     f"{s('reset')}\n"),
] + SORT_STAMPS[-2:]

# the rounds as shipped, and variants of them (timed beside it, held to
# its outputs)
GROUP_ROUNDS = {
    "cta256": [("constexpr int kWaveThreads = 512;\nconstexpr int "
                "kWaveBlocks = 1;\n", "constexpr int kWaveThreads = 256;\n"
                "constexpr int kWaveBlocks = 2;\n")],
}

DESIGNS = (("banked", GROUP_ADJ, BANKED_STAMPS, GROUP_ROUNDS),
           ("group", GROUP_ADJ, GROUP_STAMPS, GROUP_ROUNDS),
           ("sort", SORT_ADJ, SORT_STAMPS, {}))


def missing(src: str, edits):
    """The first edit's text that does not match the source once."""
    return next((old for old, _ in edits if src.count(old) != 1), None)


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"wavefront.cu: the source moved; no single "
                             f"match for {old!r}")
        src = src.replace(old, new, 1)
    return src


def design(src: str) -> tuple:
    """The (adjacency variants, stamp edits, rounds variants) of the
    source's design."""
    for _, adj, stamps, rounds in DESIGNS:
        edits = [e for v in (*adj.values(), *rounds.values()) for e in v]
        if missing(src, edits + stamps) is None:
            return adj, stamps, rounds
    _, adj, stamps, rounds = DESIGNS[0]
    old = missing(src, [e for v in (*adj.values(), *rounds.values())
                        for e in v] + stamps)
    raise SystemExit(f"wavefront.cu: the source moved; no single match for "
                     f"{old!r}")


def build(tree: str, kernels, variants: dict) -> dict:
    """Compile the tree's other sources once and every variant's
    wavefront.cu at once; returns name -> library path."""
    shutil.rmtree(OUT, ignore_errors=True)
    csrc = os.path.join(tree, "goldrush_tpu_torch", "csrc")
    with open(os.path.join(csrc, "wavefront.cu")) as f:
        src = f.read()
    nvcc = kernels.nvcc_path()
    flags = list(kernels.NVCC_FLAGS)
    common = os.path.join(OUT, "common")
    os.makedirs(common)
    procs, objs = {}, []
    for name in kernels.SOURCES:
        if name == "wavefront.cu":
            continue
        o = os.path.join(common, name + ".o")
        objs.append(o)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-c", os.path.join(csrc, name), "-o", o],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, edits in variants.items():
        d = os.path.join(OUT, name)
        os.makedirs(d)
        cu = os.path.join(d, "wavefront.cu")
        with open(cu, "w") as f:
            f.write(patched(src, edits))
        procs[name] = subprocess.Popen(
            [nvcc, "-Xptxas=-v", *flags, "-I", csrc, "-c", cu, "-o",
             os.path.join(d, "wavefront.o")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        if name in variants:
            regs = [ln.split(": ", 1)[-1].strip() for ln in err.splitlines()
                    if "registers" in ln]
            print(f"[build] {name}: " + " | ".join(regs), flush=True)
    libs = {}
    for name in variants:
        d = os.path.join(OUT, name)
        libs[name] = os.path.join(d, "lib.so")
        r = subprocess.run([nvcc, "-shared", *flags, "-o", libs[name],
                            os.path.join(d, "wavefront.o"), *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"link failed on {name}:\n{r.stderr}")
    return libs


def load(kernels, path: str) -> ctypes.CDLL:
    """The variant's library, bound as kernels.lib() binds the built one."""
    dll = ctypes.CDLL(path)
    for sym, args in kernels._SIGNATURES.items():
        fn = getattr(dll, sym)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    dll.gr_error_string.argtypes = [ctypes.c_int]
    dll.gr_error_string.restype = ctypes.c_char_p
    return dll


def order_histogram(gi, fp, limit: int, ranked: bool, B: int) -> str:
    """Groups by their number of distinct read orders (1, 2, ..., 8, >8),
    and the share of the window's keys in groups of two orders or more."""
    import torch
    from goldrush_tpu_torch.path import wavefront as wave
    ob = wave.ord_bits(B)
    conf = gi if ranked else gi & ((1 << wave.DIRECT_CONFLICT_BITS) - 1)
    keys = (((conf << wave.FP_BITS | fp) << ob)
            | torch.arange(B, device=gi.device)[:, None, None])[gi < limit]
    groups, per_group = torch.unique(keys >> ob, return_counts=True)
    orders = torch.unique(torch.unique(keys) >> ob, return_counts=True)[1]
    hist = torch.bincount(orders.clamp(max=9), minlength=10).tolist()[1:]
    multi = int(per_group[orders >= 2].sum())
    return (f"keys={keys.numel()} groups={groups.numel()} "
            + " ".join(f"orders{i + 1}={n}" for i, n in enumerate(hist[:8]))
            + f" orders_gt8={hist[8]} keys_in_multi={multi} "
            f"share_in_multi={multi / max(keys.numel(), 1):.4f}")


def main(argv: list[str]) -> int:
    tree = REPO
    if argv[:1] == ["--tree"] and len(argv) == 2:
        tree = os.path.abspath(argv[1])
    elif argv:
        raise SystemExit(__doc__)
    with open(os.path.join(tree, "goldrush_tpu_torch", "csrc",
                           "wavefront.cu")) as f:
        adj_variants, stamps, rounds_variants = design(f.read())
    # the tree's port, this checkout's chip_smoke.py (its 9(a) windows)
    sys.path.insert(0, tree)
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.ops.nthash import fingerprints
    from goldrush_tpu_torch.path import wavefront as wave
    if not torch.cuda.is_available():
        raise SystemExit("torch_port_wave_parts: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(f"[tree] {tree}", flush=True)
    variants = dict(adj_variants, stamps=stamps, **rounds_variants)
    libs = {n: load(kernels, p) for n, p in build(tree, kernels,
                                                   variants).items()}
    libs["stamps"].gr_wave_stamps.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)

    def use(name):
        kernels._lib = libs[name]
    use("full")

    _, reads = cs.bench_reads(dev)
    for mode, te, filt in cs.wave_filters(dev, reads):
        B, T = te.batch_reads, 20
        table = filt.ids if mode == "compressed" else filt.words
        side = torch.zeros_like(table)
        _, _, ranked, limit, _ = wave._filter_view(filt, te.size)
        scal = torch.tensor([0, 0, 1, 0], dtype=torch.int64, device=dev)
        for w, name in enumerate(cs.WAVE_WINDOWS):
            if name == "rotation":
                scal.copy_(torch.tensor([0, te.cfg.target_bases() - 1, 1, 0]))
            codes_d, grid, ok, gi, oi, nt, fl = cs.wave_inputs(te, reads, w,
                                                               name)
            tag = f"filter={mode} window={name}"
            fp = fingerprints(codes_d, te.fam_ins, T * te.cfg.tile_length,
                              te.params_ins.frame_stride, wave.FP_BITS)
            want = wave.wave_adjacency_plain(gi, fp, limit, ranked)
            print(f"[orders] {tag} " + order_histogram(gi, fp, limit, ranked,
                                                       B), flush=True)
            del fp

            def adjacency():
                return wave.wave_adjacency(te.wave_spec, gi, codes_d, limit,
                                           ranked, T)
            for v in adj_variants:
                use(v)
                got = adjacency()
                torch.cuda.synchronize()
                if v in ("full", "round512") and not torch.equal(got,
                                                                  want):
                    raise SystemExit(f"wave_adjacency differs from the plain "
                                     f"version: {tag}")
            times = {}
            for order in (1, -1):
                for v in list(adj_variants)[::order]:
                    use(v)
                    times.setdefault(v, []).append(cs.cuda_ms(adjacency, 5,
                                                              hold=4))
            for v, ms in times.items():
                print(f"[parts] kernel=wave_adjacency {tag} variant={v} ms="
                      + ",".join(f"{t:.4f}" for t in ms), flush=True)
            adj = want
            # the rounds: as shipped, stamped and each variant, in turns
            # from the same tables, each held to the first run's outputs
            saved = [t.clone() for t in filt] + [side.clone(), scal.clone()]
            rows = torch.empty((B, 8), dtype=torch.int64, device=dev)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            out = (ctypes.c_ulonglong * 8)()
            res, first = {}, None
            order = ["full", "stamps", *rounds_variants]
            for v in order + order[::-1]:
                use(v)
                for t, x in zip(list(filt) + [side, scal], saved):
                    t.copy_(x)
                if v == "stamps":
                    libs[v].gr_wave_stamps(ctypes.addressof(out))
                counters = wave.new_counters(dev)
                torch.cuda._sleep(1_000_000)
                start.record()
                wave.wave_window(te.wave_spec, filt, side, grid, ok, gi, oi,
                                 nt, fl, adj, scal, rows, counters, T)
                stop.record()
                torch.cuda.synchronize()
                res.setdefault(v, []).append(start.elapsed_time(stop))
                got = [rows.clone(), counters] + [t.clone() for t in filt] \
                    + [side.clone(), scal.clone()]
                if first is None:
                    first = got
                elif not all(torch.equal(x, y) for x, y in zip(got, first)):
                    raise SystemExit(f"wave_rounds variant {v} differs: {tag}")
                if v == "stamps":
                    libs[v].gr_wave_stamps(ctypes.addressof(out))
                    res.setdefault("steps", []).append(list(out))
            counts = dict(zip(wave.WAVE_COUNTS, counters.tolist()))
            print(f"[rounds] {tag} " + " ".join(
                f"{k}={n}" for k, n in counts.items()) + " " + " ".join(
                f"ms_{v}=" + ",".join(f"{t:.4f}" for t in res[v])
                for v in order), flush=True)
            for i, step in enumerate(STEPS):
                print(f"[parts] kernel=wave_rounds {tag} step={step} us="
                      + ",".join(f"{r[i] / 1e3:.1f}" for r in res["steps"]),
                      flush=True)
            del saved, adj, want
        del te, filt, side, table
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
