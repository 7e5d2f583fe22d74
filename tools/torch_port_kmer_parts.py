"""Where a K21 launch's time goes (kmer_query, kmer_count), on one GPU.

Builds variants of a tree's csrc/kmer_count.cu (this checkout's, or with
--tree DIR another checkout's, such as the parent's from `git archive`),
each with one part of the kernel's work taken out, into
smoke_work/kmer_parts/<variant>/ (one nvcc per variant, all at once; each
is a library of its own with the same C entry points), then times every
variant on chip_smoke.py's K21 inputs at k = 32:
the query of 40,000 candidate windows of width 2k + 2 and of one 1 Mbp
contig row, the count of 64 x 32,768 reads and of a homopolymer batch, in
turns (every variant once, then again in the reverse order).  A variant
keeps its work alive by folding what it would have stored into one value
that it stores only if it equals a constant no input gives.

    python3 tools/torch_port_kmer_parts.py [--tree DIR]

The variants are those of the source's design: the prefix-XOR scan (its
scan in nthash_scan.cuh, or, as first written, inline), or the rolling
hash with one thread per run of 16 positions that the scan replaced,
whichever design's edits all match the source once; otherwise the tool
stops with the text of the scan design it missed.  The scan
design:
  full      the kernel as shipped;
  stage     the tile's geometry and its threads' codes loaded, then the
            CTA stops;
  scan      and the prefix-XOR scan of S and R into shared memory;
  hash      and every output's hash and slot: no gather and no store
            (query), no __match_any_sync and no atomic (count);
  gather    the query's gathers, no store;
  store     the query's stores of the output index alone: no staging, no
            scan, no hash;
  match     the count's grouping of lanes and held counts, no atomic;
  match_always  the count with __match_any_sync on every step (the
            grouping runs it only where two neighbouring lanes share a
            slot).
The rolling design: full; hash (the hashes and slots: no gather and no
store, no match and no atomic); gather; store (the query's stores of the
position alone, no hash); match (the count's __match_any_sync, no atomic).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "smoke_work", "kmer_parts")
MAGIC = "0x9E3779B97F4A7C15ull"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared")

Q_OUT = ("      unsigned got[kKmerChunk];\n#pragma unroll\n"
         "      for (int q = 0; q < kKmerChunk; ++q)\n"
         "        if (valid[q]) got[q] = __ldg(a.counts + slot[q]);\n"
         "#pragma unroll\n      for (int q = 0; q < kKmerChunk; ++q)\n"
         "        if (valid[q]) a.out[o0 + tid + (q0 + q) * kKmerThreads] = "
         "got[q];\n")
C_HELD = ("  unsigned held = 0, n_held = 0;",
          "  unsigned held = 0, n_held = 0, fold = 0;")
C_INNER = ("            if (n_held) atomicAdd(a.counts + held, n_held);\n",
           "            fold ^= held + n_held;\n")
C_LAST = ("  if constexpr (kCount) {\n"
          "    if (n_held) atomicAdd(a.counts + held, n_held);\n  }\n",
          "  if constexpr (kCount) {\n    fold ^= held + n_held;\n"
          "    if (fold == 0x9E3779B9u) a.counts[0] = fold;\n  }\n")
C_PEERS = ("        unsigned peers = 1u << lane;\n"
           "        if (repeat) peers = __match_any_sync(kFull, key);\n")


def fold_out(what: str) -> tuple:
    """The query's gathers and stores replaced by a fold of `what`."""
    return (Q_OUT, "      unsigned acc = 0;\n"
            "      for (int q = 0; q < kKmerChunk; ++q)\n"
            f"        if (valid[q]) acc ^= {what};\n"
            "      if (acc == 0x9E3779B9u) a.out[0] = acc;\n")


def stop_before(anchor: str, fold: str) -> tuple:
    """End the kernel before `anchor`, keeping `fold` alive."""
    return (anchor, f"  if ({fold}) a.counts[0] = 1;\n  return;\n" + anchor)


VARIANTS = {
    "full": [],
    "stage": [stop_before("  uint64_t inc_s[kKmerRun], inc_r[kKmerRun];\n",
                          "(cw.x ^ cw.y) == 0x9E3779B9u")],
    "scan": [stop_before(
        "  // one lane per output, a chunk of kKmerChunk a thread at a time: "
        "its\n", f"(sr[tid].x ^ sr[tid].y) == {MAGIC}")],
    "hash": [fold_out("slot[q]"), C_HELD, C_INNER, C_LAST,
             (C_PEERS, "        const unsigned peers = 1u << lane;\n")],
    "gather": [fold_out("__ldg(a.counts + slot[q])")],
    "store": [("  const int n_out = static_cast<int>(min64(a.W, a.total - "
               "o0));\n",
               "  const int n_out = static_cast<int>(min64(a.W, a.total - "
               "o0));\n  if constexpr (!kCount) {\n"
               "    for (int i = tid; i < n_out; i += kKmerThreads)\n"
               "      a.out[o0 + i] = i;\n    return;\n  }\n")],
    "match": [C_HELD, C_INNER, C_LAST],
    "match_always": [(C_PEERS, "        const unsigned peers = "
                               "__match_any_sync(kFull, key);\n")],
}
QUERY_VARIANTS = ("full", "stage", "scan", "hash", "gather", "store")
COUNT_VARIANTS = ("full", "stage", "scan", "hash", "match", "match_always")

# the rolling design (one thread per run of kKmerRun positions)
R_DECL = ("  for (int64_t p = rr.p0;; ++p) {\n",
          "  uint64_t acc = 0;\n  for (int64_t p = rr.p0;; ++p) {\n")
R_TAIL = ("    h.roll(row[p] & 3u, row[p + k] & 3u);\n  }\n}\n",
          "    h.roll(row[p] & 3u, row[p + k] & 3u);\n  }\n"
          f"  if (acc == {MAGIC}) out[gid] = 1;\n}}\n")
R_STORE = "    out[rr.b * P + p] = counts[slot];\n"
R_CDECL = ("  for (int q = 0; q < kKmerRun; ++q) {\n",
           "  unsigned acc = 0;\n  for (int q = 0; q < kKmerRun; ++q) {\n")
R_ATOMIC = ("    const unsigned peers = __match_any_sync(kFull, slot);\n"
            "    if (valid && lane == static_cast<unsigned>(__ffs(peers) - 1)"
            ") {\n      atomicAdd(counts + slot, static_cast<unsigned>("
            "__popc(peers)));\n    }\n  }\n}\n")
R_FOLD = "  }\n  if (acc == 0x9E3779B9u) counts[0] += 1;\n}\n"
ROLL_VARIANTS = {
    "full": [],
    "hash": [R_DECL, R_TAIL, (R_STORE, "    acc ^= slot;\n"),
             R_CDECL, (R_ATOMIC, "    acc ^= slot;\n" + R_FOLD)],
    "gather": [R_DECL, R_TAIL, (R_STORE, "    acc ^= counts[slot];\n")],
    "store": [("  NtRoll h(k);\n  h.init([&](unsigned j) { return "
               "row[rr.p0 + j] & 3u; });\n  for (int64_t p = rr.p0;; ++p) {\n"
               "    const uint64_t slot = __umul64hi(h.canonical(), size);\n"
               + R_STORE,
               "  for (int64_t p = rr.p0;; ++p) {\n"
               "    out[rr.b * P + p] = static_cast<unsigned>(p);\n"),
              ("    if (p + 1 >= end) break;\n"
               "    h.roll(row[p] & 3u, row[p + k] & 3u);\n",
               "    if (p + 1 >= end) break;\n")],
    "match": [R_CDECL, (R_ATOMIC,
                        "    const unsigned peers = __match_any_sync(kFull, "
                        "slot);\n    acc ^= peers;\n" + R_FOLD)],
}
# the same design with its scan in nthash_scan.cuh (shared with K20)
SHARED_VARIANTS = dict(VARIANTS, stage=[stop_before(
    "  nt_prefix_scan<kKmerRun, kKmerThreads>(cw, sr, wsum);\n",
    "(cw[0] ^ cw[1]) == 0x9E3779B9u")])
DESIGNS = ((SHARED_VARIANTS, QUERY_VARIANTS, COUNT_VARIANTS),
           (VARIANTS, QUERY_VARIANTS, COUNT_VARIANTS),
           (ROLL_VARIANTS, ("full", "hash", "gather", "store"),
            ("full", "hash", "match")))


def missing(src: str, edits):
    """The first edit's text that does not match the source once."""
    return next((old for old, _ in edits if src.count(old) != 1), None)


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"kmer_count.cu: the source moved; no single "
                             f"match for {old!r}")
        src = src.replace(old, new, 1)
    return src


def design(src: str) -> tuple:
    """(variants, query variants, count variants) of the source's design."""
    for variants, query, count in DESIGNS:
        if all(missing(src, e) is None for e in variants.values()):
            return variants, query, count
    old = missing(src, [e for edits in SHARED_VARIANTS.values()
                        for e in edits])
    raise SystemExit(f"kmer_count.cu: the source moved; no single match for "
                     f"{old!r}")


def build(csrc: str, variants: dict) -> dict:
    """Compile every variant at once; returns name -> library path."""
    shutil.rmtree(OUT, ignore_errors=True)
    with open(os.path.join(csrc, "kmer_count.cu")) as f:
        src = f.read()
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    procs, libs = {}, {}
    for name, edits in variants.items():
        d = os.path.join(OUT, name)
        os.makedirs(d)
        for h in os.listdir(csrc):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, h), d)
        with open(os.path.join(d, "kmer_count.cu"), "w") as f:
            f.write(patched(src, edits))
        libs[name] = os.path.join(d, "libkmer.so")
        procs[name] = subprocess.Popen(
            [nvcc, "-Xptxas=-v", *FLAGS, os.path.join(d, "kmer_count.cu"),
             "-o", libs[name]], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{err}")
        regs = [ln.strip() for ln in err.splitlines() if "registers" in ln]
        print(f"[build] {name}: " + " | ".join(regs))
    return libs


def main(argv: list[str]) -> int:
    tree = REPO
    if argv[:1] == ["--tree"] and len(argv) == 2:
        tree = os.path.abspath(argv[1])
    elif argv:
        raise SystemExit(__doc__)
    csrc = os.path.join(tree, "goldrush_tpu_torch", "csrc")
    with open(os.path.join(csrc, "kmer_count.cu")) as f:
        variants, query_variants, count_variants = design(f.read())
    sys.path.insert(0, REPO)
    import torch
    import chip_smoke as cs
    from goldrush_tpu_torch import hard_cases as hard
    from goldrush_tpu_torch.stages import polish as tpol
    if not torch.cuda.is_available():
        raise SystemExit("torch_port_kmer_parts: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(f"[tree] {tree}")
    libs = build(csrc, variants)
    dev = torch.device("cuda", 0)
    P_, I_, L_, Q_ = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_uint64)
    fns = {}
    for name, path in libs.items():
        dll = ctypes.CDLL(path)
        dll.gr_kmer_count.argtypes = [P_, I_, L_, P_, I_, Q_, P_, P_]
        dll.gr_kmer_query.argtypes = [P_, I_, L_, I_, Q_, P_, P_, P_]
        fns[name] = dll

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    k, size, W = 32, (1 << 22) | 1, 32_768
    codes, lens = hard.stage_codes([W] * 64, W, seed=11)
    reads = (torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev))
    homo = (torch.full((64, W), 2, dtype=torch.uint8, device=dev), reads[1])
    contig, _ = hard.stage_codes([1_000_000], 1_000_000, seed=12)
    table = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    tpol._count_kmers_plain(table, *reads, k, size)
    cand = torch.from_numpy(hard.candidate_windows(contig[0], 40_000, k,
                                                   seed=k)[0]).to(dev)
    row = torch.from_numpy(contig).to(dev)
    want = {n: table[tpol._slots_plain(c, k, size)]
            for n, c in (("windows", cand), ("row", row))}
    scratch = table.clone()

    def query(name, c):
        out = torch.empty((c.shape[0], c.shape[1] - k + 1),
                          dtype=torch.int32, device=dev)

        def go():
            err = fns[name].gr_kmer_query(ptr(c), c.shape[0], c.shape[1], k,
                                          size, ptr(table), ptr(out),
                                          stream())
            if err != 0:
                raise SystemExit(f"{name}: gr_kmer_query returned {err}")
        return go, out

    def count(name, batch):
        c, n = batch

        def go():
            err = fns[name].gr_kmer_count(ptr(c), c.shape[0], c.shape[1],
                                          ptr(n), k, size, ptr(scratch),
                                          stream())
            if err != 0:
                raise SystemExit(f"{name}: gr_kmer_count returned {err}")
        return go

    go, out = query("full", cand)
    go()
    torch.cuda.synchronize()
    assert torch.equal(out, want["windows"]), "full query differs"
    times = {}
    for order in (1, -1):
        for name in query_variants[::order]:
            for tag, c in (("windows", cand), ("row", row)):
                fn = query(name, c)[0]
                times.setdefault(("kmer_query", tag, name), []).append(
                    cs.cuda_ms(fn, 20))
        for name in count_variants[::order]:
            for tag, b in (("reads", reads), ("homopolymer", homo)):
                times.setdefault(("kmer_count", tag, name), []).append(
                    cs.cuda_ms(count(name, b), 20))
    for (kernel, tag, name), ms in times.items():
        print(f"[parts] kernel={kernel} input={tag} variant={name} ms="
              + ",".join(f"{t:.4f}" for t in ms))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
