"""Where a K20 launch's time goes (minimizer_keys), on one GPU.

Builds variants of a tree's csrc/minimizers.cu (this checkout's, or with
--tree DIR another checkout's, such as the parent's from `git archive`),
each with one part of the kernel's work taken out, into
smoke_work/minimizer_parts/<variant>/ (one nvcc per variant, all at once;
each is a library of its own with the same C entry point), then times
every variant on chip_smoke.py's K20 inputs (32 x 32,768 codes at (k, w) =
(15, 10), (40, 250) and (32, 1,000)), in turns (every variant once, then
again in the reverse order).  A variant keeps its work alive by folding
what it would have stored into one value that it stores only if it equals
a constant no input gives.

    python3 tools/torch_port_minimizer_parts.py [--tree DIR]

The variants are those of the source's design, whichever design's edits
all match the source once; otherwise the tool stops with the text of the
newest design that it missed.  The scan design (a prefix-XOR scan of the
tile's codes, a van Herk/Gil-Werman window minimum):
  full    the kernel as shipped;
  stage   the tile's codes loaded, then the CTA stops;
  scan    and the prefix-XOR scan into shared memory;
  hash    and every position's hash: no store, no window minimum;
  runs    and the runs' (segment seen, min) pairs scanned across each warp
          (the hashes in shared memory for their stores): no store;
  min     and the window minimum: no store of hashes or keys;
  store   the stores alone (each position's index as its hash and key):
          no codes, no hash, no minimum;
  bounds2 the kernel compiled for 512 threads an SM (more registers a
          thread) instead of 768;
  codes2048, codes4096  the kernel with that many codes a CTA at every
          (k, w).
The rolling design (one thread per run of 16 positions, log-doubling):
  full; stage; hash (the hashes in shared memory, no store, no minimum);
  min (and the doubling passes, no store); store (as above).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "smoke_work", "minimizer_parts")
MAGIC = "0x9E3779B97F4A7C15ull"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared")
SHAPES = ((15, 10), (40, 250), (32, 1000))


def stop_before(anchor: str, fold: str, keys: str = "a.keys") -> tuple:
    """End the kernel before `anchor`, keeping `fold` alive."""
    return (anchor, f"  if ({fold}) {keys}[0] = 1;\n  return;\n" + anchor)


# the scan design (csrc/minimizers.cu since the redesign)
S_HSTORE = ("  store_pairs<kThreads>(a.hashes + hb, n_own,\n                  "
            "      [&](int j) { return pre[idx(j + off)]; });\n", "")
S_KSTORE = ("  store_pairs<kThreads>(a.keys + kb, n_win, [&](int i) {\n"
            "    return umin(suf[idx(i + off)], pre[idx(i + off + w - 1)]);\n"
            "  });\n",
            "  uint64_t fold = 0;\n"
            "  for (int i = tid; i < n_win; i += kThreads)\n"
            "    fold ^= umin(suf[idx(i + off)], pre[idx(i + off + w - 1)]);\n"
            f"  if (fold == {MAGIC}) a.keys[0] = 1;\n")
S_CODES = ("inline int min_codes(int k, int w) { return k + w <= 512 ? 2048 "
           ": 4096; }\n")
S_BOUNDS = "__launch_bounds__(kThreads, 768 / kThreads)"


def codes(n: int) -> list:
    """The kernel with n codes a CTA at every (k, w)."""
    return [(S_CODES, f"inline int min_codes(int k, int w) {{ return {n}; }}"
             "\n")]


SCAN_VARIANTS = {
    "full": [],
    "stage": [stop_before(
        "  // each entry's XOR within its run, then the runs' carries\n",
        "(cw[0] ^ cw[3]) == 0xA5A5A5A5u")],
    "scan": [stop_before("  // each thread's positions: ",
                         f"(loc[tid].x ^ loc[tid].y) == {MAGIC}")],
    "hash": [stop_before("  // the window minimum: ",
                         f"(h[0] ^ h[1] ^ h[2] ^ h[3] ^ h[4] ^ h[5] ^ h[6] ^ "
                         f"h[7] ^ h[8] ^ h[9] ^ h[10] ^ h[11] ^ h[12] ^ h[13] "
                         f"^ h[14] ^ h[15]) == {MAGIC}")],
    "runs": [stop_before("  // the hashes this tile owns: ",
                         f"(pc ^ sc ^ pcs ^ scs) == {MAGIC}")],
    "min": [S_HSTORE, S_KSTORE],
    "store": [("  // the scan: ",
               "  store_pairs<kThreads>(a.hashes + b * a.P + t0, n_own,\n"
               "                        [&](int j) { return t0 + j; });\n"
               "  store_pairs<kThreads>(a.keys + b * a.nw + t0, n_win,\n"
               "                        [&](int i) { return t0 + i; });\n"
               "  return;\n  // the scan: ")],
    "bounds2": [(S_BOUNDS, "__launch_bounds__(kThreads, 512 / kThreads)")],
    "codes2048": codes(2048),
    "codes4096": codes(4096),
}

# the rolling design (its first form: one thread per run of kRun positions)
R_HSTORE = ("  for (int i = threadIdx.x; i < owned; i += blockDim.x) {\n"
            "    hrow[i] = static_cast<int64_t>(buf_a[i]);\n  }\n", "")
R_KSTORE = ("  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {\n"
            "    krow[i] = static_cast<int64_t>(umin(m[i], m[i + w - p]));\n"
            "  }\n",
            "  uint64_t acc = 0;\n"
            "  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {\n"
            "    acc ^= umin(m[i], m[i + w - p]);\n  }\n"
            f"  if (acc == {MAGIC}) krow[0] = 1;\n")
ROLL_VARIANTS = {
    "full": [],
    "stage": [stop_before(
        "  for (int r0 = threadIdx.x * kRun; r0 < n; r0 += blockDim.x * kRun)"
        " {\n", "(sc[threadIdx.x] ^ sc[n_codes - 1]) == 0xA5", "keys")],
    "hash": [stop_before(
        "  // the hashes this tile owns: its kTile positions, or all up to P "
        "in the\n", f"buf_a[threadIdx.x] == {MAGIC}", "keys")],
    "min": [R_HSTORE, R_KSTORE],
    "store": [("  const uint8_t* row = codes + b * L;\n",
               "  {\n    const int owned_ = t0 + kTile >= nw ? n : kTile;\n"
               "    for (int i = threadIdx.x; i < owned_; i += blockDim.x)\n"
               "      hashes[b * P + t0 + i] = t0 + i;\n"
               "    const int n_out_ = static_cast<int>(min64(kTile, "
               "nw - t0));\n"
               "    for (int i = threadIdx.x; i < n_out_; i += blockDim.x)\n"
               "      keys[b * nw + t0 + i] = t0 + i;\n    return;\n  }\n"
               "  const uint8_t* row = codes + b * L;\n")],
}
DESIGNS = (SCAN_VARIANTS, ROLL_VARIANTS)
# the variants that compute the whole function, held to the plain version
WHOLE = ("full", "bounds2", "codes2048", "codes4096")


def missing(src: str, edits):
    """The first edit's text that does not match the source once."""
    return next((old for old, _ in edits if src.count(old) != 1), None)


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"minimizers.cu: the source moved; no single "
                             f"match for {old!r}")
        src = src.replace(old, new, 1)
    return src


def design(src: str) -> dict:
    """The variants of the source's design."""
    for variants in DESIGNS:
        if all(missing(src, e) is None for e in variants.values()):
            return variants
    old = missing(src, [e for edits in SCAN_VARIANTS.values() for e in edits])
    raise SystemExit(f"minimizers.cu: the source moved; no single match for "
                     f"{old!r}")


def build(csrc: str, variants: dict) -> dict:
    """Compile every variant at once; returns name -> library path."""
    shutil.rmtree(OUT, ignore_errors=True)
    with open(os.path.join(csrc, "minimizers.cu")) as f:
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
        with open(os.path.join(d, "minimizers.cu"), "w") as f:
            f.write(patched(src, edits))
        libs[name] = os.path.join(d, "libmin.so")
        procs[name] = subprocess.Popen(
            [nvcc, "-Xptxas=-v", *FLAGS, os.path.join(d, "minimizers.cu"),
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
    with open(os.path.join(csrc, "minimizers.cu")) as f:
        variants = design(f.read())
    sys.path.insert(0, REPO)
    import torch
    import chip_smoke as cs
    from goldrush_tpu_torch import hard_cases as hard
    from goldrush_tpu_torch.ops import minimizers as tmin
    if not torch.cuda.is_available():
        raise SystemExit("torch_port_minimizer_parts: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(f"[tree] {tree}")
    libs = build(csrc, variants)
    dev = torch.device("cuda", 0)
    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fns = {}
    for name, path in libs.items():
        dll = ctypes.CDLL(path)
        dll.gr_minimizer_keys.argtypes = [P_, I_, L_, L_, I_, I_, P_, P_, P_]
        fns[name] = dll

    W = 32_768
    inputs = {}
    for k, w in SHAPES:
        codes, _ = hard.stage_codes(hard.minimizer_lengths(k, w, W, 32), W,
                                    seed=k + w, n_frac=0.01)
        c = torch.from_numpy(codes).to(dev)
        P = W - k + 1
        keys = torch.empty((32, P - w + 1), dtype=torch.int64, device=dev)
        hashes = torch.empty((32, P), dtype=torch.int64, device=dev)
        inputs[(k, w)] = (c, P, keys, hashes)

    def launch(name, k, w):
        c, P, keys, hashes = inputs[(k, w)]

        def go():
            err = fns[name].gr_minimizer_keys(
                ctypes.c_void_p(c.data_ptr()), c.shape[0], c.shape[1], P, k,
                w, ctypes.c_void_p(keys.data_ptr()),
                ctypes.c_void_p(hashes.data_ptr()),
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
            if err != 0:
                raise SystemExit(f"{name}: gr_minimizer_keys returned {err}")
        return go

    for k, w in SHAPES:
        c, P, keys, hashes = inputs[(k, w)]
        want = tmin._minimizer_keys_plain(c, k, w, P)
        for name in variants:
            if name not in WHOLE:
                continue
            launch(name, k, w)()
            torch.cuda.synchronize()
            if not (torch.equal(keys, want[0])
                    and torch.equal(hashes, want[1])):
                raise SystemExit(f"{name} differs from the plain version at "
                                 f"(k, w) = ({k}, {w})")
    times = {}
    for order in (1, -1):
        for name in list(variants)[::order]:
            for k, w in SHAPES:
                times.setdefault((k, w, name), []).append(
                    cs.cuda_ms(launch(name, k, w), 20))
    for (k, w, name), ms in times.items():
        print(f"[parts] kernel=minimizer_keys k={k} w={w} variant={name} ms="
              + ",".join(f"{t:.4f}" for t in ms))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
