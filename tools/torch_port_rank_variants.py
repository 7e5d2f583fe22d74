"""rank_build (csrc/rank.cu), the freeze, in variants of its tile shape,
timed in turns on one GPU.

Each variant is the tree's rank.cu with two constants replaced (a copy in
smoke_work/rank_variants/, built alone with nvcc into a library of its
own): a CTA's threads (kBuildThreads) and its 16-byte copies a thread
(kBuildRows); the tile, 4 x rows x threads words staged in shared memory,
must divide a superblock's 2^27 words.

Every variant freezes the same synthetic bitmaps (chip_smoke.py's
synthetic_bitmap: a quarter of the bits set, a superblock fully set) at
142,368,384, 4,603,242,496 and 56,947,329,536 slots and must equal the
tree's own rank_build; each is timed with CUDA events (chip_smoke.py's
cuda_ms), in the order of VARIANTS and then back, beside the freeze's
bound and beside `bits.to(torch.int64)`, which moves the freeze's bytes
(4 read and 8 written a word) and nothing else: what this card gives a
kernel of that shape.  Prints the card and its power limit, then one
line per run.

    python3 tools/torch_port_rank_variants.py
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
WORK = os.path.join(REPO, "smoke_work", "rank_variants")
SIZES = ((142_368_384, 0), (4_603_242_496, 0), (56_947_329_536, 3))
# (name, threads, rows); the first is the tree's
VARIANTS = (("t128_r16", 128, 16),
            ("t64_r32", 64, 32),
            ("t128_r8", 128, 8),
            ("t256_r8", 256, 8))
ANCHORS = {
    "threads": "constexpr int kBuildThreads = 128;",
    "rows": "constexpr int kBuildRows = 16;                    // 16-byte "
            "copies a thread",
}


def variant_source(text: str, threads: int, rows: int) -> str:
    for key, anchor in ANCHORS.items():
        if text.count(anchor) != 1:
            raise SystemExit(f"rank.cu: the {key} anchor is not unique")
    text = text.replace(ANCHORS["threads"],
                        f"constexpr int kBuildThreads = {threads};")
    return text.replace(ANCHORS["rows"],
                        f"constexpr int kBuildRows = {rows};")


def build(name: str, *shape) -> ctypes.CDLL:
    from goldrush_tpu_torch import kernels
    d = os.path.join(WORK, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for h in kernels.HEADERS:
        shutil.copy(os.path.join(kernels.CSRC, h), d)
    with open(os.path.join(kernels.CSRC, "rank.cu")) as f:
        text = variant_source(f.read(), *shape)
    with open(os.path.join(d, "rank.cu"), "w") as f:
        f.write(text)
    so = os.path.join(d, "rank.so")
    r = subprocess.run([kernels.nvcc_path(), "-Xptxas=-v", *kernels.NVCC_FLAGS,
                        "-shared", "-o", so, os.path.join(d, "rank.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stderr}")
    regs = [ln.strip() for ln in r.stderr.splitlines() if "registers" in ln]
    print(f"[build] variant={name} {' '.join(regs)}", flush=True)
    lib = ctypes.CDLL(so)
    lib.gr_rank_build.argtypes = list(kernels._SIGNATURES["gr_rank_build"])
    lib.gr_rank_build.restype = ctypes.c_int
    return lib


def freeze_with(lib, tile_words: int):
    """A freeze through one variant's library: (bitrank, supers, pop)."""
    import torch
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.mibf import compressed as cz

    def run(bits, size):
        nw = bits.numel()
        dev = bits.device
        bitrank = torch.empty(nw + 1, dtype=torch.int64, device=dev)
        supers = torch.empty(cz.n_supers(size), dtype=torch.int64, device=dev)
        pop = torch.empty(1, dtype=torch.int64, device=dev)
        scratch = torch.zeros(-(-nw // tile_words) + 2, dtype=torch.int64,
                              device=dev)
        err = lib.gr_rank_build(
            kernels.ptr(bits), size, nw, kernels.ptr(bitrank),
            kernels.ptr(supers), kernels.ptr(pop), kernels.ptr(scratch),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if err:
            raise RuntimeError(f"rank_build variant: CUDA error {err}")
        return bitrank, supers, pop
    return run


def main() -> None:
    import torch
    from chip_smoke import (HBM_BYTES_PER_S, cuda_ms, freeze_bytes,
                            synthetic_bitmap)
    from goldrush_tpu_torch.mibf import compressed as cz

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_rank_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    runs = {name: freeze_with(build(name, *shape), 4 * shape[1] * shape[0])
            for name, *shape in VARIANTS}
    for size, full in SIZES:
        bits = synthetic_bitmap(dev, size, full, size % 1000)
        want = cz._build_rank_cuda(bits, size)
        bound = freeze_bytes(size) / HBM_BYTES_PER_S * 1e3
        order = [v[0] for v in VARIANTS]
        for name in order + order[::-1]:
            got = runs[name](bits, size)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            del got
            ms = cuda_ms(lambda: runs[name](bits, size), 5)
            print(f"[variant] name={name} slots={size} same={same} "
                  f"ms={ms:.4f} bound_ms={bound:.4f} "
                  f"bound_share={bound / ms:.3f}", flush=True)
            if not same:
                raise SystemExit(f"{name} differs from rank_build at {size}")
        widen = cuda_ms(lambda: bits.to(torch.int64), 5)
        print(f"[variant] name=widen_int64 slots={size} ms={widen:.4f} "
              f"bound_ms={bound:.4f} bound_share={bound / widen:.3f}",
              flush=True)
        del bits, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
