"""Kernel A's pass-1 fill, two designs timed in turns on one GPU.

  bitmap  this tree's design: each batch sets bits in a ceil(size / 32)-word
          presence bitmap (17.8 MB at the bench sizing, L2-resident), and
          one merge writes every word from it after the last batch (the
          words' first write, as the direct filter's pass 1 does);
  direct  the same kernel with its reduction aimed at the words themselves
          (PRESENT into words[slot], 570 MB): built from a copy of csrc/ in
          which that one line is replaced, into smoke_work/.

Both run a fill pass of the bench dataset's shape (chip_smoke.py's
fill_pass_batches: 47 batches of 64 x 32,768), the direct design into a
zeroed filter, in the order bitmap, direct, direct, bitmap, and must leave
the same words.
Prints the card and its power limit, then one line per run.

    python3 tools/torch_port_fill_designs.py
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
WORK = os.path.join(REPO, "smoke_work", "fill_designs")
BITMAP_LINE = "atomicOr(bits + (slot >> 5), 1u << (slot & 31u));"
DIRECT_LINE = "atomicOr(bits + slot, kPresent);"


def build_direct() -> ctypes.CDLL:
    """The kernels with the fill's reduction aimed at the words."""
    from goldrush_tpu_torch import kernels
    shutil.rmtree(WORK, ignore_errors=True)
    shutil.copytree(kernels.CSRC, os.path.join(WORK, "csrc"))
    src = os.path.join(WORK, "csrc", "seed_hash.cu")
    with open(src) as f:
        text = f.read()
    if text.count(BITMAP_LINE) != 1:
        raise SystemExit("the fill's bitmap reduction line is not unique")
    with open(src, "w") as f:
        f.write(text.replace(BITMAP_LINE, DIRECT_LINE))
    so = os.path.join(WORK, "direct.so")
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", so,
                    *(os.path.join(WORK, "csrc", s) for s in kernels.SOURCES)],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.gr_seed_hash_fill.argtypes = list(
        kernels._SIGNATURES["gr_seed_hash_fill"])
    lib.gr_seed_hash_fill.restype = ctypes.c_int
    return lib


def main() -> None:
    import torch
    from chip_smoke import cuda_ms, fill_pass_batches
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import calc_optimal_size
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.ops.nthash import build_seed_family
    from goldrush_tpu_torch.ops.seeds import make_seed_pattern

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_fill_designs: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    fam = build_seed_family(make_seed_pattern("1011011110110111101101", 22,
                                              16, 3))
    size = calc_optimal_size(15_000_000, 1, 0.1)
    alloc = -(-(size + 1) // 1024) * 1024
    batches = fill_pass_batches(dev)
    direct = build_direct()
    kernels.lib()
    words = dict(bitmap=torch.empty(alloc, dtype=torch.int32, device=dev),
                 direct=torch.zeros(alloc, dtype=torch.int32, device=dev))

    def bitmap_pass():
        bits = dm.presence_bitmap(size, dev)
        for codes, lengths in batches:
            dm.fill_presence_bits(bits, codes, lengths, fam, size)
        dm.merge_presence(words["bitmap"], bits, size, first_write=True)

    def direct_pass():
        stream = torch.cuda.current_stream(dev).cuda_stream
        for codes, lengths in batches:
            err = direct.gr_seed_hash_fill(
                kernels.ptr(codes), *codes.shape, kernels.ptr(lengths),
                *dm._family_args(fam, dev), size, 0,
                kernels.ptr(words["direct"]), ctypes.c_void_p(stream))
            if err != 0:
                raise RuntimeError(f"direct fill: CUDA error {err}")

    try:
        for name, fn in (("bitmap", bitmap_pass), ("direct", direct_pass),
                         ("direct", direct_pass), ("bitmap", bitmap_pass)):
            ms = cuda_ms(fn, 5, hold=40)
            print(f"design={name} batches={len(batches)} fill_pass_ms={ms:.4f}",
                  flush=True)
        if not torch.equal(words["bitmap"], words["direct"]):
            raise AssertionError("the two designs filled different words")
        print(f"same_words=True present={int((words['direct'] != 0).sum())}")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    main()
