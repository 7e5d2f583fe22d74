"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, bound with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  The library lands in the git-ignored ``_build/``
directory next to this file, named by a hash of the sources and flags, so a
fresh checkout builds at first use and an unchanged one reuses its build.

Each kernel entry point is a ``Kernel``: calling it launches on PyTorch's
current stream, raises if the launch returns a CUDA error, and only then
adds one to its ``launches`` count.  An entry whose inputs leave nothing to
launch (an empty batch, an empty tile range) returns ``NO_LAUNCH`` and is
not counted.  Nothing here is imported or compiled
until a CUDA tensor reaches a wrapper, so CPU-only installs import freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
SOURCES = ("seed_hash.cu", "probe_vote.cu", "classify.cu",
           "insert_sorted.cu", "rank.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# the largest dynamic shared memory one block may use on Hopper
MAX_SMEM = 232_448
# what an entry returns when its inputs left nothing to launch (common.cuh)
NO_LAUNCH = -1

_lock = threading.Lock()
_lib = None

_P, _I, _U, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                  ctypes.c_int64)
# C signatures: every entry returns the cudaError_t of its launch, or
# NO_LAUNCH
_SIGNATURES = {
    "gr_seed_hash_grid": (_P, _L, _L, _P, _P, _I, _I, _L, _I, _P, _P, _P),
    "gr_seed_hash_fill": (_P, _L, _L, _P, _P, _L, _I, _P, _P),
    "gr_probe_vote": (_P, _P, _I, _L, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "gr_classify": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "gr_insert_sorted": (_P, _P, _P, _I, _L, _I, _L, _U, _I, _I, _U, _I,
                         _I, _P, _I, _P),
    "gr_rank_pack": (_P, _L, _L, _P, _P, _P),
    "gr_rank_carry": (_P, _P, _L, _P, _P),
    "gr_rank_lookup": (_P, _L, _P, _L, _L, _P, _P),
}


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, the standard toolkit location, or PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of goldrush_tpu_torch cannot be built")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"gr_kernels-{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels unless a build of these exact sources exists.
    Returns the library path; raises with nvcc's output on failure."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        if verbose:
            print(r.stderr, end="")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            dll = ctypes.CDLL(build())
            for sym, args in _SIGNATURES.items():
                fn = getattr(dll, sym)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            dll.gr_error_string.argtypes = [ctypes.c_int]
            dll.gr_error_string.restype = ctypes.c_char_p
            _lib = dll
        return _lib


class Kernel:
    """One kernel entry point and its launch count."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.source = source          # path of its CUDA source in the repo
        self.replaces = replaces      # the Pallas kernel and/or JAX
                                      # function it replaces (file:line)
        self.launches = 0

    def __call__(self, device: torch.device, *args) -> bool:
        """Launch; True if a kernel ran, False if the inputs were empty."""
        dll = lib()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(dll, self.symbol)(*args, _P(stream))
        if err == NO_LAUNCH:
            return False
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed: "
                               f"{dll.gr_error_string(err).decode()}")
        self.launches += 1
        return True


SEED_HASH_GRID = Kernel(
    "seed_hash_grid", "gr_seed_hash_grid",
    "goldrush_tpu_torch/csrc/seed_hash.cu",
    "goldrush_tpu/mibf/mibf.py:158")
SEED_HASH_FILL = Kernel(
    "seed_hash_fill", "gr_seed_hash_fill",
    "goldrush_tpu_torch/csrc/seed_hash.cu",
    "goldrush_tpu/mibf/mibf.py:122")
PROBE_VOTE = Kernel(
    "probe_vote", "gr_probe_vote",
    "goldrush_tpu_torch/csrc/probe_vote.cu",
    "tools/probe_pallas.py:100; goldrush_tpu/mibf/mibf.py:361")
CLASSIFY = Kernel(
    "classify", "gr_classify",
    "goldrush_tpu_torch/csrc/classify.cu",
    "goldrush_tpu/path/classify.py:77")
INSERT_SORTED = Kernel(
    "insert_sorted", "gr_insert_sorted",
    "goldrush_tpu_torch/csrc/insert_sorted.cu",
    "goldrush_tpu/mibf/mibf.py:540")
RANK_PACK = Kernel(
    "rank_pack", "gr_rank_pack", "goldrush_tpu_torch/csrc/rank.cu",
    "tools/probe_pallas.py:82; goldrush_tpu/mibf/compressed.py:132")
RANK_CARRY = Kernel(
    "rank_carry", "gr_rank_carry", "goldrush_tpu_torch/csrc/rank.cu",
    "tools/probe_pallas.py:128; goldrush_tpu/mibf/compressed.py:153")
RANK_LOOKUP = Kernel(
    "rank_lookup", "gr_rank_lookup", "goldrush_tpu_torch/csrc/rank.cu",
    "tools/probe_pallas.py:61; goldrush_tpu/mibf/compressed.py:218")
ALL = (SEED_HASH_GRID, SEED_HASH_FILL, PROBE_VOTE, CLASSIFY, INSERT_SORTED,
       RANK_PACK, RANK_CARRY, RANK_LOOKUP)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return _P(0 if t is None else t.data_ptr())


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple | None = None, device: torch.device | None = None
          ) -> None:
    """Validate a kernel argument: CUDA, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())
