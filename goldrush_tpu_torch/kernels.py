"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled by ``nvcc`` for ``sm_90a``, one process per source
and all at once, and linked into one shared library with a plain C
interface, bound with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The library lands in the git-ignored ``_build/``
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
           "insert_sorted.cu", "insert_max.cu", "rank.cu", "minimizers.cu",
           "kmer_count.cu", "consume.cu", "ntcard.cu", "wavefront.cu")
HEADERS = ("common.cuh", "probe_vote.cuh", "classify.cuh", "insert.cuh",
           "seed_hash.cuh", "nthash_scan.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# what an entry returns when its inputs left nothing to launch (common.cuh)
NO_LAUNCH = -1

_lock = threading.Lock()
_lib = None

_P, _I, _U, _L, _Q = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                      ctypes.c_int64, ctypes.c_uint64)
_PP = ctypes.POINTER(ctypes.c_void_p)
# a filter's bank view (csrc/common.cuh make_banks, ``banks_args``): the
# table's and the counters' bank pointers (or the wavefront's id table's
# and side table's), their number, the entries of a bank, and whether a
# bank lies on another card
_BANKS = (_PP, _PP, _I, _L, _I)
# C signatures: every entry returns the cudaError_t of its launch, or
# NO_LAUNCH
_SIGNATURES = {
    "gr_seed_hash_grid": (_P, _L, _L, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                          _I, _I, _I, _I, _L, _I, _P, _P, _P, _P, _I, _I,
                          _P),
    "gr_seed_hash_fill": (_P, _L, _L, _P, _P, _I, _I, _I, _I, _I, _I,
                          _L, _I, _P, _P),
    "gr_seed_hash_rank_grid": (_P, _L, _L, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P, _I, _I, _I, _I, _L, _I, _P, _P, _L, _L,
                               _P, _P, _P, _P, _I, _I, _P),
    "gr_presence_merge": (_P, _L, _P, _L, _I, _P),
    "gr_probe_vote": (*_BANKS, _P, _I, _L, _P, _I, _I, _I, _I, _I, _I, _I,
                      _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "gr_classify": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "gr_row_cummax": (_P, _I, _I, _P, _P),
    "gr_insert_sorted": (*_BANKS, _P, _P, _P, _I, _L, _I, _L, _I, _L, _U,
                         _U, _I, _I, _U, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "gr_insert_batch": (*_BANKS, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _L, _U, _U, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                        _P, _P),
    "gr_insert_max": (*_BANKS, _P, _I, _L, _I, _L, _U, _I, _I, _U, _I, _I,
                      _P),
    "gr_rank_build": (_P, _L, _L, _P, _P, _P, _P),
    "gr_minimizer_keys": (_P, _I, _L, _L, _I, _I, _P, _P),
    "gr_kmer_count": (_P, _I, _L, _P, _I, _Q, _P),
    "gr_kmer_query": (_P, _I, _L, _I, _Q, _P, _P),
    "gr_consume": (*_BANKS, _I, _L, _L, _U, _P, _P, _I, _I, _P, _P, _I,
                   _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _I, _I, _I, _I, _L, _L, _I, _I, _I, _P, _P, _P,
                   _P, _P, _P, _P, _P, _P, _P),
    "gr_recheck_zone": (_P, _I, _I, _I, _I, _P),
    "gr_ntcard_count": (_P, _L, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I,
                        _P),
    "gr_wave_adjacency": (_P, _I, _I, _I, _I, _I, _I, _P, _L, _P, _I, _I,
                          _I, _I, _I, _I, _L, _I, _I, _I, _I, _I, _P, _P,
                          _P, _P, _P, _P),
    "gr_wave_rounds": (*_BANKS, _I, _L, _U, _P, _P, _I, _I, _P, _P, _I,
                       _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _L, _L, _P, _P, _P, _P, _P, _P,
                       _P, _P, _P, _L),
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
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *(["-Xptxas=-v"] if verbose else []), *NVCC_FLAGS, "-c",
             os.path.join(CSRC, s), "-o", o], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for s, o in zip(SOURCES, objs)]
        outs = [p.communicate() for p in procs]
        for s, p, (_, err) in zip(SOURCES, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n"
                                   f"{err}")
            if verbose:
                print(err, end="")
        lib_tmp = os.path.join(tmp, "lib.so")
        r = subprocess.run([nvcc, "-shared", *NVCC_FLAGS, "-o", lib_tmp,
                            *objs], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(lib_tmp, so)
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
            dll.gr_peer_access.argtypes = [_I, _I, ctypes.POINTER(_I),
                                           ctypes.POINTER(_I)]
            dll.gr_peer_access.restype = ctypes.c_int
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
    "goldrush_tpu/mibf/mibf.py:158; sampled: goldrush_tpu/mibf/mibf.py:234, "
    ":288, goldrush_tpu/ops/nthash.py:324")
SEED_HASH_RANK_GRID = Kernel(
    "seed_hash_rank_grid", "gr_seed_hash_rank_grid",
    "goldrush_tpu_torch/csrc/seed_hash.cu",
    "tools/probe_pallas.py:61; goldrush_tpu/mibf/compressed.py:218; "
    "sampled: goldrush_tpu/mibf/mibf.py:234, :288")
SEED_HASH_FILL = Kernel(
    "seed_hash_fill", "gr_seed_hash_fill",
    "goldrush_tpu_torch/csrc/seed_hash.cu",
    "goldrush_tpu/mibf/mibf.py:122; K12 goldrush_tpu/mibf/compressed.py:65")
PRESENCE_MERGE = Kernel(
    "presence_merge", "gr_presence_merge",
    "goldrush_tpu_torch/csrc/seed_hash.cu",
    "goldrush_tpu/mibf/mibf.py:122")
PROBE_VOTE = Kernel(
    "probe_vote", "gr_probe_vote",
    "goldrush_tpu_torch/csrc/probe_vote.cu",
    "goldrush_tpu/mibf/mibf.py:361")
CLASSIFY = Kernel(
    "classify", "gr_classify",
    "goldrush_tpu_torch/csrc/classify.cu",
    "tools/probe_pallas.py:100; goldrush_tpu/path/classify.py:77")
INSERT_SORTED = Kernel(
    "insert_sorted", "gr_insert_sorted",
    "goldrush_tpu_torch/csrc/insert_sorted.cu",
    "goldrush_tpu/mibf/mibf.py:540; insert_read goldrush_tpu/mibf/mibf.py:449, "
    "goldrush_tpu/mibf/compressed.py:338")
INSERT_BATCH = Kernel(
    "insert_batch", "gr_insert_batch",
    "goldrush_tpu_torch/csrc/insert_sorted.cu",
    "goldrush_tpu/mibf/mibf.py:449 (insert_read, once a recruit in "
    "train_step's scan, goldrush_tpu/parallel/mesh.py:86-108)")
INSERT_MAX = Kernel(
    "insert_max", "gr_insert_max", "goldrush_tpu_torch/csrc/insert_max.cu",
    "goldrush_tpu/mibf/mibf.py:638; goldrush_tpu/mibf/compressed.py:480")
RANK_BUILD = Kernel(
    "rank_build", "gr_rank_build", "goldrush_tpu_torch/csrc/rank.cu",
    "tools/probe_pallas.py:82, :128; goldrush_tpu/mibf/compressed.py:153-169 "
    "(super_base); K12 goldrush_tpu/mibf/compressed.py:104, :90, :52")
MINIMIZER_KEYS = Kernel(
    "minimizer_keys", "gr_minimizer_keys",
    "goldrush_tpu_torch/csrc/minimizers.cu",
    "goldrush_tpu/ops/minimizers.py:46 (+ _sliding_min :31)")
KMER_COUNT = Kernel(
    "kmer_count", "gr_kmer_count", "goldrush_tpu_torch/csrc/kmer_count.cu",
    "goldrush_tpu/stages/polish.py:82")
KMER_QUERY = Kernel(
    "kmer_query", "gr_kmer_query", "goldrush_tpu_torch/csrc/kmer_count.cu",
    "goldrush_tpu/stages/polish.py:93")
CONSUME = Kernel(
    "consume", "gr_consume", "goldrush_tpu_torch/csrc/consume.cu",
    "goldrush_tpu/path/engine.py:892-1024 (K9); K18 "
    "goldrush_tpu/path/engine_util.py:10; K10/K19 "
    "goldrush_tpu/mibf/mibf.py:686, goldrush_tpu/mibf/compressed.py:559")
NTCARD_COUNT = Kernel(
    "ntcard_count", "gr_ntcard_count", "goldrush_tpu_torch/csrc/ntcard.cu",
    "goldrush_tpu/utils/ntcard.py:41 (_sample_and_count, with the hashing "
    "and clamp of :95-116)")
WAVE_ADJACENCY = Kernel(
    "wave_adjacency", "gr_wave_adjacency",
    "goldrush_tpu_torch/csrc/wavefront.cu",
    "goldrush_tpu/path/wavefront.py:159 (K23a: the window's overlap "
    "adjacency, :281-345)")
WAVE_ROUNDS = Kernel(
    "wave_rounds", "gr_wave_rounds", "goldrush_tpu_torch/csrc/wavefront.cu",
    "goldrush_tpu/path/wavefront.py:159 (K23b: the round loop, :491-726)")
# the consume kernel's zone predicate (K18) launched alone, to hold it
# against the plain predicate; not a kernel of the path, so not in ALL
RECHECK_ZONE = Kernel(
    "recheck_zone", "gr_recheck_zone", "goldrush_tpu_torch/csrc/consume.cu",
    "goldrush_tpu/path/engine_util.py:10")
# kernel C's warp cummax (the arithmetic of tools/probe_pallas.py:98, run
# inside C's passes 5 and 10) launched alone, to hold it against
# torch.cummax; not a kernel of the path, so not in ALL
ROW_CUMMAX = Kernel(
    "row_cummax", "gr_row_cummax", "goldrush_tpu_torch/csrc/classify.cu",
    "tools/probe_pallas.py:100")
# the kernels goldrush-path's main path launches, and those of the stages
# after the golden path (the minimizer mapper and the k-mer polisher).
# Kernel D's and insert_max's code runs inside the consume kernel; their
# standalone launches (held to their plain versions and timed on their own)
# are not on the path, so not in ALL
PATH = (SEED_HASH_GRID, SEED_HASH_RANK_GRID, SEED_HASH_FILL, PRESENCE_MERGE,
        PROBE_VOTE, CLASSIFY, RANK_BUILD, CONSUME)
# ntCard's counters, which size the filter when the engine runs with
# ntcard=True (before pass 1)
SIZING = (NTCARD_COUNT,)
# the wavefront consume, which replaces the consume kernel on the path
# when the engine runs with wavefront=True under the optimistic policy
WAVE = (WAVE_ADJACENCY, WAVE_ROUNDS)
STAGES = (MINIMIZER_KEYS, KMER_COUNT, KMER_QUERY)
# the mesh module's state-mutating step (train_step, sharded_train_step):
# kernel D over the whole classified batch, once a step a data row
TRAIN = (INSERT_BATCH,)
ALL = PATH + SIZING + WAVE + STAGES + TRAIN


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return _P(0 if t is None else t.data_ptr())


# the (launching card, bank card) pairs whose peer access is checked and
# enabled
_PEERS: set = set()


def peer_attributes(device: torch.device, peer: torch.device
                    ) -> tuple[bool, bool]:
    """Whether a kernel on ``device`` can reach ``peer``'s memory
    (``cudaDeviceCanAccessPeer``) and with native atomics
    (``cudaDevP2PAttrNativeAtomicSupported``); when both hold, the access
    is enabled (csrc/consume.cu gr_peer_access)."""
    can, atomics = ctypes.c_int(0), ctypes.c_int(0)
    err = lib().gr_peer_access(device.index, peer.index, ctypes.byref(can),
                               ctypes.byref(atomics))
    if err != 0:
        raise RuntimeError(f"peer access {device} -> {peer}: "
                           f"{lib().gr_error_string(err).decode()}")
    return bool(can.value), bool(atomics.value)


def require_peer(device: torch.device, peer: torch.device) -> None:
    """Let a kernel launched on ``device`` reach memory on ``peer``: raise
    unless the card can access the peer's memory with native atomics (the
    scatter-max's), then enable the access (``peer_attributes``).  Banks
    are never copied to the launching card instead."""
    key = (device.index, peer.index)
    if device == peer or key in _PEERS:
        return
    can, atomics = peer_attributes(device, peer)
    if not can:
        raise RuntimeError(f"{device} cannot access the memory of {peer} "
                           "(cudaDeviceCanAccessPeer): a filter banked "
                           "across them cannot run")
    if not atomics:
        raise RuntimeError(f"{device} has no native atomics on {peer}'s "
                           "memory (cudaDevP2PAttrNativeAtomicSupported): a "
                           "filter banked across them cannot run")
    _PEERS.add(key)


def banks_args(table, counts, device: torch.device) -> tuple:
    """The bank view of a filter array and its counters as a launch's
    leading arguments (csrc/common.cuh make_banks): the banks' pointer
    tables, their number, the entries of a bank, and whether a bank lies
    on another card than ``device``.  ``table`` and ``counts`` are int32
    tensors (one bank each) or ``mibf.Banks`` split alike; ``counts`` may
    be None, or another array banked as ``table`` is (the wavefront's side
    table: make_side_banks).  Each bank must be a contiguous int32 CUDA
    tensor; a bank on another card needs ``require_peer``."""
    tparts = getattr(table, "parts", (table,))
    cparts = None if counts is None else getattr(counts, "parts", (counts,))
    n, bank_len = len(tparts), tparts[0].shape[0]
    for name, parts in (("table", tparts), ("counts", cparts)):
        if parts is None:
            continue
        if len(parts) != n:
            raise ValueError(f"{name}: {len(parts)} banks, expected {n}")
        for j, p in enumerate(parts):
            check(p, f"{name} bank {j}", torch.int32, (bank_len,))
    remote = False
    for p in tparts + (cparts or ()):
        if p.device != device:
            require_peer(device, p.device)
            remote = True
    arr = ctypes.c_void_p * n
    return (arr(*(p.data_ptr() for p in tparts)),
            None if cparts is None else arr(*(p.data_ptr() for p in cparts)),
            n, bank_len, int(remote))


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
