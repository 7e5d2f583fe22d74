"""Build + ctypes bindings for the native seqio FASTQ/FASTA reader.

The C++ source, ``seqio.cpp`` beside this file, is this package's own copy
of the JAX package's reader (byte for byte the same, so both read a file
alike).  It is compiled lazily with g++ into this package's git-ignored
build directory, keyed by a hash of the source; ``available()`` is False
where the toolchain is missing, and the ingest layer then uses the
pure-Python reader, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "seqio.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_lock = threading.Lock()
_lib = None
_failed = False


def _build() -> str | None:
    """Path of the compiled library, building it if needed (None when the
    source or g++/zlib is missing)."""
    if not os.path.exists(SRC):
        return None
    with open(SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"seqio-{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a temporary name and rename: concurrent test workers
    # never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SRC,
                        "-o", tmp, "-lz"], check=True, capture_output=True)
        os.replace(tmp, so)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def get_lib():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = _build()
        if so is None:
            _failed = True
            return None
        lib = ctypes.CDLL(so)
        lib.seqio_open.restype = ctypes.c_void_p
        lib.seqio_open.argtypes = [ctypes.c_char_p]
        lib.seqio_close.argtypes = [ctypes.c_void_p]
        lib.seqio_read_block.restype = ctypes.c_int64
        lib.seqio_read_block.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None
