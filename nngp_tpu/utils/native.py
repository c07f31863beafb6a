"""ctypes loader for the native preprocessing library (native/).

Builds native/libnngp_native.so from native/nngp_native.cpp on first use
with one C++ compiler command, adding ``-fopenmp`` when the toolchain
compiles and links an OpenMP probe; falls back to the NumPy implementations
when no toolchain builds it.  The native fast paths cover the O(n^2) exact maxmin ordering and the sequential greedy
coloring (reference equivalents: GpGp::order_maxmin C++ and the R loop in
Scripts/Coloring.R).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libnngp_native.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.maxmin_order.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.maxmin_order.restype = None
        lib.greedy_coloring.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.greedy_coloring.restype = ctypes.c_int32
        _lib = lib
    except OSError:
        _lib = None
    return _lib


_OPENMP_PROBE = b"#include <omp.h>\nint main() { return omp_get_max_threads() < 1; }\n"


def _openmp_flags(cxx: str) -> list[str]:
    """["-fopenmp"] when ``cxx`` compiles and links an OpenMP program."""
    try:
        subprocess.run([cxx, "-fopenmp", "-x", "c++", "-", "-o", os.devnull],
                       input=_OPENMP_PROBE, check=True, capture_output=True,
                       timeout=60)
    except (OSError, subprocess.SubprocessError):
        return []
    return ["-fopenmp"]


def _build() -> bool:
    """Compile the library; True when it now exists."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return False
    # Concurrent first uses (test workers) each write their own file and
    # rename it into place, so no process loads a half-written library.
    tmp = f"{_LIB_PATH}.{os.getpid()}"
    cmd = [cxx, "-O3", "-fPIC", "-shared", "-std=c++17", *_openmp_flags(cxx),
           "-o", tmp, os.path.join(_NATIVE_DIR, "nngp_native.cpp")]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def maxmin_order_native(x: np.ndarray):
    """Native exact maxmin ordering, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    n, d = x.shape
    out = np.empty(n, dtype=np.int64)
    lib.maxmin_order(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        d,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def greedy_coloring_native(indptr: np.ndarray, indices: np.ndarray, n: int):
    """Native first-fit coloring over CSR adjacency, or None."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    out = np.empty(n, dtype=np.int32)
    lib.greedy_coloring(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
