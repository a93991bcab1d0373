"""ctypes bindings for the native host runtime, and the shared-library
builder (and the loader of the CUDA kernels) the port's compiled sources
use.

Twin of ``coulomb_oscillators_tpu/native/__init__.py``: the same functions
(``kdtree_build``, ``node_geometry``, ``traverse_fine``) over the reference's
own ``coulomb_oscillators_tpu/native/co_native.cpp``, compiled by path with
``g++``.  That source has no JAX in it, so there is no second copy of the
C++.  Differences from the twin:

  * the library is built into the port's git-ignored ``build/`` directory
    at the repository root, never into the JAX package's directory;
  * the functions raise when the library cannot be built or loaded; the
    twin returns None from them.  :func:`available` says whether it can
    be, and the kd engine asks it before taking the host fallback (the
    device builders and the numpy ``_traverse_raw``), as the twin's
    callers test for None.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(_REPO, "build")
SRC = os.path.join(_REPO, "coulomb_oscillators_tpu", "native", "co_native.cpp")

_lock = threading.Lock()
_lib = None
build_seconds = None       # wall time of this process's build (None: cached)
build_error = None         # why the library could not be built, if it failed


def build_library(src: str, name: str, cmd: list):
    """Compile `src` into BUILD_DIR/lib<name>_<hash>.so unless that file
    exists; `cmd` is the compiler command without the output and source
    arguments.  The key hashes the source, the command and the compiler's
    own version line, never an mtime, so a library built by another
    toolchain is never loaded.  Concurrent builders write private temp
    files and rename them atomically.  Returns (path, compiler output; ""
    when cached).  Raises RuntimeError if the compiler cannot run or the
    build fails."""
    try:
        ver = subprocess.run([cmd[0], "--version"], capture_output=True,
                             text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"cannot run {cmd[0]!r} to build {src}: {e}") from e
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(cmd).encode()
                             + ver.encode()).hexdigest()
    so = os.path.join(BUILD_DIR, f"lib{name}_{key[:12]}.so")
    if os.path.exists(so):
        return so, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}.{threading.get_ident()}"
    res = subprocess.run(cmd + ["-o", tmp, src], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {src} failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so, res.stdout + res.stderr


# nvcc flags of every kernel library (route (b): a plain C interface,
# loaded with ctypes; no --use_fast_math)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    """The nvcc to build with: the one on PATH, else the CUDA default."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


class CudaLibrary:
    """A ``csrc/*.cu`` source built with nvcc for sm_90a into BUILD_DIR at
    first use (never at import) and loaded with ctypes; `bind` declares
    the loaded library's argtypes and restypes."""

    def __init__(self, src: str, name: str, bind):
        self.src = src
        self.name = name
        self._bind = bind
        self._lock = threading.Lock()
        self._lib = None
        self.build_seconds = None  # wall time of this process's build + load
        self.build_log = ""        # nvcc's output of that build ("" if cached)

    def get(self):
        """The loaded library; builds it on first use and raises if it
        cannot be built or loaded."""
        with self._lock:
            if self._lib is None:
                t0 = time.perf_counter()
                so, self.build_log = build_library(self.src, self.name,
                                                   [nvcc()] + NVCC_FLAGS)
                lib = ctypes.CDLL(so)
                self._bind(lib)
                self.build_seconds = time.perf_counter() - t0
                self._lib = lib
            return self._lib


def get_lib():
    """The loaded native library; builds it on first use, raises if it
    cannot be built or loaded."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        so, _ = build_library(SRC, "co_native",
                           ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"])
        lib = ctypes.CDLL(so)
        build_seconds = time.perf_counter() - t0
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_f32p = ctypes.POINTER(ctypes.c_float)
        lib.co_kdtree_build.argtypes = [c_f32p, c_i32p, ctypes.c_int64,
                                        ctypes.c_int32, ctypes.c_int32]
        lib.co_kdtree_build.restype = None
        lib.co_node_geometry.argtypes = [c_f32p, ctypes.c_int64,
                                         ctypes.c_int32, ctypes.c_int32,
                                         c_f32p, c_f32p, c_f32p, c_f32p]
        lib.co_node_geometry.restype = None
        lib.co_traverse_fine.argtypes = [
            c_f32p, c_f32p, c_f32p, c_i32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
            ctypes.c_float, ctypes.c_int32,
            c_i32p, ctypes.c_int64, c_i64p,
            c_i32p, c_i32p, ctypes.c_int64, c_i64p]
        lib.co_traverse_fine.restype = ctypes.c_int32
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native library builds and loads here; the first call
    tries the build, and a failure is kept in ``build_error``."""
    global build_error
    if _lib is None and build_error is None:
        try:
            get_lib()
        except (RuntimeError, OSError) as e:
            build_error = str(e)
    return _lib is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def kdtree_build(pos: np.ndarray, L: int) -> np.ndarray:
    """Exact equal-count kd permutation; pos [n, dim] float32."""
    lib = get_lib()
    n, dim = pos.shape
    pos = np.ascontiguousarray(pos, dtype=np.float32)
    perm = np.arange(n, dtype=np.int32)
    lib.co_kdtree_build(_ptr(pos, ctypes.c_float),
                        _ptr(perm, ctypes.c_int32), n, L, dim)
    return perm


def node_geometry(pos_s: np.ndarray, L: int):
    """Per-node center/lbound/rbound/lam over the heap, from the sorted
    particle array."""
    lib = get_lib()
    n, dim = pos_s.shape
    pos_s = np.ascontiguousarray(pos_s, dtype=np.float32)
    M = (1 << (L + 1)) - 1
    center = np.empty((M, dim), dtype=np.float32)
    lb = np.empty((M, dim), dtype=np.float32)
    rb = np.empty((M, dim), dtype=np.float32)
    lam = np.empty(M, dtype=np.float32)
    lib.co_node_geometry(_ptr(pos_s, ctypes.c_float), n, L, dim,
                         _ptr(center, ctypes.c_float),
                         _ptr(lb, ctypes.c_float),
                         _ptr(rb, ctypes.c_float),
                         _ptr(lam, ctypes.c_float))
    return center, lb, rb, lam


def traverse_fine(center, lb, rb, mult, L, sub_depth, n, dim, p, radius,
                  coll, mult_floor=1, sub_boost=1.0,
                  m2l_cap=1 << 20, near_cap=1 << 20):
    """Single-pass dual-granularity traversal + device-ready lists.

    mult_floor: MAC multiplicity floor (Mf uses max(mult, mult_floor)).
    sub_boost: acceptance-radius boost for nodes below the block level.
    Returns (m2l [Kd,2] directed target-sorted, near [Q,2] with packed
    source blocks, target-sorted).  Capacities grow and the traversal
    reruns until the lists fit."""
    lib = get_lib()
    center = np.ascontiguousarray(center, dtype=np.float32)
    lb = np.ascontiguousarray(lb, dtype=np.float32)
    rb = np.ascontiguousarray(rb, dtype=np.float32)
    mult = np.ascontiguousarray(mult, dtype=np.int32)
    while True:
        m2l = np.empty((m2l_cap, 2), dtype=np.int32)
        near_t = np.empty(near_cap, dtype=np.int32)
        near_p = np.empty(near_cap, dtype=np.int32)
        nm = ctypes.c_int64()
        nq = ctypes.c_int64()
        rc = lib.co_traverse_fine(
            _ptr(center, ctypes.c_float), _ptr(lb, ctypes.c_float),
            _ptr(rb, ctypes.c_float), _ptr(mult, ctypes.c_int32),
            L, sub_depth, n, dim, p, radius, int(mult_floor),
            float(sub_boost), int(bool(coll)),
            _ptr(m2l, ctypes.c_int32), m2l_cap, ctypes.byref(nm),
            _ptr(near_t, ctypes.c_int32), _ptr(near_p, ctypes.c_int32),
            near_cap, ctypes.byref(nq))
        if rc == 0:
            near = np.stack([near_t[:nq.value], near_p[:nq.value]],
                            axis=1).astype(np.int64)
            return m2l[:nm.value].astype(np.int64), near
        m2l_cap = max(m2l_cap * 2, int(nm.value * 1.2))
        near_cap = max(near_cap * 2, int(nq.value * 1.2))
