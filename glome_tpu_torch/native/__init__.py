"""The native BVH builder (bvh_builder.cpp), built with g++ and loaded
with ctypes.

accel.build_bvh uses it by default.  The library is compiled at first
use into build/ at the repository root (kernels.BUILD_DIR), named by a
hash of the source, the flags and `g++ --version` (build_key), so an
unchanged source is compiled once per checkout and compiler.  There is no
fallback: a missing compiler, a failed build or a failed call raises
RuntimeError, and only a caller that passes native=False gets the numpy
builder.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np

from ..kernels import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "bvh_builder.cpp")
CXX = "g++"
# -ffp-contract=off: the surface-area costs round as numpy rounds them
# (no fused a*b+c on a host with FMA), so the splits, and the tables,
# are numpy's; no -ffast-math and no -march for the same reason
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]

_LIB = None
# the build of this process: {"path", "seconds", "version"}
BUILD_INFO = {}


def cxx_path() -> str:
    found = shutil.which(CXX)
    if not found:
        raise RuntimeError(f"the C++ compiler {CXX!r} was not found (PATH); "
                           "the native BVH builder needs it")
    return found


@functools.lru_cache(maxsize=None)
def cxx_version(path: str) -> str:
    """`<path> --version`'s output (read once per process)."""
    proc = subprocess.run([path, "--version"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{path} --version failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def build_key(version: str, source: str = SOURCE, flags=None) -> str:
    """The hash that names the library: the source's contents, the flags
    (CXX_FLAGS by default) and the compiler's `version` text."""
    flags = CXX_FLAGS if flags is None else flags
    h = hashlib.sha256(" ".join(flags).encode() + b"\0" + version.encode()
                       + b"\0")
    with open(source, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile bvh_builder.cpp into build/libglome_bvh_builder_<key>.so
    unless that file exists (written to a temporary name, then renamed
    into place); returns its path."""
    cxx = cxx_path()
    version = cxx_version(cxx)
    out = os.path.join(BUILD_DIR,
                       f"libglome_bvh_builder_{build_key(version)}.so")
    BUILD_INFO.update(path=out, seconds=0.0, version=version)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    return out


def get_lib():
    """The loaded library (built and loaded once per process)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        p_f64 = ctypes.POINTER(ctypes.c_double)
        p_f32 = ctypes.POINTER(ctypes.c_float)
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        lib.glome_build_bvh.restype = ctypes.c_int32
        lib.glome_build_bvh.argtypes = [
            p_f64, p_f64, ctypes.c_int32, ctypes.c_int32, p_f32, p_f32,
            p_i32, p_i32, p_i32, p_i32, ctypes.c_int32, ctypes.c_int32,
            p_i32]
        _LIB = lib
    return _LIB


def build_bvh_native(bmin: np.ndarray, bmax: np.ndarray, leaf_max: int):
    """The skip-link tree over the (P, 3) prim boxes, as accel.BvhFlat's
    fields (bmin, bmax, leaf_start, leaf_count, skip, order); the boxes
    are taken as float64.  Raises RuntimeError where the library cannot
    be built or the tree outgrows its 4 P + 8 node capacity."""
    bmin = np.ascontiguousarray(bmin, dtype=np.float64)
    bmax = np.ascontiguousarray(bmax, dtype=np.float64)
    if bmin.ndim != 2 or bmin.shape[1] != 3 or bmax.shape != bmin.shape:
        raise ValueError(f"prim boxes must be two (P, 3) arrays, got "
                         f"{bmin.shape} and {bmax.shape}")
    if int(leaf_max) < 1:
        raise ValueError(f"leaf_max must be at least 1, got {leaf_max}")
    lib = get_lib()
    P = int(bmin.shape[0])
    cap = 4 * P + 8
    nb_min = np.empty((cap, 3), np.float32)
    nb_max = np.empty((cap, 3), np.float32)
    ls, lc, sk, order = (np.empty(cap, np.int32) for _ in range(4))
    n_order = ctypes.c_int32(0)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    M = lib.glome_build_bvh(
        ptr(bmin, ctypes.c_double), ptr(bmax, ctypes.c_double), P,
        int(leaf_max), ptr(nb_min, ctypes.c_float),
        ptr(nb_max, ctypes.c_float), ptr(ls, ctypes.c_int32),
        ptr(lc, ctypes.c_int32), ptr(sk, ctypes.c_int32),
        ptr(order, ctypes.c_int32), cap, cap, ctypes.byref(n_order))
    if M < 0:
        raise RuntimeError(f"the native BVH build over {P} prims outgrew "
                           f"its capacity of {cap} nodes")
    return (nb_min[:M].copy(), nb_max[:M].copy(), ls[:M].copy(),
            lc[:M].copy(), sk[:M].copy(), order[:n_order.value].copy())
