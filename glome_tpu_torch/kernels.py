"""Build and load the port's CUDA kernels (csrc/*.cu).

Each kernel source is compiled at first use with nvcc into a shared
library with a plain C interface and loaded with ctypes.  The library
lands in `build/` at the repository root, named by a hash of the
sources and the flags, so an unchanged source is compiled once per
checkout.  Nothing here runs at import time: this module (and every
module importing it) loads on machines without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")

# -fmad=false: no multiply-add contraction, so every product is rounded
# as the plain torch versions (separate eager ops) round it.  On
# TestScene's 345,600 primary rays (H100 80GB HBM3, 700 W power limit)
# contraction put 633 lanes' t outside rtol 5e-5 / atol 1e-4 of the
# plain version's (grazing hits, where float32 cancels); without it the
# two agree bit for bit, for 6-8% more kernel time (see PERF.md).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

MEGA_SOURCES = ("mega_select.cu", "prims.cuh")

# loaded libraries by path; the build log of each (nvcc + ptxas -v)
_LIBS = {}
BUILD_INFO = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


def build(sources, name: str) -> str:
    """Compile sources[0] (the others are its headers) into
    build/lib<name>_<hash>.so unless that file exists; returns its
    path.  BUILD_INFO[path] records the build seconds and log."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        with open(os.path.join(CSRC, s), "rb") as f:
            h.update(s.encode() + b"\0" + f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        BUILD_INFO.setdefault(out, {"seconds": 0.0, "log": "(cached)"})
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
           os.path.join(CSRC, sources[0])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    BUILD_INFO[out] = {"seconds": secs, "log": log}
    return out


def mega_select_lib():
    """The loaded K1 library (csrc/mega_select.cu), built on first use."""
    path = build(MEGA_SOURCES, "glome_mega")
    lib = _LIBS.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.glome_mega_select.argtypes = [vp, i32, vp, vp, vp, vp, vp, vp,
                                          i32, i32, vp, vp, vp, vp]
        lib.glome_mega_select.restype = i32
        lib.glome_mega_stack_max.argtypes = []
        lib.glome_mega_stack_max.restype = i32
        lib.glome_cuda_error_name.argtypes = [i32]
        lib.glome_cuda_error_name.restype = ctypes.c_char_p
        from .megakernel import STACK_MAX
        if lib.glome_mega_stack_max() != STACK_MAX:
            raise RuntimeError("csrc/mega_select.cu MEGA_STACK_MAX != "
                               "megakernel.STACK_MAX")
        _LIBS[path] = lib
    return lib


def cuda_error_name(err: int) -> str:
    return mega_select_lib().glome_cuda_error_name(err).decode()
