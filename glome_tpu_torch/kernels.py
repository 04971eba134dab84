"""Build and load the port's CUDA kernels (csrc/*.cu).

Each kernel source is compiled at first use with nvcc into a shared
library with a plain C interface and loaded with ctypes.  The library
lands in `build/` at the repository root, named by a hash of the
sources, the flags and nvcc's version (build_key), so an unchanged
source is compiled once per checkout and toolkit.  Nothing here runs at
import time: this module (and every module importing it) loads on
machines without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

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

# each library: its .cu source first, then the headers it includes
MEGA_SOURCES = ("mega_select.cu", "prims.cuh", "walk.cuh", "bvh_walk.cuh")
BLOCK_SOURCES = ("block_select.cu", "prims.cuh", "walk.cuh", "cons.cuh",
                 "bvh_walk.cuh")
MESH_SOURCES = ("mesh_block_select.cu", "prims.cuh", "walk.cuh",
                "bvh_walk.cuh")
DENSE_SOURCES = ("dense_select.cu", "prims.cuh", "walk.cuh", "cons.cuh")
BVH_SOURCES = ("bvh_select.cu", "prims.cuh", "walk.cuh", "cons.cuh",
               "bvh_walk.cuh")
MICRO_PRIMS_SOURCES = ("micro_prims.cu", "micro.cuh")
MICRO_KWIDE_SOURCES = ("micro_kwide.cu", "micro.cuh")
FINALIZE_SOURCES = ("finalize_hit.cu", "prims.cuh")
LIBRARIES = {"glome_mega": MEGA_SOURCES, "glome_block": BLOCK_SOURCES,
             "glome_mesh": MESH_SOURCES, "glome_dense": DENSE_SOURCES,
             "glome_bvh": BVH_SOURCES,
             "glome_micro_prims": MICRO_PRIMS_SOURCES,
             "glome_micro_kwide": MICRO_KWIDE_SOURCES,
             "glome_finalize": FINALIZE_SOURCES}

# The near-first walks of K1-K3 and K5 (csrc/bvh_walk.cuh) keep their
# deferred subtrees on a stack in dynamic shared memory: WALK_THREADS
# threads per CTA, one 8-byte (reference, near) entry each per level.  A
# CTA may hold SMEM_BLOCK_MAX bytes of shared memory on an H100 (232,448
# of the SM's 256 KB, above 48 KB only after opting in), so at most 227
# entries.
WALK_THREADS = 128
STACK_ENTRY_BYTES = 8
SMEM_BLOCK_MAX = 232_448


def walk_stack(depth: int, reserved: int = 0) -> int:
    """Entries per thread of the shared stack of a near-first walk over
    trees at most `depth` deep (the root at depth 1): the walk holds at
    most one deferred sibling per level above its leaf, depth - 1
    entries (at least 1).  `reserved`: bytes of the CTA's shared memory
    the kernel also uses.  Raises ValueError where the card's shared
    memory cannot hold the stack."""
    entries = max(int(depth) - 1, 1)
    need = entries * WALK_THREADS * STACK_ENTRY_BYTES + reserved
    if need > SMEM_BLOCK_MAX:
        raise ValueError(
            f"a tree of depth {depth} needs a {entries}-entry walk stack, "
            f"{need} bytes of shared memory per CTA; the card holds "
            f"{SMEM_BLOCK_MAX}")
    return entries


# loaded libraries by name (each is built, hashed and loaded once per
# process: the wrappers look their library up on every launch); the build
# log of each library file (nvcc + ptxas -v)
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


@functools.lru_cache(maxsize=None)
def nvcc_version() -> str:
    """nvcc --version's output (read once per process)."""
    proc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc --version failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def build_key(sources, version: str, csrc: str = CSRC) -> str:
    """The hash that names a library: its sources' names and contents (in
    `csrc`), NVCC_FLAGS and the nvcc `version` text, so a change of any
    of them, a new toolkit included, builds a new library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + b"\0"
                       + version.encode())
    for s in sources:
        with open(os.path.join(csrc, s), "rb") as f:
            h.update(s.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(sources, name: str, csrc: str = CSRC) -> str:
    """Compile sources[0] (the others are its headers, all in `csrc`)
    into build/lib<name>_<build_key>.so unless that file exists; returns
    its path.  BUILD_INFO[path] records the build seconds and the log
    (nvcc and ptxas -v), which is also kept beside the library as .so.log."""
    key = build_key(sources, nvcc_version(), csrc)
    out = os.path.join(BUILD_DIR, f"lib{name}_{key}.so")
    if os.path.exists(out):
        if out not in BUILD_INFO:
            log = "(cached)"
            if os.path.exists(out + ".log"):
                with open(out + ".log") as f:
                    log = f.read()
            BUILD_INFO[out] = {"seconds": 0.0, "log": log}
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", csrc, "-o", tmp,
           os.path.join(csrc, sources[0])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", out + ".log")
    os.replace(tmp, out)
    BUILD_INFO[out] = {"seconds": secs, "log": log}
    return out


def _load(name: str, setup):
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(LIBRARIES[name], name))
        lib.glome_cuda_error_name.argtypes = [ctypes.c_int]
        lib.glome_cuda_error_name.restype = ctypes.c_char_p
        setup(lib)
        _LIBS[name] = lib
    return lib


_vp, _i32 = ctypes.c_void_p, ctypes.c_int


def _setup_mega(lib):
    lib.glome_mega_select.argtypes = [_vp, _i32, _vp, _vp, _vp, _vp, _vp,
                                      _vp, _vp, _vp, _i32, _i32, _i32, _i32,
                                      _vp, _vp, _vp, _vp, _vp]
    lib.glome_mega_select.restype = _i32


def _setup_block(lib):
    lib.glome_block_select.argtypes = [_vp, _i32, _vp, _vp, _vp, _i32, _i32,
                                       _i32, _i32, _i32, _i32, _vp, _vp,
                                       _i32, _vp, _vp, _vp, _vp]
    lib.glome_block_select.restype = _i32


def _setup_mesh(lib):
    lib.glome_mesh_block_select.argtypes = [_vp, _i32, _vp, _vp, _i32, _vp,
                                            _i32, _i32, _vp, _vp, _vp, _vp]
    lib.glome_mesh_block_select.restype = _i32


def _setup_dense(lib):
    lib.glome_dense_select.argtypes = [_vp, _i32, _vp, _vp, _vp, _vp, _i32,
                                       _i32, _i32, _i32, _i32, _vp, _vp,
                                       _i32, _vp, _vp, _vp, _vp]
    lib.glome_dense_select.restype = _i32
    for fn in (lib.glome_dense_block, lib.glome_dense_sub,
               lib.glome_dense_fx_max):
        fn.argtypes = []
        fn.restype = _i32
    from .group_kernels import BP, FX_MAX, SUB
    if (lib.glome_dense_block(), lib.glome_dense_sub(),
            lib.glome_dense_fx_max()) != (BP, SUB, FX_MAX):
        raise RuntimeError("csrc/dense_select.cu DENSE_BP / DENSE_SUB / "
                           "DENSE_FX_MAX != group_kernels.BP / SUB / FX_MAX")


def _setup_bvh(lib):
    lib.glome_bvh_select.argtypes = [_vp, _i32, _vp, _vp, _i32, _i32, _vp,
                                     _vp, _i32, _i32, _vp, _vp, _i32, _vp,
                                     _vp, _vp, _vp]
    lib.glome_bvh_select.restype = _i32


def _setup_finalize(lib):
    _ll = ctypes.c_longlong
    lib.glome_finalize_hit.argtypes = [
        _vp, _ll, _ll, _vp, _ll, _ll, _i32, _vp, _vp, _vp, _i32, _vp, _i32,
        _vp, _vp, _i32, _i32, _vp, _vp, _vp, _i32, _vp, _i32, _vp, _vp, _vp,
        _vp, _vp, _vp]
    lib.glome_finalize_hit.restype = _i32


# the C entries of csrc/micro_prims.cu, one per variant:
# (rays, T, table, [P, [STEPS]], out, stream)
MICRO_PRIMS_ENTRIES = {
    "glome_micro_vote_while": [_vp, _i32, _vp, _i32, _i32, _vp, _vp],
    "glome_micro_dense_fori": [_vp, _i32, _vp, _i32, _vp, _vp],
    "glome_micro_gate8": [_vp, _i32, _vp, _i32, _vp, _vp],
    "glome_micro_gate16": [_vp, _i32, _vp, _i32, _vp, _vp],
    "glome_micro_gate32": [_vp, _i32, _vp, _i32, _vp, _vp],
    "glome_micro_bits168": [_vp, _i32, _vp, _i32, _vp, _vp],
    "glome_micro_lane8x128": [_vp, _i32, _vp, _vp, _vp],
    "glome_micro_mxu128": [_vp, _i32, _vp, _vp, _vp]}
# csrc/micro_kwide.cu's: (rays, T, nf, M, K, out, stream), (rays, T,
# NREAD, out, stream)
MICRO_KWIDE_ENTRIES = {
    "glome_micro_walk": [_vp, _i32, _vp, _i32, _i32, _vp, _vp],
    "glome_micro_vread": [_vp, _i32, _i32, _vp, _vp]}
# the launch floor beside them in csrc/micro_prims.cu: (rays, T,
# blocks_per_tile, threads, out, stream)
MICRO_FLOOR_ENTRIES = {
    "glome_micro_store_tile": [_vp, _i32, _i32, _i32, _vp, _vp]}


def set_entries(lib, entries):
    """Give each C entry of `lib` named in `entries` its argument types
    (and an int result)."""
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _i32


def _setup_micro_prims(lib):
    set_entries(lib, {**MICRO_PRIMS_ENTRIES, **MICRO_FLOOR_ENTRIES})


def _setup_micro_kwide(lib):
    set_entries(lib, MICRO_KWIDE_ENTRIES)


def mega_select_lib():
    """The loaded K1 library (csrc/mega_select.cu), built on first use."""
    return _load("glome_mega", _setup_mega)


def block_select_lib():
    """The loaded K2 library (csrc/block_select.cu), built on first use."""
    return _load("glome_block", _setup_block)


def mesh_select_lib():
    """The loaded K3 library (csrc/mesh_block_select.cu), built on first
    use."""
    return _load("glome_mesh", _setup_mesh)


def dense_select_lib():
    """The loaded K4 library (csrc/dense_select.cu), built on first use."""
    return _load("glome_dense", _setup_dense)


def bvh_select_lib():
    """The loaded K5 library (csrc/bvh_select.cu), built on first use."""
    return _load("glome_bvh", _setup_bvh)


def micro_prims_lib():
    """The loaded M1 library (csrc/micro_prims.cu), built on first use."""
    return _load("glome_micro_prims", _setup_micro_prims)


def micro_kwide_lib():
    """The loaded M2 library (csrc/micro_kwide.cu), built on first use."""
    return _load("glome_micro_kwide", _setup_micro_kwide)


def finalize_hit_lib():
    """The loaded fused finalize library (csrc/finalize_hit.cu), built on
    first use."""
    return _load("glome_finalize", _setup_finalize)


def load_all():
    """Run every library's loader at once, so the nvcc builds overlap
    (chip_smoke.py builds every kernel inside its time limit); returns
    the paths of all the libraries, in LIBRARIES order."""
    loaders = (mega_select_lib, block_select_lib, mesh_select_lib,
               dense_select_lib, bvh_select_lib, micro_prims_lib,
               micro_kwide_lib, finalize_hit_lib)
    with ThreadPoolExecutor(len(loaders)) as pool:
        futs = [pool.submit(f) for f in loaders]
        for f in futs:
            f.result()
    return [library_path(name) for name in LIBRARIES]


def library_path(name: str) -> str:
    """The file of library `name` (a key of LIBRARIES), built if it is
    not there yet."""
    return build(LIBRARIES[name], name)


def ptxas_figures(log: str):
    """{mangled name: {registers, smem, stack_frame, spill_stores,
    spill_loads}} of every entry function in a build's ptxas -v log."""
    figs, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            cur = figs.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_frame=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return figs


def sass(path: str) -> str:
    """`cuobjdump -sass` of a built library (the toolkit's, beside
    nvcc): the machine code its kernels run."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {path} failed "
                           f"({proc.returncode}):\n{proc.stderr}")
    return proc.stdout


def check_launch(lib, err: int, what: str):
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        name = lib.glome_cuda_error_name(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({name})")


def check_tally(tally, rays, rows: int = 2):
    """A work tally must be a contiguous (rows, N) int32 tensor beside
    the rays (or None)."""
    if tally is None:
        return
    n = rays.shape[1]
    if (tally.dtype != torch.int32 or tuple(tally.shape) != (rows, n)
            or tally.device != rays.device or not tally.is_contiguous()):
        raise ValueError(f"tally must be a contiguous ({rows}, {n}) int32 "
                         f"tensor on {rays.device}")


def tally_ptr(tally):
    return None if tally is None else tally.data_ptr()
