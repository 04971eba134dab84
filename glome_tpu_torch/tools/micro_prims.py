"""Microbenchmarks of traversal design constants, on the card (M1).

The counterpart of tools/micro_prims.py (the TPU tool, whose Pallas
bodies csrc/micro_prims.cu replaces).  Per tile of 1024 rays it measures:
  a. a while loop with one tile-wide any() vote per step
  b. dense sphere tests over all P spheres, no decisions
  c. the same with a tile-wide gate every LEAF spheres (8, 16, 32)
  d. a packed-bit readout: the tile's hit mask in eight 21-bit words, then
     a loop over the set bits
  e. lane-parallel sphere blocks: ray (sub, lane) against spheres
     sb * 128 + lane
  f. the all-pairs product of the tile's rays with 128 sphere centres on
     the tensor cores (3xTF32)

Each variant has a kernel wrapper (CUDA tensors launch csrc/micro_prims.cu
and count `launches`; CPU tensors take the plain version) and a plain
torch version (`*_plain`, counting `calls`).  Inputs are the tool's own:
make_inputs() draws them with numpy exactly as tools/micro_prims.py does.
Beside them: store_tile, a kernel of a variant's grid that only stores
its output (the launch floor), and the readers of a build's ptxas log
and SASS that give each variant's registers and its issue floor.

    python -m glome_tpu_torch.tools.micro_prims                  # the card
    python -m glome_tpu_torch.tools.micro_prims --device cpu --tiles 2

On the card each row is `name  ms  ns/unit/tile`: device milliseconds per
launch (tools.device_time) and nanoseconds per unit per tile, the units
being the tool's (STEPS, P or the spheres a variant names).  On the CPU
the plain versions run and each row is a checksum, never a time.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import re
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

T = 256          # tiles (the tool's size: 262,144 rays)
P = 1024         # spheres
STEPS = 256      # while-loop steps of (a)
TILE = 1024      # rays per tile, (8, 128)
MISS = 1e6

# float32 operations per ray of one sphere test (sph: 3 sub, 7 mul, 4 add,
# 2 sub, compare, max, sqrt, 2 add/sub, 2 select) and of keeping the
# nearest (compare, select, min); e computes t0 alone (no v + sq, one
# select) and keeps it with a min; f's epilogue per ray and sphere (mul,
# sub, max, sqrt, sub, compare, select, min) and its product, 2 * 8 TF32
# operations, issued three times
SPH_OPS = 23
KEEP_OPS = 3
LANE_OPS = SPH_OPS - 2 + 1
MXU_EPI_OPS = 8
MXU_TF32_OPS = 3 * 2 * 8


def make_inputs(tiles: int = T):
    """(rays (8, tiles, 8, 128), pf (4P,), pf_lane (4, 8, 128)) float32,
    drawn as tools/micro_prims.py draws them: rays[6] is the seed t 1e6,
    pf the row-major [cx cy cz r2] spheres with r2 = 0.05, pf_lane the
    same table field-major."""
    rng = np.random.default_rng(0)
    rays = rng.normal(size=(8, tiles, 8, 128)).astype(np.float32)
    rays[6] = 1e6
    pf = rng.normal(size=(P * 4,)).astype(np.float32)
    pf[3::4] = 0.05
    pf_lane = pf.reshape(P, 4).T.reshape(4, 8, 128).copy()
    return rays, pf, pf_lane


# --- the plain versions --------------------------------------------------------

def _sph(cx, cy, cz, r2, ox, oy, oz, dx, dy, dz):
    """tools/micro_prims.py:47 sph, op for op."""
    ex = cx - ox
    ey = cy - oy
    ez = cz - oz
    v = ex * dx + ey * dy + ez * dz
    disc = r2 - (ex * ex + ey * ey + ez * ez - v * v)
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    return torch.where(ok, v - sq, MISS), torch.where(ok, v + sq, MISS)


def _keep(bt, t0, t1):
    return torch.minimum(bt, torch.where(t0 > 0, t0, t1))


def _tally(tally, tests):
    if tally is not None:
        tally += tests


def vote_while_plain(rays, pf, tally=None):
    """(a) Every tile runs its own while loop over sphere i % P (all tiles
    at once, a finished tile masked); `tally`, a (T,) int64 tensor,
    receives each tile's sphere tests."""
    vote_while_plain.calls += 1
    ox, oy, oz, dx, dy, dz, seed = rays[:7]
    n_p = pf.numel() // 4
    rows = pf.view(n_p, 4)
    bt = seed.clone()
    i = torch.zeros(rays.shape[1], dtype=torch.int64, device=rays.device)
    for _ in range(STEPS):          # i grows by 1 or 2 a step
        live = i < STEPS
        s = rows[i % n_p][:, :, None, None]
        t0, t1 = _sph(s[:, 0], s[:, 1], s[:, 2], s[:, 3], ox, oy, oz, dx, dy,
                      dz)
        nb = _keep(bt, t0, t1)
        bt = torch.where(live[:, None, None], nb, bt)
        vote = (t0 < nb).flatten(1).any(dim=1)
        _tally(tally, live)
        i = torch.where(live, torch.where(vote, i + 1, i + 2), i)
    return bt


vote_while_plain.calls = 0


def dense_fori_plain(rays, pf, tally=None):
    """(b) Every ray against all P spheres in order."""
    dense_fori_plain.calls += 1
    ox, oy, oz, dx, dy, dz, seed = rays[:7]
    bt = seed
    rows = pf.view(-1, 4)
    for p in range(rows.shape[0]):
        s = rows[p]
        bt = _keep(bt, *_sph(s[0], s[1], s[2], s[3], ox, oy, oz, dx, dy, dz))
    _tally(tally, rows.shape[0])
    return bt


dense_fori_plain.calls = 0


def gated_plain(rays, pf, leaf: int, tally=None):
    """(c) Leaf l's LEAF spheres only for the tiles where some ray has
    bt > 0.05 * l, the product rounded in float32 (JAX's weak-typed float
    times int32)."""
    gated_plain.calls += 1
    ox, oy, oz, dx, dy, dz, seed = rays[:7]
    bt = seed
    rows = pf.view(-1, 4)
    for l in range(rows.shape[0] // leaf):
        thr = float(np.float32(0.05) * np.float32(l))
        gate = (bt > thr).flatten(1).any(dim=1)
        nb = bt
        for k in range(leaf):
            s = rows[l * leaf + k]
            nb = _keep(nb, *_sph(s[0], s[1], s[2], s[3], ox, oy, oz, dx, dy,
                                 dz))
        bt = torch.where(gate[:, None, None], nb, bt)
        _tally(tally, gate * leaf)
    return bt


gated_plain.calls = 0


def tile_words(rays):
    """(T, 8) int64: the tile's hit mask (ox + dx > 0) in the tool's
    21-bit words: bit k of word w is lane w*21 + k of sub-row 0 for w < 7
    (word 6: lanes 126 and 127) and lane k of sub-row 1 for w = 7."""
    hit = ((rays[0] + rays[3]) > 0.0).to(torch.int64)
    weight = 2 ** torch.arange(21, device=rays.device)
    words = [(hit[:, 0, 21 * w:21 * w + 21] * weight[:min(21, 128 - 21 * w)])
             .sum(dim=1) for w in range(7)]
    words.append((hit[:, 1, :21] * weight).sum(dim=1))
    return torch.stack(words, dim=1)


def bits168_plain(rays, pf, tally=None):
    """(d) Every ray of a tile tests sphere w*21 + k for each set bit k of
    the tile's word w (tile_words), in word then bit order."""
    bits168_plain.calls += 1
    ox, oy, oz, dx, dy, dz, seed = rays[:7]
    words = tile_words(rays)
    bt = seed
    rows = pf.view(-1, 4)
    for w in range(8):
        for k in range(21):
            on = ((words[:, w] >> k) & 1).bool()
            s = rows[w * 21 + k]
            nb = _keep(bt, *_sph(s[0], s[1], s[2], s[3], ox, oy, oz, dx, dy,
                                 dz))
            bt = torch.where(on[:, None, None], nb, bt)
            _tally(tally, on)
    return bt


bits168_plain.calls = 0


def lane8x128_plain(rays, pf_lane, tally=None):
    """(e) Ray (sub, lane) against spheres sb*128 + lane, sb < 8, keeping
    t0 (1e6 on a miss) with no t0 > 0 select."""
    lane8x128_plain.calls += 1
    ox, oy, oz, dx, dy, dz, seed = rays[:7]
    bt = seed
    for sb in range(8):
        t0, _t1 = _sph(pf_lane[0, sb], pf_lane[1, sb], pf_lane[2, sb],
                       pf_lane[3, sb], ox, oy, oz, dx, dy, dz)
        bt = torch.minimum(bt, t0)
    _tally(tally, 8)
    return bt


lane8x128_plain.calls = 0


def mxu_features(rays, pf_lane):
    """(rd (T, 1024, 8), feat (8, 128)) of tools/micro_prims.py:199-207:
    per ray [dx dy dz ox oy oz 1 0]; per sphere of block 0 its centre,
    then -c * 0 and two zero rows."""
    ox, oy, oz, dx, dy, dz = rays[:6]
    n = rays.shape[1]
    rd = torch.stack([dx, dy, dz, ox, oy, oz, torch.ones_like(ox),
                      torch.zeros_like(ox)], dim=-1).reshape(n, TILE, 8)
    c = pf_lane[0:3, 0]
    feat = torch.cat([c, -c * 0.0, torch.zeros(2, 128, device=c.device)])
    return rd, feat


def mxu128_plain(rays, pf_lane, tally=None):
    """(f) vm = d . c for every ray and the first 128 spheres (one
    float32 matmul); t0 = vm - sqrt(vm^2 - 0.05) where that is >= 0, else
    1e6; bt = min(seed, min over the spheres)."""
    mxu128_plain.calls += 1
    rd, feat = mxu_features(rays, pf_lane)
    vm = torch.matmul(rd, feat)
    disc = vm * vm - 0.05
    t0 = torch.where(disc >= 0.0, vm - torch.sqrt(torch.clamp_min(disc, 0.0)),
                     MISS)
    n = rays.shape[1]
    _tally(tally, 128)
    return torch.minimum(rays[6], t0.amin(dim=-1).reshape(n, 8, 128))


mxu128_plain.calls = 0


# --- the kernel wrappers -------------------------------------------------------
# Each checks its inputs, then on a CUDA tensor launches its kernel on the
# current stream (counting `launches`), on a CPU tensor runs its plain
# version; another device raises.

def on_card(name, rays, tables):
    """Check (8, T, 8, 128) rays and [(name, tensor, shape)] tables:
    float32, contiguous, on the rays' device, which is the CPU or a CUDA
    device; True on a CUDA device."""
    if rays.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {rays.device}")
    if rays.dim() != 4 or rays.shape[0] != 8 or tuple(rays.shape[2:]) != (
            8, 128):
        raise ValueError(f"{name}: rays must be (8, T, 8, 128), got "
                         f"{tuple(rays.shape)}")
    for tname, t, shape in [("rays", rays, tuple(rays.shape))] + tables:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != rays.device:
            raise ValueError(f"{name}: {tname} on {t.device}, rays on "
                             f"{rays.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    return rays.device.type == "cuda"


def _pf_on_card(name, rays, pf, min_spheres=1):
    """on_card for a row-major (4P,) sphere table with P >= min_spheres."""
    if pf.dim() != 1 or pf.numel() % 4 or pf.numel() < 4 * min_spheres:
        raise ValueError(f"{name}: pf must be (4P,) with P >= {min_spheres}, "
                         f"got {tuple(pf.shape)}")
    return on_card(name, rays, [("pf", pf, tuple(pf.shape))])


def launch(lib, entry: str, rays, *args):
    """Launch `entry` of the loaded library `lib` (its C signature: rays,
    T, *args, out, stream) on the rays' current stream; returns the
    (T, 8, 128) output."""
    from .. import kernels
    out = torch.empty(rays.shape[1:], dtype=torch.float32,
                      device=rays.device)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = getattr(lib, entry)(rays.data_ptr(), rays.shape[1], *args,
                                  out.data_ptr(), ctypes.c_void_p(stream))
    kernels.check_launch(lib, err, entry)
    return out


def _pf_call(entry):
    return lambda pf: (entry, (pf.data_ptr(), pf.numel() // 4))


# each variant's C entry and its arguments after (rays, T), from its
# tables (c_call)
_C_CALLS = {
    "a_vote_while": lambda pf: ("glome_micro_vote_while",
                                (pf.data_ptr(), pf.numel() // 4, STEPS)),
    "b_dense_fori": _pf_call("glome_micro_dense_fori"),
    **{f"c_gate{n}": _pf_call(f"glome_micro_gate{n}") for n in (8, 16, 32)},
    "d_bits168": _pf_call("glome_micro_bits168"),
    "e_lane8x128": lambda pfl: ("glome_micro_lane8x128", (pfl.data_ptr(),)),
    "f_mxu128": lambda pfl: ("glome_micro_mxu128", (pfl.data_ptr(),)),
}


def c_call(name: str, *tables):
    """(C entry, its arguments after (rays, T)) of variant `name` on its
    tables (kernel_ab.py calls an earlier build's entries the same
    way)."""
    return _C_CALLS[name](*tables)


def _launch(name: str, rays, *tables):
    """Launch variant `name`'s entry of this checkout's M1 library."""
    from .. import kernels
    entry, args = c_call(name, *tables)
    return launch(kernels.micro_prims_lib(), entry, rays, *args)


def vote_while(rays, pf):
    """(a): csrc/micro_prims.cu vote_while_kernel or vote_while_plain."""
    if not _pf_on_card("vote_while", rays, pf):
        return vote_while_plain(rays, pf)
    out = _launch("a_vote_while", rays, pf)
    vote_while.launches += 1
    return out


def dense_fori(rays, pf):
    """(b): dense_fori_kernel or dense_fori_plain."""
    if not _pf_on_card("dense_fori", rays, pf):
        return dense_fori_plain(rays, pf)
    out = _launch("b_dense_fori", rays, pf)
    dense_fori.launches += 1
    return out


def _gate_wrapper(leaf: int):
    def gate(rays, pf):
        if not _pf_on_card(f"gate{leaf}", rays, pf):
            return gated_plain(rays, pf, leaf)
        out = _launch(f"c_gate{leaf}", rays, pf)
        gate.launches += 1
        return out
    gate.__name__ = gate.__qualname__ = f"gate{leaf}"
    gate.__doc__ = f"(c), LEAF = {leaf}: gated_kernel<{leaf}> or gated_plain."
    gate.launches = 0
    return gate


gate8, gate16, gate32 = (_gate_wrapper(n) for n in (8, 16, 32))


def bits168(rays, pf):
    """(d): bits168_kernel or bits168_plain; pf holds >= 168 spheres."""
    if not _pf_on_card("bits168", rays, pf, min_spheres=8 * 21):
        return bits168_plain(rays, pf)
    out = _launch("d_bits168", rays, pf)
    bits168.launches += 1
    return out


def lane8x128(rays, pf_lane):
    """(e): lane8x128_kernel or lane8x128_plain."""
    if not on_card("lane8x128", rays, [("pf_lane", pf_lane, (4, 8, 128))]):
        return lane8x128_plain(rays, pf_lane)
    out = _launch("e_lane8x128", rays, pf_lane)
    lane8x128.launches += 1
    return out


def mxu128(rays, pf_lane):
    """(f): mxu128_kernel (wgmma TF32, 3xTF32 split) or mxu128_plain."""
    if not on_card("mxu128", rays, [("pf_lane", pf_lane, (4, 8, 128))]):
        return mxu128_plain(rays, pf_lane)
    out = _launch("f_mxu128", rays, pf_lane)
    mxu128.launches += 1
    return out


def store_tile(rays, grid):
    """The launch floor of a grid (blocks per tile, threads per block):
    csrc/micro_prims.cu store_tile_kernel on rays' T tiles, which only
    stores its (T, 8, 128) output (zeros).  Needs CUDA rays."""
    from .. import kernels
    if not on_card("store_tile", rays, []):
        raise ValueError("store_tile: the launch floor is a card kernel")
    return launch(kernels.micro_prims_lib(), "glome_micro_store_tile", rays,
                  *grid)


for _fn in (vote_while, dense_fori, bits168, lane8x128, mxu128):
    _fn.launches = 0


# --- the variants --------------------------------------------------------------

@dataclass(frozen=True)
class Variant:
    """One row of a tool: its kernel wrapper and plain version (both
    (rays, *tables) -> (T, 8, 128); the plain version also takes
    `tally`, a (T,) int64 tensor that receives each tile's tests), the
    names of the tables they read, the tool's units per tile (None: the
    output counts them), the ray components read, and the float32
    operations of one test (a sphere, node or read) over a whole tile.
    Then the kernel as built: a fragment of its mangled name, the tests
    one pass of its hot loop makes for a ray (a thread's share of them
    where several threads serve a ray; 0: a kernel with no loop, whose
    every instruction a thread issues once), and its grid per tile
    (blocks, threads per block).  Last, the bytes its function reads of
    the rays, as a function of them (None: its ray_comps components
    whole)."""
    name: str
    kernel: Callable
    plain: Callable
    tables: tuple
    units: int | None
    ray_comps: int
    tile_ops: int
    symbol: str
    per_pass: int = 1
    grid: tuple = (1, TILE)
    ray_bytes: Callable | None = None


def moved_bytes(v: Variant, inputs) -> int:
    """The bytes variant v's function must move on `inputs` (a dict of
    tensors: "rays" and its tables), the numerator of its bound: what it
    reads of the rays, each of its tables once and its (T, 8, 128) output
    once."""
    rays = inputs["rays"]
    n_rays = rays[0].numel()
    reads = (v.ray_bytes(rays) if v.ray_bytes is not None
             else 4 * v.ray_comps * n_rays)
    return (reads + 4 * n_rays
            + sum(4 * inputs[t].numel() for t in v.tables))


_TEST_OPS = (SPH_OPS + KEEP_OPS) * TILE

# b's tests per pass of its sphere loop, the (ray, sphere) pairs one
# thread of f covers per pass of its loop over two 64-sphere halves (32
# accumulators: 16 spheres for each of its 2 rays), and the grids of the
# split variants (csrc/micro_prims.cu DENSE_UNROLL, MXU_ACC, SPLIT,
# MXU_SPLIT)
DENSE_UNROLL = 4
MXU_PASS = 32
SPLIT_GRID = (4, 256)
MXU_GRID = (16, 128)

VARIANTS = (
    Variant("a_vote_while", vote_while, vote_while_plain, ("pf",), STEPS, 7,
            _TEST_OPS + TILE,                       # + the vote's compare
            "vote_while_kernel"),
    Variant("b_dense_fori", dense_fori, dense_fori_plain, ("pf",), P, 7,
            _TEST_OPS, "dense_fori_kernel", DENSE_UNROLL, SPLIT_GRID),
    Variant("c_gate8", gate8, functools.partial(gated_plain, leaf=8),
            ("pf",), P, 7, _TEST_OPS, "gated_kernelILi8E", 8),
    Variant("c_gate16", gate16, functools.partial(gated_plain, leaf=16),
            ("pf",), P, 7, _TEST_OPS, "gated_kernelILi16E", 16),
    Variant("c_gate32", gate32, functools.partial(gated_plain, leaf=32),
            ("pf",), P, 7, _TEST_OPS, "gated_kernelILi32E", 32),
    Variant("d_bits168", bits168, bits168_plain, ("pf",), 168, 7, _TEST_OPS,
            "bits168_kernel"),
    Variant("e_lane8x128", lane8x128, lane8x128_plain, ("pf_lane",), P, 7,
            LANE_OPS * TILE, "lane8x128_kernel", 0, SPLIT_GRID),
    Variant("f_mxu128", mxu128, mxu128_plain, ("pf_lane",), 128, 7,
            MXU_EPI_OPS * TILE, "mxu128_kernel", MXU_PASS, MXU_GRID),
)
PLAIN = (vote_while_plain, dense_fori_plain, gated_plain, bits168_plain,
         lane8x128_plain, mxu128_plain)

# f against its plain version: the 3xTF32 product carries ~1e-6 relative
# error where the plain float32 matmul rounds differently, and the min
# over 128 spheres is taken of t0 = vm - sqrt(vm^2 - 0.05), ill-conditioned
# near disc = 0; held to rtol / atol 1e-4 on >= 99.9% of rays
MXU_RTOL, MXU_ATOL, MXU_AGREE = 1e-4, 1e-4, 0.999


# --- the build: SASS and the issue floor -----------------------------------------
# SMs and lanes issuing one thread-instruction each per cycle: the floor
# of a launch is its thread-instructions over (SMs x LANES x SM clock)
LANES_PER_SM = 128


def sass_functions(text: str):
    """{function name: [(address, opcode, branch target or None)]} of
    `cuobjdump -sass` output; NOPs are left out.  A branch names its
    target as an address (BRA 0x1a0) or a label (BRA `(.L_x_3)), whose
    line precedes the instruction it labels."""
    funcs, labels = {}, {}
    cur, pending = None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur, pending = m.group(1), []
            funcs[cur], labels[cur] = [], {}
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m is None or cur is None:
            continue
        addr = int(m.group(1), 16)
        labels[cur].update((lab, addr) for lab in pending)
        pending = []
        words = m.group(2).split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if not words or words[0] == "NOP":
            continue
        target = None
        if words[0].startswith("BRA"):
            rest = " ".join(words[1:])
            t = re.search(r"\(\s*(\.L_x_\d+)\s*\)", rest)
            if t:
                target = t.group(1)
            else:
                t = re.search(r"0x([0-9a-f]+)", rest)
                target = int(t.group(1), 16) if t else None
        funcs[cur].append((addr, words[0], target))
    return {name: [(a, op, labels[name].get(t) if isinstance(t, str) else t)
                   for a, op, t in instrs]
            for name, instrs in funcs.items()}


def innermost_loops(instrs):
    """[(first address, back-edge address, instructions)] of the loops of
    one function: each backward branch and its target bound a loop; the
    innermost are those that hold no other loop."""
    loops = [(tgt, addr) for addr, _op, tgt in instrs
             if isinstance(tgt, int) and tgt <= addr]
    inner = [(a, b) for a, b in loops
             if not any((a, b) != (c, d) and a <= c and d <= b
                        for c, d in loops)]
    return [(a, b, sum(1 for addr, _o, _t in instrs if a <= addr <= b))
            for a, b in sorted(set(inner))]


def hot_loop(instrs):
    """Instructions of a function's largest innermost loop (0 without
    one)."""
    return max((n for _a, _b, n in innermost_loops(instrs)), default=0)


def thread_instructions(instrs, per_pass: int):
    """Instructions a thread issues per test: its hot loop's over the
    tests one pass makes, or, for a kernel with no loop (per_pass 0),
    the whole function's."""
    if per_pass == 0:
        return float(len(instrs))
    body = hot_loop(instrs)
    if body == 0:
        raise ValueError("no loop in the function")
    return body / per_pass


def find_function(funcs, symbol: str):
    """The one function whose mangled name holds `symbol`."""
    hits = [name for name in funcs if symbol in name]
    if len(hits) != 1:
        raise KeyError(f"{symbol!r} names {len(hits)} functions: {hits}")
    return hits[0]


def issue_floor(v: Variant, funcs, tests: int, tiles: int, sms: int,
                clock_mhz: float):
    """(ms, thread-instructions per test) of variant v's launch over
    `tiles` tiles at the issue rate of `sms` SMs x LANES_PER_SM lanes at
    clock_mhz.  A looping kernel issues its instructions per test for
    each of `tests` (its tiles' tests, summed) on each ray of a tile, and
    the rest of its function once on each of its threads; a kernel with
    no loop issues its whole function on each thread.  The SASS count
    includes branches not taken (the slow path's call sites), so this is
    the floor of the code as compiled, a little above what runs."""
    instrs = funcs[find_function(funcs, v.symbol)]
    per = thread_instructions(instrs, v.per_pass)
    threads = tiles * v.grid[0] * v.grid[1]
    if v.per_pass:
        total = per * tests * TILE + (len(instrs) - hot_loop(instrs)) * threads
    else:
        total = per * threads
    return total / (sms * LANES_PER_SM * clock_mhz * 1e6) * 1e3, per


def device_inputs(device, tiles: int = T):
    """{"rays", "pf", "pf_lane"} of make_inputs(tiles) as tensors on
    `device`."""
    rays, pf, pf_lane = make_inputs(tiles)
    return {k: torch.as_tensor(v, device=device)
            for k, v in (("rays", rays), ("pf", pf), ("pf_lane", pf_lane))}


def check_device(device: str):
    """Raise unless `device` is "cpu" or "cuda" with a CUDA device."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (--device cpu runs the plain "
                           "versions, untimed)")


def run_variants(variants, inputs):
    """[(variant, seconds per launch or None, output)]: each variant's
    wrapper on `inputs` (a dict of tensors: "rays" and its tables); on
    CUDA tensors timed by device_time, on CPU tensors untimed."""
    from .device_time import device_time
    rows = []
    for v in variants:
        args = (inputs["rays"], *(inputs[t] for t in v.tables))
        out = v.kernel(*args)
        sec = (device_time(lambda: v.kernel(*args))
               if inputs["rays"].is_cuda else None)
        rows.append((v, sec, out))
    return rows


def run(device: str = "cuda", tiles: int = T):
    """run_variants of VARIANTS on make_inputs(tiles) on `device`."""
    check_device(device)
    return run_variants(VARIANTS, device_inputs(device, tiles))


def main(argv=None):
    """Print one row per variant (see the module docstring); returns the
    rows of run()."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiles", type=int, default=T)
    args = ap.parse_args(argv)
    rows = run(args.device, args.tiles)
    if args.device == "cuda":
        print(f"# {torch.cuda.get_device_name(0)}, {args.tiles} tiles")
    for v, sec, out in rows:
        if sec is None:
            print(f"{v.name:14s} checksum {float(out.double().sum()):.9g}")
        else:
            per = sec * 1e9 / args.tiles / v.units
            print(f"{v.name:14s} {sec * 1e3:8.4f} ms  {per:8.2f} "
                  f"ns/unit/tile")
    return rows


if __name__ == "__main__":
    main()
