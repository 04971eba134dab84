"""The K-wide frontier walk and tile-scratch reads, on the card (M2).

The counterpart of tools/micro_kwide.py (the TPU tool, whose Pallas
kernels csrc/micro_kwide.cu replaces):
  walk_K       a mock traversal over an implicit heap of M node boxes:
               the tile shares one stack; each iteration pops up to K
               nodes, slab-tests each against every ray of the tile, and
               pushes both children of each inner node some ray hit.  Its
               output is the nodes popped per tile; the time per node at
               K = 1, 2, 4, 8, 16 is what the tool compares.
  vread_NREAD  NREAD scalar reads of a tile scratch, summed in order.

Each build has a kernel wrapper, WALKS[K] or VREADS[NREAD] (CUDA tensors
launch csrc/micro_kwide.cu and count `launches`; CPU tensors take the
plain version) and a plain torch
version (`walk_plain`, `vread_plain`, counting `calls`).  make_inputs()
draws the tool's inputs with numpy in the tool's order.

    python -m glome_tpu_torch.tools.micro_kwide                  # the card
    python -m glome_tpu_torch.tools.micro_kwide --device cpu --tiles 2

On the card the rows give device milliseconds per launch
(tools.device_time), the nodes visited per tile and nanoseconds per node,
or per read; on the CPU the visited counts and checksums, never a time.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .micro_prims import Variant, check_device, launch, on_card, run_variants

T = 256
DEPTH = 10
M = 2 ** DEPTH - 1      # implicit heap
KS = (1, 2, 4, 8, 16)
NREADS = (16, 64)
# the walk's stack, the tool's (1024,) scratch; csrc/micro_kwide.cu's
# shared stack has as many entries and its C entry refuses a larger heap
STACK = 1024
TILE = 1024
# float32 operations per ray of one slab test (6 sub, 6 mul, 6 min/max of
# the pairs, 2 max, 2 min, 2 compares)
SLAB_OPS = 24
# bytes: the least a read moves from the card's memory
SECTOR = 32


def make_inputs(tiles: int = T):
    """(rays (8, tiles, 8, 128), nf (6M,)) float32, drawn as
    tools/micro_kwide.py draws them: rays, then per heap node a centre
    and a box of half-width 2.5 * 0.55**level, as (lo xyz, hi xyz)."""
    rng = np.random.default_rng(0)
    rays = rng.normal(size=(8, tiles, 8, 128)).astype(np.float32)
    rays[6] = 1e6
    nf = np.zeros((M, 6), np.float32)
    for i in range(M):
        lvl = int(np.floor(np.log2(i + 1)))
        c = rng.normal(size=3) * 0.5
        half = 2.5 * (0.55 ** lvl)
        nf[i, :3] = c - half
        nf[i, 3:] = c + half
    return rays, nf.reshape(-1)


# --- the plain versions --------------------------------------------------------

def _inv(d):
    return torch.reciprocal(torch.where(d == 0.0, 1e-20, d))


def _slab(box, ox, oy, oz, ivx, ivy, ivz):
    """tools/micro_kwide.py:56 slab for one box per tile (box (T, 6))."""
    b = box[:, :, None, None]
    t1x = (b[:, 0] - ox) * ivx
    t2x = (b[:, 3] - ox) * ivx
    t1y = (b[:, 1] - oy) * ivy
    t2y = (b[:, 4] - oy) * ivy
    t1z = (b[:, 2] - oz) * ivz
    t2z = (b[:, 5] - oz) * ivz
    near = torch.maximum(torch.maximum(torch.minimum(t1x, t2x),
                                       torch.minimum(t1y, t2y)),
                         torch.minimum(t1z, t2z))
    far = torch.minimum(torch.minimum(torch.maximum(t1x, t2x),
                                      torch.maximum(t1y, t2y)),
                        torch.maximum(t1z, t2z))
    return (near <= far) & (far > 0.0)


def _heap_size(name, nf):
    m = nf.numel() // 6
    if nf.dim() != 1 or nf.numel() != 6 * m or not 0 < m <= STACK:
        raise ValueError(f"{name}: nf must be (6M,) with 0 < M <= {STACK} "
                         f"(each node enters the stack at most once), got "
                         f"{tuple(nf.shape)}")
    return m


def walk_plain(rays, nf, K: int):
    """Every tile's walk at once (a per-tile stack; a tile with an empty
    stack pops nothing): returns (T, 8, 128) float32, the nodes popped by
    the tile, broadcast."""
    walk_plain.calls += 1
    m = _heap_size("walk_plain", nf)
    boxes = nf.view(m, 6)
    ox, oy, oz = rays[0], rays[1], rays[2]
    ivx, ivy, ivz = _inv(rays[3]), _inv(rays[4]), _inv(rays[5])
    n = rays.shape[1]
    dev = rays.device
    tile = torch.arange(n, device=dev)
    stack = torch.zeros((n, STACK), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    popped = torch.zeros(n, dtype=torch.int64, device=dev)
    while bool((sp > 0).any()):
        kk = torch.clamp(sp, max=K)
        nodes, hits = [], []
        for k in range(K):
            nd = stack[tile, torch.clamp(sp - 1 - k, min=0)]
            hit = _slab(boxes[nd], ox, oy, oz, ivx, ivy, ivz)
            nodes.append(nd)
            hits.append(hit.flatten(1).any(dim=1) & (k < kk))
        sp = sp - kk
        for k in range(K):
            push = hits[k] & (2 * nodes[k] + 2 < m)
            rows, at, nd = tile[push], sp[push], nodes[k][push]
            stack[rows, at] = 2 * nd + 1
            stack[rows, at + 1] = 2 * nd + 2
            sp = sp + 2 * push
        popped += kk
    return popped.to(torch.float32)[:, None, None].expand(n, 8, 128) \
        .contiguous()


walk_plain.calls = 0


def vread_plain(rays, nread: int):
    """acc = sum_{i < nread} ox[i % 8, (i*13) % 128] of each tile, in i
    order from 0, broadcast to the tile."""
    vread_plain.calls += 1
    ox = rays[0]
    acc = torch.zeros(ox.shape[0], dtype=torch.float32, device=rays.device)
    for i in range(nread):
        acc = acc + ox[:, i % 8, (i * 13) % 128]
    return acc[:, None, None].expand_as(ox).contiguous()


vread_plain.calls = 0


# --- the kernel wrappers -------------------------------------------------------
# Each checks its inputs, then on a CUDA tensor launches its kernel on the
# current stream (counting `launches`), on a CPU tensor runs its plain
# version; another device raises.

def c_call(name, *tables):
    """(C entry, its arguments after (rays, T)) of variant `name` on its
    tables (kernel_ab.py calls an earlier build's entries the same
    way)."""
    if name.startswith("walk_K"):
        (nf,) = tables
        return "glome_micro_walk", (nf.data_ptr(), nf.numel() // 6,
                                    int(name[6:]))
    return "glome_micro_vread", (int(name[6:]),)


def _launch(name, rays, *tables):
    from .. import kernels
    entry, args = c_call(name, *tables)
    return launch(kernels.micro_kwide_lib(), entry, rays, *args)


def _walk_wrapper(K: int):
    def walk_k(rays, nf):
        m = _heap_size(f"walk{K}", nf)
        if not on_card(f"walk{K}", rays, [("nf", nf, (6 * m,))]):
            return walk_plain(rays, nf, K)
        out = _launch(f"walk_K{K}", rays, nf)
        walk_k.launches += 1
        return out
    walk_k.__name__ = walk_k.__qualname__ = f"walk{K}"
    walk_k.__doc__ = f"K = {K}: walk_kernel<{K}> or walk_plain."
    walk_k.launches = 0
    return walk_k


def _vread_wrapper(nread: int):
    def vread_n(rays):
        if not on_card(f"vread{nread}", rays, []):
            return vread_plain(rays, nread)
        out = _launch(f"vread_{nread}", rays)
        vread_n.launches += 1
        return out
    vread_n.__name__ = vread_n.__qualname__ = f"vread{nread}"
    vread_n.__doc__ = (f"NREAD = {nread}: vread_kernel<{nread}> or "
                       f"vread_plain.")
    vread_n.launches = 0
    return vread_n


# one wrapper (and launch count) per build of the kernel
WALKS = {K: _walk_wrapper(K) for K in KS}
VREADS = {n: _vread_wrapper(n) for n in NREADS}


def _plain_walk(K):
    def plain(rays, nf, tally=None):
        out = walk_plain(rays, nf, K)
        if tally is not None:
            tally += out[:, 0, 0].to(torch.int64)
        return out
    return plain


def _plain_vread(nread):
    def plain(rays, tally=None):
        if tally is not None:
            tally += nread
        return vread_plain(rays, nread)
    return plain


def vread_sectors(nread: int) -> int:
    """The 32-byte sectors of a tile's ox (4096 bytes from a 32-byte
    boundary) that vread<nread>'s reads fall in: the least it moves."""
    return len({4 * ((i % 8) * 128 + (i * 13) % 128) // SECTOR
                for i in range(nread)})


def _vread_bytes(nread):
    return lambda rays: rays.shape[1] * SECTOR * vread_sectors(nread)


# the tool's rows (micro_prims.Variant): a walk's units are the nodes it
# visits, read from its output; a walk's pass tests K nodes, vread has no
# loop, stores its tile from 256 threads (csrc/micro_kwide.cu
# VREAD_THREADS) and reads only its sectors of ox
VREAD_GRID = (1, 256)
VARIANTS = tuple(
    [Variant(f"walk_K{K}", WALKS[K], _plain_walk(K), ("nf",), None, 6,
             SLAB_OPS * TILE, f"walk_kernelILi{K}E", K) for K in KS]
    + [Variant(f"vread_{n}", VREADS[n], _plain_vread(n), (), n, 1, 1,
               f"vread_kernelILi{n}E", 0, VREAD_GRID, _vread_bytes(n))
       for n in NREADS])
PLAIN = (walk_plain, vread_plain)


# --- the tool ------------------------------------------------------------------

def device_inputs(device, tiles: int = T):
    """{"rays", "nf"} of make_inputs(tiles) as tensors on `device`."""
    rays, nf = make_inputs(tiles)
    return {"rays": torch.as_tensor(rays, device=device),
            "nf": torch.as_tensor(nf, device=device)}


def run(device: str = "cuda", tiles: int = T):
    """micro_prims.run_variants of VARIANTS on make_inputs(tiles)."""
    check_device(device)
    return run_variants(VARIANTS, device_inputs(device, tiles))


def main(argv=None):
    """Print the tool's rows (see the module docstring); returns run()'s
    rows."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiles", type=int, default=T)
    args = ap.parse_args(argv)
    rows = run(args.device, args.tiles)
    if args.device == "cuda":
        print(f"# {torch.cuda.get_device_name(0)}, {args.tiles} tiles")
    for v, sec, out in rows:
        if v.units is None:                       # a walk
            nvis = float(out[0, 0, 0])
            line = f"K={v.name[6:]:>2s}  visited/tile={nvis:6.0f}"
            if sec is not None:
                line += (f"  {sec * 1e3:8.4f} ms  "
                         f"{sec * 1e9 / args.tiles / nvis:7.2f} ns/node")
        elif sec is None:
            line = (f"scratch scalar reads n={v.units:3d}  checksum "
                    f"{float(out[:, 0, 0].double().sum()):.9g}")
        else:
            line = (f"scratch scalar reads n={v.units:3d}  "
                    f"{sec * 1e3:8.4f} ms  "
                    f"{sec * 1e9 / args.tiles / v.units:7.2f} ns/read")
        print(line)
    return rows


if __name__ == "__main__":
    main()
