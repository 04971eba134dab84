"""Block-BVH selection for giant flat-triangle groups (K3).

glome_tpu routes a plain, untransformed, unconstrained triangle group
whose select table (9 floats a triangle) exceeds
megakernel.BLOCK_VMEM_MAX to its Pallas mesh kernel
(glome_tpu/mesh_kernel.py:mesh_block_select), which kept the table in
HBM and DMA'd only the leaf blocks a ray tile could reach.  The port
keeps that contract -- a BVH over blocks of triangles, the table stored
in leaf order, the winner an index into that permuted table mapped back
through plan.sel_to_local -- and sizes the blocks for a CUDA thread
instead of a TPU lane row.  Its tree is strictly binary
(accel.build_bvh2, laid out as accel.node_records), so the kernel walks
it near child first with K2's walk (csrc/bvh_walk.cuh), where glome_tpu
walks a skip-link tree.

  - MeshBlockPlan / get_block_plan: the host plan of one group;
  - pack_tri_blocks: the (n_blocks * BP, TRI_F) permuted triangle table
    (mesh_tables: a group's, from the scene tensors);
  - mesh_block_select: the hand-written CUDA kernel
    (csrc/mesh_block_select.cu) on CUDA tensors, mesh_block_select_plain
    on CPU tensors;
  - mesh_block_pass: one group's pass, group-local triangle or -1.

Flat triangles only: their exit crossing is always a miss, so the
winner needs no entry/exit slot bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import accel as A
from .config import INFINITY
from .megakernel import _PLAIN_BUDGET, _candidates

INF = INFINITY

# triangles per block and blocks per BVH leaf.  glome_tpu used 128 x 4:
# one lane row per block and a DMA per block, so a leaf moved 512
# triangles at once.  A CUDA thread tests a leaf's rows one after another
# from L2, so leaves stay small: one block of 4 triangles (192 bytes).  Of
# 4 or 8 rows a block and 1 or 2 blocks a leaf, this was the fastest on
# the H100, and 8 x 2 the slowest (PERF.md).
BP = 4
BLOCK_LEAF_MAX = 1
# floats per row (TRI_F in the kernel): p1, p2, p3, the fields the
# triangle t-kernel reads, then 3 zeros, so a row is three aligned
# 16-byte loads
TRI_F = 12


class MeshBlockPlan:
    """Host-side static plan for one group: a binary BVH over blocks of
    BP triangles (at most BLOCK_LEAF_MAX blocks per leaf) as child-pair
    records, and the permutation of triangle rows into its leaf order."""

    def __init__(self, g):
        P = g.size
        self.n_blocks = (P + BP - 1) // BP
        bmin, bmax = A.group_bounds(g)
        padP = self.n_blocks * BP - P
        if padP:
            # padded bounds collapse to the last prim's box (harmless:
            # padded rows are zero, degenerate triangles that never hit)
            bmin = np.concatenate([bmin, np.repeat(bmin[-1:], padP, 0)])
            bmax = np.concatenate([bmax, np.repeat(bmax[-1:], padP, 0)])
        blk_min = bmin.reshape(self.n_blocks, BP, 3).min(axis=1)
        blk_max = bmax.reshape(self.n_blocks, BP, 3).max(axis=1)
        self.bvh = bvh = A.build_bvh2(blk_min, blk_max,
                                      leaf_max=BLOCK_LEAF_MAX)
        block_order = np.asarray(bvh.order, np.int64)  # perm of blocks
        # a leaf's blocks are contiguous in leaf order: one run of rows
        self.nodes = A.node_records(bvh.bmin, bvh.bmax, bvh.left, bvh.right,
                                    bvh.leaf_start * BP,
                                    bvh.leaf_count * BP).reshape(-1)
        self.n_nodes = bvh.n_nodes
        self.depth = bvh.depth
        # permuted-row -> group-local triangle (-1 = padding), and the
        # row gather that builds the permuted table
        self.row_perm = (np.repeat(block_order * BP, BP)
                         + np.tile(np.arange(BP), self.n_blocks))
        self.sel_to_local = np.where(self.row_perm < P, self.row_perm,
                                     -1).astype(np.int32)
        self.padP = padP

    def device_tables(self, device):
        """(nodes, row_perm, sel_to_local) on `device`, cached per
        device."""
        cache = self.__dict__.setdefault("_dev", {})
        key = str(device)
        if key not in cache:
            cache[key] = tuple(
                torch.as_tensor(a, device=device) for a in
                (self.nodes, self.row_perm, self.sel_to_local))
        return cache[key]


def get_block_plan(g) -> MeshBlockPlan:
    """The group's MeshBlockPlan, built once and cached on the group."""
    plan = getattr(g, "_mesh_plan_t", None)
    if plan is None:
        plan = MeshBlockPlan(g)
        g._mesh_plan_t = plan
    return plan


def pack_tri_blocks(plan: MeshBlockPlan, params) -> torch.Tensor:
    """(n_blocks * BP, TRI_F) float32 rows [p1, p2, p3, 0, 0, 0] in leaf
    order, padded with zero rows (`params` detached)."""
    rows = torch.cat([params[k] for k in ("p1", "p2", "p3")],
                     dim=-1).to(torch.float32)
    rows = torch.cat([rows, rows.new_zeros((rows.shape[0], TRI_F - 9))], -1)
    if plan.padP:
        rows = torch.cat([rows, rows.new_zeros((plan.padP, TRI_F))])
    _nodes, row_perm, _s2l = plan.device_tables(rows.device)
    return rows[row_perm].contiguous()


def _check_launch(plan, tri, rays, seed):
    dev = rays.device
    if rays.dim() != 2 or rays.shape[0] < 6:
        raise ValueError(f"rays must be (>=6, N), got {tuple(rays.shape)}")
    n = rays.shape[1]
    if seed.shape != (n,):
        raise ValueError(f"seed must be ({n},), got {tuple(seed.shape)}")
    if tuple(tri.shape) != (plan.n_blocks * BP, TRI_F):
        raise ValueError(f"tri must be {(plan.n_blocks * BP, TRI_F)}, "
                         f"got {tuple(tri.shape)}")
    for name, t in (("rays", rays), ("seed", seed), ("tri", tri)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, rays on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def mesh_block_select(plan: MeshBlockPlan, tri, rays, seed,
                      shadow: bool = False, tally=None):
    """(t, sel): the nearest triangle of the group per ray.

    rays: (8, N) float32 component planes (rows 0-5 = o, d are read);
    seed: (N,) float32 start best t (<= 0 = dead lane).  sel indexes the
    PERMUTED table (map through plan.sel_to_local); t == seed and
    sel == -1 where nothing is nearer.  shadow=True is any-hit: only
    sel >= 0 is meaningful.

    A CUDA tensor launches csrc/mesh_block_select.cu on the current
    stream; a CPU tensor runs mesh_block_select_plain.  `tally` as in
    megakernel.mega_select."""
    if rays.device.type == "cpu" and tally is None:
        return mesh_block_select_plain(plan, tri, rays, seed, shadow)
    if rays.device.type != "cuda":
        raise ValueError(
            f"mesh_block_select: unsupported device {rays.device}")
    from . import kernels
    _check_launch(plan, tri, rays, seed)
    kernels.check_tally(tally, rays)
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    sel = torch.empty(n, dtype=torch.int32, device=rays.device)
    if n == 0:
        return t, sel
    nodes, _perm, _s2l = plan.device_tables(rays.device)
    lib = kernels.mesh_select_lib()
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = lib.glome_mesh_block_select(
            rays.data_ptr(), n, seed.data_ptr(), nodes.data_ptr(),
            plan.n_nodes, tri.data_ptr(), kernels.walk_stack(plan.depth),
            int(bool(shadow)), t.data_ptr(), sel.data_ptr(),
            kernels.tally_ptr(tally), ctypes.c_void_p(stream))
    kernels.check_launch(lib, err, "mesh_block_select")
    mesh_block_select.launches += 1
    return t, sel


mesh_block_select.launches = 0


def mesh_block_select_plain(plan: MeshBlockPlan, tri, rays, seed,
                            shadow: bool = False):
    """Plain torch version of mesh_block_select: every live ray against
    every permuted row, rays in chunks to bound memory.  The best
    candidate is the least (t, row), the first row of an exact tie as
    argmin takes it here; the kernel's near-first walk keeps the same
    row whatever order it visits the leaves in.  Shadow mode finds the
    nearest blocker; only sel >= 0 is meaningful there."""
    mesh_block_select_plain.calls += 1
    n = rays.shape[1]
    bt = seed.clone()
    bl = torch.full((n,), -1, dtype=torch.int64, device=rays.device)
    idx = torch.nonzero(seed > 0.0)[:, 0]
    chunk = max(1, _PLAIN_BUDGET // tri.shape[0])
    for s in range(0, idx.numel(), chunk):
        ix = idx[s:s + chunk]
        b_t = bt[ix]
        t0, _t1 = _candidates("triangle", tri, TRI_F, False,
                              rays[0:3, ix].t(), rays[3:6, ix].t())
        tc = torch.where((t0 > 0.0) & (t0 < b_t[:, None]), t0,
                         torch.full_like(t0, INF))
        tmin, arg = torch.min(tc, dim=1)
        better = tmin < b_t
        bt[ix] = torch.where(better, tmin, b_t)
        bl[ix] = torch.where(better, arg, bl[ix])
    return bt, torch.where(bt < seed, bl, -1).to(torch.int32)


mesh_block_select_plain.calls = 0


def mesh_tables(sc, garrs, gi) -> torch.Tensor:
    """pack_tri_blocks' table of group gi of a packed scene (`garrs` the
    scene's device arrays)."""
    from .compile import group_device_params
    g = sc.groups[gi]
    ga = {k: v.detach() for k, v in group_device_params(g, garrs[gi]).items()
          if k in ("p1", "p2", "p3")}
    return pack_tri_blocks(get_block_plan(g), ga)


def mesh_block_pass(sc, garrs, gi, rays, seed, shadow: bool,
                    select=mesh_block_select, tri=None):
    """(t, local) of group gi of a packed scene: the group-local
    triangle, -1 = nothing beat `seed`.  `garrs` are the scene's device
    arrays; `select` is mesh_block_select or mesh_block_select_plain;
    `tri` the group's mesh_tables, or None to pack it here."""
    g = sc.groups[gi]
    plan = get_block_plan(g)
    if tri is None:
        tri = mesh_tables(sc, garrs, gi)
    t, sel = select(plan, tri, rays, seed.detach().contiguous(), shadow)
    s2l = plan.device_tables(rays.device)[2]
    return t, torch.where(sel >= 0, s2l[torch.clamp(sel, min=0).long()], -1)
