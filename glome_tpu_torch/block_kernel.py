"""Block-dense selection for big primitive groups of any type (K2).

glome_tpu routes a group to its Pallas block kernel
(glome_tpu/block_kernel.py:block_select) when it is too big for the
megakernel's SMEM scalar tables (megakernel.BLOCK_MIN prims) and has at
most BLOCK_CONS_MAX constraint rows: the 100k-triangle mesh of
scenes/meshscene.py, big sphere lattices, transformed instance groups,
difference constraints.  The kernel is a separate launch seeded with the
best t of the launches before it, and only SELECTS (t, row*2 + slot);
megakernel.finalize re-evaluates the winner differentiably.

  - BlockPlan / get_block_plan: the host plan of one group.  Packed
    group rows are already Morton-ordered by the compiler
    (compile._morton_order, so glome_tpu's unused
    block_kernel.morton_order has no counterpart here), so consecutive
    runs of BP rows are spatially compact blocks and the table needs no
    permutation; a strictly binary BVH (accel.build_bvh2, one block per
    leaf) is built over the block AABBs and laid out as child-pair
    records (accel.node_records).
  - pack_blocks / pack_cons: the (n_blocks, BP, F) row table and the
    flat constraint-member rows, from the scene tensors (block_tables:
    both of a group).
  - block_select: the hand-written CUDA kernel (csrc/block_select.cu) on
    CUDA tensors, block_select_plain on CPU tensors.
  - block_pass: one group's pass, group-local row*2 + slot.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import accel as A
from .config import INFINITY
from .megakernel import (FIELDS, PTYPE_CODE, _PLAIN_BUDGET, _candidates,
                         _inside_comp)

INF = INFINITY

# prims per block.  On the TPU bp was the sublane width of the dense
# leaf test, and it doubled until the block BVH fit SMEM
# (glome_tpu MAX_BLOCKS = 2048, so bp = 64 at 100k triangles).  A CUDA
# thread tests a leaf's rows one after another and reads the tree's
# records from L2, so there is no node cap and the leaf stays narrow: 4
# rows against the 2 box tests of each inner node.  On the H100, 4-row
# blocks halve the triangle tests of mesh100k's rays against 8-row ones
# and take a third less time (PERF.md).  Results do not depend on bp: an
# exact tie goes to the lowest row, in the kernel as in the plain
# version.
BP = 4

# the select table only carries the fields the t-kernel reads:
# trianglenorm's n1..n3 are finalize's job (the triangle t-kernel reads
# p1..p3 only), which halves a smooth mesh's table (7.2 -> 3.6 MB at 100k)
SELECT_FIELDS = dict(FIELDS)
SELECT_FIELDS["trianglenorm"] = FIELDS["triangle"]

# floats per row of an untransformed triangle group: p1, p2, p3, then 3
# zeros, so the kernel reads a row as three aligned 16-byte loads (as K3's
# rows, mesh_kernel.TRI_F)
TRI_F = 12
TRI_PTYPES = ("triangle", "trianglenorm")

# constraint descriptor widths (CC_W / CMB_W in csrc/cons.cuh)
CC_W = 3     # positive, member_start, member_count
CMB_W = 5    # ptype, cf_off, M, Fm, has_inv


def _field_width(ptype):
    return sum(w for _, w in SELECT_FIELDS[ptype])


class BlockPlan:
    """Host-side static plan for one group: blocks of BP packed rows,
    a binary BVH over the blocks and the constraint member tables."""

    def __init__(self, g, sc):
        P = g.size
        self.ptype = g.ptype
        self.transformed = g.m_inv is not None
        self.nfld = _field_width(g.ptype)
        self.F = self.nfld + (12 if self.transformed else 0)
        if self.ptype in TRI_PTYPES and not self.transformed:
            self.F = TRI_F
        bmin, bmax = A.group_bounds(g)
        self.n_blocks = (P + BP - 1) // BP
        padP = self.n_blocks * BP - P
        # pad by replicating the last prim: real geometry, so padded
        # rows can win only with a result identical to the prim they
        # duplicate (never a phantom hit, unlike zero rows)
        if padP:
            bmin = np.concatenate([bmin, np.repeat(bmin[-1:], padP, 0)])
            bmax = np.concatenate([bmax, np.repeat(bmax[-1:], padP, 0)])
        blk_min = bmin.reshape(self.n_blocks, BP, 3).min(axis=1)
        blk_max = bmax.reshape(self.n_blocks, BP, 3).max(axis=1)
        self.bvh = bvh = A.build_bvh2(blk_min, blk_max, leaf_max=1)
        # a leaf's rows are its ORIGINAL block's (the table is unpermuted)
        leaf = bvh.leaf_count > 0
        self.leaf_block = np.where(
            leaf, np.asarray(bvh.order)[np.clip(bvh.leaf_start, 0,
                                                self.n_blocks - 1)], -1)
        self.nodes = A.node_records(bvh.bmin, bvh.bmax, bvh.left, bvh.right,
                                    self.leaf_block * BP,
                                    np.where(leaf, BP, 0)).reshape(-1)
        self.n_nodes = bvh.n_nodes
        self.depth = bvh.depth
        # constraints: [(positive, [(ptype, cf_off, M, Fm, has_inv)])]
        self.cons = []
        self.cons_spec = []   # [(gi2, member row indices)] pack spec
        if g.constraints:
            off = 0
            for positive, members in g.constraints:
                ms = []
                for gi2, idx in members:
                    g2 = sc.groups[gi2]
                    has_inv = g2.m_inv is not None
                    Fm = _field_width(g2.ptype) + (12 if has_inv else 0)
                    M = len(idx)
                    if M == 0:
                        continue
                    ms.append((g2.ptype, off, M, Fm, has_inv))
                    self.cons_spec.append((gi2, np.asarray(idx, np.int64)))
                    off += M * Fm
                self.cons.append((bool(positive), ms))
        self.cdesc = encode_cons(self.cons)

    def device_tables(self, device):
        """(nodes, cdesc) on `device`, cached per device."""
        cache = self.__dict__.setdefault("_dev", {})
        key = str(device)
        if key not in cache:
            cache[key] = tuple(torch.as_tensor(a, device=device)
                               for a in (self.nodes, self.cdesc))
        return cache[key]


def encode_cons(cons) -> np.ndarray:
    """The constraint list as the kernel's int32 descriptor:
    [n_clauses, (positive, member_start, member_count) per clause,
    (ptype, cf_off, M, Fm, has_inv) per member]."""
    head = [len(cons)]
    members = []
    m_base = 1 + CC_W * len(cons)
    for positive, ms in cons:
        head += [int(positive), m_base + CMB_W * len(members), len(ms)]
        members += [[PTYPE_CODE[pt], off, M, Fm, int(inv)]
                    for pt, off, M, Fm, inv in ms]
    return np.asarray(head + [v for m in members for v in m], np.int32)


def get_block_plan(g, sc) -> BlockPlan:
    """The group's BlockPlan (`sc` the packed scene that holds it), built
    once and cached on the group."""
    plan = getattr(g, "_block_plan_t", None)
    if plan is None:
        plan = BlockPlan(g, sc)
        g._block_plan_t = plan
    return plan


def _rows(ptype, ga, with_inv):
    """(P, F) float32 SELECT_FIELDS columns [+ 12 inverse-matrix]."""
    cols = []
    for name, _w in SELECT_FIELDS[ptype]:
        v = ga[name]
        cols.append(v.reshape(v.shape[0], -1) if v.dim() > 1 else v[:, None])
    if with_inv:
        cols.append(ga["m_inv"].reshape(-1, 12))
    return torch.cat(cols, dim=-1).to(torch.float32)


def pack_blocks(plan: BlockPlan, params) -> torch.Tensor:
    """(n_blocks, BP, F) float32 table of the group's rows in packed
    order, padded by copies of the last row (`params` detached);
    untransformed triangle rows end in TRI_F - 9 zeros."""
    rows = _rows(plan.ptype, params, plan.transformed)
    if rows.shape[1] < plan.F:
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0],
                                                plan.F - rows.shape[1]))], 1)
    padP = plan.n_blocks * BP - rows.shape[0]
    if padP:
        rows = torch.cat([rows, rows[-1:].expand(padP, -1)])
    return rows.reshape(plan.n_blocks, BP, plan.F).contiguous()


def pack_cons(plan: BlockPlan, sc, garrs, device) -> torch.Tensor:
    """Flat float32 table of the constraint member rows (`garrs` the
    scene's device arrays), detached."""
    from .compile import group_device_params
    if not plan.cons_spec:
        return torch.zeros(1, dtype=torch.float32, device=device)
    # the member index arrays on the device, cached per device: a
    # captured frame must not copy from the host
    cache = plan.__dict__.setdefault("_dev_cons_idx", {})
    if str(device) not in cache:
        cache[str(device)] = [torch.as_tensor(idx, device=device)
                              for _gi2, idx in plan.cons_spec]
    parts = []
    for (gi2, _idx), idx_t in zip(plan.cons_spec, cache[str(device)]):
        g2 = sc.groups[gi2]
        ga = {k: v.detach() for k, v in
              group_device_params(g2, garrs[gi2]).items()}
        rows = _rows(g2.ptype, ga, g2.m_inv is not None)
        parts.append(rows[idx_t].reshape(-1))
    return torch.cat(parts)


def _check_launch(plan, tab, cf, rays, seed):
    dev = rays.device
    if rays.dim() != 2 or rays.shape[0] < 6:
        raise ValueError(f"rays must be (>=6, N), got {tuple(rays.shape)}")
    n = rays.shape[1]
    if seed.shape != (n,):
        raise ValueError(f"seed must be ({n},), got {tuple(seed.shape)}")
    if tuple(tab.shape) != (plan.n_blocks, BP, plan.F):
        raise ValueError(f"tab must be {(plan.n_blocks, BP, plan.F)}, "
                         f"got {tuple(tab.shape)}")
    for name, t in (("rays", rays), ("seed", seed), ("tab", tab),
                    ("cf", cf)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, rays on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def block_select(plan: BlockPlan, tab, cf, rays, seed, shadow: bool = False,
                 tally=None):
    """(t, sel2): the nearest valid candidate of this group per ray.

    rays: (8, N) float32 component planes (rows 0-5 = o, d are read);
    seed: (N,) float32 start best t (<= 0 = dead lane).  t == seed and
    sel2 == -1 where nothing is nearer, else sel2 = row * 2 + slot (slot
    0 entry / 1 exit) into the packed table (padded rows duplicate the
    last prim).  shadow=True is any-hit: only sel2 >= 0 is meaningful.

    A CUDA tensor launches csrc/block_select.cu on the current stream; a
    CPU tensor runs block_select_plain.  `tally` as in
    megakernel.mega_select."""
    if rays.device.type == "cpu" and tally is None:
        return block_select_plain(plan, tab, cf, rays, seed, shadow)
    if rays.device.type != "cuda":
        raise ValueError(f"block_select: unsupported device {rays.device}")
    from . import kernels
    _check_launch(plan, tab, cf, rays, seed)
    kernels.check_tally(tally, rays)
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    sel = torch.empty(n, dtype=torch.int32, device=rays.device)
    if n == 0:
        return t, sel
    nodes, cdesc = plan.device_tables(rays.device)
    lib = kernels.block_select_lib()
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = lib.glome_block_select(
            rays.data_ptr(), n, seed.data_ptr(), nodes.data_ptr(),
            tab.data_ptr(), plan.n_nodes, kernels.walk_stack(plan.depth),
            plan.F, PTYPE_CODE[plan.ptype], int(plan.transformed), plan.nfld,
            cf.data_ptr(), cdesc.data_ptr(), int(bool(shadow)),
            t.data_ptr(), sel.data_ptr(), kernels.tally_ptr(tally),
            ctypes.c_void_p(stream))
    kernels.check_launch(lib, err, "block_select")
    block_select.launches += 1
    return t, sel


block_select.launches = 0


def cons_ok(cons, cf, px, py, pz):
    """Clause validity at candidate points (Csg.hs:92-101: IN(member
    rows) == positive for every clause), as csrc/cons.cuh eval_cons
    evaluates it.  `cons` is the list encode_cons encodes (BlockPlan.cons),
    `cf` the flat member rows it points into."""
    ok = torch.ones(px.shape, dtype=torch.bool, device=px.device)
    for positive, ms in cons:
        inn = torch.zeros_like(ok)
        for ptype2, off, M, Fm, has_inv in ms:
            for r in range(M):
                row = cf[off + r * Fm:off + (r + 1) * Fm]
                x, y, z = px, py, pz
                if has_inv:
                    mi = row[Fm - 12:]
                    x = mi[0] * px + mi[1] * py + mi[2] * pz + mi[3]
                    y = mi[4] * px + mi[5] * py + mi[6] * pz + mi[7]
                    z = mi[8] * px + mi[9] * py + mi[10] * pz + mi[11]
                inn = inn | _inside_comp(ptype2, lambda q: row[q], x, y, z)
        ok = ok & (inn == positive)
    return ok


def block_select_plain(plan: BlockPlan, tab, cf, rays, seed,
                       shadow: bool = False):
    """Plain torch version of block_select: every live ray against every
    table row (the kernel's BVH only culls), rays in chunks to bound
    memory.  Candidate maths and the tie rule are the kernel's: the best
    candidate is the least (t, row), argmin's first row on an exact tie,
    which the kernel's walk keeps whatever order it visits the blocks in,
    so the two agree on every lane.  Shadow mode finds the nearest
    blocker; only sel2 >= 0 is meaningful there, as in the kernel."""
    block_select_plain.calls += 1
    rows = tab.reshape(-1, plan.F)
    n = rays.shape[1]
    bt = seed.clone()
    bs = torch.full((n,), -1, dtype=torch.int64, device=rays.device)
    idx = torch.nonzero(seed > 0.0)[:, 0]
    chunk = max(1, _PLAIN_BUDGET // rows.shape[0])
    for s in range(0, idx.numel(), chunk):
        ix = idx[s:s + chunk]
        o = rays[0:3, ix].t()
        d = rays[3:6, ix].t()
        b_t = bt[ix]
        t0, t1 = _candidates(plan.ptype, rows, plan.nfld, plan.transformed,
                             o, d)
        v0 = (t0 > 0.0) & (t0 < b_t[:, None])
        v1 = (t1 > 0.0) & (t1 < b_t[:, None])
        if plan.cons:
            for which in (0, 1):
                tv = t0 if which == 0 else t1
                okc = cons_ok(plan.cons, cf, o[:, 0:1] + d[:, 0:1] * tv,
                              o[:, 1:2] + d[:, 1:2] * tv,
                              o[:, 2:3] + d[:, 2:3] * tv)
                if which == 0:
                    v0 = v0 & okc
                else:
                    v1 = v1 & okc
        tc = torch.where(v0, t0, torch.where(v1, t1,
                                             torch.full_like(t1, INF)))
        arg = torch.argmin(tc, dim=1)
        tmin = tc.gather(1, arg[:, None])[:, 0]
        slot = (~v0.gather(1, arg[:, None])[:, 0]).to(torch.int64)
        better = tmin < b_t
        bt[ix] = torch.where(better, tmin, b_t)
        bs[ix] = torch.where(better, arg * 2 + slot, bs[ix])
    return bt, torch.where(bt < seed, bs, -1).to(torch.int32)


block_select_plain.calls = 0


def block_tables(sc, garrs, gi, device):
    """(tab, cf) of group gi of a packed scene: pack_blocks' row table
    and pack_cons' constraint rows (`garrs` the scene's device arrays)."""
    from .compile import group_device_params
    g = sc.groups[gi]
    plan = get_block_plan(g, sc)
    ga = {k: v.detach() for k, v in group_device_params(g, garrs[gi]).items()
          if k != "m_fwd"}
    return pack_blocks(plan, ga), pack_cons(plan, sc, garrs, device)


def block_pass(sc, garrs, gi, rays, seed, shadow: bool,
               select=block_select, tables=None):
    """(t, local2) of group gi of a packed scene: local2 = group-local
    prim * 2 + slot, -1 = nothing beat `seed`.  `garrs` are the scene's
    device arrays (as from to_torch); `select` is block_select or
    block_select_plain; `tables` the group's block_tables, or None to
    pack them here."""
    g = sc.groups[gi]
    plan = get_block_plan(g, sc)
    tab, cf = (block_tables(sc, garrs, gi, rays.device) if tables is None
               else tables)
    t, sel2 = select(plan, tab, cf, rays, seed.detach().contiguous(), shadow)
    # table rows are group-local prim order (padded rows duplicate the
    # last prim): arithmetic map, no gather
    local = torch.clamp(sel2 // 2, 0, g.size - 1)
    return t, torch.where(sel2 >= 0, local * 2 + sel2 % 2, -1)
