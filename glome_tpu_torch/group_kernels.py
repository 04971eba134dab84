"""Per-group select kernels of the pass-per-group route (K4, K5) and
their host side.

The counterpart of glome_tpu/pallas_kernels.py.  glome_tpu's
pass-per-group pipeline (intersect.intersect, the port's
`route=intersect.GROUPS`) intersects one primitive group per launch:
a group with a skip-link BVH (compile.group_accel) goes to bvh_intersect,
any other plain or inline group to dense_intersect.  Both only SELECT the
nearest valid candidate (t, prim) per ray, seeded with the best t of the
passes before; intersect._finalize_winner re-evaluates the winner
differentiably.

  - FIELDS, prim_aabb (shared with megakernel), pack_params_T,
    pack_params_rows, block_aabbs, pack_constraints: the host packers of
    pallas_kernels.py, on the scene's tensors;
  - cull_aabbs: K4's cull table (padded per-sub-block and per-prim
    world boxes; block_aabbs' per-block boxes are the TPU kernel's);
  - encode_constraints: a group's inline constraints as the descriptor
    and flat member rows of csrc/cons.cuh (block_kernel.encode_cons's
    format, any number of rows);
  - bvh_records: K5's child-pair records of a group's skip-link BVH
    (accel.skip_link_pairs), cached on the tree per device;
  - dense_select (K4, csrc/dense_select.cu) and bvh_select (K5,
    csrc/bvh_select.cu): the hand-written CUDA kernels on CUDA tensors,
    their plain torch versions dense_select_plain / bvh_select_plain on
    CPU tensors.  Each wrapper counts its launches (`launches`), each
    plain version its calls (`calls`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .block_kernel import cons_ok, encode_cons
from .config import INFINITY
from .megakernel import (FIELDS, PTYPE_CODE, _PLAIN_BUDGET, _candidates,
                         _field_width, padded_prim_aabb, prim_aabb)

INF = INFINITY

# prims per block of K4 and rays per CTA (DENSE_BP in
# csrc/dense_select.cu).  The TPU kernel's block was one 128-lane row of
# prims (one AABB of block_aabbs); on the card a block is what a CTA
# stages in shared memory at once.
BP = 128
# prims per K4 sub-block (DENSE_SUB): one box of cull_aabbs each
SUB = 32
# the widest K4 row (DENSE_FX_MAX): trianglenorm's 18 fields + 12
# inverse-matrix floats
FX_MAX = 30


def _columns(ptype, params):
    cols = []
    for name, _width in FIELDS[ptype]:
        v = params[name]
        cols.append(v.reshape(v.shape[0], -1) if v.dim() > 1 else v[:, None])
    return cols


def pack_params_T(ptype: str, params: dict) -> torch.Tensor:
    """A group's param dict as a transposed (F, P) float32 table."""
    return torch.cat(_columns(ptype, params), dim=-1).t().to(
        torch.float32).contiguous()


def pack_params_rows(ptype: str, params: dict) -> torch.Tensor:
    """A group's param dict as row-major (P, F) float32 rows."""
    return torch.cat(_columns(ptype, params), dim=-1).to(
        torch.float32).contiguous()


def block_aabbs(ptype: str, params: dict, m_fwd, P: int, bp: int = BP):
    """Per-bp-prim-block AABB table (n_j, 8) float32 [bmin, bmax, 0, 0],
    the cull of glome_tpu's dense_intersect (and of K4 before
    cull_aabbs), or None when the type is unbounded (plane)."""
    ab = prim_aabb(ptype, params, m_fwd)
    if ab is None:
        return None
    bmin, bmax = ab
    n_j = (P + bp - 1) // bp
    pad = n_j * bp - P
    if pad:
        bmin = torch.cat([bmin, torch.full((pad, 3), float("inf"),
                                           dtype=bmin.dtype,
                                           device=bmin.device)])
        bmax = torch.cat([bmax, torch.full((pad, 3), float("-inf"),
                                           dtype=bmax.dtype,
                                           device=bmax.device)])
    blo = bmin.reshape(n_j, bp, 3).amin(dim=1)
    bhi = bmax.reshape(n_j, bp, 3).amax(dim=1)
    return torch.cat([blo, bhi, torch.zeros((n_j, 2), dtype=blo.dtype,
                                            device=blo.device)],
                     dim=-1).to(torch.float32).contiguous()


def cull_aabbs(ptype: str, params: dict, m_fwd, P: int):
    """K4's cull table, (ceil(P / SUB) + P, 8) float32 rows [bmin, bmax,
    0, 0]: each SUB-prim sub-block's box (the union of its prims' boxes),
    then each prim's padded world box (megakernel.padded_prim_aabb); None
    when the type is unbounded (plane)."""
    boxes = padded_prim_aabb(ptype, params, m_fwd)
    if boxes is None:
        return None
    bmin, bmax = boxes[:, 0:3], boxes[:, 3:6]
    n_sub = (P + SUB - 1) // SUB
    fill = n_sub * SUB - P
    smin = torch.cat([bmin, bmin.new_full((fill, 3), float("inf"))])
    smax = torch.cat([bmax, bmax.new_full((fill, 3), float("-inf"))])
    rows = torch.cat([
        torch.cat([smin.reshape(n_sub, SUB, 3).amin(dim=1),
                   smax.reshape(n_sub, SUB, 3).amax(dim=1)], dim=-1),
        torch.cat([bmin, bmax], dim=-1)])
    return torch.cat([rows, rows.new_zeros((rows.shape[0], 2))],
                     dim=-1).to(torch.float32).contiguous()


def pack_constraints(sc, garrs, g):
    """A group's inline CSG constraints as [(positive, [(ptype2, cmat
    (M, F2), cminv (M, 12) or None)])], detached (glome_tpu's
    pallas_kernels.pack_constraints); `garrs` are the scene's device
    arrays with mesh params materialized."""
    cons = []
    for positive, members in (g.constraints or []):
        ms = []
        for gi2, idx in members:
            g2 = sc.groups[gi2]
            ga2 = garrs[gi2]
            it = torch.as_tensor(np.asarray(idx, np.int64),
                                 device=next(iter(ga2.values())).device)
            cmat = pack_params_rows(g2.ptype,
                                    {k: v.detach()[it] for k, v in ga2.items()
                                     if k not in ("m_inv", "m_fwd")})
            cmi = (ga2["m_inv"].detach()[it].reshape(len(idx), 12)
                   .to(torch.float32) if g2.m_inv is not None else None)
            ms.append((g2.ptype, cmat, cmi))
        cons.append((positive, ms))
    return cons


class Constraints(NamedTuple):
    """A group's inline constraints as the kernels read them: `spec`
    [(positive, [(ptype, cf_off, M, Fm, has_inv)])] (the plain versions
    read it, as BlockPlan.cons), `cf` the flat float32 member rows
    (fields, then 12 inverse-matrix floats where has_inv) and `desc` the
    int32 descriptor of csrc/cons.cuh (block_kernel.encode_cons)."""
    spec: list
    cf: torch.Tensor
    desc: torch.Tensor


def encode_constraints(cons, device) -> Constraints:
    """pack_constraints' list as Constraints on `device`."""
    spec, parts, off = [], [], 0
    for positive, members in cons:
        ms = []
        for ptype2, cmat, cminv in members:
            M = int(cmat.shape[0])
            if M == 0:
                continue
            rows = cmat if cminv is None else torch.cat([cmat, cminv], dim=-1)
            Fm = int(rows.shape[1])
            ms.append((ptype2, off, M, Fm, cminv is not None))
            parts.append(rows.reshape(-1).to(torch.float32))
            off += M * Fm
        spec.append((bool(positive), ms))
    cf = (torch.cat(parts).contiguous() if parts
          else torch.zeros(1, dtype=torch.float32, device=device))
    desc = torch.as_tensor(encode_cons(spec), device=device)
    return Constraints(spec, cf, desc)


# --- the launches -----------------------------------------------------------

def _check_common(rays, seed, cons, tensors):
    dev = rays.device
    if rays.dim() != 2 or rays.shape[0] < 6:
        raise ValueError(f"rays must be (>=6, N), got {tuple(rays.shape)}")
    n = rays.shape[1]
    if tuple(seed.shape) != (n,):
        raise ValueError(f"seed must be ({n},), got {tuple(seed.shape)}")
    named = dict(tensors, rays=rays, seed=seed, cf=cons.cf)
    for name, t in named.items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, rays on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cons.desc.dtype != torch.int32 or cons.desc.device != dev:
        raise ValueError("constraint descriptor must be int32 beside rays")


def _dense_table(params_T, m_inv):
    """K4's (FX, P) table: the transposed fields, then the 12
    inverse-matrix rows of a transformed group."""
    if m_inv is None:
        return params_T
    P = params_T.shape[1]
    return torch.cat([params_T, m_inv.reshape(P, 12).t().to(
        params_T.dtype)]).contiguous()


def _outputs(rays):
    n = rays.shape[1]
    return (torch.empty(n, dtype=torch.float32, device=rays.device),
            torch.empty(n, dtype=torch.int32, device=rays.device))


def dense_select(ptype: str, params_T, m_inv, vis, cons: Constraints, rays,
                 seed, block_bbox=None, shadow: bool = False, tally=None):
    """Nearest valid candidate of every ray against one dense group (K4).

    params_T: (F, P) float32 (pack_params_T); m_inv: (P, 3, 4) or (P, 12)
    or None; vis: (P,) float32 0/1; cons: encode_constraints of the
    group; rays: (>=6, N) float32 component planes (rows 0-5 = o, d);
    seed: (N,) float32 start best t (<= 0 = dead lane); block_bbox: the
    group's cull table (cull_aabbs, (ceil(P / SUB) + P, 8)) or None (no
    cull).  Returns (t, local):
    t == seed and local == -1 where nothing is nearer.  shadow=True is
    any-hit: a blocked ray has t < seed and local >= 0, but t is the
    first blocker found, not the nearest.

    A CUDA tensor launches csrc/dense_select.cu on the current stream; a
    CPU tensor runs dense_select_plain.  `tally`, a (2, N) int32 CUDA
    tensor, receives each ray's box and prim tests (the kernel's counting
    build)."""
    if rays.device.type == "cpu" and tally is None:
        return dense_select_plain(ptype, params_T, m_inv, vis, cons, rays,
                                  seed, block_bbox, shadow)
    if rays.device.type != "cuda":
        raise ValueError(f"dense_select: unsupported device {rays.device}")
    from . import kernels
    nfld = _field_width(ptype)
    F, P = params_T.shape
    if F != nfld or vis.shape != (P,) or (
            m_inv is not None and m_inv.numel() != 12 * P):
        raise ValueError(f"dense_select: params_T {tuple(params_T.shape)}, "
                         f"vis {tuple(vis.shape)} for {nfld} {ptype} fields")
    n_cull = (P + SUB - 1) // SUB + P
    if block_bbox is not None and tuple(block_bbox.shape) != (n_cull, 8):
        raise ValueError(f"block_bbox must be the ({n_cull}, 8) cull_aabbs "
                         f"table, got {tuple(block_bbox.shape)}")
    _check_common(rays, seed, cons,
                  {"params_T": params_T, "m_inv": m_inv, "vis": vis,
                   "block_bbox": block_bbox})
    kernels.check_tally(tally, rays)
    tab = _dense_table(params_T, m_inv)
    t, local = _outputs(rays)
    n = rays.shape[1]
    if n == 0 or P == 0:
        t.copy_(seed)
        local.fill_(-1)
        return t, local
    lib = kernels.dense_select_lib()
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = lib.glome_dense_select(
            rays.data_ptr(), n, seed.data_ptr(), tab.data_ptr(),
            vis.data_ptr(),
            None if block_bbox is None else block_bbox.data_ptr(),
            P, tab.shape[0], nfld, PTYPE_CODE[ptype], int(m_inv is not None),
            cons.cf.data_ptr(), cons.desc.data_ptr(), int(bool(shadow)),
            t.data_ptr(), local.data_ptr(), kernels.tally_ptr(tally),
            ctypes.c_void_p(stream))
    kernels.check_launch(lib, err, "dense_select")
    dense_select.launches += 1
    return t, local


dense_select.launches = 0


class BvhRecords(NamedTuple):
    """A group's skip-link BVH as K5 walks it: `nodes` the flat float32
    child-pair records (accel.node_records) of accel.skip_link_pairs(bvh)
    on a device, `n_nodes` and `depth` that binary tree's node count and
    depth (the root at depth 1)."""
    nodes: torch.Tensor
    n_nodes: int
    depth: int


def bvh_records(bvh, device) -> BvhRecords:
    """K5's records of the skip-link BVH `bvh` on `device`, cached on the
    tree per device."""
    from . import accel as A
    cache = bvh.__dict__.setdefault("_dev", {})
    key = str(device)
    if key not in cache:
        pairs = A.skip_link_pairs(bvh)
        recs = A.node_records(pairs.bmin, pairs.bmax, pairs.left,
                              pairs.right, pairs.leaf_start, pairs.leaf_count)
        cache[key] = BvhRecords(
            torch.as_tensor(recs.reshape(-1), device=device), pairs.n_nodes,
            pairs.depth)
    return cache[key]


def bvh_select(ptype: str, bvh, rows, vis, cons: Constraints, rays, seed,
               shadow: bool = False, tally=None):
    """Nearest valid candidate of every ray against one untransformed
    group through its BVH (K5).

    bvh: the group's skip-link accel.BvhFlat (compile.group_accel),
    walked as the child-pair records of bvh_records; rows: (P, F)
    float32 params in LEAF order (bvh.order applied; pack_params_rows);
    vis: (P,) float32 0/1 in leaf order; cons, rays, seed as in
    dense_select.  Returns (t, leaf): leaf indexes the leaf order (the
    caller maps it back through bvh.order), -1 where nothing beat the
    seed.  shadow=True is any-hit, as in dense_select.

    A CUDA tensor launches csrc/bvh_select.cu on the current stream; a
    CPU tensor runs bvh_select_plain.  `tally` as in dense_select."""
    if rays.device.type == "cpu" and tally is None:
        return bvh_select_plain(ptype, bvh, rows, vis, cons, rays, seed,
                                shadow)
    if rays.device.type != "cuda":
        raise ValueError(f"bvh_select: unsupported device {rays.device}")
    from . import kernels
    P, F = rows.shape
    if F != _field_width(ptype) or vis.shape != (P,) \
            or len(bvh.order) != P:
        raise ValueError(f"bvh_select: rows {tuple(rows.shape)}, vis "
                         f"{tuple(vis.shape)}, {len(bvh.order)} tree prims "
                         f"for {_field_width(ptype)} {ptype} fields")
    _check_common(rays, seed, cons, {"rows": rows, "vis": vis})
    kernels.check_tally(tally, rays)
    t, leaf = _outputs(rays)
    n = rays.shape[1]
    if n == 0:
        return t, leaf
    recs = bvh_records(bvh, rays.device)
    lib = kernels.bvh_select_lib()
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = lib.glome_bvh_select(
            rays.data_ptr(), n, seed.data_ptr(), recs.nodes.data_ptr(),
            recs.n_nodes, kernels.walk_stack(recs.depth), rows.data_ptr(),
            vis.data_ptr(), F, PTYPE_CODE[ptype], cons.cf.data_ptr(),
            cons.desc.data_ptr(), int(bool(shadow)), t.data_ptr(),
            leaf.data_ptr(), kernels.tally_ptr(tally),
            ctypes.c_void_p(stream))
    kernels.check_launch(lib, err, "bvh_select")
    bvh_select.launches += 1
    return t, leaf


bvh_select.launches = 0


# --- the plain versions ------------------------------------------------------

def _brute(ptype, rows, transformed, vis, cons, rays, seed):
    """(t, index): the first row (in `rows` order) reaching the nearest
    valid candidate of each live ray, by brute force over every row, rays
    in chunks to bound memory.  t == seed and index == -1 where nothing
    is nearer."""
    n = rays.shape[1]
    P = rows.shape[0]
    bt = seed.clone()
    bl = torch.full((n,), -1, dtype=torch.int64, device=rays.device)
    ok_p = (vis > 0.5)[None, :]
    idx = torch.nonzero(seed > 0.0)[:, 0]   # dead lanes do no work
    chunk = max(1, _PLAIN_BUDGET // max(P, 1))
    for s in range(0, idx.numel() if P else 0, chunk):
        ix = idx[s:s + chunk]
        o = rays[0:3, ix].t()
        d = rays[3:6, ix].t()
        b_t = bt[ix]
        t0, t1 = _candidates(ptype, rows, _field_width(ptype), transformed,
                             o, d)
        v0 = ok_p & (t0 > 0.0) & (t0 < b_t[:, None])
        v1 = ok_p & (t1 > 0.0) & (t1 < b_t[:, None])
        if cons.spec:
            for which in (0, 1):
                tv = t0 if which == 0 else t1
                okc = cons_ok(cons.spec, cons.cf, o[:, 0:1] + d[:, 0:1] * tv,
                              o[:, 1:2] + d[:, 1:2] * tv,
                              o[:, 2:3] + d[:, 2:3] * tv)
                if which == 0:
                    v0 = v0 & okc
                else:
                    v1 = v1 & okc
        tc = torch.where(v0, t0, torch.where(v1, t1,
                                             torch.full_like(t1, INF)))
        arg = torch.argmin(tc, dim=1)       # the first minimal row
        tmin = tc.gather(1, arg[:, None])[:, 0]
        better = tmin < b_t
        bt[ix] = torch.where(better, tmin, b_t)
        bl[ix] = torch.where(better, arg, bl[ix])
    return bt, torch.where(bt < seed, bl, -1).to(torch.int32)


def dense_select_plain(ptype: str, params_T, m_inv, vis, cons: Constraints,
                       rays, seed, block_bbox=None, shadow: bool = False):
    """Plain torch version of dense_select: every live ray against every
    prim of the group in local order (the semantics of glome_tpu's
    intersect.brute_scan without its scan); the kernel's boxes only cull,
    so block_bbox is not read.  The first prim reaching the minimum
    wins, as in the kernel, so the two agree except on exact ties.
    Shadow mode finds the nearest blocker; only t < seed is meaningful
    there, as in the kernel."""
    dense_select_plain.calls += 1
    tab = _dense_table(params_T, m_inv)
    return _brute(ptype, tab.t(), m_inv is not None, vis, cons, rays, seed)


dense_select_plain.calls = 0


def bvh_select_plain(ptype: str, bvh, rows, vis, cons: Constraints, rays,
                     seed, shadow: bool = False):
    """Plain torch version of bvh_select: brute force over the group's
    rows in leaf order (the tree only culls).  The first row in leaf
    order wins a tie, as the kernel's least (t, row) does whatever order
    its walk visits the leaves in, so the two agree on every lane.
    Shadow mode finds the nearest blocker, as in dense_select_plain."""
    bvh_select_plain.calls += 1
    return _brute(ptype, rows, False, vis, cons, rays, seed)


bvh_select_plain.calls = 0


def select_pair(select: str):
    """(dense, bvh) select functions of the named kernel set
    (megakernel.KERNELS or PLAIN)."""
    from .megakernel import KERNELS, PLAIN
    if select == KERNELS:
        return dense_select, bvh_select
    if select == PLAIN:
        return dense_select_plain, bvh_select_plain
    raise ValueError(f"select must be {KERNELS!r} or {PLAIN!r}, "
                     f"got {select!r}")
