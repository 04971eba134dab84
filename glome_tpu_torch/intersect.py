"""Ray-scene intersection entry points (torch).

glome_tpu/intersect.py holds two pipelines, and so does the port; the
table entries (intersect_multi_table, shadow_query_table) take the one
to run as an explicit `route`:

  - MEGA (the default): the megakernel route.  Every batch goes through
    the select kernels (K1 megakernel.mega_select, then K2/K3 for groups
    too big for it) and megakernel.finalize.
  - GROUPS: glome_tpu's pass-per-group pipeline (its route on the CPU,
    and on the TPU under GLOME_DISABLE_MEGA=1): convex CSG objects by
    interval intersection (convex_pass), then each plain or inline group
    through one select launch seeded with the best t so far -- K5
    group_kernels.bvh_select for a group with a skip-link BVH
    (compile.group_accel), K4 dense_select for any other -- then the
    deferred CSG groups by brute force (_deferred_group), and the
    difference-B retexture.  Selection runs under torch.no_grad(); each
    winner is re-evaluated differentiably (_finalize_winner,
    _finalize_convex), with vec.finite_grad at the gather boundary.

`select` names the kernel set on either route (megakernel.KERNELS: the
CUDA kernels on CUDA tensors, their plain versions on CPU tensors;
megakernel.PLAIN: the plain versions on any device).  The Hit record
keeps glome_tpu's layout, so the tests compare like with like.

Left out of the group route on purpose:
  - glome_tpu's TPU-shaped scans: brute_scan (a lax.scan over prim
    chunks) and bvh_pass (a lockstep tile walk) are its CPU stand-ins
    for the two Pallas kernels; here the kernels' plain versions
    (dense_select_plain, bvh_select_plain) stand in on CPU tensors;
  - the compacted branch of the deferred pass: glome_tpu's
    DEFERRED_CAP_FRAC = 1.0 never takes it, so only the exact branch is
    ported, and _deferred_eligible (read only by that branch) is not.
    The deferred pass chunks the rays instead, so that one step's
    (rays, prims, 3) temporaries stay under DEFERRED_BUDGET elements;
  - the retexture's compaction cap: glome_tpu compacts the useatex
    difference-B hits with nonzero(size=max(64, N // 8)) and skips the
    rest when there are more; the port compacts exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import geom
from . import group_kernels as GK
from . import megakernel as MK
from .compile import (TAG_DEPTH, TEX_DEPTH, group_accel,
                      materialize_scene_params)
from .config import DELTA, INFINITY
from .vec import const, finite_grad, vnorm, vscaleadd
from .xfm import apply_normal_T, apply_point, apply_vector

INF = INFINITY

# the two routes of the table entries
MEGA = "mega"
GROUPS = "groups"
ROUTES = (MEGA, GROUPS)

PRIM_CHUNK = 4096
# elements of one (rays, prims, 3) step of the deferred pass
DEFERRED_BUDGET = 1 << 26


class Hit(NamedTuple):
    """Per-ray nearest-hit record (the reference Rayint, Solid.hs:20-28)."""
    t: torch.Tensor          # (N,) world distance; INFINITY = miss
    hit: torch.Tensor        # (N,) bool
    pos: torch.Tensor        # (N, 3)
    norm: torch.Tensor       # (N, 3)
    obj_o: torch.Tensor      # (N, 3) object-space ray (riray for Warp)
    obj_d: torch.Tensor      # (N, 3)
    tex_stack: torch.Tensor  # (N, TEX_DEPTH) texture ids, innermost first
    tag_stack: torch.Tensor  # (N, TAG_DEPTH) tag ids
    prim_serial: torch.Tensor  # (N,) global prim id, -1 = miss


def _kernel_hits2(ptype, params, o, d):
    if ptype == "sphere":
        return geom.sphere_hits2(params["center"], params["radius"], o, d)
    if ptype == "plane":
        return geom.plane_hits2(params["norm"], params["offset"], o, d)
    if ptype == "box":
        return geom.box_hits2(params["bmin"], params["bmax"], o, d)
    if ptype == "triangle":
        return geom.triangle_hits2(params["p1"], params["p2"], params["p3"],
                                   o, d)
    if ptype == "trianglenorm":
        return geom.trianglenorm_hits2(params["p1"], params["p2"],
                                       params["p3"], params["n1"],
                                       params["n2"], params["n3"], o, d)
    if ptype == "disc":
        return geom.disc_hits2(params["pos"], params["norm"], params["rsqr"],
                               o, d)
    if ptype == "cylinder":
        return geom.cylinder_hits2(params["radius"], params["h1"],
                                   params["h2"], o, d)
    if ptype == "cone":
        return geom.cone_hits2(params["radius"], params["clip1"],
                               params["clip2"], params["height"], o, d)
    raise ValueError(ptype)


def _kernel_inside(ptype, params, p):
    if ptype == "sphere":
        return geom.sphere_inside(params["center"], params["radius"], p)
    if ptype == "plane":
        return geom.plane_inside(params["norm"], params["offset"], p)
    if ptype == "box":
        return geom.box_inside(params["bmin"], params["bmax"], p)
    if ptype in ("triangle", "trianglenorm", "disc"):
        return torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device)
    if ptype == "cylinder":
        return geom.cylinder_inside(params["radius"], params["h1"],
                                    params["h2"], p)
    if ptype == "cone":
        return geom.cone_inside(params["radius"], params["clip1"],
                                params["clip2"], params["height"], p)
    raise ValueError(ptype)


# --- static per-group tables on the device ---------------------------------

def _static(g, name, device, make):
    """A device copy of a static per-group numpy table (make()), made
    once per device and cached on the group."""
    cache = g.__dict__.setdefault("_dev_static", {})
    key = (name, str(device))
    if key not in cache:
        cache[key] = torch.as_tensor(make(), device=device)
    return cache[key]


def _vis(g, shadow, device):
    """(P,) float32 0/1: the prims a shadow (noshadow off) or primary
    (onlyshadow off) pass sees."""
    if shadow:
        return _static(g, "vis_shadow", device,
                       lambda: (~g.noshadow).astype(np.float32))
    return _static(g, "vis", device,
                   lambda: (~g.onlyshadow).astype(np.float32))


def _meta(g, name, device):
    """The group's tex_stack / tag_stack / prim_serial / csg_id on
    `device` (int64, for gathers)."""
    return _static(g, name, device,
                   lambda: np.asarray(getattr(g, name), np.int64))


def _index(idx, device):
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def _gather_params(ga, local):
    return {k: v[local] for k, v in ga.items() if k not in ("m_inv", "m_fwd")}


# --- CSG membership ----------------------------------------------------------

def group_inside(sc, garrs, gi: int, idx: np.ndarray, pts,
                 chunk: int = PRIM_CHUNK):
    """Inside test of member prims (group gi, static local indices idx) at
    points pts (..., 3).  Returns (..., len(idx)) bools."""
    g = sc.groups[gi]
    ga = garrs[gi]
    outs = []
    for s in range(0, len(idx), chunk):
        sub = _index(idx[s:s + chunk], pts.device)
        p = pts[..., None, :]
        if g.m_inv is not None:
            p = apply_point(ga["m_inv"][sub], p)
        outs.append(_kernel_inside(g.ptype, _gather_params(ga, sub), p))
    return torch.cat(outs, dim=-1)


def group_inside_any(sc, garrs, gi: int, idx: np.ndarray, pts,
                     chunk: int = 32):
    """any(inside) over member prims without materializing the full
    (..., M) membership matrix: a loop over member chunks keeps the peak
    at (..., chunk).  Used for big clause sets (the 2,786-sphere lattice
    shell of TestScene), where the dense matrix would take tens of GB."""
    g = sc.groups[gi]
    ga = garrs[gi]
    M = len(idx)
    if M <= 2 * chunk:
        return group_inside(sc, garrs, gi, idx, pts).any(dim=-1)
    C = (M + chunk - 1) // chunk
    padM = C * chunk - M
    idx_p = np.concatenate([idx, np.zeros(padM, idx.dtype)]) if padM else idx
    validrow = np.ones(C * chunk, bool)
    validrow[M:] = False
    it = _index(idx_p, pts.device)

    def stack(v):
        return v[it].reshape((C, chunk) + v.shape[1:])

    params_s = {k: stack(v) for k, v in ga.items()
                if k not in ("m_inv", "m_fwd")}
    valid = torch.as_tensor(validrow.reshape(C, chunk), device=pts.device)
    m_s = stack(ga["m_inv"]) if g.m_inv is not None else None
    p = pts[..., None, :]
    out = torch.zeros(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    for c in range(C):
        pc = apply_point(m_s[c], p) if m_s is not None else p
        ins = _kernel_inside(g.ptype, {k: v[c] for k, v in params_s.items()},
                             pc) & valid[c]
        out = out | ins.any(dim=-1)
    return out


def clause_in(sc, garrs, clause, pts):
    """IN(clause set) at pts (..., 3) -> (...) bool (group `inside`
    semantics: any member contains the point, Solid.hs:331)."""
    out = torch.zeros(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    for gi, idx in clause.members:
        out = out | group_inside_any(sc, garrs, gi, idx, pts)
    return out


def clause_first_inside(sc, garrs, clause, pts):
    """First member (ordinal within the clause's flattened member list)
    containing each point; returns (found, ordinal)."""
    found = torch.zeros(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    ordinal = torch.zeros(pts.shape[:-1], dtype=torch.int64,
                          device=pts.device)
    base = 0
    for gi, idx in clause.members:
        ins = group_inside(sc, garrs, gi, idx, pts)            # (..., M)
        any_here = ins.any(dim=-1)
        first = ins.to(torch.uint8).argmax(dim=-1) + base
        take = any_here & ~found
        ordinal = torch.where(take, first, ordinal)
        found = found | any_here
        base += len(idx)
    return found, ordinal


def _inline_valid(sc, garrs, constraints, pts):
    """Evaluate a group's static inline CSG constraint list at pts."""
    ok = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    for positive, members in constraints:
        inn = torch.zeros_like(ok)
        for gi, idx in members:
            inn = inn | group_inside_any(sc, garrs, gi, idx, pts)
        ok = ok & (inn == positive)
    return ok


# --- convex CSG objects ------------------------------------------------------

def _member_interval(sc, garrs, gi, li, o, d):
    """Exact parameter interval [t_in, t_out] of one convex volumetric
    prim along each ray, as extended reals (empty = [INF, INF], which
    max/min handles correctly for intersections).  World distances."""
    g = sc.groups[gi]
    ga = garrs[gi]
    params = {k: v[li] for k, v in ga.items() if k not in ("m_inv", "m_fwd")}
    if g.m_inv is not None:
        minv = ga["m_inv"][li]
        oo = apply_point(minv, o)
        dd = apply_vector(minv, d)
        ils = 1.0 / torch.sqrt(torch.clamp(torch.sum(dd * dd, dim=-1),
                                           min=1e-30))
        ou, du = oo, dd * ils[..., None]
    else:
        ou, du, ils = o, d, None
    if g.ptype == "plane":
        # half-space interval (plane_hits2 slots encode crossing kind,
        # not the interval): entering -> [t, +INF); exiting -> (-INF, t];
        # parallel -> all-or-nothing by inside(o)
        n, off = params["norm"], params["offset"]
        dn = torch.sum(n * du, dim=-1)
        t = -(torch.sum(n * ou, dim=-1) - off) / torch.where(dn == 0.0, 1.0,
                                                             dn)
        ins = torch.sum(n * ou, dim=-1) < off
        t0 = torch.where(dn < 0.0, t, -INF)
        t1 = torch.where(dn > 0.0, t, INF)
        t0 = torch.where(dn == 0.0, torch.where(ins, -INF, INF), t0)
        t1 = torch.where(dn == 0.0, torch.where(ins, INF, -INF), t1)
    else:
        t0, _, t1, _ = _kernel_hits2(g.ptype, params, ou, du)
    if ils is not None:
        t0 = torch.where(torch.abs(t0) >= INF, t0, t0 * ils)
        t1 = torch.where(torch.abs(t1) >= INF, t1, t1 * ils)
    return t0, t1


def _convex_members(sc, csg):
    """Flattened member list [(gi, li)] of a convex csg in clause order."""
    out = []
    for clause in csg.clauses:
        for gi, idx in clause.members:
            for li in idx:
                out.append((gi, int(li)))
    return out


@torch.no_grad()
def convex_pass(sc, garrs, csg, o, d, seed_t, shadow: bool):
    """Direct interval intersection of one convex CSG object: the hit is
    the max of member entries if ahead of the origin, else the min of
    member exits (origin inside).  Select-only (winner finalized
    differentiably by _finalize_convex).  Returns (t, ordinal, exit?)."""
    members = _convex_members(sc, csg)
    g0, l0 = members[0]
    vis = ((~sc.groups[g0].noshadow[l0]) if shadow
           else (~sc.groups[g0].onlyshadow[l0]))
    N = o.shape[0]
    dev = o.device
    if not bool(vis):
        return (torch.full((N,), INF, dtype=o.dtype, device=dev),
                torch.zeros((N,), dtype=torch.int64, device=dev),
                torch.zeros((N,), dtype=torch.bool, device=dev))
    t_in = torch.full((N,), -INF, dtype=o.dtype, device=dev)
    t_out = torch.full((N,), INF, dtype=o.dtype, device=dev)
    a_in = torch.zeros((N,), dtype=torch.int64, device=dev)
    a_out = torch.zeros((N,), dtype=torch.int64, device=dev)
    for k, (gi, li) in enumerate(members):
        t0, t1 = _member_interval(sc, garrs, gi, li, o, d)
        upd0 = t0 > t_in
        t_in = torch.where(upd0, t0, t_in)
        a_in = torch.where(upd0, k, a_in)
        upd1 = t1 < t_out
        t_out = torch.where(upd1, t1, t_out)
        a_out = torch.where(upd1, k, a_out)
    entering = t_in > 0.0
    t_cand = torch.where(entering, t_in, t_out)
    ok = ((t_in <= t_out) & (t_cand > 0.0) & (t_cand < seed_t)
          & (t_cand < INF))
    return (torch.where(ok, t_cand, INF),
            torch.where(entering, a_in, a_out), ~entering)


def _finalize_convex(sc, garrs, csg, o, d, t, ordinal, is_exit):
    """Differentiable recompute of the winning member's surface for rays
    whose global best came from a convex csg object."""
    members = _convex_members(sc, csg)
    N = o.shape[0]
    dev = o.device
    tsel = t
    n = torch.zeros((N, 3), dtype=o.dtype, device=dev)
    oo_sel, du_sel = o, d
    tex = torch.full((N, TEX_DEPTH), -1, dtype=torch.int64, device=dev)
    tag = torch.full((N, TAG_DEPTH), -1, dtype=torch.int64, device=dev)
    ser = torch.full((N,), -1, dtype=torch.int64, device=dev)
    for k, (gi, li) in enumerate(members):
        g = sc.groups[gi]
        ga = garrs[gi]
        params = {kk: v[li] for kk, v in ga.items()
                  if kk not in ("m_inv", "m_fwd")}
        if g.m_inv is not None:
            minv = ga["m_inv"][li]
            oo = apply_point(minv, o)
            dd = apply_vector(minv, d)
            ils = 1.0 / torch.sqrt(torch.clamp(torch.sum(dd * dd, dim=-1),
                                               min=1e-30))
            du = dd * ils[..., None]
            t0k, n0k, t1k, n1k = _kernel_hits2(g.ptype, params, oo, du)
            t0k = t0k * ils
            t1k = t1k * ils
            n0k = vnorm(apply_normal_T(minv, n0k))
            n1k = vnorm(apply_normal_T(minv, n1k))
        else:
            oo, du = o, d
            t0k, n0k, t1k, n1k = _kernel_hits2(g.ptype, params, o, d)
        sel = ordinal == k
        tk = torch.where(is_exit, t1k, t0k)
        # clamp differentiable recompute to the selected value when the
        # kernels disagree numerically (e.g. tangency)
        tk = torch.where(torch.abs(tk - t) < 1e-2 * (1.0 + torch.abs(t)),
                         tk, t)
        nk = torch.where(is_exit[:, None], n1k, n0k)
        tsel = torch.where(sel, tk, tsel)
        n = torch.where(sel[:, None], nk, n)
        oo_sel = torch.where(sel[:, None], oo, oo_sel)
        du_sel = torch.where(sel[:, None], du, du_sel)
        tex = torch.where(sel[:, None], _meta(g, "tex_stack", dev)[li][None],
                          tex)
        tag = torch.where(sel[:, None], _meta(g, "tag_stack", dev)[li][None],
                          tag)
        ser = torch.where(sel, int(g.prim_serial[li]), ser)
    return tsel, n, oo_sel, du_sel, tex, tag, ser


# --- plain and inline groups: K4 / K5 ----------------------------------------

def _rays(o, d):
    """The (6, N) float32 component planes [o, d] the select kernels
    read."""
    return torch.cat([o.t(), d.t()]).detach().to(torch.float32).contiguous()


def dense_args(sc, garrs, gi, shadow: bool, device):
    """K4's inputs for group gi, as dense_pass packs them: ((ptype,
    params_T, m_inv, vis, constraints), cull table), detached."""
    g = sc.groups[gi]
    ga = garrs[gi]
    params = {k: v.detach() for k, v in ga.items()
              if k not in ("m_inv", "m_fwd")}
    minv = ga.get("m_inv")
    m_fwd = ga.get("m_fwd")
    cons = GK.encode_constraints(GK.pack_constraints(sc, garrs, g), device)
    bbox = GK.cull_aabbs(g.ptype, params,
                         None if m_fwd is None else m_fwd.detach(), g.size)
    return ((g.ptype, GK.pack_params_T(g.ptype, params),
             None if minv is None else minv.detach().to(torch.float32),
             _vis(g, shadow, device), cons), bbox)


@torch.no_grad()
def dense_pass(sc, garrs, gi, o, d, seed_t, shadow: bool,
               select=GK.dense_select):
    """Dense group intersection: (t, local) of group gi through K4
    (`select`: group_kernels.dense_select, or dense_select_plain), t ==
    seed_t and local == -1 where nothing is nearer."""
    args, bbox = dense_args(sc, garrs, gi, shadow, o.device)
    return select(*args, _rays(o, d),
                  seed_t.detach().to(torch.float32).contiguous(),
                  block_bbox=bbox, shadow=shadow)


def bvh_args(sc, garrs, gi, shadow: bool, device):
    """K5's inputs for group gi, as bvh_dispatch packs them: ((ptype,
    bvh, leaf-ordered rows, leaf-ordered vis, constraints), order), with
    order the tree's leaf order as an int64 tensor on `device`."""
    g = sc.groups[gi]
    if g.m_inv is not None:
        raise ValueError("the compiler gives no transformed group a BVH")
    bvh = group_accel(g)
    order = _static(g, "accel_order", device,
                    lambda: np.asarray(bvh.order, np.int64))
    params_lo = {k: v.detach()[order] for k, v in garrs[gi].items()
                 if k not in ("m_inv", "m_fwd")}
    cons = GK.encode_constraints(GK.pack_constraints(sc, garrs, g), device)
    return ((g.ptype, bvh, GK.pack_params_rows(g.ptype, params_lo),
             _vis(g, shadow, device)[order].contiguous(), cons), order)


@torch.no_grad()
def bvh_dispatch(sc, garrs, gi, o, d, seed_t, shadow: bool,
                 select=GK.bvh_select):
    """An accelerated group through its skip-link BVH and K5 (`select`:
    group_kernels.bvh_select, or bvh_select_plain); the leaf-order winner
    is mapped back to the group-local prim through the tree's order."""
    args, order = bvh_args(sc, garrs, gi, shadow, o.device)
    bt, bl_leaf = select(*args, _rays(o, d),
                         seed_t.detach().to(torch.float32).contiguous(),
                         shadow=shadow)
    local = order[torch.clamp(bl_leaf, min=0).to(torch.int64)]
    return bt, torch.where(bl_leaf >= 0, local, -1)


def _finalize_winner(sc, garrs, gi, o, d, t, local):
    """Recompute the winning candidate's normal / object ray / metadata
    for rays whose global best came from group gi."""
    g = sc.groups[gi]
    ga = garrs[gi]
    dev = o.device
    local = torch.clamp(local, min=0).to(torch.int64)
    # per-lane non-finite-cotangent filter at the gather boundary:
    # singular lanes (tangency, dead rays) must not poison the
    # cross-lane gradient accumulation into the parameter rows
    prow = {k: finite_grad(v) for k, v in _gather_params(ga, local).items()}
    transformed = g.m_inv is not None
    if transformed:
        minv = finite_grad(ga["m_inv"][local])
        oo = apply_point(minv, o)
        dd = apply_vector(minv, d)
        ils = 1.0 / torch.sqrt(torch.clamp(torch.sum(dd * dd, dim=-1),
                                           min=1e-30))
        du = dd * ils[..., None]
        t0c, n0, t1c, n1 = _kernel_hits2(g.ptype, prow, oo, du)
        t0c = t0c * ils
        t1c = t1c * ils
    else:
        oo, du = o, d
        t0c, n0, t1c, n1 = _kernel_hits2(g.ptype, prow, o, d)
    # which crossing won: re-derive by distance, then re-evaluate it
    # differentiably
    slot0 = torch.abs(t0c - t) <= torch.abs(t1c - t)
    tsel = torch.where(slot0, t0c, t1c)
    tsel = torch.where(torch.abs(tsel - t) < 1e-2 * (1.0 + torch.abs(t)),
                       tsel, t)
    n = torch.where(slot0[:, None], n0, n1)
    if transformed:
        n = vnorm(apply_normal_T(minv, n))
    tex = _meta(g, "tex_stack", dev)[local]
    tag = _meta(g, "tag_stack", dev)[local]
    ser = _meta(g, "prim_serial", dev)[local]
    return tsel, n, oo, du, tex, tag, ser


# --- deferred CSG groups -----------------------------------------------------

def _deferred_group(sc, garrs, gi, o, d, tmax, shadow: bool,
                    prim_chunk: int = PRIM_CHUNK):
    """Full advance-and-retest CSG candidate logic for one deferred group
    over the given rays.  Returns per-ray group-local best (t, norm,
    obj_o, obj_d, tex, tag, serial, csg, neg); t == INFINITY where no
    valid candidate.  Heavy (membership scans per candidate), so the
    rays go in chunks of DEFERRED_BUDGET / (3 * prims) at a time."""
    N = o.shape[0]
    rc = max(1, DEFERRED_BUDGET // (3 * min(prim_chunk, sc.groups[gi].size)))
    if N <= rc:
        return _deferred_rays(sc, garrs, gi, o, d, tmax, shadow, prim_chunk)
    parts = [_deferred_rays(sc, garrs, gi, o[s:s + rc], d[s:s + rc],
                            tmax[s:s + rc], shadow, prim_chunk)
             for s in range(0, N, rc)]
    return tuple(torch.cat([p[k] for p in parts]) for k in range(9))


def _take(x, pidx):
    """x (N, P, 3) at prim pidx (N,) of each ray -> (N, 3)."""
    return x.gather(1, pidx[:, None, None].expand(-1, 1, 3))[:, 0]


def _deferred_rays(sc, garrs, gi, o, d, tmax, shadow, prim_chunk):
    g = sc.groups[gi]
    ga = garrs[gi]
    N = o.shape[0]
    dt = o.dtype
    dev = o.device
    best_t = torch.full((N,), INF, dtype=dt, device=dev)
    best_norm = torch.zeros((N, 3), dtype=dt, device=dev)
    best_obj_o = o
    best_obj_d = d
    best_tex = torch.full((N, TEX_DEPTH), -1, dtype=torch.int64, device=dev)
    best_tag = torch.full((N, TAG_DEPTH), -1, dtype=torch.int64, device=dev)
    best_serial = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_csg = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_neg = torch.zeros((N,), dtype=torch.bool, device=dev)

    for start in range(0, g.size, prim_chunk):
        sl = slice(start, min(start + prim_chunk, g.size))
        P = sl.stop - sl.start
        params = {k: v[sl] for k, v in ga.items()
                  if k not in ("m_inv", "m_fwd")}
        transformed = g.m_inv is not None
        if transformed:
            minv = ga["m_inv"][sl]                            # (P, 3, 4)
            oo = apply_point(minv[None], o[:, None, :])       # (N, P, 3)
            dd = apply_vector(minv[None], d[:, None, :])
            inv_ls = 1.0 / torch.sqrt(torch.sum(dd * dd, dim=-1))
            du = dd * inv_ls[..., None]
            t0, n0, t1, n1 = _kernel_hits2(g.ptype, params, oo, du)
            # preserve the miss sentinel through distance rescaling
            t0 = torch.where(t0 >= INF, INF, t0 * inv_ls)
            t1 = torch.where(t1 >= INF, INF, t1 * inv_ls)
        else:
            oo = o[:, None, :]
            du = d[:, None, :].expand(N, P, 3)
            t0, n0, t1, n1 = _kernel_hits2(g.ptype, params, oo, du)

        csg_ids = g.csg_id[sl]
        is_csg = csg_ids >= 0
        neg_np = np.zeros((P,), dtype=bool)
        # Candidate validity.  For plain prims keeping both candidates
        # reproduces reference nearest-hit semantics: a valid entry is
        # always nearer than the exit, so argmin picks the entry when it
        # is ahead of the origin and the exit otherwise.
        v0 = (t0 > 0.0) & (t0 < tmax[:, None]) & (t0 < INF)
        v1 = (t1 > 0.0) & (t1 < tmax[:, None]) & (t1 < INF)

        for cid in sorted(set(int(c) for c in csg_ids[is_csg])):
            rows = np.where(csg_ids == cid)[0]
            rows_t = _index(rows, dev)
            csg = sc.csgs[cid]
            clauses_of_rows = g.csg_clause[sl][rows]
            # membership tests only select: no gradient through them
            with torch.no_grad():
                x0 = vscaleadd(o[:, None, :], d[:, None, :], t0[:, rows_t])
                x1 = vscaleadd(o[:, None, :], d[:, None, :], t1[:, rows_t])
                okay0 = torch.ones(x0.shape[:-1], dtype=torch.bool,
                                   device=dev)
                okay1 = torch.ones_like(okay0)
                for ci, clause in enumerate(csg.clauses):
                    need = _index(np.where(clauses_of_rows != ci)[0], dev)
                    if need.numel() == 0:
                        continue
                    pts = torch.stack([x0[:, need], x1[:, need]], dim=2)
                    ok = clause_in(sc, garrs, clause, pts) == clause.positive
                    okay0[:, need] = okay0[:, need] & ok[:, :, 0]
                    okay1[:, need] = okay1[:, need] & ok[:, :, 1]
                # sibling DNF regions (non-conjunctive CSG): a candidate
                # is a UNION boundary iff union membership flips across
                # it -- evaluated at delta-nudged points, because exact
                # surface points of a member duplicated across disjuncts
                # make strict inside tests coin flips (the reference's
                # own delta-advance style, Csg.hs:38-54)
                if csg.excl:
                    dx = d[:, None, :] * DELTA
                    pts = torch.stack([x0 - dx, x0 + dx, x1 - dx, x1 + dx],
                                      dim=2)
                    u = None
                    for conj in [csg.clauses] + list(csg.excl):
                        rin = None
                        for clause in conj:
                            inn = (clause_in(sc, garrs, clause, pts)
                                   == clause.positive)
                            rin = inn if rin is None else rin & inn
                        u = rin if u is None else u | rin
                    okay0 = okay0 & (u[:, :, 0] != u[:, :, 1])
                    okay1 = okay1 & (u[:, :, 2] != u[:, :, 3])
                # negative-clause rows: only exit candidates, and the ray
                # must actually leave the clause set
                for ci, clause in enumerate(csg.clauses):
                    if clause.positive:
                        continue
                    nrows = np.where(clauses_of_rows == ci)[0]
                    if len(nrows) == 0:
                        continue
                    neg_np[rows[nrows]] = True
                    nr = _index(nrows, dev)
                    okay0[:, nr] = False
                    xa = vscaleadd(x1[:, nr], d[:, None, :], DELTA)
                    still_in = clause_in(sc, garrs, clause, xa)
                    okay1[:, nr] = okay1[:, nr] & ~still_in
            v0[:, rows_t] = v0[:, rows_t] & okay0
            v1[:, rows_t] = v1[:, rows_t] & okay1

        cand_t = torch.stack([torch.where(v0, t0, INF),
                              torch.where(v1, t1, INF)], dim=-1)

        # shadow / primary visibility flags (static per prim)
        vis = (~g.noshadow[sl]) if shadow else (~g.onlyshadow[sl])
        cand_t = torch.where(torch.as_tensor(vis, device=dev)[None, :, None],
                             cand_t, INF)

        # reduce chunk -> per-ray best candidate
        flat = cand_t.reshape(N, P * 2)
        arg = torch.argmin(flat, dim=-1)
        tbest = flat.gather(1, arg[:, None])[:, 0]
        upd = tbest < best_t
        if shadow:
            best_t = torch.where(upd, tbest, best_t)
            continue

        pidx = arg // 2
        slot = arg % 2
        nsel = torch.where((slot == 0)[:, None], _take(n0, pidx),
                           _take(n1, pidx))
        if transformed:
            minv_sel = minv[pidx]                             # (N, 3, 4)
            nsel = vnorm(apply_normal_T(minv_sel, nsel))
            oo_sel = _take(oo, pidx)
            du_sel = _take(du, pidx)
        else:
            oo_sel = o
            du_sel = d
        flip = torch.as_tensor(neg_np, device=dev)[pidx]
        nsel = torch.where(flip[:, None], -nsel, nsel)

        at = start + pidx
        best_norm = torch.where(upd[:, None], nsel, best_norm)
        best_obj_o = torch.where(upd[:, None], oo_sel, best_obj_o)
        best_obj_d = torch.where(upd[:, None], du_sel, best_obj_d)
        best_tex = torch.where(upd[:, None],
                               _meta(g, "tex_stack", dev)[at], best_tex)
        best_tag = torch.where(upd[:, None],
                               _meta(g, "tag_stack", dev)[at], best_tag)
        best_serial = torch.where(upd, _meta(g, "prim_serial", dev)[at],
                                  best_serial)
        best_csg = torch.where(upd, _meta(g, "csg_id", dev)[at], best_csg)
        best_neg = torch.where(upd, flip, best_neg)
        best_t = torch.where(upd, tbest, best_t)

    return (best_t, best_norm, best_obj_o, best_obj_d, best_tex,
            best_tag, best_serial, best_csg, best_neg)


# --- the pass-per-group pipeline ---------------------------------------------

def intersect(compiled, arrays, scene_id: int, o, d, tmax=None,
              shadow: bool = False, prim_chunk: int = PRIM_CHUNK,
              select: str = MK.KERNELS) -> Hit:
    """Nearest valid hit of N rays against one packed scene, on the
    pass-per-group route (the megakernel route is
    megakernel.mega_intersect).

    o, d: (N, 3); d unit length.  tmax: (N,) or None (= INFINITY).
    shadow=True applies shadow-pass semantics: prims flagged noshadow are
    skipped, onlyshadow prims participate (Tex.hs:81-96); only `hit`
    (blocked) is meaningful then, since K4 and K5 stop at any blocker.

    Pass order (each seeded with the running best so later passes cull):
    convex CSG objects, dense/BVH groups, then deferred CSG groups last.
    """
    dense, bvh = GK.select_pair(select)
    sc = compiled.scenes[scene_id]
    garrs = materialize_scene_params(sc, arrays["scenes"][scene_id])
    N = o.shape[0]
    dt = o.dtype
    dev = o.device
    if tmax is None:
        tmax = torch.full((N,), INF, dtype=dt, device=dev)

    best_t = torch.full((N,), INF, dtype=dt, device=dev)
    best_norm = torch.zeros((N, 3), dtype=dt, device=dev)
    best_obj_o = o
    best_obj_d = d
    best_tex = torch.full((N, TEX_DEPTH), -1, dtype=torch.int64, device=dev)
    best_tag = torch.full((N, TAG_DEPTH), -1, dtype=torch.int64, device=dev)
    best_serial = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_csg = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_neg = torch.zeros((N,), dtype=torch.bool, device=dev)

    # convex CSG objects: one interval candidate per object
    for csg in sc.csgs:
        if not csg.convex:
            continue
        seed = torch.minimum(best_t, tmax)
        bt, ordn, is_exit = convex_pass(sc, garrs, csg, o, d, seed, shadow)
        upd = bt < seed
        if shadow:
            best_t = torch.where(upd, bt, best_t)
            continue
        tsel, n, oo_sel, du_sel, tex_sel, tag_sel, ser_sel = \
            _finalize_convex(sc, garrs, csg, o, d, bt, ordn, is_exit)
        best_t = torch.where(upd, tsel, best_t)
        best_norm = torch.where(upd[:, None], n, best_norm)
        best_obj_o = torch.where(upd[:, None], oo_sel, best_obj_o)
        best_obj_d = torch.where(upd[:, None], du_sel, best_obj_d)
        best_tex = torch.where(upd[:, None], tex_sel, best_tex)
        best_tag = torch.where(upd[:, None], tag_sel, best_tag)
        best_serial = torch.where(upd, ser_sel, best_serial)
        best_csg = torch.where(upd, -1, best_csg)
        best_neg = torch.where(upd, False, best_neg)

    for gi, g in enumerate(sc.groups):
        if g.vclass in ("deferred", "convex") or g.size == 0:
            continue
        seed = torch.minimum(best_t, tmax)
        if g.accel_eligible:
            bt, bl = bvh_dispatch(sc, garrs, gi, o, d, seed, shadow, bvh)
        else:
            bt, bl = dense_pass(sc, garrs, gi, o, d, seed, shadow, dense)
        upd = bt < seed
        if shadow:
            best_t = torch.where(upd, bt, best_t)
            continue
        tsel, n, oo_sel, du_sel, tex_sel, tag_sel, ser_sel = \
            _finalize_winner(sc, garrs, gi, o, d, bt, bl)
        best_t = torch.where(upd, tsel, best_t)
        best_norm = torch.where(upd[:, None], n, best_norm)
        best_obj_o = torch.where(upd[:, None], oo_sel, best_obj_o)
        best_obj_d = torch.where(upd[:, None], du_sel, best_obj_d)
        best_tex = torch.where(upd[:, None], tex_sel, best_tex)
        best_tag = torch.where(upd[:, None], tag_sel, best_tag)
        best_serial = torch.where(upd, ser_sel, best_serial)
        csg_sel = _meta(g, "csg_id", dev)[torch.clamp(bl, min=0).to(
            torch.int64)]
        best_csg = torch.where(upd, csg_sel, best_csg)
        best_neg = torch.where(upd, False, best_neg)

    # deferred CSG groups: the full advance-and-retest logic over every
    # ray (glome_tpu's exact branch)
    for gi, g in enumerate(sc.groups):
        if g.vclass != "deferred" or g.size == 0:
            continue
        seed = torch.minimum(best_t, tmax)
        (dt_, dnorm, doo, ddu, dtex, dtag, dser, dcsg, dneg) = \
            _deferred_group(sc, garrs, gi, o, d, seed, shadow, prim_chunk)
        upd = dt_ < seed
        best_t = torch.where(upd, dt_, best_t)
        if shadow:
            continue
        best_norm = torch.where(upd[:, None], dnorm, best_norm)
        best_obj_o = torch.where(upd[:, None], doo, best_obj_o)
        best_obj_d = torch.where(upd[:, None], ddu, best_obj_d)
        best_tex = torch.where(upd[:, None], dtex, best_tex)
        best_tag = torch.where(upd[:, None], dtag, best_tag)
        best_serial = torch.where(upd, dser, best_serial)
        best_csg = torch.where(upd, dcsg, best_csg)
        best_neg = torch.where(upd, dneg, best_neg)

    hit = best_t < INF
    pos = vscaleadd(o, d, torch.where(hit, best_t, 0.0))

    if not shadow:
        # retexture difference-B winners with useatex from the first
        # containing A member's local stacks (Csg.hs:38-41), on the
        # affected rays only (compacted exactly)
        for cid_all, csg in _all_useatex(sc):
            clause0 = csg.clauses[0]
            if not clause0.members:
                continue  # A side entirely simplified away
            ridx = torch.nonzero(hit & best_neg & (best_csg == cid_all))[:, 0]
            if ridx.numel() == 0:
                continue
            found, ordn = clause_first_inside(sc, garrs, clause0,
                                              pos[ridx].detach())
            use = ridx[found]
            ltex, ltag = _clause_local_stacks(sc, clause0)
            pick = ordn[found]
            best_tex = best_tex.index_copy(
                0, use, torch.as_tensor(ltex, dtype=torch.int64,
                                        device=dev)[pick])
            best_tag = best_tag.index_copy(
                0, use, torch.as_tensor(ltag, dtype=torch.int64,
                                        device=dev)[pick])

    return Hit(t=torch.where(hit, best_t, INF), hit=hit, pos=pos,
               norm=best_norm, obj_o=best_obj_o, obj_d=best_obj_d,
               tex_stack=best_tex.to(torch.int32),
               tag_stack=best_tag.to(torch.int32),
               prim_serial=best_serial.to(torch.int32))


def _all_useatex(sc):
    out = []
    for cid, csg in enumerate(sc.csgs):
        if csg.kind == "difference" and csg.useatex:
            out.append((cid, csg))
    return out


def _clause_local_stacks(sc, clause):
    """Concatenated (local_tex_stack, local_tag_stack) over the clause's
    members, in member-ordinal order (host-side static arrays)."""
    texs, tags = [], []
    for gi, idx in clause.members:
        g = sc.groups[gi]
        texs.append(g.local_tex_stack[idx])
        tags.append(g.local_tag_stack[idx])
    return np.concatenate(texs, axis=0), np.concatenate(tags, axis=0)


def shadow_query(compiled, arrays, scene_id, o, d, tmax,
                 prim_chunk: int = PRIM_CHUNK, select: str = MK.KERNELS):
    """True where something valid blocks the segment (0, tmax)."""
    h = intersect(compiled, arrays, scene_id, o, d, tmax=tmax, shadow=True,
                  prim_chunk=prim_chunk, select=select)
    return h.hit


def intersect_multi(compiled, arrays, o, d, sid, tmax=None,
                    shadow: bool = False, select: str = MK.KERNELS) -> Hit:
    """Nearest hit where each ray selects its scene via `sid` (N,) int
    (-1 = no scene; always a miss).  Implemented by running each packed
    scene with tmax zeroed for out-of-scene rays -- every candidate then
    fails t > 0, and the kernels skip those lanes -- and merging."""
    N = o.shape[0]
    if tmax is None:
        tmax = torch.full((N,), INF, dtype=o.dtype, device=o.device)
    best = None
    for si in range(len(compiled.scenes)):
        tm = torch.where(sid == si, tmax, 0.0)
        h = intersect(compiled, arrays, si, o, d, tmax=tm, shadow=shadow,
                      select=select)
        if best is None:
            best = h
            continue
        upd = h.t < best.t
        best = Hit(*(torch.where(upd if a.dim() == 1 else upd[:, None], a, b)
                     for a, b in zip(h, best)))
    return best


def shadow_query_multi(compiled, arrays, o, d, sid, tmax,
                       select: str = MK.KERNELS):
    h = intersect_multi(compiled, arrays, o, d, sid, tmax=tmax, shadow=True,
                        select=select)
    return h.hit


# --- the table entries -------------------------------------------------------

def _guard_dead(table):
    """Dead/fill lanes can carry d = 0: give them a unit direction.
    Their results are discarded (tmax 0), but an unguarded zero
    direction meets inf-scaled gradients in the backward pass
    (0 x inf = NaN), and ONE such lane poisons every accumulated
    scene-parameter gradient."""
    d = table[3:6]
    dead = torch.sum(d * d, dim=0) == 0.0
    unit = const((0.0, 0.0, 1.0), table.dtype, table.device)[:, None]
    return torch.cat([table[0:3], torch.where(dead[None], unit, d),
                      table[6:8]], dim=0)


def check_route(route: str):
    if route not in ROUTES:
        raise ValueError(f"route must be {MEGA!r} or {GROUPS!r}, "
                         f"got {route!r}")


def _unpack(table):
    """(o, d, tmax, sid) columns of a guarded ray table (glome_tpu's
    intersect_multi_table unpacking)."""
    table = _guard_dead(table)
    return (table[0:3].t(), table[3:6].t(), table[6],
            table[7].to(torch.int32))


def intersect_multi_table(compiled, arrays, table,
                          select: str = MK.KERNELS, route: str = MEGA,
                          launches=None, tables=None) -> Hit:
    """Nearest hits of a ray table: (8, N) float32 component planes
    [ox,oy,oz,dx,dy,dz,tmax,sid] (dead lanes tmax 0, sid -1), through
    the named `route` (MEGA or GROUPS) and kernel set `select`
    (megakernel.KERNELS, or PLAIN to run the plain versions on any
    device).  On MEGA a list `launches` gets each K2 and K3 launch's
    (kernel, live lanes) (megakernel._select_all), and `tables` may hand
    in the scene's megakernel.select_tables, which the batch then reads
    instead of building its own."""
    check_route(route)
    if route == MEGA:
        return MK.mega_intersect_table(compiled, arrays, _guard_dead(table),
                                       select=select, launches=launches,
                                       tables=tables)
    o, d, tmax, sid = _unpack(table)
    return intersect_multi(compiled, arrays, o, d, sid, tmax=tmax,
                           select=select)


def shadow_query_table(compiled, arrays, table, select: str = MK.KERNELS,
                       route: str = MEGA, launches=None, tables=None):
    """Any-hit occlusion of a ray table as in intersect_multi_table
    (row 6 = segment tmax, launches and tables as there); returns (N,)
    bool blocked."""
    check_route(route)
    if route == MEGA:
        return MK.mega_shadow_table(compiled, arrays, _guard_dead(table),
                                    select=select, launches=launches,
                                    tables=tables)
    o, d, tmax, sid = _unpack(table)
    return shadow_query_multi(compiled, arrays, o, d, sid, tmax,
                              select=select)


def shadow_query_multi_rays(compiled, arrays, rays,
                            select: str = MK.KERNELS, route: str = MEGA):
    """glome_tpu's plane-table occlusion entry: `rays` is the (8, W)
    float32 table [ox,oy,oz,dx,dy,dz,tmax,sid] with dead lanes at tmax 0
    / sid -1; returns (W,) bool blocked.  The port's ray tables are these
    planes already, so it is shadow_query_table."""
    return shadow_query_table(compiled, arrays, rays, select=select,
                              route=route)
