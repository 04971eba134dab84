"""One-launch scene-intersection megakernel (K1) and its host side.

The JAX package replaced its pass-per-group intersect pipeline with ONE
Pallas launch (glome_tpu/megakernel.py:mega_select): every primitive
group, convex CSG object and deferred CSG prim of every compiled scene
is a *phase*, the running best (t, winner) carries across phases, rays
carry a scene id so portal rays share the launch, and shadow mode is an
any-hit variant.  This module keeps that design and its host side:

  - build_plan / get_plan: the static MegaPlan (copied from glome_tpu,
    so winner ids gprim*2+slot match the reference exactly);
  - encode_phases: the plan's phases, constraint member sets and DNF
    regions as ONE flat int32 descriptor table, which a single generic
    CUDA kernel reads at run time (no per-scene code generation);
  - pack_tables: the PF/BB parameter tables from the scene tensors;
  - mega_select: the hand-written CUDA kernel (csrc/mega_select.cu) on
    CUDA tensors, its plain torch version mega_select_plain on CPU
    tensors;
  - finalize: re-evaluates the winners differentiably (normals,
    object-space rays, texture/tag stacks, difference-B retexture), so
    gradients flow through torch autograd.

The kernel only SELECTS: (t, wid, aux) with wid = global_prim*2 + slot
(slot 0 = entry crossing, 1 = exit), -1 = miss.

Reference semantics mirrored: nearest-hit per prim (each rayint_* in
GlomeTrace), CSG clause validity (Csg.hs:33-101), instance transforms
(Solid.hs:388-403), shadow flags (Tex.hs:81-96), BIH-style traversal
(Bih.hs:332-368) as a near-child-first per-ray stack walk.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import DELTA, INFINITY
from . import accel as A

INF = INFINITY

# groups larger than this are walked through a binary BVH ('bvh2'
# phase); smaller ones are tested densely behind one group AABB
DENSE_MAX = 96

# plain flat-triangle groups larger than this served glome_tpu's
# separate VMEM-streamed kernels (K2 block_kernel / K3 mesh_kernel);
# the plan keeps that routing so the tables stay identical, and the
# entry points raise NotImplementedError for such groups until K2/K3
# are ported
MEGA_EXT_MIN = 16384
BLOCK_VMEM_MAX = 8 * 2**20
BLOCK_MIN = MEGA_EXT_MIN
BLOCK_CONS_MAX = 8
# floats per flat triangle in K2/K3's select table
_SELECT_TRI_WIDTH = 9

# bvh2 leaf width (build_bvh2 leaf_max), as in glome_tpu
BVH2_LEAF = 16

# constraint member sets above this size get a point-query BVH
CONS_BVH_MIN = 48

# per-thread traversal stack of the CUDA kernel (MEGA_STACK_MAX in
# csrc/mega_select.cu); the near-first walk holds at most depth - 1
# entries, and the wrapper raises for deeper trees
STACK_MAX = 64

# per-ptype parameter field order of one PF row (glome_tpu
# pallas_kernels.FIELDS)
FIELDS = {
    "sphere": [("center", 3), ("radius", 1)],
    "plane": [("norm", 3), ("offset", 1)],
    "box": [("bmin", 3), ("bmax", 3)],
    "triangle": [("p1", 3), ("p2", 3), ("p3", 3)],
    "trianglenorm": [("p1", 3), ("p2", 3), ("p3", 3),
                     ("n1", 3), ("n2", 3), ("n3", 3)],
    "disc": [("pos", 3), ("norm", 3), ("rsqr", 1)],
    "cylinder": [("radius", 1), ("h1", 1), ("h2", 1)],
    "cone": [("radius", 1), ("clip1", 1), ("clip2", 1), ("height", 1)],
}

# ptype codes of the descriptor table (PType in csrc/prims.cuh)
PTYPE_CODE = {"sphere": 0, "plane": 1, "box": 2, "triangle": 3,
              "trianglenorm": 4, "disc": 5, "cylinder": 6, "cone": 7}


def _field_width(ptype):
    return sum(w for _, w in FIELDS[ptype])


# --- primitive candidate functions (plain torch) ---------------------------
# Mirrors of glome_tpu pallas_kernels._T_KERNELS (and of csrc/prims.cuh):
# each takes a field accessor p(k) -> tensor broadcastable against the
# ray components and returns the two boundary-crossing distances, +INF
# for absent crossings.  No normals: finalize re-evaluates winners with
# geom.py.

def _safe(x, default=1.0):
    return torch.where(x == 0.0, default, x)


def _sphere_t(p, ox, oy, oz, dx, dy, dz):
    cx, cy, cz, r = p(0), p(1), p(2), p(3)
    ex, ey, ez = cx - ox, cy - oy, cz - oz
    v = ex * dx + ey * dy + ez * dz
    disc = r * r - (ex * ex + ey * ey + ez * ez - v * v)
    ok = disc >= 0.0
    sq = torch.sqrt(torch.where(ok, disc, 0.0))
    return torch.where(ok, v - sq, INF), torch.where(ok, v + sq, INF)


def _plane_t(p, ox, oy, oz, dx, dy, dz):
    nx, ny, nz, off = p(0), p(1), p(2), p(3)
    dn = nx * dx + ny * dy + nz * dz
    t = -(nx * ox + ny * oy + nz * oz - off) / _safe(dn)
    t = torch.where(dn == 0.0, INF, t)
    entering = dn < 0.0
    return torch.where(entering, t, INF), torch.where(entering, INF, t)


def _slab1(lo, hi, o, d):
    inv = 1.0 / _safe(d)
    ta = (lo - o) * inv
    tb = (hi - o) * inv
    tin = torch.minimum(ta, tb)
    tout = torch.maximum(ta, tb)
    para = d == 0.0
    ins = (o > lo) & (o < hi)
    BIG = 1e18
    tin = torch.where(para, torch.where(ins, -BIG, BIG), tin)
    tout = torch.where(para, torch.where(ins, BIG, -BIG), tout)
    return tin, tout


def _box_t(p, ox, oy, oz, dx, dy, dz):
    ix, axo = _slab1(p(0), p(3), ox, dx)
    iy, ayo = _slab1(p(1), p(4), oy, dy)
    iz, azo = _slab1(p(2), p(5), oz, dz)
    lastin = torch.maximum(torch.maximum(ix, iy), iz)
    firstout = torch.minimum(torch.minimum(axo, ayo), azo)
    ok = lastin <= firstout
    return torch.where(ok, lastin, INF), torch.where(ok, firstout, INF)


def _triangle_t(p, ox, oy, oz, dx, dy, dz):
    p1x, p1y, p1z = p(0), p(1), p(2)
    e1x, e1y, e1z = p(3) - p1x, p(4) - p1y, p(5) - p1z
    e2x, e2y, e2z = p(6) - p1x, p(7) - p1y, p(8) - p1z
    s1x = dy * e2z - dz * e2y
    s1y = dz * e2x - dx * e2z
    s1z = dx * e2y - dy * e2x
    div = s1x * e1x + s1y * e1y + s1z * e1z
    ok = div != 0.0
    inv = 1.0 / _safe(div)
    ddx, ddy, ddz = ox - p1x, oy - p1y, oz - p1z
    b1 = (ddx * s1x + ddy * s1y + ddz * s1z) * inv
    ok = ok & (b1 >= 0.0) & (b1 <= 1.0)
    s2x = ddy * e1z - ddz * e1y
    s2y = ddz * e1x - ddx * e1z
    s2z = ddx * e1y - ddy * e1x
    b2 = (dx * s2x + dy * s2y + dz * s2z) * inv
    ok = ok & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv
    t = torch.where(ok, t, INF)
    return t, torch.full_like(t, INF)


def _disc_t(p, ox, oy, oz, dx, dy, dz):
    px, py, pz = p(0), p(1), p(2)
    nx, ny, nz, rsqr = p(3), p(4), p(5), p(6)
    dn = nx * dx + ny * dy + nz * dz
    t = -(nx * (ox - px) + ny * (oy - py) + nz * (oz - pz)) / _safe(dn)
    hx = ox + dx * t - px
    hy = oy + dy * t - py
    hz = oz + dz * t - pz
    ok = (dn != 0.0) & (hx * hx + hy * hy + hz * hz <= rsqr)
    t = torch.where(ok, t, INF)
    return t, torch.full_like(t, INF)


def _roots(a, b, c):
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.where(ok, disc, 0.0))
    q = torch.where(b < 0.0, (b - sq) * -0.5, (b + sq) * -0.5)
    t0 = q / _safe(a)
    t1 = c / _safe(q)
    return torch.minimum(t0, t1), torch.maximum(t0, t1), ok


def _cylinder_t(p, ox, oy, oz, dx, dy, dz):
    r, h1, h2 = p(0), p(1), p(2)
    a = dx * dx + dy * dy
    b = 2.0 * (dx * ox + dy * oy)
    c = ox * ox + oy * oy - r * r
    lo, hi, ok = _roots(a, b, c)
    vert = a == 0.0
    inc = c < 0.0
    lo = torch.where(vert, torch.where(inc, -INF, INF),
                     torch.where(ok, lo, INF))
    hi = torch.where(vert, torch.where(inc, INF, -INF),
                     torch.where(ok, hi, -INF))
    zlo, zhi = _slab1(h1, h2, oz, dz)
    t0 = torch.maximum(lo, zlo)
    t1 = torch.minimum(hi, zhi)
    empty = t0 > t1
    return torch.where(empty, INF, t0), torch.where(empty, INF, t1)


def _cone_t(p, ox, oy, oz, dx, dy, dz):
    r, clip1, clip2, height = p(0), p(1), p(2), p(3)
    kp = r / height
    k = kp * kp
    a = dx * dx + dy * dy - k * dz * dz
    b = 2.0 * (dx * ox + dy * oy - k * dz * (oz - height))
    c = ox * ox + oy * oy - k * (oz - height) * (oz - height)
    lo, hi, ok = _roots(a, b, c)
    neg_lo = torch.where(dz > 0.0, -INF, hi)
    neg_hi = torch.where(dz > 0.0, lo, INF)
    lin_t = -c / _safe(b)
    lin_lo = torch.where(b < 0.0, lin_t, -INF)
    lin_hi = torch.where(b < 0.0, INF, lin_t)
    lin_lo = torch.where(b == 0.0, torch.where(c < 0.0, -INF, INF), lin_lo)
    lin_hi = torch.where(b == 0.0, torch.where(c < 0.0, INF, -INF), lin_hi)
    flo = torch.where(a > 0.0, torch.where(ok, lo, INF),
                      torch.where(a < 0.0, torch.where(ok, neg_lo, -INF),
                                  lin_lo))
    fhi = torch.where(a > 0.0, torch.where(ok, hi, -INF),
                      torch.where(a < 0.0, torch.where(ok, neg_hi, INF),
                                  lin_hi))
    zlo, zhi = _slab1(clip1, clip2, oz, dz)
    t0 = torch.maximum(flo, zlo)
    t1 = torch.minimum(fhi, zhi)
    empty = t0 > t1
    return torch.where(empty, INF, t0), torch.where(empty, INF, t1)


_T_KERNELS = {
    "sphere": _sphere_t,
    "plane": _plane_t,
    "box": _box_t,
    "triangle": _triangle_t,
    "trianglenorm": _triangle_t,   # same distances, fan fields first
    "disc": _disc_t,
    "cylinder": _cylinder_t,
    "cone": _cone_t,
}


def _inside_comp(ptype, c, x, y, z):
    """Strict point-in-solid tests for constraint members (glome_tpu
    pallas_kernels._inside_comp); surface prims have no volume."""
    if ptype == "sphere":
        ex, ey, ez = c(0) - x, c(1) - y, c(2) - z
        return ex * ex + ey * ey + ez * ez < c(3) * c(3)
    if ptype == "plane":
        return c(0) * x + c(1) * y + c(2) * z < c(3)
    if ptype == "box":
        return ((x > c(0)) & (x < c(3)) & (y > c(1)) & (y < c(4))
                & (z > c(2)) & (z < c(5)))
    if ptype == "cylinder":
        return (z > c(1)) & (z < c(2)) & (x * x + y * y < c(0) * c(0))
    if ptype == "cone":
        rz = c(0) * (1.0 - (z - c(1)) / c(3))
        return (z > c(1)) & (z < c(2)) & (x * x + y * y < rz * rz)
    return torch.zeros(torch.broadcast_shapes(x.shape, c(0).shape),
                       dtype=torch.bool, device=x.device)


def prim_aabb(ptype: str, params: dict, m_fwd=None):
    """(bmin, bmax) world AABBs (P, 3) of a dense group's prims from the
    param tensors; None for unbounded types (plane)."""
    if ptype == "sphere":
        r = params["radius"][:, None]
        bmin, bmax = params["center"] - r, params["center"] + r
    elif ptype == "box":
        bmin, bmax = params["bmin"], params["bmax"]
    elif ptype in ("triangle", "trianglenorm"):
        pts = torch.stack([params["p1"], params["p2"], params["p3"]])
        bmin, bmax = pts.amin(0), pts.amax(0)
    elif ptype == "disc":
        r = torch.sqrt(params["rsqr"])[:, None]
        bmin, bmax = params["pos"] - r, params["pos"] + r
    elif ptype == "cylinder":
        r = params["radius"]
        bmin = torch.stack([-r, -r, params["h1"]], dim=-1)
        bmax = torch.stack([r, r, params["h2"]], dim=-1)
    elif ptype == "cone":
        r = params["radius"]
        bmin = torch.stack([-r, -r, params["clip1"]], dim=-1)
        bmax = torch.stack([r, r, params["clip2"]], dim=-1)
    else:
        return None
    if m_fwd is not None:
        corners = torch.stack(
            [torch.stack([bmin[:, 0] if i & 1 else bmax[:, 0],
                          bmin[:, 1] if i & 2 else bmax[:, 1],
                          bmin[:, 2] if i & 4 else bmax[:, 2]], dim=-1)
             for i in range(8)], dim=1)                      # (P, 8, 3)
        w = torch.einsum('pkj,pij->pki', corners, m_fwd[:, :, :3]) \
            + m_fwd[:, None, :, 3]
        return w.amin(dim=1), w.amax(dim=1)
    return bmin, bmax



# --- static plan ------------------------------------------------------------

@dataclasses.dataclass
class ConsMember:
    ptype: str
    pf_base: int
    F: int          # floats per row (fields [+ 12 inverse])
    M: int
    has_inv: bool
    pi_base: int = -1   # PI rows: [global prim id, clause ordinal]
    # big member sets get their own skip-link BVH for point queries
    # (rows stored in leaf order); n_nodes == 0 -> linear scan
    nf_base: int = 0
    ni_base: int = 0
    n_nodes: int = 0


# constraint member sets above this size get a point-query BVH
CONS_BVH_MIN = 48


@dataclasses.dataclass
class Phase:
    kind: str          # 'dense' | 'bvh2' | 'convex' | 'deferred'
    si: int
    gi: int = -1
    ptype: str = ""
    transformed: bool = False
    P: int = 0
    pf_base: int = 0
    F: int = 0
    pi_base: int = 0
    cons: Optional[list] = None    # [(positive, [ConsMember])]
    vis: Tuple[bool, bool] = (True, True)   # static (primary, shadow)
    vis_mixed: bool = False        # per-prim flags live in PI when True
    bb_idx: int = -1               # dense-phase AABB row in BB
    # bvh2
    nf_base: int = 0
    ni_base: int = 0
    n_nodes: int = 0
    depth: int = 0                 # bvh2 stack bound
    # convex csg: [(ptype, pf_off, F, has_inv, gprim)]
    members: Optional[list] = None
    # deferred prim
    gprim: int = -1
    neg: bool = False
    own: Optional[List[ConsMember]] = None
    # sibling DNF regions (non-conjunctive CSG): candidates strictly
    # inside any region are union-interior, not boundary.  Each region
    # is a clause list in eval_cons form: [(sign, [ConsMember])]
    regions: Optional[list] = None
    # index into `cons` of the difference's A clause when this prim is
    # a difference-B surface with useatex (retexture, Csg.hs:39-41):
    # the kernel tracks the first containing A member during the
    # validity scan and returns it as the aux output
    atex_clause: int = -1


@dataclasses.dataclass
class MegaPlan:
    phases: List[Phase]
    pf_spec: List[tuple]           # instructions to assemble PF from arrays
    pf_size: int
    pi: np.ndarray                 # flat int32 [gprim, flags] per prim row
    nf: np.ndarray                 # flat node floats (bmin, bmax)
    ni: np.ndarray                 # flat node ints (skip, leaf_start, count)
    bb_spec: List[tuple]           # [(si, gi)] rows of the BB table
    prim_base: Dict[Tuple[int, int], Tuple[int, int]]  # (si,gi)->(base,size)
    n_prims: int
    n_scenes: int
    tex_all: np.ndarray            # (Ptot, TEX_DEPTH) int32
    tag_all: np.ndarray
    serial_all: np.ndarray         # (Ptot,) int32
    neg_all: np.ndarray            # (Ptot,) bool
    csg_all: np.ndarray            # (Ptot,) int32 csg id within its scene
    scene_of: np.ndarray           # (Ptot,) int32
    # per-prim LOCAL texture/tag stacks (below the enclosing CSG node)
    # and the useatex flag, for difference-B retexture via kernel aux
    ltex_all: np.ndarray
    ltag_all: np.ndarray
    atex_all: np.ndarray           # (Ptot,) bool
    # (si, gi) groups whose winners need differentiable object-space
    # rays (their prims carry Warp-reachable textures)
    warp_groups: frozenset
    # finalize combos: all groups of one (ptype, transformed) pair are
    # re-evaluated in ONE gather+eval pass over concatenated params
    combos: List[tuple] = dataclasses.field(default_factory=list)
    # per-global-prim combo id / row within the combo's concat tables
    cid_all: np.ndarray = None
    row_all: np.ndarray = None
    # oversized flat-triangle groups that glome_tpu serves with K3
    # (mesh_kernel); not ported yet (see MEGA_EXT_MIN)
    external: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    # big groups that glome_tpu serves with K2 (block_kernel); not
    # ported yet (see BLOCK_MIN)
    blocks: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)


def _aabb_overlap(a, b, eps=1e-6):
    return bool(np.all(a[0] - eps <= b[1]) and np.all(b[0] - eps <= a[1]))


def _restrict_members(sc, bounds_cache, members, prim_bb, prim_group,
                      prim_li):
    """Clause members whose solids can contain a point on the candidate
    prim's surface: AABB overlap, refined exactly for sphere-vs-sphere
    (a member sphere can touch the shell of the candidate sphere iff
    | |c-C| - R | <= r)."""
    g_p = sc.groups[prim_group]
    sphere_prim = (g_p.ptype == "sphere" and g_p.m_inv is None)
    if sphere_prim:
        C = np.asarray(g_p.params["center"][prim_li], np.float64)
        R = float(np.asarray(g_p.params["radius"][prim_li]))
    out = []
    for gi, idx in members:
        g = sc.groups[gi]
        if gi not in bounds_cache:
            bounds_cache[gi] = A.group_bounds(g)
        bmin, bmax = bounds_cache[gi]
        idx = np.asarray(idx)
        sel = np.array([_aabb_overlap((bmin[li], bmax[li]), prim_bb)
                        for li in idx], dtype=bool)
        if sphere_prim and g.ptype == "sphere" and g.m_inv is None:
            c = np.asarray(g.params["center"], np.float64)[idx]
            r = np.asarray(g.params["radius"], np.float64)[idx]
            # slack covers the delta-nudged sample points (exit checks
            # and DNF region flip tests probe p +- DELTA*d)
            shell = (np.abs(np.linalg.norm(c - C, axis=-1) - R)
                     <= r + 2 * DELTA + 1e-6)
            sel = sel & shell
        keep = idx[sel].astype(np.int32)
        if len(keep):
            out.append((gi, keep))
    return out


def build_plan(compiled) -> MegaPlan:
    """Flatten a CompiledScene into the megakernel's static plan."""
    from .compile import TEX_DEPTH, TAG_DEPTH

    pf_spec: List[tuple] = []
    pf_off = 0
    pi_rows: List[np.ndarray] = []
    pi_off = 0
    nf_parts: List[np.ndarray] = []
    ni_parts: List[np.ndarray] = []
    nf_off = ni_off = 0
    bb_spec: List[tuple] = []
    phases: List[Phase] = []
    external: List[Tuple[int, int]] = []
    blocks: List[Tuple[int, int]] = []
    prim_base: Dict[Tuple[int, int], Tuple[int, int]] = {}
    tex_all, tag_all, ser_all, neg_all, csg_all, sc_of = [], [], [], [], [], []
    ltex_all, ltag_all, atex_all = [], [], []
    warp_groups = set()
    group_meta: Dict[Tuple[int, int], Tuple[int, int, int]] = {}

    warp_tids = {tid for tid, ws in enumerate(compiled.tex_warps) if ws}

    # ---- global static per-prim tables ------------------------------------
    nbase = 0
    for si, sc in enumerate(compiled.scenes):
        for gi, g in enumerate(sc.groups):
            prim_base[(si, gi)] = (nbase, g.size)
            tex_all.append(g.tex_stack)
            tag_all.append(g.tag_stack)
            ser_all.append(g.prim_serial)
            csg_all.append(g.csg_id)
            sc_of.append(np.full(g.size, si, np.int32))
            ltex_all.append(g.local_tex_stack)
            ltag_all.append(g.local_tag_stack)
            neg = np.zeros(g.size, bool)
            atex = np.zeros(g.size, bool)
            for li in range(g.size):
                cid = int(g.csg_id[li])
                if cid >= 0:
                    csg = sc.csgs[cid]
                    neg[li] = not csg.clauses[int(g.csg_clause[li])].positive
                    atex[li] = neg[li] and csg.useatex
            neg_all.append(neg)
            atex_all.append(atex)
            if any(int(t) in warp_tids for t in np.unique(g.tex_stack)
                   if int(t) >= 0):
                warp_groups.add((si, gi))
            nbase += g.size

    def add_group_pf(si, gi, g, perm):
        """Emit a group's params (in `perm` order) into PF and its
        [gprim, visflags] rows into PI; returns (pf_base, F, pi_base)."""
        nonlocal pf_off, pi_off
        F = _field_width(g.ptype) + (12 if g.m_inv is not None else 0)
        base = pf_off
        pf_spec.append((si, gi,
                        None if perm is None else np.asarray(perm, np.int32),
                        F))
        pf_off += g.size * F
        flags = ((~g.onlyshadow).astype(np.int32)
                 + 2 * (~g.noshadow).astype(np.int32))
        order = (np.arange(g.size, dtype=np.int32) if perm is None
                 else np.asarray(perm, np.int32))
        gprim = prim_base[(si, gi)][0] + order
        pi_rows.append(np.stack([gprim, flags[order]], axis=1)
                       .reshape(-1).astype(np.int32))
        pib = pi_off
        pi_off += 2 * g.size
        group_meta[(si, gi)] = (base, F, pib)
        return base, F, pib

    def add_rows_pf(si, gi, g, idx, ords, bounds) -> ConsMember:
        """Copy selected prim rows (constraint member sets) into PF,
        their [global prim id, clause ordinal] into PI, and -- for big
        sets -- a point-query BVH into NF/NI (rows in leaf order)."""
        nonlocal pf_off, pi_off, nf_off, ni_off
        idx = np.asarray(idx, np.int32)
        ords = np.asarray(ords, np.int32)
        nfb = nib = nnodes = 0
        if (len(idx) > CONS_BVH_MIN and g.ptype != "plane"
                and bounds is not None):
            bvh = A.build_bvh(bounds[0][idx], bounds[1][idx])
            idx = idx[bvh.order]
            ords = ords[bvh.order]
            nfb, nib = nf_off, ni_off
            nf_parts.append(np.concatenate(
                [np.asarray(bvh.bmin, np.float32),
                 np.asarray(bvh.bmax, np.float32)], axis=1).reshape(-1))
            ni_parts.append(np.stack(
                [np.asarray(bvh.skip, np.int32),
                 np.asarray(bvh.leaf_start, np.int32),
                 np.asarray(bvh.leaf_count, np.int32)],
                axis=1).reshape(-1))
            nf_off += nf_parts[-1].shape[0]
            ni_off += ni_parts[-1].shape[0]
            nnodes = bvh.n_nodes
        F = _field_width(g.ptype) + (12 if g.m_inv is not None else 0)
        base = pf_off
        pf_spec.append((si, gi, idx, F))
        pf_off += len(idx) * F
        gprim = prim_base[(si, gi)][0] + idx
        pi_rows.append(np.stack([gprim, ords], axis=1)
                       .reshape(-1).astype(np.int32))
        pib = pi_off
        pi_off += 2 * len(idx)
        return ConsMember(g.ptype, base, F, len(idx), g.m_inv is not None,
                          pi_base=pib, nf_base=nfb, ni_base=nib,
                          n_nodes=nnodes)

    # ---- phases ------------------------------------------------------------
    for si, sc in enumerate(compiled.scenes):
        bounds_cache: Dict[int, tuple] = {}

        def cons_members(members):
            out = []
            ord0 = 0
            for gi2, idx in members:
                if not len(idx):
                    continue
                if gi2 not in bounds_cache:
                    bounds_cache[gi2] = A.group_bounds(sc.groups[gi2])
                out.append(add_rows_pf(
                    si, gi2, sc.groups[gi2], idx,
                    ord0 + np.arange(len(idx)), bounds_cache[gi2]))
                ord0 += len(idx)
            return out

        deferred_phases: List[Phase] = []
        for gi, g in enumerate(sc.groups):
            if g.size == 0 or g.vclass == "convex":
                continue
            vis = (not bool(g.onlyshadow.all()), not bool(g.noshadow.all()))
            vis_mixed = (bool(g.onlyshadow.any()) != bool(g.onlyshadow.all())
                         or bool(g.noshadow.any()) != bool(g.noshadow.all()))
            if g.vclass == "deferred":
                base, F, _ = add_group_pf(si, gi, g, None)
                if gi not in bounds_cache:
                    bounds_cache[gi] = A.group_bounds(g)
                bmin, bmax = bounds_cache[gi]
                for li in range(g.size):
                    cid = int(g.csg_id[li])
                    own_ci = int(g.csg_clause[li])
                    csg = sc.csgs[cid]
                    neg = not csg.clauses[own_ci].positive
                    cons = []
                    atex_clause = -1
                    for ci, clause in enumerate(csg.clauses):
                        if ci == own_ci or not clause.members:
                            continue
                        mm = _restrict_members(sc, bounds_cache,
                                               clause.members,
                                               (bmin[li], bmax[li]), gi, li)
                        if (neg and csg.useatex and clause.positive
                                and ci == 0):
                            atex_clause = len(cons)
                        cons.append((clause.positive, cons_members(mm)))
                    own = (cons_members(csg.clauses[own_ci].members)
                           if neg else None)
                    regions = None
                    if csg.excl:
                        # region list = [own conjunction] + siblings,
                        # restricted against the prim's delta-inflated
                        # bbox (the flip test samples p +- DELTA*d)
                        infl = (bmin[li] - 2 * DELTA, bmax[li] + 2 * DELTA)
                        regions = []
                        for reg in [csg.clauses] + list(csg.excl):
                            entries = []
                            for clause in reg:
                                mm = _restrict_members(
                                    sc, bounds_cache, clause.members,
                                    infl, gi, li)
                                entries.append((clause.positive,
                                                cons_members(mm)))
                            regions.append(entries)
                    deferred_phases.append(Phase(
                        "deferred", si, gi=gi, ptype=g.ptype,
                        transformed=g.m_inv is not None,
                        pf_base=base + li * F, F=F,
                        gprim=prim_base[(si, gi)][0] + li,
                        neg=neg, cons=cons, own=own, regions=regions,
                        atex_clause=atex_clause,
                        vis=(not bool(g.onlyshadow[li]),
                             not bool(g.noshadow[li]))))
                continue
            if (g.vclass == "plain" and not g.constraints
                    and g.m_inv is None
                    and g.ptype in ("triangle", "trianglenorm")
                    and g.size > MEGA_EXT_MIN):
                # K2 packs the select-only field set (9 floats for
                # flat tris, normals are finalize's job)
                if g.size * _SELECT_TRI_WIDTH * 4 > BLOCK_VMEM_MAX:
                    external.append((si, gi))
                    continue
            cons_rows = sum(len(idx) for _pos, members in
                            (g.constraints or []) for _gi2, idx in members)
            if (g.size > BLOCK_MIN and g.ptype != "plane"
                    and not vis_mixed and cons_rows <= BLOCK_CONS_MAX):
                blocks.append((si, gi))
                continue
            # plain / inline groups: dense or in-kernel BVH
            use_bvh = g.size > DENSE_MAX and g.ptype != "plane"
            perm = None
            bvh = None
            if use_bvh:
                if gi not in bounds_cache:
                    bounds_cache[gi] = A.group_bounds(g)
                bvh = A.build_bvh2(*bounds_cache[gi], leaf_max=BVH2_LEAF)
                perm = np.asarray(bvh.order, np.int32)
            base, F, pib = add_group_pf(si, gi, g, perm)
            cons = None
            if g.constraints:
                cons = [(pos, cons_members(members))
                        for pos, members in g.constraints]
            if use_bvh:
                nfb, nib = nf_off, ni_off
                nf_parts.append(np.concatenate(
                    [np.asarray(bvh.bmin, np.float32),
                     np.asarray(bvh.bmax, np.float32)], axis=1).reshape(-1))
                ni_parts.append(np.stack(
                    [np.asarray(bvh.left, np.int32),
                     np.asarray(bvh.right, np.int32),
                     np.asarray(bvh.leaf_start, np.int32),
                     np.asarray(bvh.leaf_count, np.int32)],
                    axis=1).reshape(-1))
                nf_off += nf_parts[-1].shape[0]
                ni_off += ni_parts[-1].shape[0]
                phases.append(Phase(
                    "bvh2", si, gi=gi, ptype=g.ptype,
                    transformed=g.m_inv is not None, P=g.size,
                    pf_base=base, F=F, pi_base=pib, cons=cons,
                    vis=vis, vis_mixed=vis_mixed,
                    nf_base=nfb, ni_base=nib, n_nodes=bvh.n_nodes,
                    depth=bvh.depth))
            else:
                bb_idx = -1
                if g.ptype != "plane":
                    bb_idx = len(bb_spec)
                    bb_spec.append((si, gi))
                phases.append(Phase(
                    "dense", si, gi=gi, ptype=g.ptype,
                    transformed=g.m_inv is not None, P=g.size,
                    pf_base=base, F=F, pi_base=pib, cons=cons,
                    vis=vis, vis_mixed=vis_mixed, bb_idx=bb_idx))

        # convex CSG objects: direct interval intersection
        for cid, csg in enumerate(sc.csgs):
            if not csg.convex:
                continue
            members = []
            vis = (True, True)
            for clause in csg.clauses:
                for gi, idx in clause.members:
                    g = sc.groups[gi]
                    if (si, gi) not in group_meta:
                        add_group_pf(si, gi, g, None)
                    base, F, _ = group_meta[(si, gi)]
                    for li in np.asarray(idx):
                        li = int(li)
                        members.append((g.ptype, base + li * F, F,
                                        g.m_inv is not None,
                                        prim_base[(si, gi)][0] + li))
                        vis = (vis[0] and not bool(g.onlyshadow[li]),
                               vis[1] and not bool(g.noshadow[li]))
            phases.append(Phase("convex", si, members=members, vis=vis))

        phases.extend(deferred_phases)

    # finalize combos: groups keyed by (ptype, transformed); all their
    # params live in ONE padded (Ptot, F_max) table so finalize pays a
    # single row gather
    combo_ix: Dict[Tuple[str, bool], int] = {}
    combos: List[tuple] = []  # (ptype, transformed, [(si, gi)], warp_any)
    cid_all = np.full(nbase, -1, np.int32)
    row_all = np.zeros(nbase, np.int32)
    for si, sc in enumerate(compiled.scenes):
        for gi, g in enumerate(sc.groups):
            if g.size == 0:
                continue
            key = (g.ptype, g.m_inv is not None)
            if key not in combo_ix:
                combo_ix[key] = len(combos)
                combos.append((key[0], key[1], [], False))
            k = combo_ix[key]
            ptype, tr, glist, warp_any = combos[k]
            base = prim_base[(si, gi)][0]
            row0 = sum(prim_base[(s2, g2)][1] for (s2, g2) in glist)
            cid_all[base:base + g.size] = k
            row_all[base:base + g.size] = row0 + np.arange(g.size)
            glist.append((si, gi))
            combos[k] = (ptype, tr, glist,
                         warp_any or ((si, gi) in warp_groups))
    # rebase rows into the single concatenated finalize table
    combo_base = {}
    acc = 0
    for k, (_pt, _tr, glist, _w) in enumerate(combos):
        combo_base[k] = acc
        acc += sum(prim_base[sg_][1] for sg_ in glist)
    for si, sc in enumerate(compiled.scenes):
        for gi, g in enumerate(sc.groups):
            if g.size == 0:
                continue
            base = prim_base[(si, gi)][0]
            row_all[base:base + g.size] += combo_base[
                int(cid_all[base])]

    return MegaPlan(
        phases=phases, pf_spec=pf_spec, pf_size=max(pf_off, 1),
        pi=(np.concatenate(pi_rows) if pi_rows else np.zeros(2, np.int32)),
        nf=(np.concatenate(nf_parts) if nf_parts
            else np.zeros(1, np.float32)),
        ni=(np.concatenate(ni_parts) if ni_parts
            else np.zeros(1, np.int32)),
        bb_spec=bb_spec, prim_base=prim_base, n_prims=nbase,
        n_scenes=len(compiled.scenes),
        tex_all=(np.concatenate(tex_all) if tex_all
                 else np.zeros((0, TEX_DEPTH), np.int32)),
        tag_all=(np.concatenate(tag_all) if tag_all
                 else np.zeros((0, TAG_DEPTH), np.int32)),
        serial_all=(np.concatenate(ser_all) if ser_all
                    else np.zeros(0, np.int32)),
        neg_all=(np.concatenate(neg_all) if neg_all
                 else np.zeros(0, bool)),
        csg_all=(np.concatenate(csg_all) if csg_all
                 else np.zeros(0, np.int32)),
        scene_of=(np.concatenate(sc_of) if sc_of
                  else np.zeros(0, np.int32)),
        ltex_all=(np.concatenate(ltex_all) if ltex_all
                  else np.zeros((0, TEX_DEPTH), np.int32)),
        ltag_all=(np.concatenate(ltag_all) if ltag_all
                  else np.zeros((0, TAG_DEPTH), np.int32)),
        atex_all=(np.concatenate(atex_all) if atex_all
                  else np.zeros(0, bool)),
        warp_groups=frozenset(warp_groups),
        combos=combos, cid_all=cid_all, row_all=row_all,
        external=external, blocks=blocks)


def get_plan(compiled) -> MegaPlan:
    plan = getattr(compiled, "_mega_plan", None)
    if plan is None:
        plan = build_plan(compiled)
        compiled._mega_plan = plan
    return plan


# --- phase-descriptor encoding ---------------------------------------------
# One flat int32 table per plan.  The first n_phases * PH_W entries are
# the phase headers in plan order; constraint member sets (CM_W ints
# each), clause entries (CL_W), DNF region entries (RG_W) and convex
# members (CV_W) follow, referenced from the headers by ABSOLUTE index.
# A conjunction [(positive, [ConsMember])] is a contiguous run of
# clause entries (positive, cm_start, cm_count); each clause's members
# are a contiguous run of CM entries.  csrc/mega_select.cu reads the
# same layout (its PH_*/CM_*/CV_* constants must match these).

PH_W = 32
(PH_KIND, PH_SI, PH_PTYPE, PH_XF, PH_P, PH_PF, PH_F, PH_PI, PH_VIS0,
 PH_VIS1, PH_VISMIX, PH_BB, PH_NF, PH_NI, PH_NNODES, PH_DEPTH, PH_CONS,
 PH_NCONS, PH_MEM, PH_NMEM, PH_GPRIM, PH_NEG, PH_OWN, PH_REG, PH_NREG,
 PH_ATEX, PH_NFLD) = range(27)
KIND_CODE = {"dense": 0, "bvh2": 1, "convex": 2, "deferred": 3}
CM_W = 10   # ptype, pf_base, F, M, has_inv, pi_base, nf_base, ni_base,
#             n_nodes, nfld
CL_W = 3    # positive, cm_start, cm_count
RG_W = 2    # cl_start, cl_count
CV_W = 6    # ptype, pf offset, F, has_inv, gprim, nfld


def encode_phases(plan: MegaPlan) -> np.ndarray:
    """The plan as one flat int32 descriptor table (cached on the plan,
    like finalize's _meta_tab)."""
    tab = getattr(plan, "_phase_tab", None)
    if tab is not None:
        return tab
    for ph in plan.phases:
        if ph.kind not in KIND_CODE:
            raise NotImplementedError(f"phase kind {ph.kind!r}")
    out = [0] * (len(plan.phases) * PH_W)

    def conj(clauses):
        entries = []
        for positive, ms in clauses:
            cm_start = len(out)
            for cm in ms:
                out.extend([PTYPE_CODE[cm.ptype], cm.pf_base, cm.F, cm.M,
                            int(cm.has_inv), cm.pi_base, cm.nf_base,
                            cm.ni_base, cm.n_nodes, _field_width(cm.ptype)])
            entries.append((int(bool(positive)), cm_start, len(ms)))
        cl_start = len(out)
        for e in entries:
            out.extend(e)
        return cl_start, len(entries)

    for i, ph in enumerate(plan.phases):
        h = [0] * PH_W
        h[PH_KIND] = KIND_CODE[ph.kind]
        h[PH_SI] = ph.si
        h[PH_PTYPE] = PTYPE_CODE.get(ph.ptype, -1)
        h[PH_XF] = int(ph.transformed)
        h[PH_P] = ph.P
        h[PH_PF] = ph.pf_base
        h[PH_F] = ph.F
        h[PH_PI] = ph.pi_base
        h[PH_VIS0], h[PH_VIS1] = int(ph.vis[0]), int(ph.vis[1])
        h[PH_VISMIX] = int(ph.vis_mixed)
        h[PH_BB] = ph.bb_idx
        h[PH_NF], h[PH_NI] = ph.nf_base, ph.ni_base
        h[PH_NNODES], h[PH_DEPTH] = ph.n_nodes, ph.depth
        h[PH_CONS], h[PH_NCONS] = conj(ph.cons) if ph.cons else (0, 0)
        if ph.members:
            h[PH_MEM], h[PH_NMEM] = len(out), len(ph.members)
            for ptype, off, F, has_inv, gp in ph.members:
                out.extend([PTYPE_CODE[ptype], off, F, int(has_inv), gp,
                            _field_width(ptype)])
        h[PH_GPRIM] = ph.gprim
        h[PH_NEG] = int(ph.neg)
        h[PH_OWN] = conj([(True, ph.own)])[0] if ph.own is not None else -1
        if ph.regions:
            regs = [conj(reg) for reg in ph.regions]
            h[PH_REG], h[PH_NREG] = len(out), len(regs)
            for r in regs:
                out.extend(r)
        h[PH_ATEX] = ph.atex_clause
        h[PH_NFLD] = _field_width(ph.ptype) if ph.ptype else 0
        out[i * PH_W:(i + 1) * PH_W] = h
    tab = np.asarray(out, np.int32)
    plan._phase_tab = tab
    return tab


# --- table packing -----------------------------------------------------------

@dataclasses.dataclass
class PlanTables:
    """Everything mega_select reads, on one device: PF f32 (prim rows),
    PI i32 ([gprim, flags|ordinal] per row), NF f32 / NI i32 (BVH node
    tables), BB f32 (n_dense, 8) dense-phase AABBs and the phase
    descriptor table."""
    plan: MegaPlan
    pf: torch.Tensor
    pi: torch.Tensor
    nf: torch.Tensor
    ni: torch.Tensor
    bb: torch.Tensor
    phases: torch.Tensor


def _check_plan_supported(plan: MegaPlan):
    if plan.blocks:
        raise NotImplementedError(
            f"groups {plan.blocks} need K2 (glome_tpu "
            "block_kernel.block_select), which is not ported yet")
    if plan.external:
        raise NotImplementedError(
            f"groups {plan.external} need K3 (glome_tpu "
            "mesh_kernel.mesh_block_select), which is not ported yet")


def _static_tables(plan: MegaPlan, device):
    """Device copies of the plan's static PI/NF/NI/descriptor tables,
    cached on the plan per device."""
    cache = plan.__dict__.setdefault("_dev_tabs", {})
    key = str(device)
    if key not in cache:
        cache[key] = tuple(
            torch.as_tensor(a, device=device) for a in
            (plan.pi, plan.nf, plan.ni, encode_phases(plan)))
    return cache[key]


def _param_rows(g, ga, dtype):
    """(P, F) rows of a group: FIELDS columns [+ 12 inverse-matrix]."""
    cols = []
    for name, _w in FIELDS[g.ptype]:
        v = ga[name]
        cols.append(v.reshape(v.shape[0], -1) if v.dim() > 1 else v[:, None])
    if g.m_inv is not None:
        cols.append(ga["m_inv"].reshape(-1, 12))
    return torch.cat(cols, dim=-1).to(dtype)


def pack_tables(plan: MegaPlan, compiled, arrays) -> PlanTables:
    """PlanTables on the device of the scene tensors (`arrays` as from
    to_torch).  The kernel only selects (winners are re-evaluated
    differentiably by finalize), so the tables are detached."""
    from .compile import group_device_params
    _check_plan_supported(plan)
    lights = arrays["lights"]["pos"]
    device = lights.device
    parts = []
    for si, gi, idx, F in plan.pf_spec:
        g = compiled.scenes[si].groups[gi]
        ga = {k: v.detach() for k, v in
              group_device_params(g, arrays["scenes"][si][gi]).items()}
        rows = _param_rows(g, ga, torch.float32)
        if idx is not None:
            rows = rows[torch.as_tensor(idx, dtype=torch.int64,
                                        device=device)]
        parts.append(rows.reshape(-1))
    pf = (torch.cat(parts) if parts
          else torch.zeros(1, dtype=torch.float32, device=device))

    bb_rows = []
    for si, gi in plan.bb_spec:
        g = compiled.scenes[si].groups[gi]
        ga = {k: v.detach() for k, v in
              group_device_params(g, arrays["scenes"][si][gi]).items()}
        ab = prim_aabb(g.ptype,
                       {k: v for k, v in ga.items()
                        if k not in ("m_inv", "m_fwd")}, ga.get("m_fwd"))
        bb_rows.append(torch.cat(
            [ab[0].amin(dim=0), ab[1].amax(dim=0),
             torch.zeros(2, dtype=ab[0].dtype, device=device)]))
    bb = (torch.stack(bb_rows).to(torch.float32) if bb_rows
          else torch.zeros((1, 8), dtype=torch.float32, device=device))
    pi, nf, ni, phases = _static_tables(plan, device)
    return PlanTables(plan, pf.contiguous(), pi, nf, ni, bb.contiguous(),
                      phases)


# --- the kernel K1 ----------------------------------------------------------

def _check_launch(tables: PlanTables, rays):
    dev = rays.device
    if rays.dim() != 2 or rays.shape[0] != 8:
        raise ValueError(f"rays must be (8, N), got {tuple(rays.shape)}")
    for name in ("pf", "nf", "bb"):
        t = getattr(tables, name)
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name in ("pi", "ni", "phases"):
        t = getattr(tables, name)
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if rays.dtype != torch.float32:
        raise TypeError(f"rays must be float32, got {rays.dtype}")
    for name in ("pf", "pi", "nf", "ni", "bb", "phases"):
        t = getattr(tables, name)
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, rays on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not rays.is_contiguous():
        raise ValueError("rays must be contiguous")
    depth = max([ph.depth for ph in tables.plan.phases
                 if ph.kind == "bvh2"], default=0)
    if depth > STACK_MAX:
        raise ValueError(f"bvh2 depth {depth} exceeds the kernel's "
                         f"stack bound {STACK_MAX}")


def mega_select(tables: PlanTables, rays, shadow: bool = False):
    """Single-launch nearest-valid-candidate selection (K1).

    rays: (8, N) float32 component planes [ox,oy,oz,dx,dy,dz,seed,sid]
    (seed = the start best t, min(tmax, INFINITY); dead lanes seed <= 0;
    sid = per-ray scene id, -1 = always a miss).  Returns (t, wid, aux):
    t == seed and wid == -1 where nothing is nearer, else wid =
    global_prim*2 + slot; aux (int32) = first containing A member of a
    useatex difference-B winner, else -1.  shadow=True is the any-hit
    variant (only wid >= 0 is meaningful).

    A CUDA tensor launches csrc/mega_select.cu on the current stream; a
    CPU tensor runs mega_select_plain."""
    if rays.device.type == "cpu":
        return mega_select_plain(tables, rays, shadow)
    if rays.device.type != "cuda":
        raise ValueError(f"mega_select: unsupported device {rays.device}")
    from . import kernels
    _check_launch(tables, rays)
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    wid = torch.empty(n, dtype=torch.int32, device=rays.device)
    aux = torch.empty(n, dtype=torch.int32, device=rays.device)
    if n == 0:
        return t, wid, aux
    lib = kernels.mega_select_lib()
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = lib.glome_mega_select(
            rays.data_ptr(), n, tables.pf.data_ptr(), tables.pi.data_ptr(),
            tables.nf.data_ptr(), tables.ni.data_ptr(),
            tables.bb.data_ptr(), tables.phases.data_ptr(),
            len(tables.plan.phases), int(bool(shadow)),
            t.data_ptr(), wid.data_ptr(), aux.data_ptr(),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"mega_select launch failed: cudaError {err} "
                           f"({kernels.cuda_error_name(err)})")
    mega_select.launches += 1
    return t, wid, aux


mega_select.launches = 0


# --- the plain version -----------------------------------------------------

# elements per (rays x prims [x members]) temporary in the plain version
_PLAIN_BUDGET = 1 << 21


def _cols(rows):
    """Field accessor over (P, F) rows -> (1, P) columns."""
    return lambda q: rows[:, q][None, :]


def _candidates(ptype, rows, nfld, transformed, o, d):
    """(n, P) entry/exit world distances of P prims (rows (P, F))
    against n rays; o, d: (n, 3)."""
    ox, oy, oz = (o[:, c:c + 1] for c in range(3))
    dx, dy, dz = (d[:, c:c + 1] for c in range(3))
    tker = _T_KERNELS[ptype]
    p = _cols(rows)
    if not transformed:
        return tker(p, ox, oy, oz, dx, dy, dz)
    m = [rows[:, nfld + q][None, :] for q in range(12)]
    pox = m[0] * ox + m[1] * oy + m[2] * oz + m[3]
    poy = m[4] * ox + m[5] * oy + m[6] * oz + m[7]
    poz = m[8] * ox + m[9] * oy + m[10] * oz + m[11]
    pdx = m[0] * dx + m[1] * dy + m[2] * dz
    pdy = m[4] * dx + m[5] * dy + m[6] * dz
    pdz = m[8] * dx + m[9] * dy + m[10] * dz
    ils = 1.0 / torch.sqrt(pdx * pdx + pdy * pdy + pdz * pdz)
    t0, t1 = tker(p, pox, poy, poz, pdx * ils, pdy * ils, pdz * ils)
    t0 = torch.where(torch.abs(t0) >= INF, t0, t0 * ils)
    t1 = torch.where(torch.abs(t1) >= INF, t1, t1 * ils)
    return t0, t1


def _member_rows(tables, cm):
    return tables.pf[cm.pf_base:cm.pf_base + cm.M * cm.F].view(cm.M, cm.F)


def _member_inside(tables, cm, px, py, pz):
    """(..., M) strict inside tests of points (...) against the M rows
    of a constraint member set."""
    rows = _member_rows(tables, cm)
    nfld = _field_width(cm.ptype)
    px, py, pz = px[..., None], py[..., None], pz[..., None]
    if cm.has_inv:
        m = [rows[:, nfld + q] for q in range(12)]
        cx = m[0] * px + m[1] * py + m[2] * pz + m[3]
        cy = m[4] * px + m[5] * py + m[6] * pz + m[7]
        cz = m[8] * px + m[9] * py + m[10] * pz + m[11]
    else:
        cx, cy, cz = px, py, pz
    return _inside_comp(cm.ptype, lambda q: rows[:, q], cx, cy, cz)


def _eval_cons(tables, cons, px, py, pz):
    """Clause check at candidate points (Csg.hs:92-101: IN(set) ==
    positive for every clause)."""
    allok = torch.ones(px.shape, dtype=torch.bool, device=px.device)
    for positive, ms in cons:
        inn = torch.zeros_like(allok)
        for cm in ms:
            if cm.M:
                inn = inn | _member_inside(tables, cm, px, py, pz).any(-1)
        allok = allok & (inn == bool(positive))
    return allok


def _clause_first(tables, ms, px, py, pz):
    """(inside_any, global prim id of the FIRST containing member in
    clause order, -1 if none): get_metainfo semantics for
    difference-B retexture (Csg.hs:39-41)."""
    big = torch.iinfo(torch.int64).max
    best_ord = torch.full(px.shape, big, dtype=torch.int64, device=px.device)
    best_gp = torch.full(px.shape, -1, dtype=torch.int64, device=px.device)
    for cm in ms:
        if not cm.M:
            continue
        ins = _member_inside(tables, cm, px, py, pz)              # (n, M)
        pir = tables.pi[cm.pi_base:cm.pi_base + 2 * cm.M].view(cm.M, 2)
        ords = torch.where(ins, pir[:, 1].to(torch.int64), big)
        o_min, arg = ords.min(dim=-1)
        better = o_min < best_ord
        best_gp = torch.where(better, pir[:, 0].to(torch.int64)[arg],
                              best_gp)
        best_ord = torch.where(better, o_min, best_ord)
    return best_ord < big, best_gp


def _plain_prims(tables, ph, o, d, bt, bw, ok_p):
    """Dense / bvh2 phase: brute force over the phase's prims in kernel
    (PF row) order.  Sequential strict-< merging keeps the FIRST prim
    reaching the minimum, which argmin reproduces."""
    P, F = ph.P, ph.F
    rows = tables.pf[ph.pf_base:ph.pf_base + P * F].view(P, F)
    pir = tables.pi[ph.pi_base:ph.pi_base + 2 * P].view(P, 2)
    gp = pir[:, 0].to(torch.int64)
    t0, t1 = _candidates(ph.ptype, rows, _field_width(ph.ptype),
                         ph.transformed, o, d)
    btc = bt[:, None]
    v0 = (t0 > 0.0) & (t0 < btc)
    v1 = (t1 > 0.0) & (t1 < btc)
    if ok_p is not None:
        v0 = v0 & ok_p[None, :]
        v1 = v1 & ok_p[None, :]
    if ph.cons:
        for which in (0, 1):
            tv = t0 if which == 0 else t1
            px = o[:, 0:1] + d[:, 0:1] * tv
            py = o[:, 1:2] + d[:, 1:2] * tv
            pz = o[:, 2:3] + d[:, 2:3] * tv
            okc = _eval_cons(tables, ph.cons, px, py, pz)
            if which == 0:
                v0 = v0 & okc
            else:
                v1 = v1 & okc
    tc = torch.where(v0, t0, torch.where(v1, t1, torch.full_like(t1, INF)))
    arg = torch.argmin(tc, dim=1)
    tmin = tc.gather(1, arg[:, None])[:, 0]
    slot = (~v0.gather(1, arg[:, None])[:, 0]).to(torch.int64)
    better = tmin < bt
    return (torch.where(better, tmin, bt),
            torch.where(better, gp[arg] * 2 + slot, bw))


def _member_interval(tables, ptype, off, F, has_inv, o, d):
    """Exact world [t_in, t_out] of one convex member (n,)."""
    row = tables.pf[off:off + F].view(1, F)
    nfld = _field_width(ptype)
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    f = lambda q: row[0, q]                                    # noqa: E731
    ils = None
    if has_inv:
        m = [row[0, nfld + q] for q in range(12)]
        ox, oy, oz = (m[0] * ox + m[1] * oy + m[2] * oz + m[3],
                      m[4] * ox + m[5] * oy + m[6] * oz + m[7],
                      m[8] * ox + m[9] * oy + m[10] * oz + m[11])
        pdx = m[0] * dx + m[1] * dy + m[2] * dz
        pdy = m[4] * dx + m[5] * dy + m[6] * dz
        pdz = m[8] * dx + m[9] * dy + m[10] * dz
        ils = 1.0 / torch.sqrt(pdx * pdx + pdy * pdy + pdz * pdz)
        dx, dy, dz = pdx * ils, pdy * ils, pdz * ils
    if ptype == "plane":
        nx_, ny_, nz_, offp = f(0), f(1), f(2), f(3)
        dn = nx_ * dx + ny_ * dy + nz_ * dz
        sdist = nx_ * ox + ny_ * oy + nz_ * oz - offp
        t = -sdist / torch.where(dn == 0.0, 1.0, dn)
        ins = sdist < 0.0
        t0 = torch.where(dn < 0.0, t, -INF)
        t1 = torch.where(dn > 0.0, t, INF)
        t0 = torch.where(dn == 0.0, torch.where(ins, -INF, INF), t0)
        t1 = torch.where(dn == 0.0, torch.where(ins, INF, -INF), t1)
    else:
        t0, t1 = _T_KERNELS[ptype](f, ox, oy, oz, dx, dy, dz)
    if ils is not None:
        t0 = torch.where(torch.abs(t0) >= INF, t0, t0 * ils)
        t1 = torch.where(torch.abs(t1) >= INF, t1, t1 * ils)
    return t0, t1


def _plain_convex(tables, ph, o, d, bt, bw):
    n = o.shape[0]
    t_in = torch.full((n,), -INF, dtype=o.dtype, device=o.device)
    t_out = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    w_in = torch.zeros((n,), dtype=torch.int64, device=o.device)
    w_out = torch.zeros_like(w_in)
    for ptype, off, F, has_inv, gp in ph.members:
        t0, t1 = _member_interval(tables, ptype, off, F, has_inv, o, d)
        u0 = t0 > t_in
        t_in = torch.where(u0, t0, t_in)
        w_in = torch.where(u0, gp * 2, w_in)
        u1 = t1 < t_out
        t_out = torch.where(u1, t1, t_out)
        w_out = torch.where(u1, gp * 2 + 1, w_out)
    entering = t_in > 0.0
    t_cand = torch.where(entering, t_in, t_out)
    ok = ((t_in <= t_out) & (t_cand > 0.0) & (t_cand < bt)
          & (t_cand < INF))
    return (torch.where(ok, t_cand, bt),
            torch.where(ok, torch.where(entering, w_in, w_out), bw))


def _plain_deferred(tables, ph, o, d, bt, bw, ba):
    """One deferred CSG prim: exit-only for negative clauses plus the
    leave-own-clause check (Csg.hs:33-54), DNF region flips, and the
    first containing A member for useatex difference-B prims."""
    rows = tables.pf[ph.pf_base:ph.pf_base + ph.F].view(1, ph.F)
    t0, t1 = _candidates(ph.ptype, rows, _field_width(ph.ptype),
                         ph.transformed, o, d)
    t0, t1 = t0[:, 0], t1[:, 0]
    v0 = (t0 > 0.0) & (t0 < bt) & (t0 < INF) & (not ph.neg)
    v1 = (t1 > 0.0) & (t1 < bt) & (t1 < INF)
    first_gp = None
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    for which in (0, 1):
        tv = t0 if which == 0 else t1
        px, py, pz = ox + dx * tv, oy + dy * tv, oz + dz * tv
        if which == 1 and ph.atex_clause >= 0:
            others = [c for i, c in enumerate(ph.cons)
                      if i != ph.atex_clause]
            okc = _eval_cons(tables, others, px, py, pz)
            inn_ok, first_gp = _clause_first(
                tables, ph.cons[ph.atex_clause][1], px, py, pz)
            okc = okc & inn_ok
        else:
            okc = _eval_cons(tables, ph.cons, px, py, pz)
        if ph.regions:
            # DNF boundary test: the union (own region OR siblings)
            # must FLIP across the candidate, sampled at p -+ DELTA*d
            um = torch.zeros_like(okc)
            up = torch.zeros_like(okc)
            for reg in ph.regions:
                um = um | _eval_cons(tables, reg, px - dx * DELTA,
                                     py - dy * DELTA, pz - dz * DELTA)
                up = up | _eval_cons(tables, reg, px + dx * DELTA,
                                     py + dy * DELTA, pz + dz * DELTA)
            okc = okc & (um != up)
        if which == 1 and ph.neg:
            # the ray must actually leave the clause set
            still = _eval_cons(tables, [(True, ph.own)], px + dx * DELTA,
                               py + dy * DELTA, pz + dz * DELTA)
            okc = okc & ~still
        if which == 0:
            v0 = v0 & okc
        else:
            v1 = v1 & okc
    tc = torch.where(v0, t0, torch.where(v1, t1, torch.full_like(t1, INF)))
    better = tc < bt
    wc = ph.gprim * 2 + (~v0).to(torch.int64)
    if first_gp is not None:
        ba = torch.where(better, first_gp, ba)
    return (torch.where(better, tc, bt), torch.where(better, wc, bw), ba)


def mega_select_plain(tables: PlanTables, rays, shadow: bool = False):
    """Plain torch version of mega_select: the same (t, wid, aux) by
    brute force over every phase's prims in plan order (the kernel's
    BVHs and AABBs only cull, so brute force gives the same nearest
    winner except on exact ties), rays processed in chunks to bound
    memory.  Shadow mode computes the nearest blocker; only wid >= 0
    is meaningful there, as in the kernel."""
    mega_select_plain.calls += 1
    plan = tables.plan
    vi = 1 if shadow else 0
    n = rays.shape[1]
    dev = rays.device
    o_all = rays[0:3].t()
    d_all = rays[3:6].t()
    seed = rays[6]
    sidr = rays[7]
    bt = seed.clone()
    bw = torch.full((n,), -1, dtype=torch.int64, device=dev)
    ba = torch.full((n,), -1, dtype=torch.int64, device=dev)
    live = seed > 0.0       # dead lanes (seed <= 0) fail every candidate
    for ph in plan.phases:
        if not ph.vis[vi]:
            continue
        sel = live & (sidr == float(ph.si))
        if shadow:
            sel = sel & (bt >= seed)         # still unblocked
        idx = torch.nonzero(sel)[:, 0]
        if idx.numel() == 0:
            continue
        ok_p = None
        if ph.kind in ("dense", "bvh2") and ph.vis_mixed:
            flags = tables.pi[ph.pi_base + 1:ph.pi_base + 2 * ph.P:2]
            ok_p = (flags % 2 == 1) if vi == 0 else (flags >= 2)
        width = max(1, ph.P) * max(
            [1] + [sum(cm.M for cm in ms) for _p, ms in (ph.cons or [])])
        chunk = max(1, _PLAIN_BUDGET // width)
        for s in range(0, idx.numel(), chunk):
            ix = idx[s:s + chunk]
            o, d = o_all[ix], d_all[ix]
            b_t, b_w = bt[ix], bw[ix]
            if ph.kind in ("dense", "bvh2"):
                b_t, b_w = _plain_prims(tables, ph, o, d, b_t, b_w, ok_p)
            elif ph.kind == "convex":
                b_t, b_w = _plain_convex(tables, ph, o, d, b_t, b_w)
            elif ph.kind == "deferred":
                b_t, b_w, b_a = _plain_deferred(tables, ph, o, d, b_t, b_w,
                                                ba[ix])
                ba[ix] = b_a
            else:
                raise NotImplementedError(f"phase kind {ph.kind!r}")
            bt[ix] = b_t
            bw[ix] = b_w
    return bt, bw.to(torch.int32), ba.to(torch.int32)


mega_select_plain.calls = 0


# --- differentiable finalize ------------------------------------------------

def _meta_tables(plan: MegaPlan, device):
    """finalize's static per-prim tables on `device` (cached): the f32
    metadata columns [tex*4, tag*4, serial, neg, cid, row, useatex] and
    the local (retexture) [ltex*4, ltag*4] rows."""
    cache = plan.__dict__.setdefault("_dev_meta", {})
    key = str(device)
    if key not in cache:
        meta_tab = np.concatenate(
            [plan.tex_all, plan.tag_all, plan.serial_all[:, None],
             plan.neg_all[:, None].astype(np.int32),
             plan.cid_all[:, None], plan.row_all[:, None],
             plan.atex_all[:, None].astype(np.int32)],
            axis=1).astype(np.int32)
        if np.abs(meta_tab).max(initial=0) >= 2 ** 24:
            raise ValueError("meta values no longer exact in f32")
        ltab = np.concatenate([plan.ltex_all, plan.ltag_all],
                              axis=1).astype(np.int32)
        cache[key] = (torch.as_tensor(meta_tab.astype(np.float32),
                                      device=device),
                      torch.as_tensor(ltab, device=device))
    return cache[key]


def finalize(compiled, plan: MegaPlan, arrays, o, d, t, wid, aux=None,
             want_meta: bool = True):
    """Re-evaluate the winning candidates differentiably and assemble
    the Hit record (normals via the geom functions, instance object
    rays, texture/tag stacks, difference-B retexture via the kernel's
    first-containing-A-member aux output)."""
    from .compile import TEX_DEPTH, TAG_DEPTH, group_device_params
    from .intersect import Hit, _kernel_hits2
    from .vec import finite_grad, vscaleadd

    N = o.shape[0]
    dt = o.dtype
    dev = o.device
    wid = wid.to(torch.int64)
    hit = wid >= 0
    prim = torch.where(hit, wid // 2, torch.zeros_like(wid))
    slot = torch.where(hit, wid % 2, torch.zeros_like(wid))

    best_t = torch.where(hit, t, torch.full_like(t, INFINITY))
    norm = torch.zeros((N, 3), dtype=dt, device=dev)
    obj_o, obj_d = o, d

    metaf, ltab = _meta_tables(plan, dev)
    TD = TEX_DEPTH
    GD = TAG_DEPTH

    # param table in GLOBAL PRIM order, one padded row per prim, with
    # the int32 metadata carried alongside as float VALUES (every meta
    # value is a small integer, exact in f32): ONE row gather serves
    # params and metadata.  The inverse matrix lives in a FIXED
    # 12-column slot after the padded field columns for every
    # transformed group, so one select + one object-space transform
    # serves all transformed combos.
    FW = max((_field_width(pt) for pt, _tr, _g, _w in plan.combos),
             default=1)
    f_max = FW + 12
    tabs = []
    for si, sc in enumerate(compiled.scenes):
        for gi, g in enumerate(sc.groups):
            if g.size == 0:
                continue
            ga = group_device_params(g, arrays["scenes"][si][gi])
            cols = []
            for name, _wd in FIELDS[g.ptype]:
                v = ga[name]
                cols.append(v.reshape(v.shape[0], -1) if v.dim() > 1
                            else v[:, None])
            rows_k = torch.cat(cols, dim=-1).to(dt)
            if rows_k.shape[1] < FW:
                rows_k = torch.cat(
                    [rows_k, torch.zeros((rows_k.shape[0],
                                          FW - rows_k.shape[1]),
                                         dtype=dt, device=dev)], dim=-1)
            if g.m_inv is not None:
                mi = ga["m_inv"].reshape(-1, 12).to(dt)
            else:
                mi = torch.zeros((rows_k.shape[0], 12), dtype=dt,
                                 device=dev)
            tabs.append(torch.cat([rows_k, mi], dim=-1))
    if tabs:
        ptab = torch.cat(tabs, dim=0)
        comb = torch.cat([ptab, metaf.to(dt)], dim=1)
        # per-lane non-finite-gradient filter at the gather boundary
        # (see vec.finite_grad): singular lanes must not poison the
        # cross-lane accumulation into parameter rows
        crow = finite_grad(comb[prim])             # (N, f_max + MW)
        prow = crow[:, :f_max]
        meta = crow[:, f_max:].detach().to(torch.int64)
    else:
        meta = metaf[prim].to(torch.int64)

    neg1 = torch.full_like(meta[:, :TD], -1)
    tex = torch.where(hit[:, None], meta[:, :TD], neg1)
    tag = torch.where(hit[:, None], meta[:, TD:TD + GD], neg1)
    ser = torch.where(hit, meta[:, TD + GD], torch.full_like(prim, -1))
    neg = (meta[:, TD + GD + 1] > 0) & hit
    cid = meta[:, TD + GD + 2]
    atex = (meta[:, TD + GD + 4] > 0) & hit

    # ONE shared object-space ray for all transformed combos
    xf_cids = [k for k, (_p, tr, _g, _w) in enumerate(plan.combos) if tr]
    any_xf = torch.zeros((N,), dtype=torch.bool, device=dev)
    for k in xf_cids:
        any_xf = any_xf | (cid == k)
    any_xf = any_xf & hit
    if xf_cids:
        ident12 = torch.tensor([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0],
                               dtype=dt, device=dev)
        m12 = torch.where(any_xf[:, None], prow[:, FW:FW + 12], ident12)
        m = [m12[:, q] for q in range(12)]
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        dx_, dy_, dz_ = d[:, 0], d[:, 1], d[:, 2]
        pox = m[0] * ox + m[1] * oy + m[2] * oz + m[3]
        poy = m[4] * ox + m[5] * oy + m[6] * oz + m[7]
        poz = m[8] * ox + m[9] * oy + m[10] * oz + m[11]
        pdx = m[0] * dx_ + m[1] * dy_ + m[2] * dz_
        pdy = m[4] * dx_ + m[5] * dy_ + m[6] * dz_
        pdz = m[8] * dx_ + m[9] * dy_ + m[10] * dz_
        ils = 1.0 / torch.sqrt(torch.clamp(
            pdx * pdx + pdy * pdy + pdz * pdz, min=1e-30))
        oo = torch.stack([pox, poy, poz], dim=-1)
        du = torch.stack([pdx * ils, pdy * ils, pdz * ils], dim=-1)

    for k, (ptype, transformed, glist, warp_any) in enumerate(plan.combos):
        mask = hit & (cid == k)
        params = {}
        off = 0
        for name, wdt in FIELDS[ptype]:
            # rows of other combos hold arbitrary values for this
            # layout; replace them under the mask so no division garbage
            # (inf / nan) leaks into gradients through the select
            col = torch.where(mask[:, None], prow[:, off:off + wdt],
                              torch.ones((), dtype=dt, device=dev))
            params[name] = col if wdt > 1 else col[:, 0]
            off += wdt
        if transformed:
            t0, n0, t1, n1 = _kernel_hits2(ptype, params, oo, du)
            t0 = t0 * ils
            t1 = t1 * ils
        else:
            t0, n0, t1, n1 = _kernel_hits2(ptype, params, o, d)
        tsel = torch.where(slot == 0, t0, t1)
        # clamp the differentiable recompute to the selected value when
        # the two evaluations disagree numerically (tangency)
        tsel = torch.where(torch.abs(tsel - t) < 1e-2 * (1.0 + torch.abs(t)),
                           tsel, t)
        nsel = torch.where((slot == 0)[:, None], n0, n1)
        best_t = torch.where(mask, tsel, best_t)
        norm = torch.where(mask[:, None], nsel, norm)
        if transformed and warp_any:
            obj_o = torch.where(mask[:, None], oo, obj_o)
            obj_d = torch.where(mask[:, None], du, obj_d)

    # object-space winner normals -> world, once for every transformed
    # combo: n_world = normalize(M_inv^T n_obj) (Vec.hs:543 semantics)
    if xf_cids:
        nx_, ny_, nz_ = norm[:, 0], norm[:, 1], norm[:, 2]
        wx = m[0] * nx_ + m[4] * ny_ + m[8] * nz_
        wy = m[1] * nx_ + m[5] * ny_ + m[9] * nz_
        wz = m[2] * nx_ + m[6] * ny_ + m[10] * nz_
        il = 1.0 / torch.sqrt(torch.clamp(wx * wx + wy * wy + wz * wz,
                                          min=1e-30))
        nw = torch.stack([wx * il, wy * il, wz * il], dim=-1)
        norm = torch.where(any_xf[:, None], nw, norm)

    norm = torch.where(neg[:, None], -norm, norm)

    pos = vscaleadd(o, d, torch.where(hit, best_t, torch.zeros_like(best_t)))

    if want_meta and aux is not None and bool(plan.atex_all.any()):
        # difference-B retexture (Csg.hs:39-41): the kernel already
        # found the first containing A member during the validity scan
        aux = aux.to(torch.int64)
        use = atex & neg & (aux >= 0)
        lrow = ltab[torch.clamp(aux, 0, plan.n_prims - 1)].to(torch.int64)
        tex = torch.where(use[:, None], lrow[:, :TD], tex)
        tag = torch.where(use[:, None], lrow[:, TD:TD + GD], tag)

    return Hit(t=best_t, hit=hit, pos=pos, norm=norm,
               obj_o=obj_o, obj_d=obj_d,
               tex_stack=tex.to(torch.int32), tag_stack=tag.to(torch.int32),
               prim_serial=ser.to(torch.int32))


# --- entry points ----------------------------------------------------------

def _ray_table(o, d, seed, sid):
    """(8, N) float32 plane table [o, d, seed, sid], detached."""
    return torch.cat([o.detach().t(), d.detach().t(),
                      seed.detach()[None], sid.to(o.dtype)[None]],
                     dim=0).to(torch.float32).contiguous()


def mega_intersect(compiled, arrays, o, d, sid=None, tmax=None,
                   shadow: bool = False, scene_id: int = 0,
                   select=mega_select):
    """Full Hit via K1 + differentiable finalize; o, d (N, 3).
    sid=None traces every ray in `scene_id`; otherwise sid is (N,) int
    per-ray scene ids (-1 = always miss)."""
    plan = get_plan(compiled)
    N = o.shape[0]
    if tmax is None:
        tmax = torch.full((N,), INFINITY, dtype=o.dtype, device=o.device)
    seed = torch.clamp(tmax, max=INFINITY)
    if sid is None:
        sid = torch.full((N,), scene_id, dtype=torch.int32, device=o.device)
    tables = pack_tables(plan, compiled, arrays)
    t, wid, aux = select(tables, _ray_table(o, d, seed, sid), shadow)
    return finalize(compiled, plan, arrays, o, d, t, wid, aux=aux,
                    want_meta=not shadow)


def mega_shadow(compiled, arrays, o, d, sid=None, tmax=None,
                scene_id: int = 0, select=mega_select):
    """Any-hit occlusion query, select only: (N,) bool blocked."""
    plan = get_plan(compiled)
    N = o.shape[0]
    if tmax is None:
        tmax = torch.full((N,), INFINITY, dtype=o.dtype, device=o.device)
    if sid is None:
        sid = torch.full((N,), scene_id, dtype=torch.int32, device=o.device)
    tables = pack_tables(plan, compiled, arrays)
    _t, wid, _a = select(tables, _ray_table(o, d, tmax, sid), True)
    return wid >= 0


def mega_intersect_table(compiled, arrays, table, select=mega_select):
    """Table-native nearest hit: `table` is (8, N) float32 component
    planes [ox,oy,oz,dx,dy,dz,tmax,sid] (dead lanes tmax 0, sid -1).
    Returns the finalized Hit; o, d for finalize are the table's rows."""
    plan = get_plan(compiled)
    tables = pack_tables(plan, compiled, arrays)
    rays = table.detach().clone()
    rays[6] = torch.clamp(rays[6], max=INFINITY)
    t, wid, aux = select(tables, rays, False)
    o = table[0:3].t()
    d = table[3:6].t()
    return finalize(compiled, plan, arrays, o, d, t, wid, aux=aux)


def mega_shadow_table(compiled, arrays, table, select=mega_select):
    """Table-native any-hit occlusion: `table` as in
    mega_intersect_table (row 6 = segment tmax; 0 = dead lane).
    Returns (N,) bool blocked."""
    plan = get_plan(compiled)
    tables = pack_tables(plan, compiled, arrays)
    _t, wid, _a = select(tables, table.detach().contiguous(), True)
    return wid >= 0
