"""Scene compiler: flatten the solid DAG into struct-of-array tables.

This is the central architecture translation (SURVEY.md section 7.1):
the reference dispatches a recursive `rayint` over a polymorphic DAG
(Solid.hs:138-254); we walk the DAG once on the host and emit, per
primitive type, dense parameter arrays plus per-prim metadata:

  - a transform id / baked parameters (Instance merging, Solid.hs:494),
  - the static texture and tag stacks accumulated from Tex/Tag wrappers
    (Tex.hs:54,66 push them during traversal -- here they are constants
    of the scene structure, so we precompute them per prim),
  - shadow-control flags (Tex.hs:81,89),
  - CSG membership: each Difference/Intersection becomes a set of
    *clauses*; a point is inside the CSG solid iff every clause is
    satisfied, where a clause is IN(set) for intersection members /
    difference-A and NOT IN(set) for difference-B (Csg.hs:92-101).

Warp materials (portals) reference other solids as whole scenes; each
distinct frame/target solid is compiled as an additional PackedScene in
the same CompiledScene so the tracer can statically recurse between
scenes (Shader.hs:157-175).

The float arrays live in a separate pytree (see `CompiledScene.arrays`,
and `to_torch` for its tensor form) so they can be differentiation
targets; everything else is static Python structure closed over by the
tracer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import solids as S
from . import xfm as X
from .materials import (AdditiveLayers, Blend, BlendFn, Light, Material,
                        Reflect, Refract, Surface, Texture, Uniform, Warp)

TEX_DEPTH = 4
TAG_DEPTH = 4

# CSG prims whose validity can be checked against at most this many other
# prims are accelerated with the check inlined into BVH leaf tests;
# bigger scans stay on the deferred brute-force path (they are rare:
# difference-B solids and members of wide intersections).
CHEAP_CONSTRAINTS_MAX = 24

# groups at or below this size are intersected by dense brute force (a
# lockstep scan over prim chunks): on a TPU dense VPU work beats
# divergent per-tile tree traversal up to ~1-2k prims (honest chained
# timings, tools/profile_honest.py: 2.8k-sphere lattice 53 ms dense vs
# 14 ms BVH; 1k transformed cones 17 ms dense vs 91 ms BVH -- per-prim
# matrix gathers dominate the transformed BVH leaf tests, so
# transformed groups stay dense regardless of size).
ACCEL_MIN_SIZE = 2048

# primitive type tags (group order is irrelevant; kernels dispatch on this)
PTYPES = ("sphere", "plane", "box", "triangle", "trianglenorm", "disc",
          "cylinder", "cone")


@dataclasses.dataclass
class PrimGroup:
    """A homogeneous batch of primitives of one type.

    `params` maps field name -> (P, ...) float64 array.  If `m_inv` is
    not None the group is traced in object space through the per-prim
    inverse matrices (rayint_instance semantics, Solid.hs:388-403).
    """
    ptype: str
    params: Dict[str, np.ndarray]
    m_fwd: Optional[np.ndarray]
    m_inv: Optional[np.ndarray]
    tex_stack: np.ndarray      # (P, TEX_DEPTH) int32, innermost first, -1 pad
    tag_stack: np.ndarray      # (P, TAG_DEPTH) int32
    local_tex_stack: np.ndarray  # stacks below the enclosing CSG node
    local_tag_stack: np.ndarray
    noshadow: np.ndarray       # (P,) bool
    onlyshadow: np.ndarray
    csg_id: np.ndarray         # (P,) int32, -1 = plain
    csg_clause: np.ndarray     # (P,) int32
    prim_serial: np.ndarray    # (P,) int32 global id (picking / debug)
    # validity class (uniform per group): 'plain' | 'inline' | 'deferred'
    vclass: str = "plain"
    # for 'inline': static constraint list [(positive, [(gi, local_idx)])],
    # shared by every prim of the group (resolved after packing)
    constraints: Optional[list] = None
    # acceleration structure (accel.BvhFlat), attached after packing for
    # bounded non-deferred groups
    accel: Optional[object] = None
    # shared-vertex mesh source (reference Mesh.hs:27-42): when set, the
    # device pytree carries {verts[, norms]} and the per-prim p1..p3
    # (n1..n3) params are DIFFERENTIABLE vertex gathers materialized by
    # group_device_params -- gradients w.r.t. a vertex accumulate over
    # every triangle sharing it.  `params` stays the host-side
    # materialized copy (bounds / accel builds).  Keys: verts (V,3) f64,
    # tri (T,3) i32 [, norms (Vn,3), tri_n (T,3)].
    mesh_src: Optional[Dict[str, np.ndarray]] = None

    @property
    def size(self):
        return int(self.prim_serial.shape[0])


@dataclasses.dataclass
class CsgClause:
    positive: bool
    # prim references after packing: list of (group_index, local_indices)
    members: List[Tuple[int, np.ndarray]]
    member_serials: List[int]


@dataclasses.dataclass
class CsgObject:
    clauses: List[CsgClause]
    useatex: bool
    kind: str  # 'difference' | 'intersection'
    # True for all-positive single-prim-per-clause intersections of
    # volumetric convex prims: traced directly by interval intersection
    # (one candidate per ray per object) instead of per-member surface
    # candidates with membership scans.
    convex: bool = False
    # sibling DNF regions (non-conjunctive CSG, Csg.hs:14-15): each
    # entry is a sibling conjunction's clause list; a candidate of this
    # object is valid only when NOT strictly inside every sibling
    # region (union interior surfaces are not boundary)
    excl: List[List[CsgClause]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PackedScene:
    groups: List[PrimGroup]
    csgs: List[CsgObject]


@dataclasses.dataclass
class WarpInfo:
    material: Warp
    frame_scene: int
    target_scene: int
    lights: Tuple[Light, ...]
    xfm: X.Xfm


@dataclasses.dataclass
class CompiledScene:
    scenes: List[PackedScene]
    textures: List[Texture]
    refract_mats: List[Refract]
    warp_mats: List[WarpInfo]
    # texture id -> set of refract/warp material indices it can evaluate
    tex_refracts: List[frozenset]
    tex_warps: List[frozenset]
    has_reflect: bool
    tag_names: List[Any]
    lights: Tuple[Light, ...]

    def arrays(self, dtype=np.float32):
        """The differentiable / device-side pytree of scene arrays."""
        out = []
        for sc in self.scenes:
            groups = []
            for g in sc.groups:
                if g.mesh_src is not None:
                    # shared-vertex SoA: the per-tri params are gathered
                    # differentiably at trace time (group_device_params)
                    ga = {"verts": np.asarray(g.mesh_src["verts"],
                                              dtype=dtype)}
                    if "norms" in g.mesh_src:
                        ga["norms"] = np.asarray(g.mesh_src["norms"],
                                                 dtype=dtype)
                    groups.append(ga)
                    continue
                ga = {k: np.asarray(v, dtype=dtype) for k, v in g.params.items()}
                if g.m_inv is not None:
                    ga["m_inv"] = np.asarray(g.m_inv, dtype=dtype)
                    ga["m_fwd"] = np.asarray(g.m_fwd, dtype=dtype)
                groups.append(ga)
            out.append(groups)
        lights = {
            "pos": np.asarray([l.pos for l in self.lights], dtype=dtype).reshape(-1, 3),
            "color": np.asarray([l.color for l in self.lights], dtype=dtype).reshape(-1, 3),
            "radius": np.asarray([l.radius for l in self.lights], dtype=dtype).reshape(-1),
        }
        return {"scenes": out, "lights": lights}


def _morton_order(centers: np.ndarray) -> np.ndarray:
    """argsort along a Morton (Z-order) curve of 3D points."""
    lo = centers.min(0)
    span = np.maximum(centers.max(0) - lo, 1e-12)
    q = np.clip(((centers - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def group_device_params(g: PrimGroup, ga):
    """Per-prim device param dict for a group: identity for plain
    groups; for shared-vertex mesh groups, DIFFERENTIABLE gathers of
    p1..p3 (n1..n3) from the verts/norms tables (the in-kernel analog of
    the reference reading Tri index records, Mesh.hs:136-153)."""
    if g.mesh_src is None:
        return ga
    verts = torch.as_tensor(ga["verts"])
    tri = torch.as_tensor(g.mesh_src["tri"], device=verts.device)
    out = {"p1": verts[tri[:, 0]], "p2": verts[tri[:, 1]],
           "p3": verts[tri[:, 2]]}
    if g.ptype == "trianglenorm":
        norms = torch.as_tensor(ga["norms"])
        trin = torch.as_tensor(g.mesh_src["tri_n"], device=norms.device)
        out.update(n1=norms[trin[:, 0]], n2=norms[trin[:, 1]],
                   n3=norms[trin[:, 2]])
    return out


def materialize_scene_params(sc: PackedScene, garrs):
    """Apply group_device_params across a packed scene's device arrays
    (no-op unless the scene has mesh groups)."""
    if not any(g.mesh_src is not None for g in sc.groups):
        return garrs
    return [group_device_params(g, ga) for g, ga in zip(sc.groups, garrs)]


# --- nested-CSG normalization ----------------------------------------------
#
# Reference CSG members are arbitrary SolidItems, including other CSG
# nodes (Csg.hs:14-15): rayint_difference / rayint_intersection compose
# recursively through the polymorphic rayint.  The flat engine instead
# evaluates ONE conjunction of clauses per CSG object, each clause
# IN(prim set) or NOT-IN(prim set).  flatten_csg normalizes a nested
# tree into that form when the boolean expansion stays conjunctive:
#
#   difference(A, B)        -> clauses(A) + negate(clauses(B))
#   intersection([T1..Tn])  -> clauses(T1) + ... + clauses(Tn)
#   wrapper(T) (Tex/Tag/Instance/shadow/Bound around a CSG)
#                           -> wrapper pushed onto every clause item
#   negated union           -> NOT-IN(a|b) == NOT-IN(a) & NOT-IN(b)
#
# Covered: difference-of-intersections, intersections containing
# differences, arbitrarily nested intersections, unions (groups) as
# clause members.  NOT expressible conjunctively (raises): a difference
# or intersection inside the *subtracted* side of a difference
# (NOT-IN(a & !b) = mixed-polarity disjunction), and a union with a CSG
# member inside another CSG (IN(a | (b & c))).

def _contains_csg(node) -> bool:
    if isinstance(node, (S.Difference, S.Intersection)):
        return True
    if isinstance(node, (S.Group, S.BihMarker)):
        return any(_contains_csg(it) for it in node.items)
    if isinstance(node, (S.Instance, S.Tex, S.Tag, S.NoShadow,
                         S.OnlyShadow, S.Bound)):
        return _contains_csg(node.item)
    return False


def _rewrap(wrapper: S.Solid, item: S.Solid) -> S.Solid:
    """Clone a single-child wrapper node around a new child."""
    if isinstance(wrapper, S.Instance):
        return S.Instance(item, wrapper.xfm)
    if isinstance(wrapper, S.Tex):
        return S.Tex(item, wrapper.texture)
    if isinstance(wrapper, S.Tag):
        return S.Tag(item, wrapper.tag)
    if isinstance(wrapper, S.NoShadow):
        return S.NoShadow(item)
    if isinstance(wrapper, S.OnlyShadow):
        return S.OnlyShadow(item)
    if isinstance(wrapper, S.Bound):
        return S.Bound(wrapper.bound, item)
    raise TypeError(type(wrapper))


# guards the DNF product blow-up (each disjunct duplicates its shared
# members' prim records)
DNF_MAX_DISJUNCTS = 16


def flatten_csg_dnf(node: S.Solid, neg: bool = False):
    """Normalize an arbitrarily nested CSG tree to disjunctive normal
    form: returns [conjunction, ...] where each conjunction is
    [(positive, [solid items])] and point membership = OR over
    conjunctions of (AND over clauses of (inside any item) == positive).

    Conjunctive trees (the common case) yield exactly one conjunction;
    the non-conjunctive forms the reference composes recursively
    (Csg.hs:14-15, 33-101) -- A-(B&C), A-(B-C), unions containing CSG
    as members -- expand by De Morgan:

      NOT-IN(a & b)  = NOT-IN(a) | NOT-IN(b)
      NOT-IN(a & !b) = NOT-IN(a) | IN(b)
      IN(a | (b&c))  = IN(a) | (IN(b) & IN(c))

    Each conjunction's clause 0 is positive when one exists (the
    leftmost positive-descent leaf), which the useatex retexture path
    relies on in the single-conjunction case."""
    def product(dnfs):
        out = [[]]
        for dnf in dnfs:
            out = [acc + conj for acc in out for conj in dnf]
            if len(out) > DNF_MAX_DISJUNCTS:
                raise NotImplementedError(
                    f"CSG DNF expansion exceeds {DNF_MAX_DISJUNCTS} "
                    "disjuncts; restructure the scene")
        return out

    if isinstance(node, S.Difference):
        if neg:
            # NOT-IN(a & !b) = NOT-IN(a) | IN(b)
            return (flatten_csg_dnf(node.a, neg=True)
                    + flatten_csg_dnf(node.b, neg=False))
        return product([flatten_csg_dnf(node.a),
                        flatten_csg_dnf(node.b, neg=True)])
    if isinstance(node, S.Intersection):
        if neg:
            # NOT-IN(a & b) = NOT-IN(a) | NOT-IN(b)
            out = []
            for it in node.items:
                out.extend(flatten_csg_dnf(it, neg=True))
            return out
        return product([flatten_csg_dnf(it) for it in node.items])
    if isinstance(node, (S.Instance, S.Tex, S.Tag, S.NoShadow,
                         S.OnlyShadow, S.Bound)) and _contains_csg(node):
        return [[(pos, [_rewrap(node, it) for it in items])
                 for pos, items in conj]
                for conj in flatten_csg_dnf(node.item, neg)]
    if isinstance(node, (S.Group, S.BihMarker)) and _contains_csg(node):
        if not neg:
            # IN(a | (b & c)) = IN(a) | (IN(b) & IN(c)); all plain
            # (CSG-free) items stay ONE disjunct's single clause, since
            # a clause set is already a disjunction over its items
            plain = [it for it in node.items if not _contains_csg(it)]
            out = [[(True, plain)]] if plain else []
            for it in node.items:
                if _contains_csg(it):
                    out.extend(flatten_csg_dnf(it, neg=False))
            return out
        # NOT-IN(a | b) = NOT-IN(a) & NOT-IN(b)
        return product([flatten_csg_dnf(it, neg=True)
                        for it in node.items])
    return [[(not neg, [node])]]


def flatten_csg(node: S.Solid, neg: bool = False):
    """Single-conjunction flattening (see flatten_csg_dnf); raises when
    the tree is not conjunctive."""
    dnf = flatten_csg_dnf(node, neg)
    if len(dnf) != 1:
        raise NotImplementedError(
            "CSG tree is not conjunctive; use flatten_csg_dnf")
    return dnf[0]


@dataclasses.dataclass
class _Ctx:
    xfm: X.Xfm
    texs: Tuple[int, ...] = ()
    tags: Tuple[int, ...] = ()
    noshadow: bool = False
    onlyshadow: bool = False
    csg: Optional[Tuple[int, int]] = None  # (csg_id, clause_id)
    csg_outer_texs: int = 0   # length of tex stack outside the CSG node
    csg_outer_tags: int = 0


class _PrimRecord:
    __slots__ = ("serial", "ptype", "params", "fwd", "inv", "texs", "tags",
                 "ltexs", "ltags", "noshadow", "onlyshadow", "csg_id",
                 "clause_id")

    def __init__(self, serial, ptype, params, fwd, inv, ctx: _Ctx):
        self.serial = serial
        self.ptype = ptype
        self.params = params
        self.fwd = fwd
        self.inv = inv
        self.texs = ctx.texs
        self.tags = ctx.tags
        if ctx.csg is not None:
            self.ltexs = ctx.texs[:max(0, len(ctx.texs) - ctx.csg_outer_texs)]
            self.ltags = ctx.tags[:max(0, len(ctx.tags) - ctx.csg_outer_tags)]
            self.csg_id, self.clause_id = ctx.csg
        else:
            self.ltexs = ()
            self.ltags = ()
            self.csg_id, self.clause_id = -1, -1
        self.noshadow = ctx.noshadow
        self.onlyshadow = ctx.onlyshadow


@dataclasses.dataclass
class _CsgBuild:
    """One conjunction during compilation: clause member serial lists +
    signs.  `excl` lists SIBLING conjunctions of the same DNF (pairs of
    (clause_serials, signs) referencing the siblings' live lists): a
    candidate surface point of this conjunction is only on the union's
    boundary when it is NOT interior to any sibling region."""
    kind: str
    useatex: bool
    clause_serials: List[List[int]]
    signs: List[bool]
    excl: List[Tuple[List[List[int]], List[bool]]] = dataclasses.field(
        default_factory=list)


class _SceneBuild:
    def __init__(self):
        self.prims: List[_PrimRecord] = []
        self.csgs: List[_CsgBuild] = []
        self.convex_cids: set = set()
        # pre-built shared-vertex mesh groups (bulk path, _walk_mesh)
        self.mesh_groups: List[PrimGroup] = []


class Compiler:
    def __init__(self):
        self.scenes: List[_SceneBuild] = []
        self._scene_ids: Dict[int, int] = {}
        self.textures: List[Texture] = []
        self._tex_ids: Dict[Any, int] = {}
        self.tags: List[Any] = []
        self._tag_ids: Dict[Any, int] = {}
        self.refract_mats: List[Refract] = []
        self.warp_mats: List[WarpInfo] = []
        self._warp_ids: Dict[int, int] = {}
        self.has_reflect = False
        self._serial = 0

    # -- interning --------------------------------------------------------

    def tex_id(self, t: Texture) -> int:
        if t in self._tex_ids:
            return self._tex_ids[t]
        tid = len(self.textures)
        self.textures.append(t)
        self._tex_ids[t] = tid
        self._scan_texture(t)
        return tid

    def tag_id(self, t) -> int:
        if t in self._tag_ids:
            return self._tag_ids[t]
        tid = len(self.tags)
        self.tags.append(t)
        self._tag_ids[t] = tid
        return tid

    def _scan_texture(self, t: Texture):
        if isinstance(t, Uniform):
            self._scan_material(t.material)
        elif isinstance(t, BlendFn):
            self._scan_material(t.m1)
            self._scan_material(t.m2)
        else:
            raise TypeError(f"unknown texture {type(t)}")

    def _scan_material(self, m: Material):
        if isinstance(m, Surface):
            return
        if isinstance(m, Reflect):
            self.has_reflect = True
            return
        if isinstance(m, Refract):
            if m not in self.refract_mats:
                self.refract_mats.append(m)
            return
        if isinstance(m, Warp):
            if id(m) not in self._warp_ids:
                frame_id = self.compile_scene_solid(m.frame)
                target_id = (0 if m.scene is None
                             else self.compile_scene_solid(m.scene))
                self._warp_ids[id(m)] = len(self.warp_mats)
                self.warp_mats.append(WarpInfo(m, frame_id, target_id,
                                               tuple(m.lights), m.xfm))
            return
        if isinstance(m, AdditiveLayers):
            for sub in m.layers:
                self._scan_material(sub)
            return
        if isinstance(m, Blend):
            self._scan_material(m.m1)
            self._scan_material(m.m2)
            return
        raise TypeError(f"unknown material {type(m)}")

    # -- scene walking ----------------------------------------------------

    def compile_scene_solid(self, solid: S.Solid) -> int:
        key = id(solid)
        if key in self._scene_ids:
            return self._scene_ids[key]
        sid = len(self.scenes)
        self._scene_ids[key] = sid
        build = _SceneBuild()
        self.scenes.append(build)
        self._walk(build, solid, _Ctx(xfm=X.IDENT))
        return sid

    def _emit(self, build, ptype, params, ctx: _Ctx, fwd=None, inv=None):
        rec = _PrimRecord(self._serial, ptype, params, fwd, inv, ctx)
        self._serial += 1
        build.prims.append(rec)
        if ctx.csg is not None:
            cid, clause = ctx.csg
            build.csgs[cid].clause_serials[clause].append(rec.serial)
        return rec

    def _walk(self, build: _SceneBuild, node: S.Solid, ctx: _Ctx):
        xf = ctx.xfm
        ident = xf.is_identity()

        if isinstance(node, S.Void):
            return
        if isinstance(node, S.Sphere):
            if ident:
                self._emit(build, "sphere",
                           {"center": node.center, "radius": node.radius}, ctx)
            else:
                s = xf.uniform_scale()
                if s is not None:
                    self._emit(build, "sphere",
                               {"center": xf.point(node.center),
                                "radius": node.radius * s}, ctx)
                else:
                    self._emit(build, "sphere",
                               {"center": node.center, "radius": node.radius},
                               ctx, fwd=xf.fwd, inv=xf.inv)
            return
        if isinstance(node, S.Plane):
            if ident:
                self._emit(build, "plane",
                           {"norm": node.norm, "offset": node.offset}, ctx)
            else:
                nw = xf.inv_normal(node.norm)
                nw = nw / np.linalg.norm(nw)
                p0 = xf.point(np.asarray(node.norm) * node.offset)
                self._emit(build, "plane",
                           {"norm": nw, "offset": float(nw @ p0)}, ctx)
            return
        if isinstance(node, S.Box):
            if ident:
                self._emit(build, "box",
                           {"bmin": node.bmin, "bmax": node.bmax}, ctx)
            elif xf.is_axis_aligned():
                c1, c2 = xf.point(node.bmin), xf.point(node.bmax)
                self._emit(build, "box",
                           {"bmin": np.minimum(c1, c2),
                            "bmax": np.maximum(c1, c2)}, ctx)
            else:
                self._emit(build, "box",
                           {"bmin": node.bmin, "bmax": node.bmax},
                           ctx, fwd=xf.fwd, inv=xf.inv)
            return
        if isinstance(node, S.Triangle):
            # always baked (reference transform_triangle, Triangle.hs:164-168)
            self._emit(build, "triangle",
                       {"p1": xf.point(node.p1), "p2": xf.point(node.p2),
                        "p3": xf.point(node.p3)}, ctx)
            return
        if isinstance(node, S.TriangleNorm):
            def nrm(n):
                v = xf.vector(n)  # reference uses forward xfm_vec
                return v / np.linalg.norm(v)
            self._emit(build, "trianglenorm",
                       {"p1": xf.point(node.p1), "p2": xf.point(node.p2),
                        "p3": xf.point(node.p3),
                        "n1": nrm(node.n1), "n2": nrm(node.n2),
                        "n3": nrm(node.n3)}, ctx)
            return
        if isinstance(node, S.Disc):
            if ident:
                self._emit(build, "disc",
                           {"pos": node.pos, "norm": node.norm,
                            "rsqr": node.radius_sqr}, ctx)
            else:
                s = xf.uniform_scale()
                if s is not None:
                    nw = xf.inv_normal(node.norm)
                    nw = nw / np.linalg.norm(nw)
                    self._emit(build, "disc",
                               {"pos": xf.point(node.pos), "norm": nw,
                                "rsqr": node.radius_sqr * s * s}, ctx)
                else:
                    self._emit(build, "disc",
                               {"pos": node.pos, "norm": node.norm,
                                "rsqr": node.radius_sqr},
                               ctx, fwd=xf.fwd, inv=xf.inv)
            return
        if isinstance(node, S.CylinderZ):
            kw = {} if ident else {"fwd": xf.fwd, "inv": xf.inv}
            self._emit(build, "cylinder",
                       {"radius": node.radius, "h1": node.h1, "h2": node.h2},
                       ctx, **kw)
            return
        if isinstance(node, S.ConeZ):
            kw = {} if ident else {"fwd": xf.fwd, "inv": xf.inv}
            self._emit(build, "cone",
                       {"radius": node.radius, "clip1": node.clip1,
                        "clip2": node.clip2, "height": node.height},
                       ctx, **kw)
            return

        if isinstance(node, (S.Group, S.BihMarker)):
            for it in node.items:
                self._walk(build, it, ctx)
            return
        if isinstance(node, S.Instance):
            self._walk(build, node.item,
                       dataclasses.replace(ctx, xfm=X.xfm_mult(xf, node.xfm)))
            return
        if isinstance(node, S.Tex):
            tid = self.tex_id(node.texture)
            self._walk(build, node.item,
                       dataclasses.replace(ctx, texs=(tid,) + ctx.texs))
            return
        if isinstance(node, S.Tag):
            tid = self.tag_id(node.tag)
            self._walk(build, node.item,
                       dataclasses.replace(ctx, tags=(tid,) + ctx.tags))
            return
        if isinstance(node, S.NoShadow):
            self._walk(build, node.item,
                       dataclasses.replace(ctx, noshadow=True))
            return
        if isinstance(node, S.OnlyShadow):
            self._walk(build, node.item,
                       dataclasses.replace(ctx, onlyshadow=True))
            return
        if isinstance(node, S.Bound):
            # the global BVH subsumes manual bounds (Bound.hs:69-74)
            self._walk(build, node.item, ctx)
            return
        if isinstance(node, S.Mesh):
            self._walk_mesh(build, node, ctx)
            return
        if isinstance(node, (S.Difference, S.Intersection)):
            if ctx.csg is not None:
                # flatten_csg raises before descending into these; this
                # is only reachable through a path it let through, which
                # would mean a normalization bug
                raise NotImplementedError(
                    "CSG reached inside another CSG's clause member")
            dnf = flatten_csg_dnf(node)
            kind = ("difference" if isinstance(node, S.Difference)
                    else "intersection")
            useatex = isinstance(node, S.Difference) and node.useatex
            # useatex retexture works per DISJUNCT: every product
            # conjunction keeps its positive A clause first, so a
            # negative-clause surface finds its containing A member in
            # its own conjunction (Csg.hs:39-41)
            base = dataclasses.replace(ctx, csg_outer_texs=len(ctx.texs),
                                       csg_outer_tags=len(ctx.tags))
            cids = []
            for clauses in dnf:
                cid = len(build.csgs)
                cids.append(cid)
                build.csgs.append(_CsgBuild(
                    kind, useatex, [[] for _ in clauses],
                    [p for p, _ in clauses]))
                for i, (_pos, items) in enumerate(clauses):
                    for it in items:
                        self._walk(build, it,
                                   dataclasses.replace(base, csg=(cid, i)))
            if len(cids) > 1:
                # sibling exclusion: reference the siblings' LIVE serial
                # lists (filled by the walks above)
                for cd in cids:
                    build.csgs[cd].excl = [
                        (build.csgs[ce].clause_serials,
                         build.csgs[ce].signs)
                        for ce in cids if ce != cd]
            return
        raise TypeError(f"unknown solid {type(node)}")

    def _walk_mesh(self, build, node: S.Mesh, ctx: _Ctx):
        """Shared-vertex mesh: verts/norms stay SoA on device; triangles
        reference them by index (reference Mesh.hs:27-42) and the
        per-tri params are differentiable gathers at trace time.  The
        whole build is vectorized numpy -- no per-triangle host loop.
        Per-tri textures/tags push onto the surrounding stacks
        (Mesh.hs:148-153); mesh triangles do not cast shadows in the
        reference (Mesh.hs:210)."""
        if ctx.csg is not None:
            # inside a CSG clause: fall back to baked per-tri records
            # (the reference's mesh has inside=False, Mesh.hs:211, so
            # this is exotic; correctness over speed here)
            return self._walk_mesh_exploded(build, node, ctx)
        xf = ctx.xfm
        tris = np.asarray(node.tris, np.int32).reshape(-1, 8)
        T = tris.shape[0]
        if T == 0:
            return
        verts = np.asarray(node.verts, np.float64)
        norms = (None if node.norms is None
                 else np.asarray(node.norms, np.float64))
        if not xf.is_identity():
            verts = verts @ xf.fwd[:, :3].T + xf.fwd[:, 3]
            if norms is not None:
                # reference transforms mesh normals by the forward
                # matrix like trianglenorm (Triangle.hs:170-177)
                norms = norms @ xf.fwd[:, :3].T
                norms = norms / np.linalg.norm(norms, axis=-1,
                                               keepdims=True)

        tex_ids = np.asarray([self.tex_id(t) for t in node.textures],
                             np.int32).reshape(-1)
        tag_ids = np.asarray([self.tag_id(t) for t in node.tags],
                             np.int32).reshape(-1)

        def stacks(table, per_tri, ctx_stack, depth):
            base = np.full((depth,), -1, np.int32)
            cs = np.asarray(ctx_stack[:depth], np.int32)
            base[:len(cs)] = cs
            out = np.tile(base, (T, 1))
            has = (per_tri >= 0) & (per_tri < len(table))
            if has.any():
                shifted = np.concatenate(
                    [np.zeros((T, 1), np.int32), out[:, :-1]], axis=1)
                shifted[:, 0] = np.where(
                    has, table[np.clip(per_tri, 0, max(len(table) - 1, 0))],
                    -1)
                out = np.where(has[:, None], shifted, out)
            return out

        tex_stack = stacks(tex_ids, tris[:, 6], ctx.texs, TEX_DEPTH)
        tag_stack = stacks(tag_ids, tris[:, 7], ctx.tags, TAG_DEPTH)
        serial0 = self._serial
        self._serial += T
        serials = serial0 + np.arange(T, dtype=np.int32)
        has_n = (tris[:, 3] >= 0) if norms is not None \
            else np.zeros(T, bool)
        for mask, ptype in ((~has_n, "triangle"), (has_n, "trianglenorm")):
            if not mask.any():
                continue
            tsel = tris[mask]
            Tm = tsel.shape[0]
            # Morton-order the triangles so BVH leaves / dense lane
            # blocks are spatially compact (same as _morton_sort)
            centers = (verts[tsel[:, 0]] + verts[tsel[:, 1]]
                       + verts[tsel[:, 2]]) / 3.0
            order = _morton_order(centers)
            tsel = tsel[order]
            src = {"verts": verts, "tri": tsel[:, :3].copy()}
            params = {"p1": verts[tsel[:, 0]], "p2": verts[tsel[:, 1]],
                      "p3": verts[tsel[:, 2]]}
            if ptype == "trianglenorm":
                src["norms"] = norms
                src["tri_n"] = tsel[:, 3:6].copy()
                params.update(n1=norms[tsel[:, 3]], n2=norms[tsel[:, 4]],
                              n3=norms[tsel[:, 5]])
            empty = np.full((Tm, TEX_DEPTH), -1, np.int32)
            g = PrimGroup(
                ptype=ptype, params=params, m_fwd=None, m_inv=None,
                tex_stack=tex_stack[mask][order],
                tag_stack=tag_stack[mask][order][:, :TAG_DEPTH],
                local_tex_stack=empty,
                local_tag_stack=np.full((Tm, TAG_DEPTH), -1, np.int32),
                # reference-faithful default: meshes never occlude
                # (Mesh.hs:210); mesh(..., cast_shadows=True) opts in
                # (still honoring an enclosing NoShadow wrapper)
                noshadow=np.full(Tm, ctx.noshadow
                                 or not node.cast_shadows, bool),
                onlyshadow=np.full(Tm, ctx.onlyshadow, bool),
                csg_id=np.full(Tm, -1, np.int32),
                csg_clause=np.full(Tm, -1, np.int32),
                prim_serial=serials[mask][order],
                vclass="plain", mesh_src=src)
            build.mesh_groups.append(g)

    def _walk_mesh_exploded(self, build, node: S.Mesh, ctx: _Ctx):
        """Per-tri baked records (CSG-context fallback only)."""
        xf = ctx.xfm
        tex_ids = [self.tex_id(t) for t in node.textures]
        tag_ids = [self.tag_id(t) for t in node.tags]
        ctx = dataclasses.replace(ctx, noshadow=True)
        for row in node.tris:
            v0, v1, v2, n0, n1, n2, ti, gi = (int(v) for v in row)
            c = ctx
            if ti >= 0:
                c = dataclasses.replace(c, texs=(tex_ids[ti],) + c.texs)
            if gi >= 0:
                c = dataclasses.replace(c, tags=(tag_ids[gi],) + c.tags)
            if n0 >= 0:
                def nrm(n):
                    v = xf.vector(node.norms[n])
                    return v / np.linalg.norm(v)
                self._emit(build, "trianglenorm",
                           {"p1": xf.point(node.verts[v0]),
                            "p2": xf.point(node.verts[v1]),
                            "p3": xf.point(node.verts[v2]),
                            "n1": nrm(n0), "n2": nrm(n1), "n3": nrm(n2)}, c)
            else:
                self._emit(build, "triangle",
                           {"p1": xf.point(node.verts[v0]),
                            "p2": xf.point(node.verts[v1]),
                            "p3": xf.point(node.verts[v2])}, c)

    # -- packing ----------------------------------------------------------

    # -- compile-time CSG simplification ----------------------------------

    @staticmethod
    def _record_bounds(rec: _PrimRecord):
        """Host-side world AABB of one prim record, or None if unbounded."""
        p = {k: np.asarray(v, dtype=np.float64) for k, v in rec.params.items()}
        t = rec.ptype
        if t == "sphere":
            bmin = p["center"] - p["radius"]
            bmax = p["center"] + p["radius"]
        elif t == "box":
            bmin, bmax = p["bmin"], p["bmax"]
        elif t in ("triangle", "trianglenorm"):
            pts = np.stack([p["p1"], p["p2"], p["p3"]])
            bmin, bmax = pts.min(0), pts.max(0)
        elif t == "disc":
            r = np.sqrt(p["rsqr"])
            bmin, bmax = p["pos"] - r, p["pos"] + r
        elif t == "cylinder":
            r = p["radius"]
            bmin = np.array([-r, -r, p["h1"]]).reshape(3)
            bmax = np.array([r, r, p["h2"]]).reshape(3)
        elif t == "cone":
            r = p["radius"]
            bmin = np.array([-r, -r, p["clip1"]]).reshape(3)
            bmax = np.array([r, r, p["clip2"]]).reshape(3)
        else:
            return None  # plane: unbounded
        if rec.fwd is not None:
            fwd = np.asarray(rec.fwd, dtype=np.float64)
            corners = np.array([[bmin[0] if i & 1 else bmax[0],
                                 bmin[1] if i & 2 else bmax[1],
                                 bmin[2] if i & 4 else bmax[2]]
                                for i in range(8)])
            w = corners @ fwd[:, :3].T + fwd[:, 3]
            bmin, bmax = w.min(0), w.max(0)
        return np.asarray(bmin).reshape(3), np.asarray(bmax).reshape(3)

    @staticmethod
    def _record_contains(rec: _PrimRecord, pts: np.ndarray, margin=1e-6):
        """True if every point is strictly inside the (convex) solid;
        None when the type has no volume or is unsupported."""
        if rec.ptype in ("triangle", "trianglenorm", "disc", "plane"):
            if rec.ptype != "plane":
                return None
        pts = np.asarray(pts, dtype=np.float64)
        if rec.inv is not None:
            inv = np.asarray(rec.inv, dtype=np.float64)
            pts = pts @ inv[:, :3].T + inv[:, 3]
        p = {k: np.asarray(v, dtype=np.float64) for k, v in rec.params.items()}
        t = rec.ptype
        if t == "sphere":
            d = np.linalg.norm(pts - p["center"], axis=-1)
            return bool(np.all(d < p["radius"] - margin))
        if t == "box":
            return bool(np.all((pts > p["bmin"] + margin)
                               & (pts < p["bmax"] - margin)))
        if t == "plane":
            return bool(np.all(pts @ p["norm"] < p["offset"] - margin))
        if t == "cylinder":
            r2 = (p["radius"] - margin) ** 2
            ok = (pts[:, 2] > p["h1"] + margin) & (pts[:, 2] < p["h2"] - margin)
            return bool(np.all(ok & (pts[:, 0]**2 + pts[:, 1]**2 < r2)))
        if t == "cone":
            rz = p["radius"] * (1.0 - (pts[:, 2] - p["clip1"]) / p["height"])
            ok = (pts[:, 2] > p["clip1"] + margin) & (pts[:, 2] < p["clip2"] - margin)
            return bool(np.all(ok & (pts[:, 0]**2 + pts[:, 1]**2
                                     < (rz - margin)**2)))
        return None

    def _simplify_csg(self, build: _SceneBuild):
        """Static difference simplification: an A member wholly inside
        the subtracted set can never contribute a valid surface (its
        entire boundary fails `not inside B`, Csg.hs:38) -- drop it.  An
        A member whose bounds are disjoint from B's bounds always passes
        the check -- relax it to a plain prim.  This is what restores
        BVH culling for subtractions like TestScene's lattice-minus-
        sphere (TestScene.hs:191-193)."""
        by_serial = {r.serial: r for r in build.prims}
        dropped = set()
        for cid, cb in enumerate(build.csgs):
            kind, clause_serials = cb.kind, cb.clause_serials
            if kind != "difference" or len(clause_serials) != 2:
                continue
            if cb.excl:
                # DNF siblings reference these serial lists; member
                # surfaces also serve the union boundary -- skip
                continue
            b_recs = [by_serial[s] for s in clause_serials[1]]
            b_bounds = [self._record_bounds(r) for r in b_recs]
            for s0 in list(clause_serials[0]):
                rec = by_serial[s0]
                bb = self._record_bounds(rec)
                if bb is None:
                    continue
                corners = np.array([[bb[0][0] if i & 1 else bb[1][0],
                                     bb[0][1] if i & 2 else bb[1][1],
                                     bb[0][2] if i & 4 else bb[1][2]]
                                    for i in range(8)])
                inside_some = any(self._record_contains(br, corners) is True
                                  for br in b_recs)
                if inside_some:
                    dropped.add(s0)
                    continue
                disjoint_all = all(
                    bbb is not None
                    and (np.any(bb[1] < bbb[0]) or np.any(bb[0] > bbb[1]))
                    for bbb in b_bounds)
                if disjoint_all:
                    rec.csg_id = -1
                    rec.clause_id = -1
            if dropped:
                clause_serials[0] = [s for s in clause_serials[0]
                                     if s not in dropped]
        if dropped:
            build.prims = [r for r in build.prims if r.serial not in dropped]

    # prim types whose hits2 entry/exit pair is the exact parameter
    # interval of a convex volume (so CSG intersections of them reduce
    # to interval max/min -- the convex fast path)
    _VOLUMETRIC = frozenset({"sphere", "plane", "box", "cylinder", "cone"})

    def _convex_cids(self, build: _SceneBuild):
        """CSG ids eligible for the direct interval-intersection path:
        every clause positive with exactly one member, every member a
        volumetric convex prim, uniform shadow flags.  Equivalent to the
        reference's rayint_intersection advance loop (Csg.hs:68-90) for
        convex members, evaluated in closed form."""
        by_serial = {r.serial: r for r in build.prims}
        out = set()
        for cid, cb in enumerate(build.csgs):
            kind, clause_serials, signs = (cb.kind, cb.clause_serials,
                                           cb.signs)
            if kind != "intersection" or not clause_serials or cb.excl:
                continue
            if not all(signs):
                continue
            if any(len(s) != 1 for s in clause_serials):
                continue
            recs = [by_serial[s[0]] for s in clause_serials]
            if any(r.ptype not in self._VOLUMETRIC for r in recs):
                continue
            if len({(r.noshadow, r.onlyshadow) for r in recs}) > 1:
                continue
            out.add(cid)
        return out

    def _morton_sort(self, recs):
        """Order a large group's prims along a Morton (Z-order) curve of
        their world bbox centers so that consecutive 128-prim lane
        blocks are spatially compact -- the per-block AABB rejection in
        the Pallas dense kernel and the BVH leaf order both feed off
        this locality.  Pure reordering: semantics are order-free."""
        if len(recs) <= 128:
            return recs
        bounds = [self._record_bounds(r) for r in recs]
        if any(b is None for b in bounds):
            return recs
        centers = np.stack([(b[0] + b[1]) * 0.5 for b in bounds])
        order = _morton_order(centers)
        return [recs[i] for i in order]

    def _vclass_key(self, build: _SceneBuild, rec: _PrimRecord):
        """Validity class for acceleration grouping: plain prims and
        positive-clause CSG prims with small other-clause scans are BVH
        eligible; everything else is brute-forced (deferred)."""
        if rec.csg_id < 0:
            return ("plain", None)
        if rec.csg_id in build.convex_cids:
            return ("convex", rec.csg_id)
        cb = build.csgs[rec.csg_id]
        if cb.excl:
            # sibling-exclusion scans only run on the deferred path
            return ("deferred", None)
        own = rec.clause_id
        other_total = sum(len(s) for ci, s in
                          enumerate(cb.clause_serials) if ci != own)
        if cb.signs[own] and other_total <= CHEAP_CONSTRAINTS_MAX:
            return ("inline", (rec.csg_id, own))
        return ("deferred", None)

    def pack(self, lights: Sequence[Light],
             accel_min_size: int = ACCEL_MIN_SIZE) -> CompiledScene:
        packed_scenes = []
        serial_loc: Dict[int, Tuple[int, int, int]] = {}
        group_builds = []
        for si, build in enumerate(self.scenes):
            self._simplify_csg(build)
            build.convex_cids = self._convex_cids(build)
            groups: Dict[tuple, List[_PrimRecord]] = {}
            for rec in build.prims:
                vkey = self._vclass_key(build, rec)
                key = (rec.ptype, rec.inv is not None, vkey)
                groups.setdefault(key, []).append(rec)
            glist = []
            for (ptype, has_m, vkey), recs in sorted(
                    groups.items(), key=lambda kv: repr(kv[0])):
                recs = self._morton_sort(recs)
                gi = len(glist)
                P = len(recs)
                pnames = recs[0].params.keys()
                params = {}
                for name in pnames:
                    params[name] = np.stack(
                        [np.asarray(r.params[name], dtype=np.float64)
                         for r in recs])
                def stack_ids(vals, depth):
                    out = np.full((P, depth), -1, dtype=np.int32)
                    for i, v in enumerate(vals):
                        v = v[:depth]
                        out[i, :len(v)] = v
                    return out
                g = PrimGroup(
                    ptype=ptype,
                    params=params,
                    m_fwd=(np.stack([r.fwd for r in recs]) if has_m else None),
                    m_inv=(np.stack([r.inv for r in recs]) if has_m else None),
                    tex_stack=stack_ids([r.texs for r in recs], TEX_DEPTH),
                    tag_stack=stack_ids([r.tags for r in recs], TAG_DEPTH),
                    local_tex_stack=stack_ids([r.ltexs for r in recs], TEX_DEPTH),
                    local_tag_stack=stack_ids([r.ltags for r in recs], TAG_DEPTH),
                    noshadow=np.array([r.noshadow for r in recs], dtype=bool),
                    onlyshadow=np.array([r.onlyshadow for r in recs], dtype=bool),
                    csg_id=np.array([r.csg_id for r in recs], dtype=np.int32),
                    csg_clause=np.array([r.clause_id for r in recs], dtype=np.int32),
                    prim_serial=np.array([r.serial for r in recs], dtype=np.int32),
                    vclass=vkey[0],
                )
                glist.append(g)
                group_builds.append((build, g, recs, vkey))
                for li, r in enumerate(recs):
                    serial_loc[r.serial] = (si, gi, li)
            for g in build.mesh_groups:
                glist.append(g)
                group_builds.append((build, g, [], ("plain", None)))
            csgs = []

            def pack_clauses(clause_serials, signs):
                out = []
                for serials, positive in zip(clause_serials, signs):
                    bygroup: Dict[int, List[int]] = {}
                    for s0 in serials:
                        _, gi, li = serial_loc[s0]
                        bygroup.setdefault(gi, []).append(li)
                    members = [(gi, np.asarray(lis, dtype=np.int32))
                               for gi, lis in sorted(bygroup.items())]
                    out.append(CsgClause(positive, members, list(serials)))
                return out

            for cb in build.csgs:
                csgs.append(CsgObject(
                    pack_clauses(cb.clause_serials, cb.signs),
                    cb.useatex, cb.kind,
                    convex=(len(csgs) in build.convex_cids),
                    excl=[pack_clauses(cs, sg) for cs, sg in cb.excl]))
            packed_scenes.append(PackedScene(glist, csgs))

        # resolve inline CSG constraints now that every prim has a home,
        # and attach per-group BVHs for bounded non-deferred groups
        from . import accel as _accel
        for build, g, recs, vkey in group_builds:
            if vkey[0] == "inline":
                cid, own = vkey[1]
                cb = build.csgs[cid]
                clause_serials, signs = cb.clause_serials, cb.signs
                cons = []
                for ci, serials in enumerate(clause_serials):
                    if ci == own:
                        continue
                    bygroup: Dict[int, List[int]] = {}
                    for s0 in serials:
                        _, gi2, li2 = serial_loc[s0]
                        bygroup.setdefault(gi2, []).append(li2)
                    members = [(gi2, np.asarray(lis, dtype=np.int32))
                               for gi2, lis in sorted(bygroup.items())]
                    cons.append((signs[ci], members))
                g.constraints = cons
            if (g.ptype != "plane" and g.vclass not in ("deferred", "convex")
                    and g.m_inv is None and g.size > accel_min_size):
                bmin, bmax = _accel.group_bounds(g)
                g.accel = _accel.build_bvh(bmin, bmax)

        # per-texture reachable refract/warp material indices (for masking
        # secondary traces)
        tex_refracts, tex_warps = [], []
        for t in self.textures:
            refr, warp = set(), set()
            mats = ([t.material] if isinstance(t, Uniform) else [t.m1, t.m2])
            def visit(m):
                if isinstance(m, Refract):
                    refr.add(self.refract_mats.index(m))
                elif isinstance(m, Warp):
                    warp.add(self._warp_ids[id(m)])
                elif isinstance(m, AdditiveLayers):
                    for sub in m.layers:
                        visit(sub)
                elif isinstance(m, Blend):
                    visit(m.m1)
                    visit(m.m2)
            for m in mats:
                visit(m)
            tex_refracts.append(frozenset(refr))
            tex_warps.append(frozenset(warp))

        return CompiledScene(
            scenes=packed_scenes,
            textures=list(self.textures),
            refract_mats=list(self.refract_mats),
            warp_mats=list(self.warp_mats),
            tex_refracts=tex_refracts,
            tex_warps=tex_warps,
            has_reflect=self.has_reflect,
            tag_names=list(self.tags),
            lights=tuple(lights),
        )


def compile_scene(solid: S.Solid, lights: Sequence[Light] = (),
                  accel_min_size: int = ACCEL_MIN_SIZE) -> CompiledScene:
    """Compile a solid DAG (+ lights) into flattened SoA tables.

    Groups larger than accel_min_size get a BVH; smaller groups are
    intersected by a dense prim-chunk scan (faster on TPU)."""
    c = Compiler()
    root = c.compile_scene_solid(solid)
    assert root == 0
    return c.pack(lights, accel_min_size=accel_min_size)


def to_torch(arrays, device):
    """The scene-array pytree of CompiledScene.arrays() -- from either
    package -- as the port's nested dict of tensors on `device`:
    {"scenes": [[{field: tensor}]], "lights": {field: tensor}}.  This
    is how scene parameters cross between the packages; leaves keep
    their dtype (float32 from arrays())."""
    def leaf(v):
        if torch.is_tensor(v):
            return v.to(device)
        return torch.tensor(np.asarray(v), device=device)
    return {
        "scenes": [[{k: leaf(v) for k, v in ga.items()} for ga in sc]
                   for sc in arrays["scenes"]],
        "lights": {k: leaf(v) for k, v in arrays["lights"].items()},
    }
