"""Host-side scene graph: constructors mirroring the reference Solid API.

The reference's `Solid` typeclass (GlomeTrace/Data/Glome/Solid.hs:138-254)
is a recursive polymorphic DAG traversed per ray.  Here the same
constructor surface builds a lightweight Python DAG that the compiler
(compile.py) flattens into struct-of-array tables for the vectorized
TPU tracer; none of these classes are touched at trace time.

Constructor parity map (reference -> here):
  sphere       Sphere.hs:15          cone/cylinder  Cone.hs:40-67
  plane        Plane.hs:17-25        disc           Cone.hs:29-31
  box          Box.hs:12             triangle(s)    Triangle.hs:18-42
  group        Solid.hs:293          transform      Solid.hs:235
  tex/tag      Tex.hs:33-39          noshadow/onlyshadow Tex.hs:43-48
  difference   Csg.hs:26-30          intersection   Csg.hs:64-65
  bih          Bih.hs:309            bound_object   Bound.hs
  mesh         Mesh.hs:50            nothing (Void) Solid.hs:351
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from .config import DELTA
from . import xfm as X
from .materials import Texture


class Solid:
    """Base class for scene-graph nodes."""


def _v(p):
    return np.asarray(p, dtype=np.float64).reshape(3)


# --- primitives -----------------------------------------------------------

@dataclasses.dataclass
class Sphere(Solid):
    center: np.ndarray
    radius: float


@dataclasses.dataclass
class Plane(Solid):
    norm: np.ndarray
    offset: float


@dataclasses.dataclass
class Box(Solid):
    bmin: np.ndarray
    bmax: np.ndarray


@dataclasses.dataclass
class Triangle(Solid):
    p1: np.ndarray
    p2: np.ndarray
    p3: np.ndarray


@dataclasses.dataclass
class TriangleNorm(Solid):
    p1: np.ndarray
    p2: np.ndarray
    p3: np.ndarray
    n1: np.ndarray
    n2: np.ndarray
    n3: np.ndarray


@dataclasses.dataclass
class Disc(Solid):
    pos: np.ndarray
    norm: np.ndarray
    radius_sqr: float


@dataclasses.dataclass
class CylinderZ(Solid):
    """Canonical z-aligned cylinder (reference Cone.hs:22)."""
    radius: float
    h1: float
    h2: float


@dataclasses.dataclass
class ConeZ(Solid):
    """Canonical z-aligned clipped cone (reference Cone.hs:23)."""
    radius: float
    clip1: float
    clip2: float
    height: float


# --- composites -----------------------------------------------------------

@dataclasses.dataclass
class Group(Solid):
    items: List[Solid]


@dataclasses.dataclass
class Void(Solid):
    pass


@dataclasses.dataclass
class Instance(Solid):
    item: Solid
    xfm: X.Xfm


@dataclasses.dataclass
class Tex(Solid):
    item: Solid
    texture: Texture


@dataclasses.dataclass
class Tag(Solid):
    item: Solid
    tag: Any


@dataclasses.dataclass
class NoShadow(Solid):
    item: Solid


@dataclasses.dataclass
class OnlyShadow(Solid):
    item: Solid


@dataclasses.dataclass
class Difference(Solid):
    a: Solid
    b: Solid
    useatex: bool = True


@dataclasses.dataclass
class Intersection(Solid):
    items: List[Solid]


@dataclasses.dataclass
class Bound(Solid):
    """Manual bounding proxy (reference Bound.hs:20).  The global BVH
    subsumes it; the flattener keeps only the contained object, exactly
    like the reference's flatten_transform_bound (Bound.hs:69-74)."""
    bound: Solid
    item: Solid


@dataclasses.dataclass
class BihMarker(Solid):
    """Marks a subtree the user asked to accelerate (reference bih,
    Bih.hs:309).  Acceleration is global in this framework, so this is
    semantically a group; the marker is kept for primcount parity."""
    items: List[Solid]


@dataclasses.dataclass
class Mesh(Solid):
    """Shared-vertex triangle mesh (reference Mesh.hs:27-52).

    verts: (V,3); norms: (Nn,3) or None; tris: (T, 8) int32 rows of
    (v0,v1,v2, n0,n1,n2, tex_idx, tag_idx) with -1 for absent, exactly
    the reference Tri record; textures/tags indexed per triangle.
    """
    verts: np.ndarray
    norms: Optional[np.ndarray]
    tris: np.ndarray
    textures: Tuple[Texture, ...] = ()
    tags: Tuple[Any, ...] = ()
    # The reference mesh never occludes shadow rays (Mesh.hs:210
    # returns False -- a known reference quirk).  cast_shadows=True is
    # the TPU-native capability the reference lacks: mesh triangles
    # participate in the any-hit shadow walk like every other prim.
    cast_shadows: bool = False


# --- constructor functions (reference API surface) ------------------------

def sphere(center, radius) -> Solid:
    return Sphere(_v(center), float(radius))


def plane(orig, norm) -> Solid:
    n = _v(norm)
    n = n / np.linalg.norm(n)
    return Plane(n, float(n @ _v(orig)))


def plane_offset(norm, offset) -> Solid:
    return Plane(_v(norm), float(offset))


def box(p1, p2) -> Solid:
    p1, p2 = _v(p1), _v(p2)
    return Box(np.minimum(p1, p2), np.maximum(p1, p2))


def triangle(p1, p2, p3) -> Solid:
    return Triangle(_v(p1), _v(p2), _v(p3))


def triangles(verts) -> List[Solid]:
    """Triangle fan (reference Triangle.hs:28-30)."""
    verts = [_v(v) for v in verts]
    return [triangle(verts[0], a, b) for a, b in zip(verts[1:], verts[2:])]


def trianglenorm(p1, p2, p3, n1, n2, n3) -> Solid:
    return TriangleNorm(_v(p1), _v(p2), _v(p3), _v(n1), _v(n2), _v(n3))


def trianglesnorms(vns) -> List[Solid]:
    """Fan from (vertex, normal) pairs (reference Triangle.hs:38-42)."""
    vns = [( _v(v), _v(n)) for v, n in vns]
    return [trianglenorm(vns[0][0], a[0], b[0], vns[0][1], a[1], b[1])
            for a, b in zip(vns[1:], vns[2:])]


def disc(pos, norm, r) -> Solid:
    return Disc(_v(pos), _v(norm), float(r) * float(r))


def cylinder(p1, p2, r) -> Solid:
    """General cylinder from p1 to p2 (reference Cone.hs:40-48)."""
    p1, p2 = _v(p1), _v(p2)
    axis = p2 - p1
    ln = float(np.linalg.norm(axis))
    ax1 = axis / ln
    ax2, ax3 = X.orth(ax1)
    return transform(CylinderZ(float(r), 0.0, ln),
                     [X.xyz_to_uvw(ax2, ax3, ax1), X.translate(p1)])


def cone(p1, r1, p2, r2) -> Solid:
    """General cone from p1 (radius r1) to p2 (radius r2)
    (reference Cone.hs:52-67)."""
    p1, p2 = _v(p1), _v(p2)
    r1, r2 = float(r1), float(r2)
    if r1 < r2:
        return cone(p2, r2, p1, r1)
    if r1 - r2 < DELTA:
        return cylinder(p1, p2, r2)
    axis = p2 - p1
    ln = float(np.linalg.norm(axis))
    ax1 = axis / ln
    ax2, ax3 = X.orth(ax1)
    height = (r1 * ln) / (r1 - r2)
    return transform(ConeZ(r1, 0.0, ln, height),
                     [X.xyz_to_uvw(ax2, ax3, ax1), X.translate(p1)])


def group(items: Sequence[Solid]) -> Solid:
    items = [s for s in items if not isinstance(s, Void)]
    if not items:
        return Void()
    if len(items) == 1:
        return items[0]
    return Group(list(items))


nothing = Void


def transform(s: Solid, xfms) -> Solid:
    """Transform a solid; merges nested instances into one matrix pair
    (reference Solid.hs:235,494-496)."""
    if isinstance(xfms, X.Xfm):
        composed = xfms
    else:
        composed = X.compose(xfms)
    if isinstance(s, Instance):
        return Instance(s.item, X.compose([s.xfm, composed]))
    return Instance(s, composed)


def tex(s: Solid, texture: Texture) -> Solid:
    return Tex(s, texture)


def tag(s: Solid, t) -> Solid:
    return Tag(s, t)


def noshadow(s: Solid) -> Solid:
    return NoShadow(s)


def onlyshadow(s: Solid) -> Solid:
    return OnlyShadow(s)


def difference(a: Solid, b: Solid) -> Solid:
    return Difference(a, b, useatex=True)


def difference_retexture(a: Solid, b: Solid) -> Solid:
    return Difference(a, b, useatex=False)


def intersection(items: Sequence[Solid]) -> Solid:
    return Intersection(list(items))


def bound_object(bound_proxy: Solid, item: Solid) -> Solid:
    return Bound(bound_proxy, item)


def bih(items: Sequence[Solid]) -> Solid:
    items = [s for s in items if not isinstance(s, Void)]
    if not items:
        return Void()
    return BihMarker(list(items))


def mesh(verts, norms, tris, textures=(), tags=(),
         cast_shadows: bool = False) -> Solid:
    """Shared-vertex mesh.  cast_shadows defaults to the reference's
    no-shadow quirk (Mesh.hs:210); True enables mesh occlusion."""
    verts = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    norms = (None if norms is None or len(norms) == 0
             else np.asarray(norms, dtype=np.float64).reshape(-1, 3))
    tris = np.asarray(tris, dtype=np.int32).reshape(-1, 8)
    return Mesh(verts, norms, tris, tuple(textures), tuple(tags),
                cast_shadows)


# --- scene stats (primcount parity, Solid.hs:197,251) ---------------------

def primcount(s: Solid) -> Tuple[int, int, int]:
    """(primitives, transforms, bounding objects) like the reference's
    primcount; BihMarker counts as zero like the reference's Bih branch
    nodes are not counted as prims."""
    if isinstance(s, (Sphere, Plane, Box, Triangle, TriangleNorm, Disc,
                      CylinderZ, ConeZ)):
        return (1, 0, 0)
    if isinstance(s, Mesh):
        return (int(s.tris.shape[0]), 0, 0)
    if isinstance(s, Void):
        return (0, 0, 0)
    if isinstance(s, (Group, BihMarker, Intersection)):
        out = (0, 0, 0)
        for it in s.items:
            p = primcount(it)
            out = (out[0] + p[0], out[1] + p[1], out[2] + p[2])
        return out
    if isinstance(s, Instance):
        p = primcount(s.item)
        return (p[0], p[1] + 1, p[2])
    if isinstance(s, (Tex, Tag, NoShadow, OnlyShadow)):
        return primcount(s.item)
    if isinstance(s, Difference):
        a, b = primcount(s.a), primcount(s.b)
        return (a[0] + b[0], a[1] + b[1], a[2] + b[2])
    if isinstance(s, Bound):
        a, b = primcount(s.bound), primcount(s.item)
        # reference marks the proxy's prims as bounds (Bound.hs:76-77)
        return (b[0], a[1] + b[1], a[0] + a[2] + b[2])
    raise TypeError(f"unknown solid {type(s)}")
