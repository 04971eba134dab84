"""The node types of the reference's own scene descriptions: plain nodes
(no code of the program), with the constructors, matrices, materials and
camera that every description uses.  A configuration's scene is the file
benchmark/reference/scenes/<builder>.py, named by the recipe's `builder`
(the name the program's glome_tpu_torch/scenes/<module>.py exports),
whose build(**args) returns (root, lights, camera); build() below finds
it.

Nodes:

  Prim(kind, p)         a primitive in its own coordinates: "sphere"
                        (cx, cy, cz, r), "plane" (nx, ny, nz, offset: the
                        half-space n.x < offset), "box" (min xyz, max xyz),
                        "cylinder" (r, z1, z2: z-aligned, capped), "cone"
                        (r, z1, z2, h: radius r at z=0 narrowing to 0 at
                        z=h, capped at z1 and z2), "triangle" (p1, p2, p3),
                        "trianglenorm" (p1, p2, p3, n1, n2, n3: unit
                        normals at the vertices)
  Group(items)          union (Glome's group, bih and bound_object: a
                        bound only speeds the search up)
  Xform(item, m)        item under the 4x4 object-to-world matrix m
  Tex(item, texture)    pushes a texture onto its hits' stack
  Diff(a, b, useatex)   CSG difference (Csg.hs:14)
  Inter(items)          CSG intersection (Csg.hs:15)

Materials and textures are tuples: ("surface", rgb, alpha, ambient, kd,
ks, shine), ("reflect", amount), ("refract", refl, refr, ior),
("warp", frame_node, lights, m); textures ("uniform", material) and
("blend", m1, m2, field) with field a function of the world position.
"""

from __future__ import annotations

import importlib.util
import math
import os
from typing import Any, List, NamedTuple, Tuple

import numpy as np

DELTA = 1.0e-4


class Prim(NamedTuple):
    kind: str
    p: Tuple[float, ...]


class Group(NamedTuple):
    items: List[Any]


class Xform(NamedTuple):
    item: Any
    m: np.ndarray


class Tex(NamedTuple):
    item: Any
    texture: Any


class Diff(NamedTuple):
    a: Any
    b: Any
    useatex: bool = True


class Inter(NamedTuple):
    items: List[Any]


class Camera(NamedTuple):
    pos: np.ndarray
    fwd: np.ndarray
    up: np.ndarray
    right: np.ndarray


class Light(NamedTuple):
    pos: Tuple[float, float, float]
    color: Tuple[float, float, float]


# --- matrices (4x4, object to world; a list applies in its order) ---------

def translate(v):
    m = np.eye(4)
    m[:3, 3] = v
    return m


def scale(v):
    return np.diag([float(v[0]), float(v[1]), float(v[2]), 1.0])


def rotate(axis, angle):
    """Right-handed rotation by `angle` radians about the unit `axis`."""
    k = np.asarray(axis, np.float64)
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    r = (math.cos(angle) * np.eye(3) + math.sin(angle) * kx
         + (1 - math.cos(angle)) * np.outer(k, k))
    m = np.eye(4)
    m[:3, :3] = r
    return m


def chain(ms):
    out = np.eye(4)
    for m in ms:
        out = m @ out
    return out


def deg(x):
    return x * math.pi / 180.0


# --- constructors ---------------------------------------------------------

def sphere(c, r):
    return Prim("sphere", (float(c[0]), float(c[1]), float(c[2]), float(r)))


def box(p1, p2):
    lo = np.minimum(p1, p2)
    hi = np.maximum(p1, p2)
    return Prim("box", tuple(float(v) for v in (*lo, *hi)))


def half_space(n, offset):
    return Prim("plane", (float(n[0]), float(n[1]), float(n[2]),
                          float(offset)))


def _frame_along(p1, axis):
    """The matrix taking z to `axis` (unit) and the origin to p1."""
    w = axis
    a = np.array([1.0, 0, 0]) if abs(w[0]) < 0.8 else np.array([0, 1.0, 0])
    u = np.cross(w, a)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = u, v, w, p1
    return m


def cone(p1, r1, p2, r2):
    """A solid capped cone from p1 (radius r1) to p2 (radius r2), a
    cylinder where the radii differ by under DELTA (Cone.hs:40-67)."""
    p1, p2 = np.asarray(p1, np.float64), np.asarray(p2, np.float64)
    r1, r2 = float(r1), float(r2)
    if r1 < r2:
        return cone(p2, r2, p1, r1)
    ln = float(np.linalg.norm(p2 - p1))
    m = _frame_along(p1, (p2 - p1) / ln)
    if r1 - r2 < DELTA:
        return Xform(Prim("cylinder", (r2, 0.0, ln)), m)
    return Xform(Prim("cone", (r1, 0.0, ln, r1 * ln / (r1 - r2))), m)


def xform(item, ms):
    return Xform(item, chain(ms))


def triangle(p1, p2, p3):
    return Prim("triangle", tuple(float(v) for v in (*p1, *p2, *p3)))


def _unit3(n):
    n = np.asarray(n, np.float64)
    return n / np.linalg.norm(n)


def trianglenorm(p1, p2, p3, n1, n2, n3):
    """A triangle whose shading normal is interpolated from unit normals
    at its vertices (Triangle.hs:14)."""
    return Prim("trianglenorm", tuple(float(v) for v in (
        *p1, *p2, *p3, *_unit3(n1), *_unit3(n2), *_unit3(n3))))


def triangles(verts):
    """An n-gon as a fan of triangles from its first vertex (Triangle.hs:28,
    NFF's `p`)."""
    return [triangle(verts[0], a, b) for a, b in zip(verts[1:], verts[2:])]


def trianglesnorms(vns):
    """A polygon patch of (vertex, normal) pairs as a fan from its first
    pair (Triangle.hs:38, NFF's `pp`)."""
    (v0, n0), rest = vns[0], vns[1:]
    return [trianglenorm(v0, a[0], b[0], n0, a[1], b[1])
            for a, b in zip(rest, rest[1:])]


# --- materials ------------------------------------------------------------

def surface(color, alpha=1.0, ambient=0.0, kd=1.0, ks=0.0, shine=1.0):
    return ("surface", tuple(float(c) for c in color), float(alpha),
            float(ambient), float(kd), float(ks), float(shine))


def matte(color):
    return ("uniform", surface(color, 1, 0.2, 1.0, 0, 0))


# --- the camera -------------------------------------------------------------

def camera(pos, at, up, angle_deg):
    """Scene.hs:48-57: an orthonormal basis scaled by tan(fov / 2)."""
    pos, at, up = (np.asarray(v, np.float64) for v in (pos, at, up))
    fwd = (at - pos) / np.linalg.norm(at - pos)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    up2 /= np.linalg.norm(up2)
    s = math.tan(math.radians(angle_deg) / 2.0)
    return Camera(pos, fwd, up2 * s, right * s)


# --- a configuration's scene, found by file -------------------------------

HERE = os.path.dirname(os.path.abspath(__file__))


def build(recipe: dict, checkout: str = None):
    """(root, lights, camera) of a configuration's scene recipe: the
    build(**args) of benchmark/reference/scenes/<builder>.py in
    `checkout` (by default the one that holds this file)."""
    name = recipe["builder"]
    base = (HERE if checkout is None
            else os.path.join(checkout, "benchmark", "reference"))
    path = os.path.join(base, "scenes", f"{name}.py")
    if not name.isidentifier() or not os.path.isfile(path):
        raise FileNotFoundError(
            f"no reference scene for builder {name!r}: write {path} with "
            f"build(**args) -> (root, lights, camera)")
    spec = importlib.util.spec_from_file_location(
        "benchmark_reference_scene_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build(**recipe.get("args", {}))
