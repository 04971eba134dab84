"""The reference's own description of a configuration's scene: plain
nodes (no code of the program), built constructor for constructor from
Glome's scene source, with the camera and lights.

Nodes:

  Prim(kind, p)         a primitive in its own coordinates: "sphere"
                        (cx, cy, cz, r), "plane" (nx, ny, nz, offset: the
                        half-space n.x < offset), "box" (min xyz, max xyz),
                        "cylinder" (r, z1, z2: z-aligned, capped), "cone"
                        (r, z1, z2, h: radius r at z=0 narrowing to 0 at
                        z=h, capped at z1 and z2)
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

import math
from typing import Any, List, NamedTuple, Tuple

import numpy as np

from . import noise as N

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


# --- materials ------------------------------------------------------------

def surface(color, alpha=1.0, ambient=0.0, kd=1.0, ks=0.0, shine=1.0):
    return ("surface", tuple(float(c) for c in color), float(alpha),
            float(ambient), float(kd), float(ks), float(shine))


def matte(color):
    return ("uniform", surface(color, 1, 0.2, 1.0, 0, 0))


SHINY_WHITE = surface((1, 1, 1), 1, 0.2, 0.8, 0.4, 10)
SHINY_RED = surface((1, 0, 0), 1, 0.2, 0.8, 0.4, 10)
DULL_GRAY = surface((0.4, 0.3, 0.35), 1, 0.2, 0.8, 0, 0)
MIRROR = ("reflect", 0.8)
T_MOTTLED = ("blend", MIRROR, matte((0.15, 0.3, 0.5))[1],
             lambda pos: N.perlin(pos * 3.0))
T_STRIPE = ("blend", SHINY_WHITE, DULL_GRAY,
            lambda pos: N.triangle_wave(pos @ pos.new_tensor((4.0, 8.0,
                                                               5.0))))


# --- TestScene (jimsnow/glome GlomeView/TestScene.hs) ---------------------

def lights():
    """TestScene.hs:17-19."""
    return (Light((-100.0, 70.0, 140.0), (7000.0, 5600.0, 5600.0)),
            Light((-3.0, 5.0, 8.0), (15.0, 20.0, 20.0)))


def lattice(n):
    """(2n+1)^3 spheres of radius 0.2 (TestScene.hs:21-25)."""
    r = range(-n, n + 1)
    return Group([sphere((x, y, z), 0.2) for x in r for y in r for z in r])


def _clipped_sphere(pos, r, normals):
    pos = np.asarray(pos, np.float64)
    planes = []
    for x in normals:
        nx = np.asarray(x, np.float64) / np.linalg.norm(x)
        planes.append(half_space(nx, r + float(nx @ pos)))
    return Inter([sphere(pos, 1.26 * r)] + planes)


def icosahedron(pos, r):
    """TestScene.hs:27-43."""
    g = (1 + math.sqrt(5)) / 2
    s, a, b = (-r, r), (-g * r, g * r), (-r / g, r / g)
    pts = ([(x, y, z) for x in s for y in s for z in s]
           + [(0, y, z) for y in b for z in a]
           + [(x, y, 0) for x in b for y in a]
           + [(x, 0, z) for x in a for z in b])
    return _clipped_sphere(pos, r, pts)


def dodecahedron(pos, r):
    """TestScene.hs:45-54."""
    g = (1 + math.sqrt(5)) / 2
    s, a = (-r, r), (-g * r, g * r)
    pts = ([(0, y, z) for y in s for z in a]
           + [(x, 0, z) for z in s for x in a]
           + [(x, y, 0) for x in s for y in a])
    return _clipped_sphere(pos, r, pts)


def oak(age, seed=42):
    """A binary tree of cones (TestScene.hs:68-110).  GHC's StdGen is not
    reproducible outside GHC: a numpy RandomState stream drives the same
    recursion, drawing in the same order."""
    rng = np.random.RandomState(seed)
    year = int(math.floor(age))
    season = age - year
    thick = 0.03

    def tree(n):
        if n == 0:
            return None
        if n == 1:
            return Tex(sphere((0, 0, 0), season), matte((0.2, 1, 0.4)))
        seglen = 0.5 + rng.uniform(0, 0.5)
        ang = rng.uniform(deg(10), deg(25))
        sc = rng.uniform(0.8, 0.95)
        kids = [tree(n - 1), tree(n - 1)]
        items = [cone((0, 0, 0), thick * n, (0, seglen, 0),
                      thick * (n - 1) * sc)]
        for sub, a in zip(kids, (ang, -ang)):
            if sub is not None:
                items.append(xform(sub, [scale((sc, sc, sc)),
                                         rotate((0, 0, 1), a),
                                         rotate((0, 1, 0), deg(30)),
                                         translate((0, seglen, 0))]))
        return Group(items)

    return Tex(tree(year), matte((0.8, 0.5, 0.4)))


def chessboard():
    """TestScene.hs:140-150."""
    items = []
    for x in np.arange(-3.5, 4.0, 1.0):
        for z in np.arange(-3.5, 4.0, 1.0):
            h = (x * z) / 40.0
            t = (("uniform", SHINY_WHITE)
                 if (math.floor(x) + math.floor(z)) % 2 == 0 else T_MOTTLED)
            items.append(Tex(box((x - 0.5, -3, z - 0.5),
                                 (x + 0.5, h, z + 0.5)), t))
    return Group(items)


def portal(height, width, thick, warp_lights):
    """The door frame and its warp surface (TestScene.hs:152-179); the
    warp's target is the whole scene."""
    frame = Tex(Diff(box((-width, 0, -thick), (width, height, thick)),
                     box((thick - width, thick, -(thick + DELTA)),
                         (width - thick, height - thick, thick + DELTA))),
                matte((0.4, 0.4, 0.8)))
    surf = box((-width, 0, -DELTA), (width, height - DELTA, DELTA))
    wx = chain([rotate((1, 0, 0), deg(-85)), translate((8, 40, -4))])
    warp = ("warp", frame, tuple(warp_lights), wx)
    return Group([frame, Tex(surf, ("uniform", warp))])


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


def test_scene(lattice_n=10, include_portal=True, include_oak=True):
    """geom'' with cust_cam (TestScene.hs:183-197): (root, lights,
    camera).  The smaller arguments are for tests."""
    ls = lights()
    items = [
        Diff(xform(chessboard(), [scale((2, 1.2, 2))]),
             Tex(sphere((4, 1.5, 3), 3.5), ("uniform", SHINY_WHITE))),
        Tex(dodecahedron((-6, 3, 0), 1), T_STRIPE),
        Tex(xform(icosahedron((4, 1.5, 3), 1.5),
                  [rotate((0, 0, 1), deg(11)), rotate((1, 0, 0), deg(7))]),
            T_MOTTLED),
        cone((-6, -1, 0), 0.7, (-6, 3, 0), 0),
        Tex(Diff(xform(lattice(lattice_n),
                       [rotate((0, 0, 1), deg(23)),
                        rotate((1, 0, 0), deg(43)), scale((3, 3, 3))]),
                 sphere((0, 0, 0), 32)), ("uniform", SHINY_RED)),
        xform(Tex(sphere((-2.3, 0.3, 4.2), 1.7),
                  ("uniform", ("refract", 0.35, 0.8, 1.5))),
              [scale((1, 0.4, 1))]),
    ]
    if include_oak:
        items.insert(4, xform(oak(11.4), [scale((2, 2, 2)),
                                          translate((2, -1, -8))]))
    if include_portal:
        items.append(xform(portal(5, 2, 1.0 / 3.0, ls),
                           [rotate((0, 1, 0), deg(8)),
                            translate((-3, 0.5, -5))]))
    cam = camera((-2, 4.3, 15), (0, 2, 0), (0, 1, 0), 45)
    return Group(items), ls, cam


SCENES = {"test_scene": test_scene}


def build(recipe: dict):
    """(root, lights, camera) of a configuration's scene recipe."""
    return SCENES[recipe["builder"]](**recipe.get("args", {}))
