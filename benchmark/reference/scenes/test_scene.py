"""TestScene (jimsnow/glome GlomeView/TestScene.hs), the reference's own
description: geom'' with cust_cam, built constructor for constructor from
the Haskell source with the node types of benchmark/reference/scene.py."""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference import noise as N
from benchmark.reference.scene import (DELTA, Diff, Group, Inter, Light, Tex,
                                       box, camera, chain, cone, deg,
                                       half_space, matte, rotate, scale,
                                       sphere, surface, translate, xform)

SHINY_WHITE = surface((1, 1, 1), 1, 0.2, 0.8, 0.4, 10)
SHINY_RED = surface((1, 0, 0), 1, 0.2, 0.8, 0.4, 10)
DULL_GRAY = surface((0.4, 0.3, 0.35), 1, 0.2, 0.8, 0, 0)
MIRROR = ("reflect", 0.8)
T_MOTTLED = ("blend", MIRROR, matte((0.15, 0.3, 0.5))[1],
             lambda pos: N.perlin(pos * 3.0))
T_STRIPE = ("blend", SHINY_WHITE, DULL_GRAY,
            lambda pos: N.triangle_wave(pos @ pos.new_tensor((4.0, 8.0,
                                                               5.0))))


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


build = test_scene
