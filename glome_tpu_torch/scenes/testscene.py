"""Port of the reference benchmark scene (GlomeView/TestScene.hs).

Everything is built constructor-for-constructor from TestScene.hs; the
only intentional deviation is the oak tree's random stream: the
reference uses GHC's System.Random StdGen (TestScene.hs:69,86-88) whose
exact sequence is not reproducible outside GHC, so an equivalent
deterministic numpy stream drives the same branching recursion --
the tree has identical structure, node count and statistics.
"""

from __future__ import annotations

import math

import numpy as np

import glome_tpu_torch as G
from glome_tpu_torch.config import DELTA, deg, rot
from glome_tpu_torch.materials import (Blend, Light, Reflect, Refract,
                                       Surface, Uniform, Warp, BlendFn, light)
from glome_tpu_torch import noise as N
from glome_tpu_torch import xfm as X
from glome_tpu_torch.render import camera


# --- materials and textures (TestScene.hs:200-245) ------------------------

m_shiny_white = Surface(color=(1, 1, 1), alpha=1, ambient=0.2, kd=0.8,
                        ks=0.4, shine=10)
m_shiny_red = Surface(color=(1, 0, 0), alpha=1, ambient=0.2, kd=0.8,
                      ks=0.4, shine=10)
m_dull_gray = Surface(color=(0.4, 0.3, 0.35), alpha=1, ambient=0.2, kd=0.8,
                      ks=0, shine=0)
m_mirror = Reflect(0.8)


def m_matte(color):
    return Surface(color=tuple(color), alpha=1, ambient=0.2, kd=1.0,
                   ks=0, shine=0)


def t_matte(color):
    return G.t_uniform(m_matte(color))


t_shiny_white = G.t_uniform(m_shiny_white)
t_shiny_red = G.t_uniform(m_shiny_red)
t_mirror = G.t_uniform(m_mirror)


def _mottled_field(pos):
    # t_mottled (TestScene.hs:214-220): perlin(pos*3) blends mirror/matte
    return N.perlin(pos * 3.0)


t_mottled = BlendFn(m_mirror, m_matte((0.15, 0.3, 0.5)), _mottled_field)


def _stripe_field(pos):
    # t_stripe (TestScene.hs:226-231)
    return N.stripe(pos, (4.0, 8.0, 5.0), N.triangle_wave)


t_stripe = BlendFn(m_shiny_white, m_dull_gray, _stripe_field)


# --- lights (TestScene.hs:17-19) ------------------------------------------

def lights():
    return (
        light((-100, 70, 140), tuple(np.array([1, 0.8, 0.8]) * 7000.0)),
        light((-3, 5, 8), tuple(np.array([1.5, 2, 2]) * 10.0)),
    )


# --- geometry pieces ------------------------------------------------------

def lattice(n=10):
    """(2n+1)^3 grid of small spheres (TestScene.hs:21-25)."""
    rng = range(-n, n + 1)
    return G.bih([G.sphere((x, y, z), 0.2)
                  for x in rng for y in rng for z in rng])


def icosahedron(pos, r):
    """Sphere clipped by 20 half-spaces (TestScene.hs:27-43)."""
    pos = np.asarray(pos, dtype=np.float64)
    gr = (1 + math.sqrt(5)) / 2
    n11 = [-r, r]
    ngrgr = [-gr * r, gr * r]
    grrcp = [-r / gr, r / gr]
    points = ([np.array([x, y, z]) for x in n11 for y in n11 for z in n11]
              + [np.array([0, y, z]) for y in grrcp for z in ngrgr]
              + [np.array([x, y, 0]) for x in grrcp for y in ngrgr]
              + [np.array([x, 0, z]) for x in ngrgr for z in grrcp])

    def pln(x):
        nx = x / np.linalg.norm(x)
        return G.plane_offset(nx, r + float(nx @ pos))

    return G.tag(G.intersection([G.sphere(pos, 1.26 * r)]
                                + [pln(p) for p in points]),
                 "icosahedron")


def dodecahedron(pos, r):
    """Sphere clipped by 12 half-spaces (TestScene.hs:45-54)."""
    pos = np.asarray(pos, dtype=np.float64)
    gr = (1 + math.sqrt(5)) / 2
    n11 = [-r, r]
    ngrgr = [-gr * r, gr * r]
    points = ([np.array([0, y, z]) for y in n11 for z in ngrgr]
              + [np.array([x, 0, z]) for z in n11 for x in ngrgr]
              + [np.array([x, y, 0]) for x in n11 for y in ngrgr])

    def pln(x):
        nx = x / np.linalg.norm(x)
        return G.plane_offset(nx, r + float(nx @ pos))

    return G.tag(G.intersection([G.sphere(pos, 1.26 * r)]
                                + [pln(p) for p in points]),
                 "dodecahedron")


def coil():
    """600-segment cone+sphere spiral (TestScene.hs:56-64)."""
    spiral = [(np.array([math.sin(rot(n)) * n, math.cos(rot(n)) * n, n - 3]),
               n / 15.0)
              for n in np.arange(0.0, 6.0, 0.01)]
    segs = []
    for (p1, r1), (p2, r2) in zip(spiral, spiral[1:]):
        segs.append(G.group([G.cone(p1, r1, p2, r2), G.sphere(p1, r1)]))
    return G.bih(segs)


def oak(age, seed=42):
    """Procedural binary tree of cones with manual bounds
    (TestScene.hs:68-110); numpy RNG stands in for GHC StdGen."""
    rng = np.random.RandomState(seed)
    if age < 0:
        return G.nothing()
    year = int(math.floor(age))
    season = age - year
    thickness = 0.03
    minbranch, maxbranch = deg(10), deg(25)

    def tree(n):
        if n == 0:
            return G.nothing()
        if n == 1:
            return G.tex(G.sphere((0, 0, 0), season),
                         t_matte((0.2, 1, 0.4)))
        nf = float(n)
        height = nf
        seglen = 0.5 + rng.uniform(0, 0.5)
        branchang = rng.uniform(minbranch, maxbranch)
        scaling = rng.uniform(0.8, 0.95)
        sub1, sub2 = tree(n - 1), tree(n - 1)
        return G.bound_object(
            G.sphere((0, height / 2, 0), height / 2),
            G.group([
                G.cone((0, 0, 0), thickness * height,
                       (0, seglen, 0), thickness * (height - 1) * scaling),
                G.transform(sub1, [G.scale((scaling,) * 3),
                                   G.rotate((0, 0, 1), branchang),
                                   G.rotate((0, 1, 0), deg(30)),
                                   G.translate((0, seglen, 0))]),
                G.transform(sub2, [G.scale((scaling,) * 3),
                                   G.rotate((0, 0, 1), -branchang),
                                   G.rotate((0, 1, 0), deg(30)),
                                   G.translate((0, seglen, 0))]),
            ]))

    return G.tag(G.tex(G.bih([tree(year)]), t_matte((0.8, 0.5, 0.4))),
                 "tree")


def sphereint():
    """Intersection of four spheres (TestScene.hs:112-115)."""
    return G.intersection([G.sphere((-1, 0, 0), 2), G.sphere((1, 0, 0), 2),
                           G.sphere((0, -1, 0), 2), G.sphere((0, 1, 0), 2)])


def chessboard():
    """8x8 field of height-varying boxes (TestScene.hs:140-150)."""
    items = []
    for x in np.arange(-3.5, 4.0, 1.0):
        for z in np.arange(-3.5, 4.0, 1.0):
            h = (x * z) / 40.0
            t = (t_shiny_white
                 if (math.floor(x) + math.floor(z)) % 2 == 0 else t_mottled)
            items.append(G.tex(G.box((x - 0.5, -3, z - 0.5),
                                     (x + 0.5, h, z + 0.5)), t))
    return G.group(items)


def portal(height, width, thickness, target_scene=None, warp_lights=()):
    """Door frame + Warp surface (TestScene.hs:152-179)."""
    frame = G.tag(
        G.tex(G.difference(
            G.box((-width, 0, -thickness), (width, height, thickness)),
            G.box((thickness - width, thickness, -(thickness + DELTA)),
                  (width - thickness, height - thickness, thickness + DELTA))),
            t_matte((0.4, 0.4, 0.8))),
        "door frame")
    surface = G.box((-width, 0, -DELTA), (width, height - DELTA, DELTA))
    wx = X.compose([X.rotate((1, 0, 0), deg(-85)),
                    X.translate((8, 40, -4))])
    warp = Warp(frame=frame, scene=target_scene, lights=tuple(warp_lights),
                xfm=wx)
    return G.group([frame, G.tex(surface, G.t_uniform(warp))])


# --- cameras --------------------------------------------------------------

def cust_cam():
    return camera((-2, 4.3, 15), (0, 2, 0), (0, 1, 0), 45)


# --- scenes ---------------------------------------------------------------

def simple_scene():
    """geom' (TestScene.hs:133-135): box + two spheres, untextured."""
    return G.group([
        G.box((-1, -1, -1), (1, 1, 1)),
        G.group([G.sphere((2, 3, 0), 1), G.sphere((-3, 4, 1), 0.8)]),
    ])


def test_scene(lattice_n=10, include_portal=True, include_oak=True,
               coil_segments=True):
    """The benchmark scene geom'' (TestScene.hs:183-197) with its lights
    and camera.  Returns (solid, lights, camera)."""
    ls = lights()
    items = [
        G.difference(
            G.transform(chessboard(), [G.scale((2, 1.2, 2))]),
            G.tex(G.sphere((4, 1.5, 3), 3.5), t_shiny_white)),
        G.tex(dodecahedron((-6, 3, 0), 1), t_stripe),
        G.tex(G.transform(icosahedron((4, 1.5, 3), 1.5),
                          [G.rotate((0, 0, 1), deg(11)),
                           G.rotate((1, 0, 0), deg(7))]), t_mottled),
        G.cone((-6, -1, 0), 0.7, (-6, 3, 0), 0),
        G.tex(G.difference(
            G.transform(lattice(lattice_n),
                        [G.rotate((0, 0, 1), deg(23)),
                         G.rotate((1, 0, 0), deg(43)),
                         G.scale((3, 3, 3))]),
            G.sphere((0, 0, 0), 32)), t_shiny_red),
        G.transform(
            G.tex(G.sphere((-2.3, 0.3, 4.2), 1.7),
                  G.t_uniform(Refract(0.35, 0.8, 1.5))),
            [G.scale((1, 0.4, 1))]),
    ]
    if include_oak:
        items.insert(4, G.transform(oak(11.4),
                                    [G.scale((2, 2, 2)),
                                     G.translate((2, -1, -8))]))
    if include_portal:
        # Warp target None = the enclosing root scene (the reference's
        # lazy self-reference to geom'', TestScene.hs:179)
        items.append(G.transform(
            portal(5, 2, 1.0 / 3.0, target_scene=None, warp_lights=ls),
            [G.rotate((0, 1, 0), deg(8)), G.translate((-3, 0.5, -5))]))
    return G.bih(items), ls, cust_cam()
