"""A small scene that exercises every megakernel phase kind.

The scene of glome_tpu's tests/test_mega.py:build_scene: dense groups,
bvh2 groups (plain and transformed, > DENSE_MAX prims), convex CSG,
deferred difference-B prims with restricted member scans (one large
enough for a point-query BVH), inline constraints, retexture, shadow
flags, and a transformed dense sphere.  `P` is the package whose
constructors build it (default: this one), so tests can build the same
scene with glome_tpu for a side-by-side comparison.
"""

from __future__ import annotations

import numpy as np


def _package(P):
    if P is None:
        import glome_tpu_torch as P
    return P


def phase_kinds_scene(P=None):
    """The all-phase-kinds solid, built with package P."""
    P = _package(P)

    def mat(c):
        return P.t_uniform(P.Surface(color=c, ambient=0.3, kd=0.7))

    rng = np.random.RandomState(7)
    items = []
    # dense boxes
    for i in range(6):
        items.append(P.tex(P.box((i, -1, -1), (i + 0.5, 1, 1)),
                           mat((1, 0, 0))))
    # bvh2 sphere grid minus a sphere: A inline with a 1-member
    # constraint, B deferred with a restricted ~150-member scan
    lat = [P.sphere((0.4 * a, 0.4 * b, 4.0 + 0.4 * c), 0.18)
           for a in range(6) for b in range(5) for c in range(5)]
    items.append(P.tex(P.difference(P.group(lat),
                                    P.sphere((1.0, 0.8, 4.8), 0.9)),
                       mat((0, 1, 0))))
    # transformed cones (bvh2, transformed leaf tests)
    cones = []
    for _ in range(100):
        p = rng.randn(3) * 2 + np.array([0, 0, 8.0])
        q = p + rng.randn(3) * 0.3
        cones.append(P.cone(tuple(p), 0.2, tuple(q), 0.05))
    items.append(P.tex(P.group(cones), mat((0, 0, 1))))
    # convex csg: intersection of planes
    items.append(P.tex(P.intersection([
        P.plane((0, 0, 12), (0, 0, 1)),
        P.plane((0, 0, 10), (0, 0, -1)),
        P.plane((1, 0, 11), (1, 0.2, 0)),
        P.plane((-1, 0, 11), (-1, 0.1, 0)),
        P.plane((0, 1, 11), (0.05, 1, 0)),
        P.plane((0, -1, 11), (0, -1, 0.02))]), mat((1, 1, 0))))
    # retexture difference (useatex): box minus sphere
    items.append(P.difference(
        P.tex(P.box((-4, -1, 2), (-2, 1, 4)), mat((1, 0, 1))),
        P.tex(P.sphere((-2, 0, 3), 0.8), mat((0, 1, 1)))))
    # nested CSG (conjunctive normalization): (lens & lens) - bite
    items.append(P.tex(P.difference(
        P.intersection([P.sphere((4.5, 0, 5.0), 1.0),
                        P.sphere((5.5, 0, 5.0), 1.0)]),
        P.sphere((5.0, 0.45, 5.0), 0.5)), mat((0.2, 0.8, 0.6))))
    # shadow-control wrappers
    items.append(P.noshadow(P.tex(P.sphere((3, 3, 3), 0.5),
                                  mat((0.5, 0.5, 0.5)))))
    items.append(P.onlyshadow(P.sphere((-3, 3, 3), 0.5)))
    # transformed squashed sphere (dense transformed)
    xf = P.compose([P.scale((1.0, 0.5, 1.0)), P.rotate((0, 0, 1), 0.4),
                    P.translate((2, -2, 6))])
    items.append(P.tex(P.transform(P.sphere((0, 0, 0), 1.0), [xf]),
                       mat((0.9, 0.3, 0.1))))
    return P.group(items)


def phase_kinds_lights(P=None):
    P = _package(P)
    return (P.light((0, 8, 0), (50, 50, 50)),)


def phase_kinds_rays(n, seed=0):
    """(o, d) float32 (n, 3) rays from behind the scene into it
    (tests/test_mega.py:rays)."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32) * 0.5 + np.array(
        [0.5, 0.2, -4.0], np.float32)
    at = rng.randn(n, 3).astype(np.float32) * 3.0 + np.array(
        [0.0, 0.0, 6.0], np.float32)
    d = at - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def csg_scene(P=None):
    """CSG the all-phase-kinds scene leaves out, built with package P:
    non-conjunctive nesting (DNF regions with sibling exclusion, after
    glome_tpu's tests/test_csg.py), a convex intersection under a
    non-uniform scale (transformed convex members) and a ground plane
    (a dense phase without an AABB)."""
    P = _package(P)

    def mat(c):
        return P.t_uniform(P.Surface(color=c, ambient=0.3, kd=0.7))

    def at(x, s):
        return P.transform(s, [P.translate((x, 0.0, 0.0))])

    s = P.sphere
    return P.group([
        # a - (b & c)  ==  (a-b) | (a-c)
        at(0.0, P.tex(P.difference(
            s((0, 0, 0), 1.2),
            P.intersection([s((0.45, 0, 0), 0.9), s((-0.45, 0, 0), 0.9)])),
            mat((1, 0, 0)))),
        # a - (b - c)  ==  (a-b) | (a & c)
        at(3.0, P.tex(P.difference(
            s((0, 0, 0), 1.2),
            P.difference(s((0.5, 0, 0), 0.9), s((0.3, 0.3, 0), 0.6))),
            mat((0, 1, 0)))),
        # (a | (b & c)) - e
        at(6.0, P.tex(P.difference(
            P.group([s((-0.6, 0, 0), 0.8),
                     P.intersection([s((0.5, 0, 0), 0.9),
                                     s((0.9, 0, 0), 0.9)])]),
            s((0, 0.5, 0), 0.5)), mat((0, 0, 1)))),
        # convex lens under a non-uniform scale and a rotation
        P.tex(P.transform(
            P.intersection([s((-0.4, 0, 0), 1.0), s((0.4, 0, 0), 1.0)]),
            [P.scale((1.0, 0.5, 1.5)), P.rotate((0, 0, 1), 0.5),
             P.translate((3.0, 2.5, 0.0))]), mat((1, 1, 0))),
        P.tex(P.plane((0, -2.5, 0), (0, 1, 0)), mat((0.5, 0.5, 0.5))),
    ])


def csg_rays(n, seed=0):
    """(o, d) float32 (n, 3) rays from in front of csg_scene into it."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32) * 0.5 + np.array(
        [3.0, 0.5, -7.0], np.float32)
    at = rng.randn(n, 3).astype(np.float32) * np.array(
        [3.0, 1.5, 0.8], np.float32) + np.array([3.0, 0.3, 0.0], np.float32)
    d = at - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d
