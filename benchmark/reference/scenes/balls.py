"""SPD `balls`, the sphereflake (Haines, "A Proposal for Standard Graphics
Environments", IEEE CG&A 7(11), Nov. 1987; generator balls.c), the
reference's own description, written from the published description with
the node types of benchmark/reference/scene.py.

A sphere of radius 0.5 at the origin.  Every sphere above the deepest
level has nine children of a third of its radius that touch it, so
their centres lie 4/3 of its radius away: six on its equator, 60 degrees
apart from azimuth 15 degrees, and three above it at the elevation of a
close-packed neighbour (atan(sqrt 2), 54.74 degrees), 120 degrees apart
from azimuth 45 degrees; listed as three trios (above, equator,
equator) a third of a turn apart.  A child's own set is turned so that
its pole lies along the direction from its parent: by the least rotation
taking +z there, a half turn about x where that direction is -z.  Under
the flake a square floor at z = -0.5 reaching 12 out, NFF's `p 4`, as a
fan of two triangles.  Three white lights.

The surfaces are NFF fills as Glome's reader makes them (Spd.hs:138):
colour, alpha 1 - transmittance, no ambient, Kd, Ks, shine; NFF's rule
that Ks also weights a mirror reflection is not Glome's, so no ball
reflects, here as in the program.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference.scene import (Group, Light, Tex, camera, sphere,
                                       surface, triangles)

ROOT_RADIUS = 0.5
FLOOR_Z = -0.5
FLOOR_HALF = 12.0

BALL = ("uniform", surface((1.0, 0.9, 0.7), 1.0, 0.0, 0.5, 0.5, 3.0827))
FLOOR = ("uniform", surface((1.0, 0.75, 0.33), 1.0, 0.0, 0.8, 0.0, 0.0))


def children():
    """The nine unit directions about a pole along +z, in set order."""
    up = math.atan(math.sqrt(2.0))
    out = []
    for turn in range(3):
        a = math.radians(120.0 * turn)
        for el, az in ((up, math.radians(45.0)), (0.0, math.radians(15.0)),
                       (0.0, math.radians(75.0))):
            out.append((math.cos(el) * math.cos(az + a),
                        math.cos(el) * math.sin(az + a), math.sin(el)))
    return np.array(out)


def pole_to(w):
    """The least rotation taking +z to the unit vector w:
    I + [v]x + [v]x^2 / (1 + w_z) with v = z x w; a half turn about x
    where w is -z."""
    if 1.0 + w[2] <= 1e-12:
        return np.diag([1.0, -1.0, -1.0])
    vx = np.array([[0.0, 0.0, w[0]], [0.0, 0.0, w[1]], [-w[0], -w[1], 0.0]])
    return np.eye(3) + vx + vx @ vx / (1.0 + w[2])


def flake(size):
    """[(centre, radius)] depth first, each sphere before its children."""
    kids = children()
    out = []

    def grow(c, r, w, depth):
        out.append((c, r))
        if depth == 0:
            return
        rot = pole_to(w)
        for k in kids:
            d = rot @ k
            grow(c + d * (r * 4.0 / 3.0), r / 3.0, d, depth - 1)
    grow(np.zeros(3), ROOT_RADIUS, np.array([0.0, 0.0, 1.0]), size)
    return out


def floor():
    h = FLOOR_HALF
    return triangles([(h, h, FLOOR_Z), (-h, h, FLOOR_Z), (-h, -h, FLOOR_Z),
                      (h, -h, FLOOR_Z)])


def build(size=5):
    balls = Group([sphere(c, r) for c, r in flake(size)])
    root = Group([Tex(Group(floor()), FLOOR), Tex(balls, BALL)])
    lights = tuple(Light(p, (1.0, 1.0, 1.0))
                   for p in ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0),
                             (-3.0, 1.0, 5.0)))
    return root, lights, camera((2.1, 1.3, 1.7), (0.0, 0.0, 0.0),
                                (0.0, 0.0, 1.0), 45.0)
