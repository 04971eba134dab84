"""SPD `balls`: Eric Haines' sphereflake, from the Standard Procedural
Databases ("A Proposal for Standard Graphics Environments", IEEE CG&A
7(11), Nov. 1987; generator balls.c), as the NFF text balls.c writes,
read through the port's own NFF import (spd.parse).

The text: the viewpoint (from 2.1 1.3 1.7, at the origin, z up, 45
degrees, 512x512), the sky-blue background, three white lights, the
beige floor fill and its square `p 4` polygon under the flake, the
off-white shiny ball fill, then the flake depth first, each sphere
before its children.  The flake starts from the radius-0.5 sphere at the
origin; every sphere above the deepest level has nine children, each a
third of its radius and touching it: six about its equator, three above
it, the set oriented along the direction from its parent (the root's
along +z).  Size factor s gives 1 + 9 + ... + 9^s spheres: 7,381 at
SPD's default of 4, 66,430 at 5.  The child set, its orientation, the
floor and the fills are reconstructed from the published description,
not read from balls.c.

Numbers are written at full double precision (balls.c prints six
significant digits), so the spheres are exactly the generator's.

    python -m glome_tpu_torch.scenes.spd_balls [size] > balls.nff
    python -m glome_tpu_torch.app --scene balls.nff --out balls.png
"""

from __future__ import annotations

import math

import numpy as np

from .. import spd

# the flake's children per sphere: distance from the parent's centre and
# radius, in parent radii
CHILD_SCALE = 1.0 / 3.0
CHILD_DIST = 1.0 + CHILD_SCALE

HEADER = """v
from 2.1 1.3 1.7
at 0 0 0
up 0 0 1
angle 45
hither 0.01
resolution 512 512
b 0.078 0.361 0.753
l 4 3 2
l 1 -4 4
l -3 1 5
f 1 0.75 0.33 0.8 0 0 0 0
p 4
12 12 -0.5
-12 12 -0.5
-12 -12 -0.5
12 -12 -0.5
f 1 0.9 0.7 0.5 0.5 3.0827 0 0
"""


def _axis_rotate(axis, angle):
    """Right-handed rotation matrices by `angle` about unit `axis`,
    batched: axis (n, 3), angle (n,) -> (n, 3, 3)."""
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    c, s = np.cos(angle), np.sin(angle)
    t = 1.0 - c
    return np.stack([
        np.stack([t * x * x + c, t * x * y - s * z, t * x * z + s * y], -1),
        np.stack([t * x * y + s * z, t * y * y + c, t * y * z - s * x], -1),
        np.stack([t * x * z - s * y, t * y * z + s * x, t * z * z + c], -1),
    ], -2)


def child_set():
    """The nine unit directions of a sphere's children about +z (balls.c's
    create_objset): three neighbours of a close-packed sphere, one above
    and two on the equator, turned so that their set's axis (1, 1, 1)
    points up, then the trio again at 120 and 240 degrees about z."""
    h = 1.0 / math.sqrt(2.0)
    trio = np.array([[h, h, 0.0], [h, 0.0, -h], [0.0, h, -h]])
    axis = np.array([[h, -h, 0.0]])
    up = _axis_rotate(axis, np.array([math.asin(2.0 / math.sqrt(6.0))]))[0]
    trio = trio @ up.T
    turns = _axis_rotate(np.tile([[0.0, 0.0, 1.0]], (3, 1)),
                         np.arange(3) * 2.0 * math.pi / 3.0)
    return np.concatenate([trio @ r.T for r in turns])


def _orient(dirs):
    """The rotations taking +z to each unit direction (n, 3): about
    z x dir by the angle between them; the identity along +z and a half
    turn about x along -z, where that axis vanishes."""
    dz = np.clip(dirs[:, 2], -1.0, 1.0)
    axis = np.stack([-dirs[:, 1], dirs[:, 0], np.zeros_like(dz)], -1)
    norm = np.linalg.norm(axis, axis=1, keepdims=True)
    rot = _axis_rotate(axis / np.where(norm > 0.0, norm, 1.0), np.arccos(dz))
    rot[1.0 - dz <= 1e-12] = np.eye(3)
    rot[1.0 + dz <= 1e-12] = np.diag([1.0, -1.0, -1.0])
    return rot


def flake(size: int = 5):
    """The flake's spheres in balls.c's output order (each sphere, then
    its children's subtrees in set order): (centres (n, 3), radii (n,))."""
    kids = child_set()
    levels = [(np.zeros((1, 3)), np.array([0.5]),
               np.array([[0.0, 0.0, 1.0]]))]
    for _ in range(size):
        c, r, d = levels[-1]
        dirs = np.einsum("nij,kj->nki", _orient(d), kids).reshape(-1, 3)
        rr = np.repeat(r, len(kids))
        levels.append((np.repeat(c, len(kids), axis=0)
                       + dirs * (rr * CHILD_DIST)[:, None],
                       rr * CHILD_SCALE, dirs))
    order = []

    def visit(level, i):
        order.append((level, i))
        if level < size:
            for k in range(len(kids)):
                visit(level + 1, i * len(kids) + k)
    visit(0, 0)
    centres = np.array([levels[lv][0][i] for lv, i in order])
    radii = np.array([levels[lv][1][i] for lv, i in order])
    return centres, radii


def nff(size: int = 5) -> str:
    """balls.c's NFF text at size factor `size`."""
    centres, radii = flake(size)
    lines = [HEADER]
    lines += [f"s {c[0]!r} {c[1]!r} {c[2]!r} {r!r}\n"
              for c, r in zip(centres.tolist(), radii.tolist())]
    return "".join(lines)


def balls(size: int = 5):
    """(solid, lights, camera) of the flake at size factor `size`, through
    spd.parse.  The NFF background is the `background` of the scene's
    RenderConfig (the CLI takes it from the file)."""
    s = spd.parse(nff(size))
    return s.geom, s.lights, s.cam


if __name__ == "__main__":
    import sys
    sys.stdout.write(nff(int(sys.argv[1]) if len(sys.argv) > 1 else 5))
