"""SPD `tetra`: Eric Haines' recursive tetrahedral pyramid, from the
Standard Procedural Databases ("A Proposal for Standard Graphics
Environments", IEEE CG&A 7(11), Nov. 1987; generator tetra.c), as the
NFF text tetra.c writes, read through the port's own NFF import
(spd.parse).

The text: the viewpoint (from 1.022846 -3.177154 -2.174261, at -0.004103
-0.004103 0.216539, up along the pyramid's apex, 45 degrees, 512x512),
the sky-blue background, one white light, the red diffuse fill, then the
leaf tetrahedra depth first, each as four `p 3` triangles.  The pyramid
starts from the regular tetrahedron on alternate corners of the cube
[-1, 1]^3, (1, 1, 1), (1, -1, -1), (-1, 1, -1) and (-1, -1, 1), the last
its apex; each subdivision replaces a tetrahedron by the four of half
its size at its corners, in corner order.  `levels` is the number of
subdivisions, tetra.c's SizeFactor less 1 (SizeFactor 1 is the one
tetrahedron, and SizeFactor s gives 4^s triangles): `levels`
subdivisions give 4^levels leaf tetrahedra and 4^(levels + 1)
triangles, 4,096 at SPD's default SizeFactor 6 (5 subdivisions) and
262,144 at SizeFactor 9 (8 subdivisions).  Each leaf's faces are wound so
that (p2 - p1) x (p3 - p1) points out of it; no face is left out.
Nothing here is read from tetra.c: the view and the light are recalled
from the published tetra.nff, and the fill, the starting tetrahedron's
placement, the counting of subdivisions and the faces' order and
winding are reconstructed from the published description.

Every vertex is a dyadic rational, written exactly (Python's shortest
round-trip repr), so the triangles are exactly the generator's.

    python -m glome_tpu_torch.scenes.spd_tetra [levels] > tetra.nff
    python -m glome_tpu_torch.app --scene tetra.nff --out tetra.png
"""

from __future__ import annotations

import numpy as np

from .. import spd

# the starting tetrahedron's vertices: alternate corners of [-1, 1]^3
CORNERS = np.array([[1.0, 1.0, 1.0], [1.0, -1.0, -1.0], [-1.0, 1.0, -1.0],
                    [-1.0, -1.0, 1.0]])
# each face's vertices, opposite vertex 0, 1, 2, 3 in turn, wound outward
FACES = ((1, 3, 2), (0, 2, 3), (0, 3, 1), (0, 1, 2))

HEADER = """v
from 1.022846 -3.177154 -2.174261
at -0.004103 -0.004103 0.216539
up -0.816497 -0.816497 0.816497
angle 45
hither 1
resolution 512 512
b 0.078 0.361 0.753
l 1.876617 -1.123283 -1.711729
f 1 0.2 0.2 0.8 0 0 0 0
"""


def triangles(levels: int = 8) -> np.ndarray:
    """The pyramid's triangles in tetra.c's output order, (4^(levels + 1),
    3, 3): each leaf tetrahedron's four faces, the leaves depth first."""
    centres, half = np.zeros((1, 3)), 1.0
    for _ in range(levels):
        half /= 2.0
        centres = (centres[:, None, :] + half * CORNERS[None]).reshape(-1, 3)
    verts = centres[:, None, :] + half * CORNERS[None]
    return verts[:, np.array(FACES)].reshape(-1, 3, 3)


def nff(levels: int = 8) -> str:
    """tetra.c's NFF text at `levels` subdivisions (SizeFactor
    `levels` + 1)."""
    lines = [HEADER]
    for tri in triangles(levels).tolist():
        lines.append("p 3\n")
        lines += [f"{x!r} {y!r} {z!r}\n" for x, y, z in tri]
    return "".join(lines)


def tetra(levels: int = 8):
    """(solid, lights, camera) of the pyramid at `levels` subdivisions
    (tetra.c's SizeFactor `levels` + 1), through spd.parse.  The NFF background is the `background` of the
    scene's RenderConfig (the CLI takes it from the file)."""
    s = spd.parse(nff(levels))
    return s.geom, s.lights, s.cam


if __name__ == "__main__":
    import sys
    sys.stdout.write(nff(int(sys.argv[1]) if len(sys.argv) > 1 else 8))
