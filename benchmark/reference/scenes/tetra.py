"""SPD `tetra`, the recursive tetrahedral pyramid (Haines, "A Proposal for
Standard Graphics Environments", IEEE CG&A 7(11), Nov. 1987; generator
tetra.c), the reference's own description, written from the published
description with the node types of benchmark/reference/scene.py.

A regular tetrahedron on alternate corners of the cube [-1, 1]^3:
(1, 1, 1), (1, -1, -1), (-1, 1, -1) and (-1, -1, 1), its apex.  A
subdivision keeps, at each vertex, the tetrahedron spanned by that
vertex and the midpoints of its three edges, vertex k's first, each with
its vertices in its parent's vertex order; the octahedron left in the
middle is empty.  After `levels` subdivisions (tetra.c's SizeFactor
`levels` + 1, whose 4^SizeFactor triangles are 4,096 at SPD's default
SizeFactor 6) each of the 4^levels tetrahedra is four triangles, NFF's
`p 3`: the face opposite each vertex in vertex order, wound so that its
flat normal points out of it.  One white light, the red diffuse fill,
the view along the apex.

The surface is an NFF fill as Glome's reader makes it (Spd.hs:138):
colour, alpha 1 - transmittance, no ambient, Kd, Ks, shine.
"""

from __future__ import annotations

from benchmark.reference.scene import (Group, Light, Tex, camera, surface,
                                       triangles)

APEX_UP = (-0.816497, -0.816497, 0.816497)
RED = ("uniform", surface((1.0, 0.2, 0.2), 1.0, 0.0, 0.8, 0.0, 0.0))

# the face opposite vertex 0, 1, 2, 3, its vertices in outward order
OUTWARD = ((1, 3, 2), (0, 2, 3), (0, 3, 1), (0, 1, 2))


def corner_tetrahedra(tet):
    """The four half-size tetrahedra at the corners of `tet` (four
    vertices), vertex 0's first."""
    mid = [[tuple((a + b) / 2.0 for a, b in zip(tet[i], tet[j]))
            for j in range(4)] for i in range(4)]
    return [[tet[i] if j == i else mid[i][j] for j in range(4)]
            for i in range(4)]


def pyramid(levels):
    """The leaf tetrahedra, depth first."""
    out = []

    def split(tet, left):
        if left == 0:
            out.append(tet)
            return
        for sub in corner_tetrahedra(tet):
            split(sub, left - 1)
    split([(1.0, 1.0, 1.0), (1.0, -1.0, -1.0), (-1.0, 1.0, -1.0),
           (-1.0, -1.0, 1.0)], levels)
    return out


def build(levels=8):
    tris = [tri for tet in pyramid(levels) for face in OUTWARD
            for tri in triangles([tet[k] for k in face])]
    root = Group([Tex(Group(tris), RED)])
    lights = (Light((1.876617, -1.123283, -1.711729), (1.0, 1.0, 1.0)),)
    return root, lights, camera((1.022846, -3.177154, -2.174261),
                                (-0.004103, -0.004103, 0.216539),
                                APEX_UP, 45.0)
