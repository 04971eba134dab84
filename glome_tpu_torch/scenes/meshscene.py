"""Procedural large-mesh benchmark scene (BASELINE.json config 4: a
~100k-triangle shared-vertex mesh under a BVH, smooth normals).

A displaced lat-long sphere ("asteroid"): shared vertex/normal arrays,
per-vertex normals accumulated from face normals the way mesh viewers
do, over a ground plane with one key light.  Mirrors the reference's
Mesh capability (GlomeTrace/Data/Glome/Mesh.hs:27-42: vectors of verts,
norms, Tri index records) at benchmark scale.
"""

from __future__ import annotations

import numpy as np

from .. import solids as S
from ..materials import Surface, Uniform, light
from ..render import camera


def _displaced_sphere(rows: int, cols: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    # low-frequency displacement from a few random spherical harmonics
    nwave = 6
    freqs = rng.randint(1, 5, size=(nwave, 2))
    phases = rng.uniform(0, 2 * np.pi, size=(nwave, 2))
    amps = rng.uniform(0.03, 0.12, size=nwave)

    th = np.linspace(1e-3, np.pi - 1e-3, rows)          # polar
    ph = np.linspace(0, 2 * np.pi, cols, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = np.ones_like(T)
    for k in range(nwave):
        r += amps[k] * np.sin(freqs[k, 0] * T + phases[k, 0]) \
            * np.cos(freqs[k, 1] * P + phases[k, 1])
    x = r * np.sin(T) * np.cos(P)
    y = r * np.cos(T)
    z = r * np.sin(T) * np.sin(P)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)

    def vid(i, j):
        return i * cols + (j % cols)

    tris = []
    for i in range(rows - 1):
        for j in range(cols):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            tris.append((a, b, c))
            tris.append((b, d, c))
    tris = np.asarray(tris, dtype=np.int32)

    # per-vertex normals: accumulate area-weighted face normals
    p0, p1, p2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    norms = np.zeros_like(verts)
    for k in range(3):
        np.add.at(norms, tris[:, k], fn)
    norms /= np.maximum(np.linalg.norm(norms, axis=-1, keepdims=True), 1e-12)
    return verts, norms, tris


def mesh_scene(n_tris: int = 100_000, seed: int = 0,
               cast_shadows: bool = False):
    """(solid, lights, camera) with ~n_tris smooth-shaded triangles.

    cast_shadows=True enables mesh self-shadowing (the honest version
    of the 1080p bench row; the default keeps the reference's
    Mesh.hs:210 no-shadow quirk)."""
    cols = max(8, int(np.sqrt(n_tris / 2.0)))
    rows = max(3, n_tris // (2 * cols) + 1)
    verts, norms, tris = _displaced_sphere(rows, cols, seed)
    T = tris.shape[0]
    rows8 = np.concatenate(
        [tris, tris, np.zeros((T, 1), np.int32),
         np.full((T, 1), -1, np.int32)], axis=1)  # n-idx == v-idx, tex 0
    rock = Uniform(Surface(color=(0.55, 0.5, 0.45), ambient=0.15, kd=0.75,
                           ks=0.25, shine=20.0))
    ground = Uniform(Surface(color=(0.25, 0.33, 0.25), ambient=0.2, kd=0.8))
    solid = S.group([
        S.mesh(verts, norms, rows8, textures=(rock,),
               cast_shadows=cast_shadows),
        S.tex(S.plane((0, -1.4, 0), (0, 1, 0)), ground),
    ])
    lights = (light((4.0, 6.0, -4.0), (45.0, 45.0, 42.0)),
              light((-5.0, 3.0, 3.0), (12.0, 13.0, 16.0)))
    cam = camera((0.0, 1.2, -3.4), (0, 0, 0), (0, 1, 0), 45)
    return solid, lights, cam
