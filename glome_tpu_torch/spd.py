"""NFF (Neutral File Format) scene import.

Parser for Eric Haines' SPD benchmark scene format, matching the
grammar the reference supports (GlomeTrace/Data/Glome/Spd.hs:82-254):
viewpoint (v/from/at/up/angle/hither/resolution), background (b),
positional lights (l), fill material (f), spheres (s), cones/cylinders
(c), polygons (p) and polygon patches (pp).  Like the reference,
polygons become triangle fans (Spd.hs:172-178), each fill material
starts a textured group, and the result's geometry is wrapped for
acceleration (bih, Spd.hs:254).

A copy of glome_tpu/spd.py (numpy only) built on this package's solids,
materials and render.camera, because importing glome_tpu loads JAX."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from . import solids as S
from .materials import Light, Surface, Uniform, light
from .render import Camera, camera


@dataclasses.dataclass
class SPD:
    geom: object
    lights: Tuple[Light, ...]
    cam: Optional[Camera]
    background: Tuple[float, float, float]
    resolution: Optional[Tuple[int, int]] = None


class _Tokens:
    def __init__(self, text: str):
        toks = []
        for line in text.splitlines():
            line = line.split("#", 1)[0]
            toks.extend(line.split())
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def word(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def num(self):
        return float(self.word())

    def int_(self):
        return int(float(self.word()))

    def vec(self):
        return np.array([self.num(), self.num(), self.num()])


def parse(text: str) -> SPD:
    tk = _Tokens(text)
    cam: Optional[Camera] = None
    resolution = None
    lights: List[Light] = []
    background = (0.0, 0.0, 0.0)
    groups: List[object] = []
    cur_tex = None
    cur_prims: List[object] = []

    def flush():
        nonlocal cur_prims
        if cur_prims:
            g = S.bih(cur_prims)
            groups.append(S.tex(g, cur_tex) if cur_tex is not None else g)
            cur_prims = []

    while tk.peek() is not None:
        w = tk.word()
        if w == "v":
            # viewpoint block (Spd.hs:89-103)
            assert tk.word() == "from"
            frm = tk.vec()
            assert tk.word() == "at"
            at = tk.vec()
            assert tk.word() == "up"
            up = tk.vec()
            assert tk.word() == "angle"
            angle = tk.num()
            assert tk.word() == "hither"
            tk.num()
            assert tk.word() == "resolution"
            resolution = (tk.int_(), tk.int_())
            cam = camera(frm, at, up, angle)
        elif w == "b":
            background = (tk.num(), tk.num(), tk.num())
        elif w == "l":
            pos = tk.vec()
            # optional color (Spd.hs:126-132)
            nxt = tk.peek()
            if nxt is not None and _is_num(nxt):
                col = (tk.num(), tk.num(), tk.num())
            else:
                col = (1.0, 1.0, 1.0)
            lights.append(light(pos, col))
        elif w == "f":
            flush()
            clr = (tk.num(), tk.num(), tk.num())
            kd, ks, shine, trans, ior = (tk.num() for _ in range(5))
            # Surface clr (1-trans) 0 kd ks shine False (Spd.hs:138)
            cur_tex = Uniform(Surface(color=clr, alpha=1.0 - trans,
                                      ambient=0.0, kd=kd, ks=ks,
                                      shine=shine))
        elif w == "s":
            c = tk.vec()
            cur_prims.append(S.sphere(c, tk.num()))
        elif w == "c":
            p1 = tk.vec()
            r1 = tk.num()
            p2 = tk.vec()
            r2 = tk.num()
            cur_prims.append(S.cone(p1, r1, p2, r2))
        elif w == "p":
            n = tk.int_()
            verts = [tk.vec() for _ in range(n)]
            cur_prims.extend(S.triangles(verts))
        elif w == "pp":
            n = tk.int_()
            vns = [(tk.vec(), tk.vec()) for _ in range(n)]
            cur_prims.extend(S.trianglesnorms(vns))
        else:
            raise ValueError(f"unknown NFF directive {w!r}")

    flush()
    return SPD(geom=S.bih(groups) if groups else S.nothing(),
               lights=tuple(lights), cam=cam, background=background,
               resolution=resolution)


def _is_num(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def load(path: str) -> SPD:
    with open(path) as f:
        return parse(f.read())
