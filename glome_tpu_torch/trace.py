"""Shading core of the Whitted tracer (torch).

The reference's per-pixel recursion (Trace.hs:59-82 + Shader.hs:65-184)
runs as per-level ray queues in trace_wavefront.WavefrontTracer; this
module holds what that tracer shares with glome_tpu's recursive
Tracer: the result record, the static per-texture tables, light
packing, and the layered texture fold over the material trees.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import color as C
from .compile import CompiledScene, TEX_DEPTH
from .config import DELTA, RenderConfig
from .intersect import Hit
from .materials import (AdditiveLayers, Blend, BlendFn, Light, Material,
                        Reflect, Refract, Surface, Uniform, Warp)
from .vec import bisect, vdot


class TraceResult(NamedTuple):
    color: torch.Tensor      # (N, 4) ColorA
    t: torch.Tensor          # (N,) hit depth (INFINITY = miss)
    tag_stack: torch.Tensor  # (N, TAG_DEPTH)
    prim_serial: torch.Tensor
    # (K,) int32 rays dropped by each capped queue segment.  The port's
    # queues are compacted exactly, so this is all zeros; it stays for
    # the API glome_tpu's callers check.
    overflow: Optional[torch.Tensor] = None


# --- light packing --------------------------------------------------------

def _light_arrays(compiled: CompiledScene, arrays,
                  lights: Tuple[Light, ...]):
    """Root lights come from the differentiable arrays dict; any other
    (warp-scene) light set becomes constants."""
    if lights == compiled.lights:
        la = arrays["lights"]
        return la["pos"], la["color"], la["radius"]
    dev = arrays["lights"]["pos"].device
    pos = torch.tensor([l.pos for l in lights], dtype=torch.float32,
                       device=dev).reshape(-1, 3)
    col = torch.tensor([l.color for l in lights], dtype=torch.float32,
                       device=dev).reshape(-1, 3)
    rad = torch.tensor([l.radius for l in lights], dtype=torch.float32,
                       device=dev).reshape(-1)
    return pos, col, rad


# --- the tracer -----------------------------------------------------------

class Tracer:
    """Static shading tables of one compiled scene and the material
    evaluation over them."""

    def __init__(self, compiled: CompiledScene, config: RenderConfig = None):
        self.compiled = compiled
        self.config = config or RenderConfig()
        # static: per-texture id, which child traces its materials may need
        ntex = len(compiled.textures)
        self.tex_needs_reflect = np.zeros(ntex, dtype=bool)
        for tid, t in enumerate(compiled.textures):
            mats = ([t.material] if isinstance(t, Uniform) else [t.m1, t.m2])

            def visit(m):
                if isinstance(m, (Reflect, Refract)):
                    self.tex_needs_reflect[tid] = True
                elif isinstance(m, AdditiveLayers):
                    for s in m.layers:
                        visit(s)
                elif isinstance(m, Blend):
                    visit(m.m1)
                    visit(m.m2)
            for m in mats:
                visit(m)
        # texture ids that reference each refract/warp material
        self.refract_texids = [
            np.array([tid for tid in range(ntex)
                      if mi in compiled.tex_refracts[tid]], dtype=np.int32)
            for mi in range(len(compiled.refract_mats))]
        self.warp_texids = [
            np.array([tid for tid in range(ntex)
                      if wi in compiled.tex_warps[tid]], dtype=np.int32)
            for wi in range(len(compiled.warp_mats))]
        self.reflect_texids = np.where(self.tex_needs_reflect)[0].astype(
            np.int32)
        # static (layer, texture) occupancy: which texture ids can occur
        # on stack layer L of any hit (incl. post-retexture local
        # stacks).  The shading fold only evaluates/selects those.
        occ = [set() for _ in range(TEX_DEPTH)]
        for sc in compiled.scenes:
            for g in sc.groups:
                for stacks in (g.tex_stack, g.local_tex_stack):
                    for L in range(TEX_DEPTH):
                        occ[L].update(int(t) for t in
                                      np.unique(stacks[:, L]) if t >= 0)
        self.tex_layer_occ = [sorted(s) for s in occ]

    # -- static helpers ----------------------------------------------------

    def _stack_uses(self, tex_stack, texids: np.ndarray):
        """(N,) bool: does any layer of the hit's texture stack have an id
        in the static set `texids`."""
        if len(texids) == 0:
            return torch.zeros(tex_stack.shape[0], dtype=torch.bool,
                               device=tex_stack.device)
        ids = torch.as_tensor(texids, dtype=tex_stack.dtype,
                              device=tex_stack.device)
        return torch.any(tex_stack[..., None] == ids, dim=2).any(dim=1)

    def _fold_textures(self, ctx, hit, shape, dtype):
        """cafold alpha layering over the hit texture stacks
        (Trace.hs:67-82): each REACHABLE texture is evaluated once,
        then every occupied layer selects from those shared results."""
        dev = hit.pos.device
        tex_cols = {}
        for tid in sorted(set().union(*map(set, self.tex_layer_occ))):
            tex_cols[tid] = self._eval_texture(
                self.compiled.textures[tid], ctx)
        acc = C.ca_transparent(shape, dtype, dev)
        for layer in range(TEX_DEPTH):
            tids_here = self.tex_layer_occ[layer]
            if not tids_here:
                continue
            tids = hit.tex_stack[:, layer]
            layer_color = C.ca_transparent(shape, dtype, dev)
            for tid in tids_here:
                layer_color = torch.where((tids == tid)[:, None],
                                          tex_cols[tid], layer_color)
            has = (tids >= 0) & hit.hit
            opaque = acc[..., 3] + DELTA >= 1.0
            folded = C.cafold(acc, layer_color)
            acc = torch.where((has & ~opaque)[:, None], folded, acc)
        if self.config.background is not None:
            # missshade (Trace.hs:44): rays that hit nothing take the
            # shader's miss color; applies at every bounce level (but
            # NOT at the recursion floor, which is traceMiss)
            bg = torch.tensor(tuple(self.config.background) + (1.0,),
                              dtype=dtype, device=dev)
            acc = torch.where(hit.hit[:, None], acc, bg)
        return acc

    # -- material evaluation (recursive over the static material tree) ----

    def _eval_texture(self, tex, ctx):
        if isinstance(tex, Uniform):
            return self._eval_material(tex.material, ctx)
        if isinstance(tex, BlendFn):
            w = tex.field(ctx["hit"].pos)
            return C.caweight(self._eval_material(tex.m1, ctx),
                              self._eval_material(tex.m2, ctx), w)
        raise TypeError(type(tex))

    def _eval_material(self, m: Material, ctx):
        hit: Hit = ctx["hit"]
        N = hit.t.shape[0]
        dt = hit.pos.dtype
        dev = hit.pos.device
        if isinstance(m, Surface):
            col = torch.tensor(m.color, dtype=dt, device=dev)
            ambient = col * m.ambient
            direct = torch.zeros((N, 3), dtype=dt, device=dev)
            for contrib, ldir, active in ctx["lights"]:
                half = bisect(ldir, ctx["eyedir"])
                ldotn = torch.clamp(vdot(ldir, hit.norm), min=0.0)
                if m.ks <= DELTA:
                    blinn = 0.0
                else:
                    hb = vdot(half, hit.norm)
                    blinn = torch.where(
                        hb > 0.0,
                        torch.pow(torch.clamp(hb, min=1e-30), m.shine)
                        * ldotn,
                        torch.zeros_like(hb))
                    blinn = torch.clamp(blinn, min=0.0)
                diffuse = vdot(ldir, hit.norm)
                w = blinn * m.ks + diffuse * m.kd
                direct = direct + contrib * w[:, None]
            if self.config.modulate_diffuse:
                rgb = col * (m.ambient + 0.0) + direct * col
            else:
                rgb = ambient + direct
            a = torch.full((N, 1), m.alpha, dtype=dt, device=dev)
            return torch.cat([rgb, a], dim=-1)

        if isinstance(m, Reflect):
            # Shader.hs:107-118: refl <= 0 gives opaque black; otherwise
            # the child trace's color with alpha scaled -- which at the
            # recursion floor is the transparent miss (Trace.hs:60)
            if m.amount <= 0:
                return C.ca_black((N,), dt, dev)
            c = ctx["children"].get("reflect")
            if c is None:
                c = C.ca_transparent((N,), dt, dev)
            return torch.cat([c[..., :3], c[..., 3:] * m.amount], dim=-1)

        if isinstance(m, Refract):
            if ctx["recurs"] > 1 and (m.refl > 0 or m.refr > 0):
                mi = self.compiled.refract_mats.index(m)
                refr = ctx["children"].get(("refract", mi))
                refl = ctx["children"].get("reflect")
                if refl is None:
                    refl = C.ca_transparent((N,), dt, dev)
                return refl * m.refl + refr * m.refr
            return C.ca_transparent((N,), dt, dev)

        if isinstance(m, Warp):
            for wi, w in enumerate(self.compiled.warp_mats):
                if w.material is m:
                    break
            key = ("warp", wi)
            if ctx["recurs"] > 1 and key in ctx["children"]:
                fcolor, ft, wcolor, wt = ctx["children"][key]
                return torch.where((ft < wt)[:, None], fcolor, wcolor)
            return C.ca_transparent((N,), dt, dev)

        if isinstance(m, AdditiveLayers):
            return C.casum([self._eval_material(s, ctx) for s in m.layers])

        if isinstance(m, Blend):
            return C.caweight(self._eval_material(m.m1, ctx),
                              self._eval_material(m.m2, ctx), m.weight)
        raise TypeError(type(m))
