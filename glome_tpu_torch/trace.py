"""Whitted-style recursive tracer (torch).

The reference's per-pixel recursion (Trace.hs:59-82 + Shader.hs:65-184)
becomes a tree of batched passes, as in glome_tpu/trace.py:

  trace(rays, recurs):
    hit   = intersect(batch)                    # one batched pass
    child = portal frame traces, then ONE union batch per (target
            scene, light set) of the reflection / per-material
            refraction / portal-target rays, compacted to the active
            rays and traced at recurs - 1
    color = layered texture fold (cafold, Clr.hs:106) over the hit's
            texture stack, shading each layer's material tree with the
            light and child-trace results

Recursion budget as in the reference: trace at recurs == 0 returns the
transparent miss (Trace.hs:60); children always get recurs - 1
(Shader.hs:107-175).  Every queue is compacted EXACTLY (torch.nonzero),
so nothing is dropped and TraceResult.overflow stays None; an empty
batch is not traced.  trace_wavefront.WavefrontTracer runs the same
recursion as per-level queues and shares this module's static tables,
light packing and texture fold.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import color as C
from . import megakernel as MK
from .compile import CompiledScene, TAG_DEPTH, TEX_DEPTH
from .config import DELTA, INFINITY, RenderConfig
from .graphs import COMPILED, EAGER, check_frame
from .intersect import (MEGA, Hit, check_route, intersect,
                        intersect_multi_table, shadow_query,
                        shadow_query_table)
from .materials import (AdditiveLayers, Blend, BlendFn, Light, Material,
                        Reflect, Refract, Surface, Uniform, Warp)
from .vec import (bisect, const, reflect as vreflect, vdot, vnorm,
                  vscaleadd)


class TraceResult(NamedTuple):
    color: torch.Tensor      # (N, 4) ColorA
    t: torch.Tensor          # (N,) hit depth (INFINITY = miss)
    tag_stack: torch.Tensor  # (N, TAG_DEPTH)
    prim_serial: torch.Tensor
    # (K,) int32 rays dropped by each capped queue segment.  The port's
    # queues are compacted exactly, so this is all zeros; it stays for
    # the API glome_tpu's callers check.
    overflow: Optional[torch.Tensor] = None


# --- compaction helpers ---------------------------------------------------
#
# glome_tpu pads each queue to a static capacity and drops what does not
# fit; the port compacts exactly.  gather and scatter are out of place, so
# autograd flows through them.

def compact_ranks(mask):
    """Rank of each element among the True entries (0-based; valid
    only where mask)."""
    return torch.cumsum(mask.to(torch.int64), 0) - 1


def compact_indices(mask, cap: Optional[int] = None):
    """Indices of the True entries of mask, in order.  `cap`, glome_tpu's
    static capacity, is here the exact count where given."""
    idx = torch.nonzero(mask)[:, 0]
    if cap is not None and cap != idx.numel():
        raise ValueError(f"compact_indices: {idx.numel()} entries, "
                         f"cap {cap} (the port's queues are exact)")
    return idx


def gather(arr, idx):
    return arr.index_select(0, idx)


def scatter(template, idx, vals):
    """template with rows idx set to vals."""
    return template.index_copy(0, idx, vals)


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

def _spawns_child(m: Material) -> bool:
    """Whether material m reaches a Reflect or Refract (a reflected or
    refracted child ray)."""
    if isinstance(m, (Reflect, Refract)):
        return True
    if isinstance(m, AdditiveLayers):
        return any(_spawns_child(s) for s in m.layers)
    if isinstance(m, Blend):
        return _spawns_child(m.m1) or _spawns_child(m.m2)
    return False


class Tracer:
    """The recursive trace program of one compiled scene.

    `route` names the intersection pipeline every intersect and shadow
    batch goes through: intersect.MEGA (K1, then K2/K3 for the groups too
    big for it) or intersect.GROUPS (the pass-per-group route: K4/K5 per
    group).  `select` names the kernel set: megakernel.KERNELS (the CUDA
    kernels on CUDA tensors, their plain versions on CPU tensors), or
    megakernel.PLAIN to run the plain versions on any device.  The
    device is that of the arrays and rays given to trace()."""

    def __init__(self, compiled: CompiledScene, config: RenderConfig = None,
                 select: str = MK.KERNELS, route: str = MEGA):
        MK.kernel_set(select)                 # rejects an unknown name
        check_route(route)
        self.compiled = compiled
        self.config = config or RenderConfig()
        self.select = select
        self.route = route
        # intersect and shadow batches of the last trace (each batch runs
        # every select pass of its route once; this tracer skips an empty
        # batch, the wavefront tracer counts every level's)
        self.last_batches = 0
        # static: per-texture id, which child traces its materials may need
        ntex = len(compiled.textures)
        self.tex_needs_reflect = np.zeros(ntex, dtype=bool)
        for tid, t in enumerate(compiled.textures):
            mats = ([t.material] if isinstance(t, Uniform) else [t.m1, t.m2])
            self.tex_needs_reflect[tid] = any(_spawns_child(m) for m in mats)
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
        ids = const(texids, tex_stack.dtype, tex_stack.device)
        return torch.any(tex_stack[..., None] == ids, dim=2).any(dim=1)

    # -- one batch through the route ----------------------------------------

    def _table(self, scene_id, o, d, tmax):
        """(8, N) ray table [o, d, tmax, sid] with a constant sid; o and
        d keep their gradient (finalize re-evaluates the winner from
        them)."""
        sid = torch.full_like(tmax, float(scene_id))
        return torch.cat([o.t(), d.t(), tmax[None], sid[None]], dim=0)

    def _intersect(self, arrays, scene_id, o, d, tmax) -> Hit:
        self.last_batches += 1
        if self.route == MEGA:
            return intersect_multi_table(
                self.compiled, arrays, self._table(scene_id, o, d, tmax),
                select=self.select, route=MEGA)
        return intersect(self.compiled, arrays, scene_id, o, d, tmax=tmax,
                         select=self.select)

    def _shadow(self, arrays, scene_id, o, d, tmax):
        self.last_batches += 1
        if self.route == MEGA:
            return shadow_query_table(
                self.compiled, arrays, self._table(scene_id, o, d, tmax),
                select=self.select, route=MEGA)
        return shadow_query(self.compiled, arrays, scene_id, o, d, tmax,
                            select=self.select)

    # -- main entry --------------------------------------------------------

    def trace(self, arrays, o, d, tmax=None, recurs: Optional[int] = None,
              scene_id: int = 0, lights: Optional[Tuple[Light, ...]] = None,
              frame: Optional[str] = None) -> TraceResult:
        """Trace N rays (o, d: (N, 3); tmax (N,) or None) in `scene_id`
        under `lights` (default: the root light set) with `recurs`
        levels (default config.maxdepth).  This tracer runs the eager
        frame only (`frame` None or graphs.EAGER); the compiled frame is
        WavefrontTracer's."""
        check_frame(frame or EAGER)
        if frame == COMPILED:
            raise NotImplementedError(
                "the recursive Tracer has no compiled frame "
                "(WavefrontTracer(frame=COMPILED) has)")
        if recurs is None:
            recurs = self.config.maxdepth
        if lights is None:
            lights = self.compiled.lights
        self.last_batches = 0
        return self._trace(arrays, scene_id, o, d, tmax, lights, recurs)

    def _trace(self, arrays, scene_id, o, d, tmax, lights, recurs
               ) -> TraceResult:
        N = o.shape[0]
        dt, dev = o.dtype, o.device
        if recurs == 0 or N == 0:
            # trace at depth 0 is a miss (Trace.hs:60); an empty batch
            # has nothing to trace
            return TraceResult(
                C.ca_transparent((N,), dt, dev),
                torch.full((N,), INFINITY, dtype=dt, device=dev),
                torch.full((N, TAG_DEPTH), -1, dtype=torch.int32,
                           device=dev),
                torch.full((N,), -1, dtype=torch.int32, device=dev))
        if tmax is None:
            tmax = torch.full((N,), INFINITY, dtype=dt, device=dev)

        hit = self._intersect(arrays, scene_id, o, d, tmax)
        eyedir = -d

        # ---- child traces (computed before shading, compacted) ----------
        children = {}
        if recurs > 1:
            children = self._trace_children(arrays, scene_id, o, d, hit,
                                            lights, recurs)

        # ---- preshade: per-light visibility and intensity ----------------
        # all lights' shadow rays are batched into ONE compacted shadow
        # query (the reference tests them one by one per hit,
        # Shader.hs:70-80)
        lpos, lcol, lrad = _light_arrays(self.compiled, arrays, lights)
        light_pre = []
        sh_segments = []
        sh_o = vscaleadd(hit.pos, hit.norm, DELTA)
        for li, l in enumerate(lights):
            lvec = lpos[li] - hit.pos
            llen = torch.sqrt(vdot(lvec, lvec))
            ldir = lvec / torch.clamp(llen, min=1e-20)[..., None]
            facing = vdot(lvec, hit.norm) >= 0.0
            in_range = llen <= lrad[li]
            active = hit.hit & facing & in_range
            light_pre.append((llen, ldir, active))
            if not l.shadow:
                continue
            idx = compact_indices(active)
            sh_segments.append((li, idx, gather(sh_o, idx),
                                gather(ldir, idx),
                                gather(llen - 2.0 * DELTA, idx)))
        blocked_by_light = {}
        n_sh = sum(s[1].numel() for s in sh_segments)
        if n_sh:
            sb = self._shadow(arrays, scene_id,
                              torch.cat([s[2] for s in sh_segments]),
                              torch.cat([s[3] for s in sh_segments]),
                              torch.cat([s[4] for s in sh_segments]))
            off = 0
            for li, idx, *_ in sh_segments:
                n_seg = idx.numel()
                blocked_by_light[li] = scatter(
                    torch.zeros((N,), dtype=torch.bool, device=dev), idx,
                    sb[off:off + n_seg])
                off += n_seg
        light_contribs = []
        for li, l in enumerate(lights):
            llen, ldir, active = light_pre[li]
            if li in blocked_by_light:
                active = active & ~blocked_by_light[li]
            falloff = l.falloff_at(llen)
            contrib = torch.where(active[:, None],
                                  lcol[li] * falloff[:, None],
                                  torch.zeros((), dtype=dt, device=dev))
            light_contribs.append((contrib, ldir, active))

        # ---- layered texture fold (Trace.hs:67-82) -----------------------
        ctx = dict(hit=hit, d=d, eyedir=eyedir, lights=light_contribs,
                   children=children, recurs=recurs)
        acc = self._fold_textures(ctx, hit, (N,), dt)
        return TraceResult(acc, hit.t, hit.tag_stack, hit.prim_serial)

    # -- secondary rays ----------------------------------------------------

    def _trace_children(self, arrays, scene_id, o, d, hit: Hit, lights,
                        recurs):
        """Secondary rays: every child ray targeting the same (scene,
        light set) is compacted and concatenated into ONE recursive trace
        per level -- reflection, each refraction material and portal
        target rays ride the same batch, so a level runs O(depth)
        intersect passes rather than O(children^depth)."""
        N = o.shape[0]
        dt, dev = o.dtype, o.device
        cc = self.compiled
        out = {}

        def blank_color():
            return torch.zeros((N, 4), dtype=dt, device=dev)

        def blank_t():
            return torch.full((N,), INFINITY, dtype=dt, device=dev)

        # ---- round 1: portal frame traces (their own mini-scenes) -------
        frame_results = {}
        for wi, w in enumerate(cc.warp_mats):
            active = hit.hit & self._stack_uses(hit.tex_stack,
                                                self.warp_texids[wi])
            idx = compact_indices(active)
            res = self._trace(arrays, w.frame_scene,
                              gather(hit.obj_o, idx), gather(hit.obj_d, idx),
                              None, lights, recurs - 1)
            fcolor = scatter(blank_color(), idx, res.color)
            ft = scatter(blank_t(), idx, res.t)
            frame_results[wi] = (active, fcolor, ft)

        # ---- round 2: same-scene children, one union batch per target ---
        specs = []  # (key, mask, o, d, tmax_or_None, scene, lights)
        if len(self.reflect_texids):
            needs_refl = self._stack_uses(hit.tex_stack, self.reflect_texids)
            outdir = vreflect(d, hit.norm)
            ro = vscaleadd(hit.pos, outdir, DELTA)
            specs.append(("reflect", hit.hit & needs_refl, ro, outdir, None,
                          scene_id, lights))

        tir_by_mat = {}
        for mi, m in enumerate(cc.refract_mats):
            active = hit.hit & self._stack_uses(hit.tex_stack,
                                                self.refract_texids[mi])
            n = hit.norm
            eta = torch.where(vdot(n, -d) > 0.0,
                              torch.full((N,), m.ior, dtype=dt, device=dev),
                              torch.full((N,), 1.0 / m.ior, dtype=dt,
                                         device=dev))
            c1 = vdot(d, n)
            cs2 = 1.0 - eta * eta * (1.0 - c1 * c1)
            tir = cs2 < 0.0
            tdir = d * eta[..., None] + n * (eta * c1 - torch.sqrt(
                torch.clamp(cs2, min=0.0)))[..., None]
            ro = vscaleadd(hit.pos, tdir, DELTA)
            tir_by_mat[mi] = (active, tir)
            specs.append((("refract", mi), active & ~tir, ro, tdir, None,
                          scene_id, lights))

        for wi, w in enumerate(cc.warp_mats):
            active, fcolor, ft = frame_results[wi]
            fwd = const(w.xfm.fwd, dt, dev)
            wo = torch.einsum('ij,nj->ni', fwd[:, :3], hit.pos) + fwd[:, 3]
            wd = vnorm(torch.einsum('ij,nj->ni', fwd[:, :3], vnorm(d)))
            specs.append((("warp_target", wi), active, wo, wd, ft,
                          w.target_scene, tuple(w.lights)))

        groups: Dict = {}
        for spec in specs:
            groups.setdefault((spec[5], spec[6]), []).append(spec)

        colors = {}
        ts = {}
        for (tscene, tlights), segs in groups.items():
            idxs, os_, ds_, tms = [], [], [], []
            for key, mask, co, cd, ctmax, _, _ in segs:
                idx = compact_indices(mask)
                idxs.append((key, idx))
                os_.append(gather(co, idx))
                ds_.append(gather(cd, idx))
                tms.append(torch.full((idx.numel(),), INFINITY, dtype=dt,
                                      device=dev)
                           if ctmax is None else gather(ctmax, idx))
            res = self._trace(arrays, tscene, torch.cat(os_),
                              torch.cat(ds_), torch.cat(tms), tlights,
                              recurs - 1)
            off = 0
            for key, idx in idxs:
                n_seg = idx.numel()
                colors[key] = scatter(blank_color(), idx,
                                      res.color[off:off + n_seg])
                ts[key] = scatter(blank_t(), idx, res.t[off:off + n_seg])
                off += n_seg

        if "reflect" in colors:
            out["reflect"] = colors["reflect"]
        for mi in range(len(cc.refract_mats)):
            key = ("refract", mi)
            active, tir = tir_by_mat[mi]
            # total internal reflection -> opaque black (Shader.hs:138-139)
            out[key] = torch.where((active & tir)[:, None],
                                   C.ca_black((N,), dt, dev), colors[key])
        for wi in range(len(cc.warp_mats)):
            _, fcolor, ft = frame_results[wi]
            key = ("warp_target", wi)
            out[("warp", wi)] = (fcolor, ft, colors[key], ts[key])
        return out

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
            bg = const(tuple(self.config.background) + (1.0,), dtype, dev)
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
            col = const(m.color, dt, dev)
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
