"""Wavefront tracer: the Whitted recursion as per-level ray queues.

Same semantics as glome_tpu/trace_wavefront.py, restructured the same
way:

  DOWN:  for each depth level, one multi-scene intersect of the queue
         (rays carry a scene id, so portal-frame and portal-target rays
         ride the same batch as reflection/refraction rays), one fused
         shadow pass over every light, then child rays are compacted
         into segments [reflect | refract_m | warp_frame_w |
         warp_target_w] forming the NEXT level's queue.
  UP:    shading runs deepest-first; each level folds its texture
         stacks (cafold) using the child colors read back from the
         next level's queue segments.  The deepest level's children are
         the transparent miss -- exactly trace at recursion 0
         (Trace.hs:60).

Queues are (8, N) float32 ray tables [ox,oy,oz,dx,dy,dz,tmax,sid].
Where glome_tpu sizes its queues by static capacity schedules in
128-lane rows (and counts the rays it drops), the port compacts every
segment EXACTLY (torch.nonzero), so nothing is dropped:
TraceResult.overflow is all zeros and RenderConfig's capacity knobs are
accepted and ignored.

Constraint: all light sets must equal the root set (true for the
TestScene portal, TestScene.hs:179).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import color as C
from . import megakernel as MK
from .compile import CompiledScene
from .config import DELTA, INFINITY, RenderConfig
from .intersect import Hit, intersect_multi_table, shadow_query_table
from .trace import TraceResult, Tracer, _light_arrays
from .vec import vnorm


def _nz(mask):
    return torch.nonzero(mask)[:, 0]


def shadow_rays(hit, sid, lights, lpos, lrad):
    """Preshade of one level (Shader.hs:65-80): per light the distance,
    direction and activity of every lane, and ONE fused shadow batch of
    the active lanes of every shadow-casting light.  Returns
    (light_pre, segments, table): light_pre[li] = [llen, (ldx, ldy,
    ldz), active]; segments = [(li, lane indices)] in table order;
    table = the (8, n) shadow rays (detached; tmax = llen - 2 DELTA)."""
    px, py, pz = hit.pos[:, 0], hit.pos[:, 1], hit.pos[:, 2]
    nx, ny, nz = hit.norm[:, 0], hit.norm[:, 1], hit.norm[:, 2]
    sox = px + nx * DELTA
    soy = py + ny * DELTA
    soz = pz + nz * DELTA
    light_pre = []
    segments = []
    rows = []
    for li, l in enumerate(lights):
        lvx = lpos[li, 0] - px
        lvy = lpos[li, 1] - py
        lvz = lpos[li, 2] - pz
        llen = torch.sqrt(lvx * lvx + lvy * lvy + lvz * lvz)
        lsafe = torch.clamp(llen, min=1e-20)
        ldx, ldy, ldz = lvx / lsafe, lvy / lsafe, lvz / lsafe
        facing = (lvx * nx + lvy * ny + lvz * nz) >= 0.0
        active = hit.hit & facing & (llen <= lrad[li])
        light_pre.append([llen, (ldx, ldy, ldz), active])
        if not l.shadow:
            continue
        idx = _nz(active)
        segments.append((li, idx))
        rows.append(torch.stack([sox[idx], soy[idx], soz[idx],
                                 ldx[idx], ldy[idx], ldz[idx],
                                 llen[idx] - 2.0 * DELTA, sid[idx]]))
    table = (torch.cat(rows, dim=1).detach() if rows else
             torch.zeros((8, 0), dtype=hit.pos.dtype, device=hit.pos.device))
    return light_pre, segments, table


class WavefrontTracer(Tracer):
    """Per-level-queue tracer for the root scene with default lights.

    `select` is the K1 entry every intersect and shadow batch goes
    through: megakernel.mega_select (the CUDA kernel on CUDA tensors,
    its plain version on CPU tensors), or megakernel.mega_select_plain
    to run the plain version on any device."""

    def __init__(self, compiled: CompiledScene, config: RenderConfig = None,
                 select=MK.mega_select):
        super().__init__(compiled, config)
        for w in compiled.warp_mats:
            if tuple(w.lights) != tuple(compiled.lights):
                raise NotImplementedError(
                    "wavefront tracer requires a single light set")
        self.select = select

    def _segments(self):
        """Child-queue segment keys, in queue order."""
        cc = self.compiled
        keys = []
        if len(self.reflect_texids):
            keys.append("reflect")
        keys += [f"refract_{mi}" for mi in range(len(cc.refract_mats))]
        for wi in range(len(cc.warp_mats)):
            keys += [f"warp_frame_{wi}", f"warp_target_{wi}"]
        return keys

    # -- one DOWN level ------------------------------------------------------

    def _down_level(self, arrays, Q, lights, lpos, lcol, lrad, last):
        """Intersect + preshade one level's queue; spawn the children
        into the next level's queue (none at the deepest level).
        Returns (child queue, stored shading inputs)."""
        cc = self.compiled
        dt = Q.dtype
        dev = Q.device
        Qc = Q.shape[1]
        hit = intersect_multi_table(cc, arrays, Q, select=self.select)

        cdx, cdy, cdz = Q[3], Q[4], Q[5]
        sidf = Q[7]
        px, py, pz = hit.pos[:, 0], hit.pos[:, 1], hit.pos[:, 2]
        nx, ny, nz = hit.norm[:, 0], hit.norm[:, 1], hit.norm[:, 2]
        light_pre, sh_segments, table = shadow_rays(hit, sidf, lights,
                                                    lpos, lrad)
        if sh_segments:
            blocked = shadow_query_table(cc, arrays, table,
                                         select=self.select)
            off = 0
            for li, idx in sh_segments:
                b = torch.zeros(Qc, dtype=torch.bool, device=dev)
                b[idx] = blocked[off:off + idx.numel()]
                off += idx.numel()
                light_pre[li][2] = light_pre[li][2] & ~b
        if light_pre:
            contrib = torch.stack(
                [torch.where(a[:, None],
                             lcol[li] * lights[li].falloff_at(ll)[:, None],
                             torch.zeros((), dtype=dt, device=dev))
                 for li, (ll, ld, a) in enumerate(light_pre)])
            ldirs = torch.stack(
                [torch.stack(ld, dim=-1) for ll, ld, a in light_pre])
            lactive = torch.stack([a for ll, ld, a in light_pre])
        else:
            contrib = torch.zeros((0, Qc, 3), dtype=dt, device=dev)
            ldirs = torch.zeros((0, Qc, 3), dtype=dt, device=dev)
            lactive = torch.zeros((0, Qc), dtype=torch.bool, device=dev)

        # ---- spawn children into exactly compacted segments ---------
        child = []          # (key, idx, (8, n_seg) rays)
        stored_mask = {}
        stored_extra = {}
        for key in self._segments():
            if key == "reflect":
                mask = hit.hit & self._stack_uses(hit.tex_stack,
                                                  self.reflect_texids)
                ddn = cdx * nx + cdy * ny + cdz * nz
                rdx = cdx - 2.0 * ddn * nx
                rdy = cdy - 2.0 * ddn * ny
                rdz = cdz - 2.0 * ddn * nz
                rox = px + rdx * DELTA
                roy = py + rdy * DELTA
                roz = pz + rdz * DELTA
                rsid = sidf
            elif key.startswith("refract_"):
                mi = int(key.split("_")[-1])
                m = cc.refract_mats[mi]
                active = hit.hit & self._stack_uses(
                    hit.tex_stack, self.refract_texids[mi])
                ndd = nx * cdx + ny * cdy + nz * cdz
                eta = torch.where(-ndd > 0.0,
                                  torch.full_like(ndd, m.ior),
                                  torch.full_like(ndd, 1.0 / m.ior))
                c1 = ndd
                cs2 = 1.0 - eta * eta * (1.0 - c1 * c1)
                tir = cs2 < 0.0
                coef = eta * c1 - torch.sqrt(torch.clamp(cs2, min=0.0))
                rdx = cdx * eta + nx * coef
                rdy = cdy * eta + ny * coef
                rdz = cdz * eta + nz * coef
                stored_extra[f"refract_active_{mi}"] = active
                stored_extra[f"refract_tir_{mi}"] = tir
                mask = active & ~tir
                rox = px + rdx * DELTA
                roy = py + rdy * DELTA
                roz = pz + rdz * DELTA
                rsid = sidf
            elif key.startswith("warp_frame_"):
                wi = int(key.split("_")[-1])
                active = hit.hit & self._stack_uses(
                    hit.tex_stack, self.warp_texids[wi])
                stored_extra[f"warp_active_{wi}"] = active
                mask = active
                rox, roy, roz = (hit.obj_o[:, 0], hit.obj_o[:, 1],
                                 hit.obj_o[:, 2])
                rdx, rdy, rdz = (hit.obj_d[:, 0], hit.obj_d[:, 1],
                                 hit.obj_d[:, 2])
                rsid = torch.full((Qc,), float(cc.warp_mats[wi].frame_scene),
                                  dtype=dt, device=dev)
            else:  # warp_target
                wi = int(key.split("_")[-1])
                w = cc.warp_mats[wi]
                mask = stored_extra[f"warp_active_{wi}"]
                # expression shapes as in glome_tpu (einsum over stacked
                # (N,3), vnorm before AND after the matrix): the portal
                # view is boundary-dense, so even op-order differences
                # here flip many pixels
                fwd = torch.as_tensor(np.asarray(w.xfm.fwd), dtype=dt,
                                      device=dev)
                pos3 = torch.stack([px, py, pz], dim=-1)
                d3 = torch.stack([cdx, cdy, cdz], dim=-1)
                ro3 = torch.einsum('ij,nj->ni', fwd[:, :3], pos3) + fwd[:, 3]
                rd3 = vnorm(torch.einsum('ij,nj->ni', fwd[:, :3],
                                         vnorm(d3)))
                rox, roy, roz = ro3[:, 0], ro3[:, 1], ro3[:, 2]
                rdx, rdy, rdz = rd3[:, 0], rd3[:, 1], rd3[:, 2]
                rsid = torch.full((Qc,), float(w.target_scene), dtype=dt,
                                  device=dev)
            stored_mask[key] = mask
            if last:
                # deepest level: children are never traced (their color
                # is the transparent miss, Trace.hs:60)
                continue
            idx = _nz(mask)
            rows = torch.stack([rox[idx], roy[idx], roz[idx],
                                rdx[idx], rdy[idx], rdz[idx],
                                torch.full((idx.numel(),), INFINITY,
                                           dtype=dt, device=dev),
                                rsid[idx]])
            child.append((key, idx, rows))

        if last or not child:
            Qnext = torch.zeros((8, 0), dtype=dt, device=dev)
        else:
            Qnext = torch.cat([r for _k, _i, r in child], dim=1)
        stored = dict(
            t=hit.t, hitmask=hit.hit, pos=hit.pos, norm=hit.norm,
            d=torch.stack([cdx, cdy, cdz], dim=-1),
            tex=hit.tex_stack, tag=hit.tag_stack,
            serial=hit.prim_serial,
            contrib=contrib, ldirs=ldirs, lactive=lactive,
            child=[(k, i) for k, i, _r in child],
            mask=stored_mask, extra=stored_extra,
        )
        return Qnext, stored

    # -- one UP level ----------------------------------------------------

    def _up_level(self, stored, color_next, t_next, lights):
        Qc = stored["t"].shape[0]
        dt = stored["pos"].dtype
        dev = stored["pos"].device
        L = len(lights)
        children = {}
        seg = {}
        off = 0
        for key, idx in stored["child"]:
            seg[key] = (idx, off)
            off += idx.numel()
        for key in self._segments():
            if key in seg:
                idx, o0 = seg[key]
                n = idx.numel()
                ccol = torch.zeros((Qc, 4), dtype=dt, device=dev)
                ccol = ccol.index_copy(0, idx, color_next[o0:o0 + n])
                ct = torch.full((Qc,), INFINITY, dtype=dt, device=dev)
                ct = ct.index_copy(0, idx, t_next[o0:o0 + n])
            else:
                # deepest level: every child is the transparent miss
                ccol = C.ca_transparent((Qc,), dt, dev)
                ct = torch.full((Qc,), INFINITY, dtype=dt, device=dev)
            if key == "reflect":
                children["reflect"] = ccol
            elif key.startswith("refract_"):
                mi = int(key.split("_")[-1])
                active = stored["extra"][f"refract_active_{mi}"]
                tir = stored["extra"][f"refract_tir_{mi}"]
                ccol = torch.where((active & tir)[:, None],
                                   C.ca_black((Qc,), dt, dev), ccol)
                children[("refract", mi)] = ccol
            elif key.startswith("warp_frame_"):
                children[("warp_frame", int(key.split("_")[-1]))] = (ccol, ct)
            else:
                wi = int(key.split("_")[-1])
                fcol, ft = children.pop(("warp_frame", wi))
                children[("warp", wi)] = (fcol, ft, ccol, ct)

        hit = Hit(t=stored["t"], hit=stored["hitmask"],
                  pos=stored["pos"], norm=stored["norm"],
                  obj_o=stored["pos"], obj_d=stored["d"],
                  tex_stack=stored["tex"], tag_stack=stored["tag"],
                  prim_serial=stored["serial"])
        light_contribs = [
            (stored["contrib"][li], stored["ldirs"][li],
             stored["lactive"][li]) for li in range(L)]
        ctx = dict(hit=hit, d=stored["d"], eyedir=-stored["d"],
                   lights=light_contribs, children=children,
                   recurs=2)  # children present; eval uses them
        acc = self._fold_textures(ctx, hit, (Qc,), dt)
        return acc, stored["t"]

    # -- the full trace ----------------------------------------------------

    def trace(self, arrays, o, d, tmax=None, recurs: Optional[int] = None,
              scene_id: int = 0, lights=None) -> TraceResult:
        if recurs is None:
            recurs = self.config.maxdepth
        if lights is None:
            lights = self.compiled.lights
        if lights != self.compiled.lights:
            raise NotImplementedError("wavefront tracer traces the root "
                                      "light set only")
        N = o.shape[0]
        dt = o.dtype
        R = max(recurs, 1)
        lpos, lcol, lrad = _light_arrays(self.compiled, arrays, lights)
        if tmax is None:
            tmax = torch.full((N,), INFINITY, dtype=dt, device=o.device)
        Q = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                         d[:, 2], tmax,
                         torch.full((N,), float(scene_id), dtype=dt,
                                    device=o.device)])
        stored_levels = []
        for level in range(R):
            Q, stored = self._down_level(arrays, Q, lights, lpos, lcol,
                                         lrad, last=(level == R - 1))
            stored_levels.append(stored)

        color = C.ca_transparent((0,), dt, o.device)
        t = torch.zeros((0,), dtype=dt, device=o.device)
        for level in reversed(range(R)):
            color, t = self._up_level(stored_levels[level], color, t,
                                      lights)
        s0 = stored_levels[0]
        n_seg = len(self._segments())
        overflow = torch.zeros(R * (n_seg + len(lights)), dtype=torch.int32,
                               device=o.device)
        return TraceResult(color, s0["t"], s0["tag"], s0["serial"], overflow)
