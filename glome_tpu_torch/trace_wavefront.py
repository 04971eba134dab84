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
128-lane rows (and counts the rays it drops), the port drops nothing:
TraceResult.overflow is all zeros and RenderConfig's capacity knobs are
accepted and ignored.  Two frames run the levels (`frame=`):

  EAGER:     op by op from Python; every segment compacted to its exact
             size (torch.nonzero, a host sync per light and segment).
  COMPILED:  each level at a static width: level 0 at whole_rows(N),
             the caller's N rays rounded up to whole 128-lane rows (N
             is the same from frame to frame), every deeper level at
             bucket(n) >= its n rays; the live rays first, dead lanes
             (tmax 0, sid -1) after.  Every
             compaction is a device cumsum + scatter into a capacity that
             is exact by construction (a child segment can take all B
             lanes, the fused shadow batch L * B), and the level's one
             host read is its child counts, which size the next level.
             The next queue holds the live rays in the eager frame's
             order, so both frames give the same bits.  The select
             tables (megakernel.select_tables) are built once a trace
             call, where the eager frame builds them in every intersect
             and shadow batch.  On a CUDA device the table build and
             each level's down and up passes are captured once as CUDA
             graphs and replayed (graphs.py); on the CPU the same levels
             run eagerly.

Constraint: all light sets must equal the root set (true for the
TestScene portal, TestScene.hs:179); trace.Tracer renders a portal with
a light set of its own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import color as C
from . import graphs as G
from . import megakernel as MK
from . import telemetry
from .compile import CompiledScene
from .config import DELTA, INFINITY, RenderConfig
from .graphs import COMPILED, EAGER
from .intersect import (MEGA, Hit, intersect_multi_table,
                        shadow_query_table)
from .trace import TraceResult, Tracer, _light_arrays
from .vec import const, vnorm

LANES = 128          # a static width is a whole number of 128-lane rows


def _nz(mask):
    return torch.nonzero(mask)[:, 0]


def whole_rows(n: int) -> int:
    """The first level's static width: n rounded up to whole LANES-lane
    rows (at least one row).  Its n is the caller's frame size, so it
    needs no ladder."""
    return LANES * max(1, -(-n // LANES))


def bucket(n: int) -> int:
    """The static width of a level of n rays: the least rung >= n of the
    ladder LANES * m, m = 1, 2, 3, 4, 5, ... with each step
    m -> max(m + 1, floor(1.25 m)).  From m = 4 on a step is at most
    1.25x, so a level of more than 4 * LANES rays is padded by less
    than 25% of its rays (under 20% of the width); a smaller one by
    less than 4 * LANES lanes."""
    m = 1
    while LANES * m < n:
        m = max(m + 1, (m * 5) // 4)
    return LANES * m


def dead_table(n: int, dtype, device):
    """(8, n) ray table of dead lanes: o = d = 0, tmax 0, sid -1."""
    q = torch.zeros((8, n), dtype=dtype, device=device)
    q[7] = -1.0
    return q


def pack_static(dst, mask, cap: int):
    """Static-width compaction: each lane's slot in a queue of `cap`
    lanes, its rank among mask's True lanes plus `dst` (a device
    offset), or `cap` (the discard slot) where mask is False."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    return torch.where(mask, dst + rank, cap)


def shadow_rays(hit, sid, lights, lpos, lrad):
    """Preshade of one level (Shader.hs:65-80): per light the distance,
    direction and activity of every lane, and ONE fused shadow batch of
    the active lanes of every shadow-casting light.  Returns
    (light_pre, segments, table): light_pre[li] = [llen, (ldx, ldy,
    ldz), active]; segments = [(li, lane indices)] in table order;
    table = the (8, n) shadow rays (detached; tmax = llen - 2 DELTA)."""
    light_pre, (sox, soy, soz) = _light_terms(hit, lights, lpos, lrad)
    segments = []
    rows = []
    for li, l in enumerate(lights):
        if not l.shadow:
            continue
        llen, (ldx, ldy, ldz), active = light_pre[li]
        idx = _nz(active)
        segments.append((li, idx))
        rows.append(torch.stack([sox[idx], soy[idx], soz[idx],
                                 ldx[idx], ldy[idx], ldz[idx],
                                 llen[idx] - 2.0 * DELTA, sid[idx]]))
    table = (torch.cat(rows, dim=1).detach() if rows else
             torch.zeros((8, 0), dtype=hit.pos.dtype, device=hit.pos.device))
    return light_pre, segments, table


def _light_terms(hit, lights, lpos, lrad):
    """Per light, [llen, (ldx, ldy, ldz), active] of every lane, and the
    shadow rays' origins (sox, soy, soz)."""
    px, py, pz = hit.pos[:, 0], hit.pos[:, 1], hit.pos[:, 2]
    nx, ny, nz = hit.norm[:, 0], hit.norm[:, 1], hit.norm[:, 2]
    sox = px + nx * DELTA
    soy = py + ny * DELTA
    soz = pz + nz * DELTA
    light_pre = []
    for li, _l in enumerate(lights):
        lvx = lpos[li, 0] - px
        lvy = lpos[li, 1] - py
        lvz = lpos[li, 2] - pz
        llen = torch.sqrt(lvx * lvx + lvy * lvy + lvz * lvz)
        lsafe = torch.clamp(llen, min=1e-20)
        ldx, ldy, ldz = lvx / lsafe, lvy / lsafe, lvz / lsafe
        facing = (lvx * nx + lvy * ny + lvz * nz) >= 0.0
        active = hit.hit & facing & (llen <= lrad[li])
        light_pre.append([llen, (ldx, ldy, ldz), active])
    return light_pre, (sox, soy, soz)


def shadow_rays_static(hit, sid, lights, lpos, lrad):
    """shadow_rays at a static width B: light_pre as there; the fused
    shadow batch is an (8, L * B) table (L the shadow-casting lights)
    holding each light's active lanes packed one light after another, in
    shadow_rays' order, then dead lanes; slots = [(li, (B,) slot of each
    lane's shadow ray, valid where active)].  Returns (light_pre, slots,
    table)."""
    light_pre, (sox, soy, soz) = _light_terms(hit, lights, lpos, lrad)
    B = sid.shape[0]
    shadow = [li for li, l in enumerate(lights) if l.shadow]
    cap = len(shadow) * B
    dev = sid.device
    table = dead_table(cap + 1, hit.pos.dtype, dev)
    if not shadow:
        return light_pre, [], table[:, :0]
    counts = torch.stack([light_pre[li][2].sum() for li in shadow])
    offs = torch.cumsum(counts, 0) - counts
    slots = [(li, pack_static(offs[k], light_pre[li][2], cap))
             for k, li in enumerate(shadow)]
    rows = [torch.stack([sox, soy, soz, *light_pre[li][1],
                         light_pre[li][0] - 2.0 * DELTA, sid])
            for li in shadow]
    table.index_copy_(1, torch.cat([sl for _li, sl in slots]),
                      torch.cat(rows, dim=1).detach())
    return light_pre, slots, table[:, :cap].contiguous()


class WavefrontTracer(Tracer):
    """Per-level-queue tracer for the root scene with default lights.

    `route` names the intersection pipeline every intersect and shadow
    batch goes through: intersect.MEGA (K1, then K2/K3 for the groups too
    big for it) or intersect.GROUPS (glome_tpu's pass-per-group route:
    K4/K5 per group).  `select` names the kernel set: megakernel.KERNELS
    (the CUDA kernels on CUDA tensors, their plain versions on CPU
    tensors), or megakernel.PLAIN to run the plain versions on any
    device.  `frame` names how trace() runs the levels: graphs.COMPILED
    (static-width levels, captured as CUDA graphs on a CUDA device, run
    eagerly on the CPU) or graphs.EAGER (exact-size queues, op by op).
    The default is COMPILED on the megakernel route with the kernels,
    EAGER otherwise; a gradient needs EAGER.  trace(frame=...) overrides
    it for one call."""

    def __init__(self, compiled: CompiledScene, config: RenderConfig = None,
                 select: str = MK.KERNELS, route: str = MEGA,
                 frame: Optional[str] = None):
        super().__init__(compiled, config, select=select, route=route)
        for w in compiled.warp_mats:
            if tuple(w.lights) != tuple(compiled.lights):
                raise NotImplementedError(
                    "the wavefront tracer requires a single light set; "
                    "trace.Tracer renders a portal with its own lights")
        if frame is None:
            frame = (COMPILED if route == MEGA and select == MK.KERNELS
                     else EAGER)
        G.check_frame(frame)
        self.frame = frame
        self.graphs = G.GraphCache()
        # the last compiled frame's captures, replays, host reads and
        # level widths (graphs.FrameRun.stats)
        self.last_frame = {}

    @staticmethod
    def _record_launches(level, kind, lanes, live, launches):
        """telemetry.launch of a batch's K1 launch (`live` lanes) and of
        each of its K2 and K3 launches, which run the same lanes:
        `launches` holds their (kernel, live lanes), ints or pending()
        values."""
        telemetry.launch("k1", level, kind, lanes, live)
        for kernel, n in launches:
            telemetry.launch(kernel, level, kind, lanes, n)

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

    def _down_level(self, arrays, Q, lights, lpos, lcol, lrad, last,
                    static: bool = False, tables=None):
        """Intersect + preshade one level's queue; spawn the children
        into the next level's queue (none at the deepest level).
        Returns (child queue, stored shading inputs).  static=True runs
        the level at Q's static width (the compiled frame): the child
        queue is then (8, bucket(n_seg * width)) with its live rays
        first, and stored["counts"] holds the (n_seg,) child counts.
        `tables`: the trace call's megakernel.select_tables, which both
        batches read, or None to let each build its own."""
        cc = self.compiled
        dt = Q.dtype
        dev = Q.device
        Qc = Q.shape[1]
        # each K2 and K3 launch's (kernel, live lanes as a 0-d tensor),
        # per batch kind
        sel = {"intersect": [], "shadow": []}
        hit = intersect_multi_table(cc, arrays, Q, select=self.select,
                                    route=self.route,
                                    launches=sel["intersect"], tables=tables)
        self.last_batches += 1

        cdx, cdy, cdz = Q[3], Q[4], Q[5]
        sidf = Q[7]
        px, py, pz = hit.pos[:, 0], hit.pos[:, 1], hit.pos[:, 2]
        nx, ny, nz = hit.norm[:, 0], hit.norm[:, 1], hit.norm[:, 2]
        light_pre, sh_segments, table = (shadow_rays_static if static else
                                         shadow_rays)(hit, sidf, lights,
                                                      lpos, lrad)
        if static:
            # the shadow batch's live lanes, read with the child counts
            sh_live = (torch.stack([light_pre[li][2]
                                    for li, _s in sh_segments]).sum()
                       if sh_segments else
                       torch.zeros((), dtype=torch.int64, device=dev))
        if sh_segments:
            blocked = shadow_query_table(cc, arrays, table,
                                         select=self.select,
                                         route=self.route,
                                         launches=sel["shadow"],
                                         tables=tables)
            self.last_batches += 1
            off = 0
            for li, idx in sh_segments:
                if static:
                    # idx: each lane's slot in the batch
                    active = light_pre[li][2]
                    b = active & blocked[torch.clamp(idx,
                                                     max=table.shape[1] - 1)]
                else:
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

        # ---- spawn children into compacted segments -----------------
        child = []          # (key, idx, (8, n_seg) rays)
        spawned = []        # static: (mask, (8, Qc) rays) per segment
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
                fwd = const(w.xfm.fwd, dt, dev)
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
            if static:
                spawned.append((mask, torch.stack([
                    rox, roy, roz, rdx, rdy, rdz,
                    torch.full((Qc,), INFINITY, dtype=dt, device=dev),
                    rsid])))
                continue
            idx = _nz(mask)
            rows = torch.stack([rox[idx], roy[idx], roz[idx],
                                rdx[idx], rdy[idx], rdz[idx],
                                torch.full((idx.numel(),), INFINITY,
                                           dtype=dt, device=dev),
                                rsid[idx]])
            child.append((key, idx, rows))

        stored = dict(
            t=hit.t, hitmask=hit.hit, pos=hit.pos, norm=hit.norm,
            d=torch.stack([cdx, cdy, cdz], dim=-1),
            tex=hit.tex_stack, tag=hit.tag_stack,
            serial=hit.prim_serial,
            contrib=contrib, ldirs=ldirs, lactive=lactive,
            mask=stored_mask, extra=stored_extra,
        )
        if static:
            # read with the child counts: each K2 and K3 launch's live
            # lanes, intersect then shadow, and the shadow batch's
            stored["sel_kernels"] = tuple(tuple(k for k, _n in sel[kind])
                                          for kind in ("intersect", "shadow"))
            return self._spawn_static(
                spawned, Qc, dt, dev, stored,
                torch.stack([n for kind in ("intersect", "shadow")
                             for _k, n in sel[kind]] + [sh_live]))
        stored["shadow_lanes"] = table.shape[1] if sh_segments else None
        stored["launches"] = sel
        if last or not child:
            Qnext = torch.zeros((8, 0), dtype=dt, device=dev)
        else:
            Qnext = torch.cat([r for _k, _i, r in child], dim=1)
        stored["child"] = [(k, i) for k, i, _r in child]
        return Qnext, stored

    @staticmethod
    def _spawn_static(spawned, B, dt, dev, stored, lives):
        """The static level's child queue: every segment's rays scattered
        to (segment offset + rank) in a queue of bucket(n_seg * B) lanes,
        in the eager frame's order, dead lanes after.  stored gets the
        (n_seg,) counts, the (n_seg, B) source slot of each lane's child
        (valid where its mask is set), and "read": the counts then
        `lives`, the level's live-lane counts (the level's one host
        read)."""
        cap = bucket(len(spawned) * B)
        if not spawned:
            stored["counts"] = torch.zeros(0, dtype=torch.int64, device=dev)
            stored["read"] = lives
            return dead_table(cap, dt, dev), stored
        masks = torch.stack([m for m, _r in spawned])
        counts = masks.sum(dim=1)
        stored["read"] = torch.cat([counts, lives])
        offs = torch.cumsum(counts, 0) - counts
        slots = torch.stack([pack_static(offs[k], masks[k], cap)
                             for k in range(len(spawned))])
        Qnext = dead_table(cap + 1, dt, dev)
        Qnext.index_copy_(1, slots.reshape(-1),
                          torch.cat([r for _m, r in spawned], dim=1))
        stored["counts"] = counts
        stored["src"] = torch.where(masks, slots, 0)
        return Qnext[:, :cap], stored

    # -- one UP level ----------------------------------------------------

    def _up_level(self, stored, color_next, t_next, lights):
        Qc = stored["t"].shape[0]
        dt = stored["pos"].dtype
        dev = stored["pos"].device
        seg = {}
        off = 0
        for key, idx in stored["child"]:
            seg[key] = (idx, off)
            off += idx.numel()
        cols = {}
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
            cols[key] = (ccol, ct)
        return self._shade_level(stored, cols, lights)

    def _up_level_static(self, stored, color_next, t_next, lights):
        """_up_level at the static width: each lane's child colour is read
        at its source slot in the next level's queue.  color_next None:
        the deepest level, whose children are the transparent miss."""
        B = stored["t"].shape[0]
        dt = stored["pos"].dtype
        dev = stored["pos"].device
        cols = {}
        for k, key in enumerate(self._segments()):
            if color_next is None:
                ccol = C.ca_transparent((B,), dt, dev)
                ct = torch.full((B,), INFINITY, dtype=dt, device=dev)
            else:
                mask = stored["mask"][key]
                src = stored["src"][k]
                ccol = torch.where(mask[:, None], color_next[src],
                                   torch.zeros((), dtype=dt, device=dev))
                ct = torch.where(mask, t_next[src],
                                 torch.full((), INFINITY, dtype=dt,
                                            device=dev))
            cols[key] = (ccol, ct)
        return self._shade_level(stored, cols, lights)

    def _shade_level(self, stored, cols, lights):
        """Shade one level from its stored inputs and each child
        segment's (colour, t) per lane: (color, t)."""
        Qc = stored["t"].shape[0]
        dt = stored["pos"].dtype
        dev = stored["pos"].device
        L = len(lights)
        children = {}
        for key in self._segments():
            ccol, ct = cols[key]
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
              scene_id: int = 0, lights=None,
              frame: Optional[str] = None) -> TraceResult:
        """Trace N rays (o, d: (N, 3); tmax (N,) or None) from `scene_id`
        with `recurs` levels (default config.maxdepth) under the root
        light set, in `frame` (default self.frame).  The compiled frame
        raises when a gradient is asked of it (grad mode on and a scene
        tensor or ray that requires grad), on route=GROUPS, and when a
        capture or replay fails; it never carries on eagerly.  On CPU
        tensors it runs its static-width levels eagerly.  A call is the
        telemetry span wavefront.trace; each intersect and shadow batch
        is a telemetry.launch of "k1", one of "k2" per block group and
        one of "k3" per external group it runs (lanes launched, lanes
        live: for K2 and K3 those their seed keeps alive,
        megakernel._run_blocks and _run_external); the counter
        megakernel.table_packs is the call's builds of the select tables
        (megakernel.pack_tables.calls: one a batch in the eager frame,
        one a call in the compiled frame); the counters
        megakernel.finalize_fused and megakernel.finalize_torch are its
        intersect batches' launches of the fused finalize and calls of
        the torch finalize (megakernel.finalize.fused_calls and
        .torch_calls)."""
        with telemetry.span("wavefront.trace"):
            if recurs is None:
                recurs = self.config.maxdepth
            if lights is None:
                lights = self.compiled.lights
            if lights != self.compiled.lights:
                raise NotImplementedError(
                    "the wavefront tracer traces the root light set only; "
                    "trace.Tracer traces any light set")
            frame = self.frame if frame is None else frame
            G.check_frame(frame)
            N = o.shape[0]
            dt = o.dtype
            R = max(recurs, 1)
            if tmax is None:
                tmax = torch.full((N,), INFINITY, dtype=dt, device=o.device)
            self.last_batches = 0
            packs = MK.pack_tables.calls
            fused, unfused = (MK.finalize.fused_calls,
                              MK.finalize.torch_calls)
            res = (self._trace_compiled if frame == COMPILED
                   else self._trace_eager)(arrays, o, d, tmax, R, scene_id,
                                           lights)
            telemetry.count("megakernel.table_packs",
                            MK.pack_tables.calls - packs)
            telemetry.count("megakernel.finalize_fused",
                            MK.finalize.fused_calls - fused)
            telemetry.count("megakernel.finalize_torch",
                            MK.finalize.torch_calls - unfused)
            return res

    def _trace_eager(self, arrays, o, d, tmax, R, scene_id, lights):
        """The eager frame: exact-size queues, op by op."""
        N = o.shape[0]
        dt = o.dtype
        lpos, lcol, lrad = _light_arrays(self.compiled, arrays, lights)
        Q = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                         d[:, 2], tmax,
                         torch.full((N,), float(scene_id), dtype=dt,
                                    device=o.device)])
        stored_levels = []
        for level in range(R):
            lanes = Q.shape[1]
            Q, stored = self._down_level(arrays, Q, lights, lpos, lcol,
                                         lrad, last=(level == R - 1))
            stored_levels.append(stored)
            if self.route == MEGA:
                # exact queues: every lane launched holds a live ray
                # (K2's and K3's are those of the group's scene, and in a
                # shadow batch those K1 left unblocked)
                sel = {kind: [(k, telemetry.pending(n)) for k, n in v]
                       for kind, v in stored["launches"].items()}
                self._record_launches(level, "intersect", lanes, lanes,
                                      sel["intersect"])
                sh = stored["shadow_lanes"]
                if sh is not None:
                    self._record_launches(level, "shadow", sh, sh,
                                          sel["shadow"])

        color = C.ca_transparent((0,), dt, o.device)
        t = torch.zeros((0,), dtype=dt, device=o.device)
        for level in reversed(range(R)):
            color, t = self._up_level(stored_levels[level], color, t,
                                      lights)
        s0 = stored_levels[0]
        return TraceResult(color, s0["t"], s0["tag"], s0["serial"],
                           self._overflow(R, lights, o.device))

    def _overflow(self, R, lights, device):
        n_seg = len(self._segments())
        return torch.zeros(R * (n_seg + len(lights)), dtype=torch.int32,
                           device=device)

    def _trace_compiled(self, arrays, o, d, tmax, R, scene_id, lights):
        """The compiled frame: level 0 at width whole_rows(N), each deeper
        level at bucket(n), through the graph cache (graphs.FrameRun),
        one host read per level.  The first level's rays are copied into
        its segment's static buffer; every later segment reads the
        outputs of the segments before it where they lie."""
        if self.route != MEGA:
            raise ValueError("the compiled frame runs the megakernel route "
                             "only (route=GROUPS: frame=EAGER)")
        G.check_no_grad(arrays, (o, d, tmax))
        N = o.shape[0]
        dt, dev = o.dtype, o.device
        run = self.graphs.frame(dev, arrays)
        widths = []
        with torch.no_grad():
            B = whole_rows(N)
            # the select tables of every batch of the call, built once;
            # the down segments read them where they lie
            tables = run.run(("tables", B),
                             lambda: MK.select_tables(self.compiled, arrays),
                             ())
            flat_tables = tuple(G.tensors(tables))
            Q = dead_table(B, dt, dev)
            Q[0:3, :N] = o.t()
            Q[3:6, :N] = d.t()
            Q[6, :N] = tmax
            Q[7, :N] = float(scene_id)
            levels = []
            live = N
            n_shadow = sum(bool(l.shadow) for l in lights)
            for level in range(R):
                last = level == R - 1
                widths.append(B)

                def down(q, *tabs, last=last):
                    lpos, lcol, lrad = _light_arrays(self.compiled, arrays,
                                                     lights)
                    return self._down_level(arrays, q, lights, lpos, lcol,
                                            lrad, last, static=True,
                                            tables=G.unflatten(tables, tabs))
                # level 0's rays are the caller's: copied; a deeper level's
                # are the level above's static queue: read in place
                Qnext, stored = run.run(("down", level, B, last), down,
                                        *(((Q,), flat_tables) if level == 0
                                          else ((), (Q,) + flat_tables)))
                levels.append(stored)
                nc = stored["counts"].numel()
                ki, ks = stored["sel_kernels"]
                ni, ns = len(ki), len(ks)
                read = None
                if not last and nc:
                    # the level's one host read: its child counts and its
                    # K2, K3 and shadow batches' live lanes
                    with telemetry.span("wavefront.count_read"):
                        read = stored["read"].tolist()
                    run.count("host_reads")

                def lives(i, j, read=read, stored=stored):
                    # read[i:j]; a level with no read copies them without
                    # blocking, each resolved when the record is read
                    return (read[i:j] if read is not None else
                            [telemetry.pending(stored["read"][k:k + 1])
                             for k in range(i, j)])
                self._record_launches(level, "intersect", B, live,
                                      zip(ki, lives(nc, nc + ni)))
                if n_shadow:
                    k1 = nc + ni + ns
                    self._record_launches(level, "shadow", n_shadow * B,
                                          lives(k1, k1 + 1)[0],
                                          zip(ks, lives(nc + ni, k1)))
                if last:
                    break
                n = sum(read[:nc]) if read is not None else 0
                # a level of no rays still runs, all dead lanes, as the
                # eager frame runs its empty batches
                B = bucket(n)
                Q = Qnext[:, :B]
                live = n

            color = t = None
            for level in reversed(range(len(levels))):
                flat = G.tensors(levels[level])

                def up(*xs, level=level, n_flat=len(flat)):
                    st = G.unflatten(levels[level], xs[:n_flat])
                    nxt = xs[n_flat:] or (None, None)
                    return self._up_level_static(st, nxt[0], nxt[1], lights)
                nxt = () if color is None else (color, t)
                color, t = run.run(
                    ("up", level, widths[level],
                     widths[level + 1] if nxt else 0),
                    up, (), tuple(flat) + nxt)
            s0 = levels[0]
            res = TraceResult(color[:N].clone(), s0["t"][:N].clone(),
                              s0["tag"][:N].clone(),
                              s0["serial"][:N].clone(),
                              self._overflow(R, lights, dev))
        # one intersect batch per level run, and one shadow batch where a
        # light casts shadows (the Python of a replayed level never runs)
        self.last_batches = len(levels) * (
            1 + any(l.shadow for l in lights))
        self.last_frame = {**run.stats(), "widths": widths}
        for k, v in run.stats().items():
            telemetry.count("graphs." + k, v)
        return res

