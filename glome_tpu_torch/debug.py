"""Work counters: rayint_debug / trace_debug parity (torch).

Port of glome_tpu/debug.py.  The reference threads a
primitives+boxes-visited count through every solid as a SEPARATE
typeclass method (rayint_debug, Solid.hs:155,205; Bih.hs:378-412) and
renders it as false color (Glome.hs:57-62).  `ray_debug_counts` replays
the compiled scene's intersection STRUCTURE as glome_tpu counts it --
dense groups, convex CSG members, deferred prims with their restricted
constraint scans (read from the megakernel plan's deferred phases), and
the tile-packet skip-link BVH traversal -- counting per ray:

  prims:  primitive intersection/inside evaluations performed
  nodes:  BVH node boxes slab-tested against the ray's tile

A dense group costs every ray its size; a BVH tile of TILE rays
advances into a node when ANY of its rays hits the node's box, and a
ray is charged for the boxes it hits and the leaf prims behind them.
These are glome_tpu's numbers, so the two packages' maps can be held
equal; they are not the work K1's own walk makes (its tallies,
`megakernel.mega_select(..., tally=)`, count a per-ray near-first walk).

The counters are torch code on the rays' device and launch no kernel;
`trace_debug_counts` runs the wavefront tracer's levels, whose
intersect and shadow batches go through the tracer's kernel set.
`python -m glome_tpu_torch.app --debug` renders prims into red and
nodes into green like the reference's get_color_debug.
"""

from __future__ import annotations

import numpy as np
import torch

from . import megakernel as MK
from .compile import group_accel
from .config import DELTA, INFINITY, RenderConfig
from .vec import vdot, vscaleadd

TILE = 256      # rays per traversal packet (glome_tpu/intersect.py:355)
CHECK_EVERY = 8  # walk steps between tests for the end of every tile


@torch.no_grad()
def ray_debug_counts(compiled, arrays, o, d, scene_id: int = 0,
                     tile: int = TILE):
    """(prims, nodes): (N,) int32 work counters for rays (o, d) in
    `scene_id`.  `arrays` is unused: the counts depend on the scene's
    structure and static BVH boxes only (as in glome_tpu)."""
    sc = compiled.scenes[scene_id]
    o = o.detach()
    d = d.detach()
    N = o.shape[0]
    prims = torch.zeros(N, dtype=torch.int32, device=o.device)
    nodes = torch.zeros(N, dtype=torch.int32, device=o.device)
    for gi, g in enumerate(sc.groups):
        if g.size == 0:
            continue
        if group_accel(g) is not None:
            p_add, n_add = _bvh_counts(sc, gi, o, d, tile)
            prims = prims + p_add
            nodes = nodes + n_add
        elif g.vclass in ("plain", "inline"):
            # dense lockstep: every prim is evaluated for every ray
            prims = prims + g.size
        elif g.vclass == "deferred":
            # candidate test + restricted other-clause membership scans
            scans = 0
            for ph in MK.get_plan(compiled).phases:
                if ph.kind == "deferred" and ph.si == scene_id \
                        and ph.gi == gi:
                    scans += 1 + sum(cm.M for _, ms in (ph.cons or [])
                                     for cm in ms)
                    scans += sum(cm.M for cm in (ph.own or []))
            prims = prims + scans
    for csg in sc.csgs:
        if csg.convex:
            prims = prims + sum(len(idx) for cl in csg.clauses
                                for _, idx in cl.members)
    return prims, nodes


def _bvh_counts(sc, gi, o, d, tile):
    """Per-ray (prims tested, node boxes hit) through the tile-packet
    skip-link traversal of group gi's BVH (compile.group_accel): the
    counting twin of glome_tpu's intersect.bvh_pass.  glome_tpu's
    lax.while_loop becomes a Python loop; a step is a no-op for a tile
    whose index has passed the last node, so the end is tested only
    every CHECK_EVERY steps (one host sync each)."""
    bvh = group_accel(sc.groups[gi])
    dev = o.device
    N = o.shape[0]
    M = bvh.n_nodes
    K = min(tile, max(N, 1))
    T = (N + K - 1) // K
    pad = T * K - N

    def tl(x, fill):
        if pad:
            x = torch.cat([x, torch.full((pad, 3), fill, dtype=x.dtype,
                                         device=dev)])
        return x.reshape(T, K, 3)

    ot, dt_ = tl(o, 0.0), tl(d, 1.0)
    inv_d = 1.0 / torch.where(dt_ == 0.0, torch.full_like(dt_, 1e-20), dt_)
    nb_min = torch.as_tensor(bvh.bmin, device=dev)
    nb_max = torch.as_tensor(bvh.bmax, device=dev)
    leaf_count = torch.as_tensor(bvh.leaf_count, dtype=torch.int32,
                                 device=dev)
    skip = torch.as_tensor(bvh.skip, dtype=torch.int64, device=dev)

    idx = torch.zeros(T, dtype=torch.int64, device=dev)
    pc = torch.zeros((T, K), dtype=torch.int32, device=dev)
    nc = torch.zeros((T, K), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    step = 0
    while step % CHECK_EVERY or bool((idx < M).any()):
        nidx = torch.clamp(idx, 0, M - 1)
        t1 = (nb_min[nidx][:, None, :] - ot) * inv_d
        t2 = (nb_max[nidx][:, None, :] - ot) * inv_d
        near = torch.amax(torch.minimum(t1, t2), dim=-1)
        far = torch.amin(torch.maximum(t1, t2), dim=-1)
        live = idx < M
        hitr = (near <= far) & (far > 0.0) & live[:, None]
        hitb = live & hitr.any(dim=-1)
        nc = nc + hitr.to(torch.int32)
        # leaf prims are charged to the rays whose box test passed (the
        # reference's per-ray rayint_debug semantics; the tile-mates'
        # lockstep ride-along is execution detail, not ray work)
        pc = pc + torch.where(hitr, leaf_count[nidx][:, None], zero)
        nxt = torch.where(hitb, idx + 1, skip[nidx])
        idx = torch.where(live, nxt, idx)
        step += 1
    return pc.reshape(-1)[:N], nc.reshape(-1)[:N]


@torch.no_grad()
def trace_debug_counts(compiled, arrays, o, d, recurs: int = 3,
                       config=None, scene_id: int = 0,
                       select: str = MK.KERNELS):
    """Full-trace work counters (trace_debug parity, Trace.hs:86-109):
    per PRIMARY ray, the intersection work of its whole bounce tree --
    each level queue's rayint work, each level's per-light shadow-ray
    work, and the children's subtree counts ascending to their parents.

    The levels are the wavefront tracer's (its `_down_level`, whose
    intersect and shadow batches run through `select`'s kernels).  Its
    queues are exact, so each level's `stored["child"]` index lists map
    a child back to its parent, where glome_tpu reads its 128-lane ROW
    segments; a child ray's BVH tile-mates are the rays beside it in
    that exact queue.  Returns (prims, nodes): (N,) int32."""
    from .trace import _light_arrays
    from .trace_wavefront import WavefrontTracer

    cfg = config or RenderConfig(maxdepth=recurs)
    tracer = WavefrontTracer(compiled, cfg, select=select)
    lights = compiled.lights
    lpos, lcol, lrad = _light_arrays(compiled, arrays, lights)
    N = o.shape[0]
    dt, dev = o.dtype, o.device
    R = max(recurs, 1)
    Q = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                     torch.full((N,), INFINITY, dtype=dt, device=dev),
                     torch.full((N,), float(scene_id), dtype=dt,
                                device=dev)]).detach()

    levels = []
    for level in range(R):
        co, cd = Q[0:3].t(), Q[3:6].t()
        Q, stored = tracer._down_level(arrays, Q, lights, lpos, lcol, lrad,
                                       last=(level == R - 1))
        # own-queue rayint work (every lane of an exact queue is live)
        qp, qn = ray_debug_counts(compiled, arrays, co, cd, scene_id)
        # per-light shadow rayint work (reconstructed preshade rays,
        # Shader.hs:65-80), charged to active shadow lanes
        sh_o = vscaleadd(stored["pos"], stored["norm"], DELTA)
        for li, l in enumerate(lights):
            if not l.shadow:
                continue
            lvec = lpos[li] - stored["pos"]
            llen = torch.sqrt(vdot(lvec, lvec))
            active = (stored["hitmask"]
                      & (vdot(lvec, stored["norm"]) >= 0.0)
                      & (llen <= lrad[li]))
            sp, sn = ray_debug_counts(compiled, arrays, sh_o,
                                      stored["ldirs"][li], scene_id)
            qp = qp + torch.where(active, sp, 0)
            qn = qn + torch.where(active, sn, 0)
        levels.append((stored["child"], qp, qn))

    # ascend: children's subtree counts flow to their parents like colors
    up_p = up_n = None
    for child, qp, qn in reversed(levels):
        if up_p is not None:
            off = 0
            for _key, idx in child:
                n = idx.numel()
                qp = qp.index_add(0, idx, up_p[off:off + n])
                qn = qn.index_add(0, idx, up_n[off:off + n])
                off += n
        up_p, up_n = qp, qn
    return up_p, up_n


def debug_image(compiled, arrays, cam, xres: int, yres: int,
                scene_id: int = 0, full: bool = False, recurs: int = 3,
                select: str = MK.KERNELS):
    """((H, W, 3) false-color work map, prims, nodes): prims -> red,
    nodes -> green, each normalized to its 99th percentile (Glome.hs:57-62
    spirit); prims and nodes are (H, W) float64 numpy maps."""
    from .render import Renderer, tile_order
    from .trace import Tracer
    cfg = RenderConfig(xres=xres, yres=yres)
    r = Renderer(Tracer(compiled, cfg), cam, cfg)
    ys, xs = np.mgrid[0:yres, 0:xres]
    perm = tile_order(xres, yres)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    o, d = r.rays_for_pixels(xs.reshape(-1)[perm].astype(np.float32),
                             ys.reshape(-1)[perm].astype(np.float32),
                             arrays["lights"]["pos"].device)
    if full:
        prims, nodes = trace_debug_counts(compiled, arrays, o, d,
                                          recurs=recurs, scene_id=scene_id,
                                          select=select)
    else:
        prims, nodes = ray_debug_counts(compiled, arrays, o, d, scene_id)
    prims = prims.cpu().numpy()[inv].reshape(yres, xres).astype(np.float64)
    nodes = nodes.cpu().numpy()[inv].reshape(yres, xres).astype(np.float64)
    img = np.zeros((yres, xres, 3))
    img[..., 0] = prims / max(np.percentile(prims, 99.0), 1.0)
    img[..., 1] = nodes / max(np.percentile(nodes, 99.0), 1.0)
    return np.clip(img, 0.0, 1.0), prims, nodes
