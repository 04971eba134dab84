"""Ray-scene intersection entry points (torch).

glome_tpu/intersect.py holds two pipelines: the jnp pass-per-group path
(its CPU oracle) and the megakernel path.  The port keeps only the
megakernel path: the table entries route every batch through the select
kernels (K1 megakernel.mega_select, then K2/K3 for groups too big for
it; CUDA kernels on CUDA tensors, their plain torch versions on CPU
tensors) and the differentiable finalize.  The Hit record keeps
glome_tpu's layout, so the tests compare like with like.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import geom
from . import megakernel as MK


class Hit(NamedTuple):
    """Per-ray nearest-hit record (the reference Rayint, Solid.hs:20-28)."""
    t: torch.Tensor          # (N,) world distance; INFINITY = miss
    hit: torch.Tensor        # (N,) bool
    pos: torch.Tensor        # (N, 3)
    norm: torch.Tensor       # (N, 3)
    obj_o: torch.Tensor      # (N, 3) object-space ray (riray for Warp)
    obj_d: torch.Tensor      # (N, 3)
    tex_stack: torch.Tensor  # (N, TEX_DEPTH) texture ids, innermost first
    tag_stack: torch.Tensor  # (N, TAG_DEPTH) tag ids
    prim_serial: torch.Tensor  # (N,) global prim id, -1 = miss


def _kernel_hits2(ptype, params, o, d):
    if ptype == "sphere":
        return geom.sphere_hits2(params["center"], params["radius"], o, d)
    if ptype == "plane":
        return geom.plane_hits2(params["norm"], params["offset"], o, d)
    if ptype == "box":
        return geom.box_hits2(params["bmin"], params["bmax"], o, d)
    if ptype == "triangle":
        return geom.triangle_hits2(params["p1"], params["p2"], params["p3"],
                                   o, d)
    if ptype == "trianglenorm":
        return geom.trianglenorm_hits2(params["p1"], params["p2"],
                                       params["p3"], params["n1"],
                                       params["n2"], params["n3"], o, d)
    if ptype == "disc":
        return geom.disc_hits2(params["pos"], params["norm"], params["rsqr"],
                               o, d)
    if ptype == "cylinder":
        return geom.cylinder_hits2(params["radius"], params["h1"],
                                   params["h2"], o, d)
    if ptype == "cone":
        return geom.cone_hits2(params["radius"], params["clip1"],
                               params["clip2"], params["height"], o, d)
    raise ValueError(ptype)


def _guard_dead(table):
    """Dead/fill lanes can carry d = 0: give them a unit direction.
    Their results are discarded (tmax 0), but an unguarded zero
    direction meets inf-scaled gradients in the backward pass
    (0 x inf = NaN), and ONE such lane poisons every accumulated
    scene-parameter gradient."""
    d = table[3:6]
    dead = torch.sum(d * d, dim=0) == 0.0
    unit = torch.tensor([0.0, 0.0, 1.0], dtype=table.dtype,
                        device=table.device)[:, None]
    return torch.cat([table[0:3], torch.where(dead[None], unit, d),
                      table[6:8]], dim=0)


def intersect_multi_table(compiled, arrays, table,
                          select: str = MK.KERNELS) -> Hit:
    """Nearest hits of a ray table: (8, N) float32 component planes
    [ox,oy,oz,dx,dy,dz,tmax,sid] (dead lanes tmax 0, sid -1).  `select`
    names the kernel set (megakernel.KERNELS, or PLAIN to run the plain
    versions on any device)."""
    return MK.mega_intersect_table(compiled, arrays, _guard_dead(table),
                                   select=select)


def shadow_query_table(compiled, arrays, table, select: str = MK.KERNELS):
    """Any-hit occlusion of a ray table as in intersect_multi_table
    (row 6 = segment tmax); returns (N,) bool blocked."""
    return MK.mega_shadow_table(compiled, arrays, _guard_dead(table),
                                select=select)
