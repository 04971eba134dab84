"""Point queries: `inside` and `metainfo` over a packed scene (torch).

Port of glome_tpu/query.py, the reference Solid methods `inside`
(Solid.hs:166) and `get_metainfo` (Solid.hs:200; BIH point traversal
Bih.hs:550-585): given world points, report whether any scene solid
contains them and the texture/tag stacks of a containing leaf solid.

CSG semantics (Csg.hs:92-101): a point is inside a Difference iff
inside A and not inside B; inside an Intersection iff inside every
member (empty intersection => True).  Plain prims use their own
`inside` tests.  Points are tensors on the scene arrays' device; the
answers lie on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

from .compile import (CompiledScene, TEX_DEPTH, TAG_DEPTH,
                      materialize_scene_params)
from .intersect import _meta, clause_in, group_inside, group_inside_any


def _scene(compiled: CompiledScene, arrays, pts, scene_id):
    sc = compiled.scenes[scene_id]
    garrs = materialize_scene_params(sc, arrays["scenes"][scene_id])
    dev = arrays["lights"]["pos"].device
    return sc, garrs, torch.as_tensor(pts, dtype=torch.float32, device=dev)


def _plain_groups(sc):
    """Groups whose prims are not CSG members (CSG objects are answered
    per object)."""
    for gi, g in enumerate(sc.groups):
        if g.size and not np.any(g.csg_id >= 0):
            yield gi, g


def _csg_ok(sc, garrs, csg, pts):
    """(...) bool: the point satisfies every clause of the CSG object."""
    ok = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    for clause in csg.clauses:
        ok = ok & (clause_in(sc, garrs, clause, pts) == clause.positive)
    return ok


@torch.no_grad()
def inside(compiled: CompiledScene, arrays, pts, scene_id: int = 0):
    """(...,) bool: any solid of the scene contains each point."""
    sc, garrs, pts = _scene(compiled, arrays, pts, scene_id)
    out = torch.zeros(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    for gi, g in _plain_groups(sc):
        out = out | group_inside_any(sc, garrs, gi, np.arange(g.size), pts)
    for csg in sc.csgs:
        out = out | _csg_ok(sc, garrs, csg, pts)
    return out


@torch.no_grad()
def metainfo(compiled: CompiledScene, arrays, pts, scene_id: int = 0):
    """(found, tex_stack, tag_stack) of the first containing leaf solid
    per point (stacks are (-1)-padded int32 id tensors; resolve tag ids
    through compiled.tag_names)."""
    sc, garrs, pts = _scene(compiled, arrays, pts, scene_id)
    shape = pts.shape[:-1]
    dev = pts.device
    found = torch.zeros(shape, dtype=torch.bool, device=dev)
    tex = torch.full(shape + (TEX_DEPTH,), -1, dtype=torch.int32, device=dev)
    tag = torch.full(shape + (TAG_DEPTH,), -1, dtype=torch.int32, device=dev)

    def take(g, idx, ins):
        nonlocal found, tex, tag
        any_here = ins.any(dim=-1)
        first = torch.as_tensor(idx, dtype=torch.int64, device=dev)[
            ins.to(torch.uint8).argmax(dim=-1)]
        use = (any_here & ~found)[..., None]
        tex = torch.where(use, _meta(g, "tex_stack", dev)[first].int(), tex)
        tag = torch.where(use, _meta(g, "tag_stack", dev)[first].int(), tag)
        found = found | any_here

    for gi, g in _plain_groups(sc):
        idx = np.arange(g.size)
        take(g, idx, group_inside(sc, garrs, gi, idx, pts))

    for csg in sc.csgs:
        ok = _csg_ok(sc, garrs, csg, pts)
        # containing leaf = first containing member of the first
        # positive clause (the A side / first intersection member)
        for clause in csg.clauses:
            if not clause.positive:
                continue
            for gi, idx in clause.members:
                ins = group_inside(sc, garrs, gi, idx, pts) & ok[..., None]
                take(sc.groups[gi], idx, ins)
            break
    return found, tex, tag
