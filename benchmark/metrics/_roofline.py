"""The bytes bound of a select kernel's launch, from the scene
description and the batch alone: never from a kernel's work tallies nor
from the program's table layouts, so a change to either leaves the
yardstick where it is.

A launch must at least read each live ray's origin, direction and tmax
(7 floats) and write its hit (distance and primitive id, 2 words): 36
bytes a ray.  It must read the primitive data of the scene description
it covers once: the floats that define each primitive's shape (its
shading data, normals and textures, is not the select's) and 12 floats
for each transform node above them.  Each byte once, at the published
HBM3 bandwidth of one H100 SXM (3.35 TB/s): the bytes bound the launch,
whose arithmetic is a few hundred flops a ray and primitive test, far
below the 67 TFLOP/s float32 peak for these batches.

Only the launch whose live rays are known from outside the program is
read: each profiled frame's first launch, the level-0 intersect of every
primary ray.  The deeper levels' and the shadow batches' live rays are
counted only inside the program, which does not report them yet.

The share of the roofline is the bound's seconds over the launch's
device seconds from the profiler, over the profiled frames.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
RAY_BYTES = 4 * (3 + 3 + 1) + 4 + 4
XFM_FLOATS = 12

# the floats that define each primitive's shape (reference/scene.py)
SHAPE_FLOATS = {"sphere": 4, "plane": 4, "box": 6, "cylinder": 3, "cone": 4,
                "triangle": 9, "trianglenorm": 9}


def scene_bytes(root) -> int:
    """Bytes of the description's primitives and transforms.  A node
    reached twice (a shared subtree) counts once."""
    from benchmark.reference import scene as S
    seen = set()
    stack = [root]
    total = 0
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, S.Prim):
            total += 4 * SHAPE_FLOATS[node.kind]
        elif isinstance(node, S.Xform):
            total += 4 * XFM_FLOATS
            stack.append(node.item)
        elif isinstance(node, S.Tex):
            stack.append(node.item)
        elif isinstance(node, S.Diff):
            stack.extend((node.a, node.b))
        else:
            stack.extend(node.items)
    return total


def description(run):
    """The configuration's scene description, the reference's own."""
    from benchmark.reference import scene as S
    return S.build(run.conf["scene"])[0]


def share_pct(run, pattern: str):
    """The roofline share, in %, of each profiled frame's first launch
    of the kernel whose device-op name matches `pattern` (its level-0
    intersect batch, whose live rays are the frame's first-pass rays),
    or None when the profile holds no such launch."""
    if run.prof is None:
        return None
    from benchmark.harness.profile import kernel_launches
    per_frame = kernel_launches(run.prof, pattern)
    firsts = [(f[0], rays) for f, rays in zip(per_frame, run.prof_rays)
              if f]
    if not firsts:
        return None
    prims = scene_bytes(description(run))
    bound_s = sum((rays * RAY_BYTES + prims) / PEAK_BYTES_PER_S
                  for _s, rays in firsts)
    took_s = sum((b - a) / 1e9 for (a, b), _r in firsts)
    return 100.0 * bound_s / took_s
