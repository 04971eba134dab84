"""Object picking: trace a pick ray and return the hit's tag stack.

Port of glome_tpu/pick.py.  The reference prints the tag stack on
mouse click (Glome.hs:416-438 via get_tags, Glome.hs:69-72); tags
accumulate from Tag wrappers during intersection (Tex.hs:54).  Here the
tag stack is a static per-prim table, gathered at the winning hit.

Each pick is one trace of one primary ray on the device of the scene
arrays, through the tracer's kernel set.  Every entry point passes
`scene_id` on to the trace (glome_tpu's `pick` and `pick_hit` take it
and drop it).
"""

from __future__ import annotations

import sys
from typing import List

import torch

from .render import Camera, pixel_coords, primary_rays
from .trace import Tracer


def _pick_ray(tracer: Tracer, cam: Camera, arrays, x, y):
    cfg = tracer.config
    dev = arrays["lights"]["pos"].device
    xc, yc = pixel_coords(cfg.xres, cfg.yres,
                          torch.tensor([float(x)], device=dev),
                          torch.tensor([float(y)], device=dev))
    return primary_rays(cam, xc, yc)


def _tags(tracer: Tracer, stack) -> List:
    return [tracer.compiled.tag_names[t]
            for t in stack.cpu().numpy().tolist() if t >= 0]


@torch.no_grad()
def _trace(tracer: Tracer, cam: Camera, arrays, x, y, scene_id: int):
    o, d = _pick_ray(tracer, cam, arrays, x, y)
    return tracer.trace(arrays, o, d, scene_id=scene_id)


def pick(tracer: Tracer, cam: Camera, arrays, x: int, y: int,
         scene_id: int = 0) -> List:
    """Tag names of the object under pixel (x, y)."""
    res = _trace(tracer, cam, arrays, x, y, scene_id)
    return _tags(tracer, res.tag_stack[0])


class PickSession:
    """Persistent render->click->tags session (the reference's SDL
    event loop, Glome.hs:416-438, headless).  glome_tpu jits its pick
    trace once; eager torch has nothing to compile, so the session keeps
    the tracer, the camera and the scene tensors, and each pick is one
    trace of one ray."""

    def __init__(self, tracer: Tracer, cam: Camera, arrays,
                 scene_id: int = 0):
        self.tracer = tracer
        self.cam = cam
        self.arrays = arrays
        self.scene_id = scene_id

    def pick(self, x: float, y: float):
        """{'t', 'prim_serial', 'tags'} under pixel (x, y)."""
        res = _trace(self.tracer, self.cam, self.arrays, x, y,
                     self.scene_id)
        return {
            "t": float(res.t[0]),
            "prim_serial": int(res.prim_serial[0]),
            "tags": _tags(self.tracer, res.tag_stack[0]),
        }

    def run(self, inp=None, out=None):
        """Interactive loop: read 'X Y' lines, print tag stacks;
        'q' quits (the reference's q key, Glome.hs:429)."""
        inp = inp or sys.stdin
        out = out or sys.stdout
        print("pick session: 'X Y' picks, 'q' quits", file=out,
              flush=True)
        for line in inp:
            line = line.strip()
            if not line:
                continue
            if line.lower() in ("q", "quit", "exit"):
                break
            try:
                x, y = (float(v) for v in line.split()[:2])
            except ValueError:
                print(f"? {line!r}", file=out, flush=True)
                continue
            h = self.pick(x, y)
            tags = " ".join(h["tags"]) if h["tags"] else "(no tags)"
            print(f"{int(x)} {int(y)}: t={h['t']:.4f} "
                  f"serial={h['prim_serial']} {tags}", file=out,
                  flush=True)


def pick_hit(tracer: Tracer, cam: Camera, arrays, x: int, y: int,
             scene_id: int = 0):
    """Full hit record under pixel (x, y) (depth, prim serial, tags,
    color)."""
    res = _trace(tracer, cam, arrays, x, y, scene_id)
    return {
        "t": float(res.t[0]),
        "prim_serial": int(res.prim_serial[0]),
        "tags": _tags(tracer, res.tag_stack[0]),
        "color": res.color[0].cpu().numpy(),
    }
