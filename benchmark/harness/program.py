"""The system under test: glome_tpu_torch, driven through its user-facing
entries.  Nothing else of the harness imports the program.

An entry is built once in set-up and then called once per frame:

  render  Renderer.render (the viewer's and the CLI's still frame)
  aa      AARenderer.render (the viewer's adaptive-AA frame)

A frame is one call of the entry that ends when its image and depth are
in host memory (numpy), as the viewer shows it and the CLI writes it.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import torch

from . import traffic as TR


def scene(conf: dict, device):
    """The configuration's scene built by the program's own scene code,
    compiled and uploaded: (the package, compiled scene, scene tensors,
    camera, {"imports_s", "compile_scene_s", "to_torch_s"})."""
    t0 = time.perf_counter()
    import glome_tpu_torch as T
    split = {"imports_s": time.perf_counter() - t0}
    recipe = conf["scene"]
    t0 = time.perf_counter()
    mod = importlib.import_module(f"glome_tpu_torch.scenes.{recipe['module']}")
    solid, lights, cam = getattr(mod, recipe["builder"])(
        **recipe.get("args", {}))
    compiled = T.compile_scene(solid, lights)
    split["compile_scene_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrays = T.to_torch(compiled.arrays(), device)
    split["to_torch_s"] = time.perf_counter() - t0
    return T, compiled, arrays, cam, split


def render_config(T, conf: dict, xres: int, yres: int):
    """The configuration's RenderConfig at xres x yres (`tuned`: the
    queue schedule measured on TestScene, RenderConfig.tuned), with its
    `background` (NFF's `b`, the miss colour) where it names one."""
    kw = dict(xres=xres, yres=yres, maxdepth=conf["maxdepth"],
              blocksize=conf.get("blocksize", 65),
              thresholds=tuple(conf.get("thresholds",
                                        (0.14, 0.15, 0.16, 0.18))))
    if conf.get("background") is not None:
        kw["background"] = tuple(float(c) for c in conf["background"])
    return (T.RenderConfig.tuned(**kw) if conf.get("render_config") == "tuned"
            else T.RenderConfig(**kw))


def build_seconds() -> dict:
    """nvcc and g++ seconds this process spent building libraries."""
    from glome_tpu_torch import kernels, native
    return {"nvcc_s": sum(i["seconds"] for i in kernels.BUILD_INFO.values()),
            "gxx_s": native.BUILD_INFO.get("seconds", 0.0)}


class SpanTracer:
    """A forwarding proxy of the program's tracer: each trace() call is a
    span, synced at both edges when `sync` (the traced window), and
    marked for the profiler as 'bench.trace'."""

    def __init__(self, inner, sync: bool):
        self._inner = inner
        self.sync = sync
        self.spans_s = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def trace(self, *args, **kwargs):
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.trace"):
            res = self._inner.trace(*args, **kwargs)
        if self.sync:
            torch.cuda.synchronize()
        self.spans_s.append(time.perf_counter() - t0)
        return res


class Entry:
    """The configuration's scene compiled on `device` and the cell's
    entry around it.  `split` holds the set-up's seconds by step."""

    def __init__(self, conf: dict, entry: str, device, xres: int, yres: int):
        T, self.compiled, self.arrays, cam, self.split = scene(conf, device)
        t0 = time.perf_counter()
        self.cfg = render_config(T, conf, xres, yres)
        self.tracer = T.WavefrontTracer(self.compiled, self.cfg)
        self.cam = cam
        self.entry = entry
        if entry == "render":
            self.view = T.Renderer(self.tracer, cam, self.cfg)
        elif entry == "aa":
            self.view = T.AARenderer(self.tracer, cam, self.cfg)
        else:
            raise ValueError(f"unknown entry {entry!r}")
        self.split["tracer_s"] = time.perf_counter() - t0
        self.rays = []    # each AA frame's requested rays by pass

    def frame(self, off):
        """One frame at the sub-pixel offset `off`: (rgb (H, W, 3),
        depth (H, W)) in host memory."""
        fwd = TR.shifted_fwd(self.cam.fwd, self.cam.right, self.cam.up,
                             self.cfg.yres, *off)
        self.view.cam = dataclasses.replace(self.cam, fwd=fwd)
        rgb, t = self.view.render(self.arrays)
        rgb, t = rgb.cpu().numpy(), t.cpu().numpy()
        if self.entry == "aa":
            self.rays.append({k: int(v) for k, v in
                              self.view.last_ray_counts.items()})
        return rgb, t

    def set_tracer(self, tracer):
        self.view.tracer = tracer

    def graph_totals(self) -> dict:
        return dict(self.tracer.graphs.totals)

    def pool_bytes(self) -> int:
        return self.tracer.graphs.pool_bytes()

    def free(self):
        """Drop the program's state (scene tensors, captured graphs)."""
        self.tracer.graphs.clear()
        self.view = self.tracer = self.arrays = self.compiled = None
