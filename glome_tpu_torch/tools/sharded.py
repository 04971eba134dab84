"""Ray-sharded rendering and training across processes on one host
(glome_tpu_torch.parallel over torch.distributed).

Without --rank it launches --nprocs rank processes of itself on a free
localhost port, waits for them (killing the rest once one fails or the
--timeout passes) and exits non-zero unless every rank succeeded.  Each
rank joins the process group (parallel.init_distributed), builds the
('dp', 'sp') mesh and runs its jobs:

  render: the scene's frame through sharded_render_fn, its rays in the
          Renderer's 32x32 tile order, scattered back to (H, W); twice,
          timing a cold and a warm frame;
  train:  one sharded_train_step_fn step (SGD, lr LR) against a black
          target.

Each rank saves what it got to <out>/rank<r>.pt (the frame, the new
arrays, the loss, its K1 launches and seconds).  Scenes: `test` (the
TestScene through the WavefrontTracer, 720x480 depth 3) and `two_prim`
(phasescene.two_prim_scene through the recursive Tracer, 32x16 depth 2,
glome_tpu's tests/test_sharding.py setup).

Usage: python -m glome_tpu_torch.tools.sharded --out DIR [--nprocs 2]
          [--device cuda|cpu] [--scene test|two_prim]
          [--jobs render,train] [--timeout 600]

The ranks join over gloo, so several may share one card: their CUDA
tensors cross the collectives through host copies.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LR = 1e-2   # the train step's, as glome_tpu's sharded_train_step_fn default


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scene", default="test", choices=("test", "two_prim"))
    ap.add_argument("--jobs", default="render,train")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    return ap


def scene_setup(name, device):
    """(compiled, cfg, cam, tracer, arrays) of a named scene."""
    import glome_tpu_torch as T
    if name == "test":
        from glome_tpu_torch.scenes import test_scene
        solid, lights, cam = test_scene()
        compiled = T.compile_scene(solid, lights)
        cfg = T.RenderConfig.tuned(xres=720, yres=480, maxdepth=3)
        tracer = T.WavefrontTracer(compiled, cfg)
    else:
        from glome_tpu_torch.scenes.phasescene import two_prim_scene
        solid, lights, cam = two_prim_scene()
        compiled = T.compile_scene(solid, lights)
        cfg = T.RenderConfig(xres=32, yres=16, maxdepth=2)
        tracer = T.Tracer(compiled, cfg)
    return compiled, cfg, cam, tracer, T.to_torch(compiled.arrays(), device)


def frame_rays(tracer, cam, cfg, device):
    """(o, d, inv): the frame's primary rays in the Renderer's tile order
    and the permutation that puts per-ray results back in raster order."""
    from glome_tpu_torch.render import Renderer, tile_order
    ys, xs = np.mgrid[0:cfg.yres, 0:cfg.xres]
    perm = tile_order(cfg.xres, cfg.yres)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    o, d = Renderer(tracer, cam, cfg).rays_for_pixels(
        xs.reshape(-1)[perm].astype(np.float32),
        ys.reshape(-1)[perm].astype(np.float32), device)
    return o, d, torch.as_tensor(inv, device=device)


def full_batch_step(tracer, arrays, o, d, target_rgb, lr):
    """The single-process reference of sharded_train_step_fn: the same
    loss over every ray and the same SGD step, no collective."""
    from glome_tpu_torch.graphs import EAGER
    from glome_tpu_torch.optimize import tree_map
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      arrays)
    res = tracer.trace(params, o, d, frame=EAGER)  # the gradient's frame
    rgb = res.color[..., :3] * res.color[..., 3:4]
    loss = torch.sum((rgb - target_rgb) ** 2) / o.shape[0]
    loss.backward()
    return tree_map(lambda p: (p - lr * (torch.zeros_like(p) if p.grad is None
                                         else p.grad)).detach(),
                    params), loss.detach()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def worker(args):
    from glome_tpu_torch import megakernel as MK
    from glome_tpu_torch.optimize import tree_map
    from glome_tpu_torch.parallel import (init_distributed, make_mesh,
                                          sharded_render_fn,
                                          sharded_train_step_fn)
    import torch.distributed as dist
    if args.device == "cuda":
        device = torch.device("cuda",
                              args.rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    init_distributed(f"localhost:{args.port}", args.nprocs, args.rank,
                     backend="gloo")
    try:
        mesh = make_mesh()
        compiled, cfg, cam, tracer, arrays = scene_setup(args.scene, device)
        o, d, inv = frame_rays(tracer, cam, cfg, device)
        out = {"rank": args.rank, "world": args.nprocs,
               "xres": cfg.xres, "yres": cfg.yres}
        jobs = args.jobs.split(",")
        if "render" in jobs:
            render = sharded_render_fn(tracer, mesh)
            seconds = []
            # a cold frame (the megakernel plan, the kernel library, the
            # first collectives), then a warm one, whose K1 launches count
            for _ in range(2):
                _sync(device)
                n0, t0 = MK.mega_select.launches, time.perf_counter()
                rgb, t = render(arrays, o, d)
                _sync(device)
                seconds.append(time.perf_counter() - t0)
            out["render_cold_s"], out["render_s"] = seconds
            out["render_launches"] = MK.mega_select.launches - n0
            out["rgb"] = rgb[inv].reshape(cfg.yres, cfg.xres, 3).cpu()
            out["t"] = t[inv].reshape(cfg.yres, cfg.xres).cpu()
        if "train" in jobs:
            step = sharded_train_step_fn(tracer, mesh, lr=LR)
            target = torch.zeros_like(o)
            n0, t0 = MK.mega_select.launches, time.perf_counter()
            new_arrays, loss = step(arrays, o, d, target)
            _sync(device)
            out["train_s"] = time.perf_counter() - t0
            out["train_launches"] = MK.mega_select.launches - n0
            out["new_arrays"] = tree_map(lambda p: p.cpu(), new_arrays)
            out["loss"] = loss.cpu()
        # JAX or the reference package, had this rank imported them
        out["foreign_modules"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "glome_tpu", "tools"))
        os.makedirs(args.out, exist_ok=True)
        torch.save(out, os.path.join(args.out, f"rank{args.rank}.pt"))
        print(f"rank {args.rank}/{args.nprocs} (gloo, {device}): "
              + ", ".join(f"{k} {out[k]:.4f}" if isinstance(out[k], float)
                          else f"{k} {out[k]}" for k in
                          ("render_cold_s", "render_s", "render_launches",
                           "train_s",
                           "train_launches") if k in out)
              + (f", loss {float(out['loss']):.9g}" if "loss" in out
                 else ""), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv, nprocs, timeout, module="glome_tpu_torch.tools.sharded"):
    """Run nprocs ranks of `module` (python -m module argv --rank r
    --port p, every rank on one free localhost port); 0 when every rank
    exits 0 before the timeout, else 1, once every rank is stopped (the
    rest are killed as soon as one fails)."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv,
         "--rank", str(r), "--port", str(port)], env=env)
        for r in range(nprocs)]
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        print(f"{module}: rank exit codes {rcs}", file=sys.stderr)
    return int(any(rcs))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("sharded: no CUDA device (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 2
    if args.rank is None:
        return launch(argv, args.nprocs, args.timeout)
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
