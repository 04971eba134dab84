"""BASELINE config 5 end to end on the port: the full TestScene, an
adaptive-AA render as the optimization target, soft-edge gradient
recovery of a perturbed geometry parameter, with checkpoints (the
counterpart of tools/config5_e2e.py, same steps, defaults and
perturbation).

Pipeline:
  1. Render the TRUE TestScene with adaptive AA (the reference's render
     cost model) -> target image.
  2. Perturb one lattice-carve sphere's center and radius (scene 0,
     group 10, row 0: the r = 3.5 difference-B sphere whose cavity cuts
     the visible lattice) by (0.06, -0.05, 0.04) and x 1.04.
  3. Adam on the SoftTracer pixel loss, pooled 8x coarse-to-fine, with
     only that row's center and radius training (only_group),
     checkpointing every 8 steps; rerunning with the same --ckpt
     resumes.
  4. Print the loss curve and the recovered-vs-true parameter error, as
     one JSON line with ms_per_step (host wall between steps, each step
     ends with the loss read back, after the first) and the card's
     nvidia-smi name and power limit.

Usage: python -m glome_tpu_torch.tools.config5_e2e [--steps 24]
          [--xres 180] [--yres 120] [--ckpt build/config5_ckpt]
          [--device cuda|cpu] [--lr 5e-3] [--save DIR]

The device is the card unless --device cpu is passed; without CUDA the
tool exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

GROUP, ROW = 10, 0                   # scene 0's lattice-carve sphere
SHIFT, GROW = (0.06, -0.05, 0.04), 1.04
POOL = 8                             # coarse term: 8x8 pooled pixels
FINE = 0.1                           # weight of the full-res term
CKPT_EVERY = 8


def setup(xres, yres, device, select=None):
    """(compiled, cfg, cam, tracer, true arrays on `device`) of the
    TestScene at xres x yres (RenderConfig.tuned) on the megakernel
    route; `select` as WavefrontTracer's (default: the kernels).  The
    tracer runs the eager frame: the step's loss needs its gradient."""
    import glome_tpu_torch as T
    from glome_tpu_torch import megakernel as MK
    from glome_tpu_torch.graphs import EAGER
    from glome_tpu_torch.scenes import test_scene
    solid, lights, cam = test_scene()
    compiled = T.compile_scene(solid, lights)
    cfg = T.RenderConfig.tuned(xres=xres, yres=yres)
    tracer = T.WavefrontTracer(compiled, cfg, select=select or MK.KERNELS,
                               frame=EAGER)
    return compiled, cfg, cam, tracer, T.to_torch(compiled.arrays(), device)


def aa_target(tracer, cam, cfg, arrays):
    """The adaptive-AA frame of `arrays`, flattened to (H*W, 3), and the
    renderer (its last_ray_counts / last_overflow)."""
    from glome_tpu_torch.aa import AARenderer
    aa = AARenderer(tracer, cam, cfg)
    with torch.no_grad():
        rgb, _depth = aa.render(arrays)
    return rgb.reshape(-1, 3), aa


def pixel_rays(tracer, cam, cfg, device):
    """One ray per pixel, raster order: (o, d)."""
    from glome_tpu_torch.render import Renderer
    ys, xs = np.mgrid[0:cfg.yres, 0:cfg.xres]
    return Renderer(tracer, cam, cfg).rays_for_pixels(
        xs.reshape(-1).astype(np.float32), ys.reshape(-1).astype(np.float32),
        device)


def perturb(arrays, gi=GROUP, row=ROW):
    """A copy of the tree with scene 0 group gi's row moved by SHIFT and
    its radius scaled by GROW (the other leaves shared)."""
    out = dict(arrays)
    out["scenes"] = list(arrays["scenes"])
    sc0 = list(arrays["scenes"][0])
    gp = dict(sc0[gi])
    c = gp["center"].clone()
    c[row] += torch.tensor(SHIFT, dtype=c.dtype, device=c.device)
    r = gp["radius"].clone()
    r[row] *= GROW
    gp["center"], gp["radius"] = c, r
    sc0[gi] = gp
    out["scenes"][0] = sc0
    return out


def param_error(arrays, true_arrays, gi=GROUP, row=ROW):
    """(max |center - true|, |radius - true|) of the perturbed row."""
    a, t = arrays["scenes"][0][gi], true_arrays["scenes"][0][gi]
    return (float((a["center"][row] - t["center"][row]).abs().max()),
            float((a["radius"][row] - t["radius"][row]).abs().max()))


def coarse_to_fine_loss(soft, H, W, k=POOL):
    """Pixel loss of the soft render: mean squared error of both images
    pooled k x k plus FINE x the full-resolution one.  The squashed
    glass sphere refracts the lattice, so the raw pixel loss ripples at
    lattice frequency; pooling smooths it to the object scale."""
    def pooled(flat):
        im = flat.reshape(H, W, 3)
        Hp, Wp = (H // k) * k, (W // k) * k
        return im[:Hp, :Wp].reshape(H // k, k, W // k, k, 3).mean(dim=(1, 3))

    def loss(params, o, d, target_rgb):
        col = soft.render(params, o, d)
        rgb = col[:, :3] * col[:, 3:4]
        coarse = torch.mean((pooled(rgb) - pooled(target_rgb)) ** 2)
        fine = torch.mean((rgb - target_rgb) ** 2)
        return coarse + FINE * fine
    return loss


def only_group(gi=GROUP, row=ROW):
    """grad_filter keeping exactly the perturbed leaves (one row's
    center and radius); every other gradient is zeroed."""
    from glome_tpu_torch.optimize import tree_map

    def zero(g):
        return tree_map(torch.zeros_like, g)

    def keep(gj, gp):
        if gj != gi:
            return zero(gp)
        out = zero(gp)
        rm = torch.zeros(gp["center"].shape[0], dtype=gp["center"].dtype,
                         device=gp["center"].device)
        rm[row] = 1.0
        out["center"] = gp["center"] * rm[:, None]
        out["radius"] = gp["radius"] * rm
        return out

    def filt(grads):
        out = {k: zero(v) for k, v in grads.items() if k != "scenes"}
        out["scenes"] = [[keep(gj, gp) if si == 0 else zero(gp)
                          for gj, gp in enumerate(scn)]
                         for si, scn in enumerate(grads["scenes"])]
        return out
    return filt


def nvidia_smi():
    """The card's `name, power.limit` as nvidia-smi reports them, or
    None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out[0] if out else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--xres", type=int, default=180)
    ap.add_argument("--yres", type=int, default=120)
    ap.add_argument("--ckpt", default=os.path.join(ROOT, "build",
                                                   "config5_ckpt"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--save", default=None,
                    help="directory for the artifacts (json + pngs)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("config5_e2e: no CUDA device (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 2
    device = torch.device(args.device)
    from glome_tpu_torch.optimize import optimize
    from glome_tpu_torch.soft import SoftTracer

    compiled, cfg, cam, tracer, arrays_true = setup(args.xres, args.yres,
                                                    device)
    # 1. adaptive-AA forward of the TRUE scene -> target pixels
    target, aa = aa_target(tracer, cam, cfg, arrays_true)
    print(f"# AA target rendered: "
          f"{sum(aa.last_ray_counts.values()) / (args.xres * args.yres):.3f}"
          f" rays/px, overflow {sum(aa.last_overflow.values())}",
          flush=True)
    o, d = pixel_rays(tracer, cam, cfg, device)

    # 2. perturb the lattice-carve sphere
    pert = perturb(arrays_true)
    e0 = param_error(pert, arrays_true)
    print(f"# start param error: center {e0[0]:.4f} radius {e0[1]:.4f}",
          flush=True)

    # 3. soft-edge optimization of that row only, checkpointed
    soft = SoftTracer(tracer)
    stamps = [time.perf_counter()]

    def on_step(i, loss):
        stamps.append(time.perf_counter())
        print(f"# step {i}: {loss:.6f}", flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    res = optimize(tracer, pert, o, d, target, steps=args.steps, lr=args.lr,
                   checkpoint_dir=args.ckpt, checkpoint_every=CKPT_EVERY,
                   loss_fn=coarse_to_fine_loss(soft, args.yres, args.xres),
                   grad_filter=only_group(), on_step=on_step)
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    e1 = param_error(res.arrays, arrays_true)
    print(f"# final param error: center {e1[0]:.4f} radius {e1[1]:.4f}",
          flush=True)
    out = {
        "backend": device.type,
        "resolution": [args.xres, args.yres],
        "steps": args.steps,
        "losses": res.losses,
        "start_err": e0, "final_err": e1,
        "loss_drop": (res.losses[0] / max(res.losses[-1], 1e-12)
                      if res.losses else None),
        "recovered": bool(e1[0] < e0[0] and res.losses
                          and res.losses[-1] < res.losses[0]),
        "ms_per_step": (float(np.mean(step_ms[1:])) if len(step_ms) > 1
                        else (step_ms[0] if step_ms else None)),
        "first_step_ms": step_ms[0] if step_ms else None,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "gpu": nvidia_smi() if device.type == "cuda" else None,
    }
    if args.save:
        from glome_tpu_torch.io import write_png
        from glome_tpu_torch.render import Renderer
        os.makedirs(args.save, exist_ok=True)
        with open(os.path.join(args.save, "config5_result.json"), "w") as f:
            json.dump(out, f, indent=1)
        write_png(os.path.join(args.save, "config5_target.png"),
                  target.reshape(cfg.yres, cfg.xres, 3).cpu().numpy())
        renderer = Renderer(tracer, cam, cfg)
        for tag, a in (("start", pert), ("final", res.arrays)):
            with torch.no_grad():
                rgb, _t = renderer.render(a)
            write_png(os.path.join(args.save, f"config5_{tag}.png"),
                      rgb.cpu().numpy())
        print(f"# artifacts -> {args.save}", flush=True)
    print(json.dumps(out))
    return 0 if out["recovered"] else 1


if __name__ == "__main__":
    sys.exit(main())
