"""Gradient optimization of scene parameters from pixels, with
checkpoint/resume (BASELINE.json config 5; port of
glome_tpu/optimize.py).

The loop: render the scene with the current parameter tree, L2 against
a target image, Adam on the gradient through the whole tracer (the
kernels select, the differentiable finalize re-evaluates each winner).
Adam is torch.optim.Adam with optax.adam's defaults (betas 0.9 / 0.999,
eps 1e-8 added after the square root of the bias-corrected second
moment): the same update.  Checkpoints are torch.save files of
{params, opt_state, step}; a run resumes from the newest one.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Optional

import torch

from .graphs import EAGER
from .trace import Tracer

CKPT_KEEP = 2
_CKPT = re.compile(r"^step_(\d+)\.pt$")


@dataclasses.dataclass
class OptimizeResult:
    arrays: dict
    losses: list
    steps_run: int


def pixel_loss_fn(tracer: Tracer):
    def loss(arrays, o, d, target_rgb):
        # the gradient needs the eager frame
        res = tracer.trace(arrays, o, d, frame=EAGER)
        rgb = res.color[..., :3] * res.color[..., 3:4]
        return torch.mean((rgb - target_rgb) ** 2)
    return loss


def tree_map(fn, tree):
    """fn over the leaves of a scene-array tree (to_torch's nested
    {"scenes": [[{field: tensor}]], "lights": {field: tensor}})."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_map2(fn, a, b):
    """fn over the paired leaves of two trees of a's structure (dict
    entries matched by key)."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _checkpoints(directory):
    """[(step, path)] of the checkpoints in `directory`, oldest first."""
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        m = _CKPT.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(found)


def _save(directory, step, params, opt):
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}.pt")
    tmp = path + ".tmp"
    torch.save({"params": tree_map(lambda p: p.detach(), params),
                "opt_state": opt.state_dict(), "step": step}, tmp)
    os.replace(tmp, path)
    for _step, old in _checkpoints(directory)[:-CKPT_KEEP]:
        os.remove(old)


def optimize(tracer: Tracer, arrays, o, d, target_rgb, *,
             steps: int = 100, lr: float = 1e-2,
             checkpoint_dir: Optional[str] = None,
             checkpoint_every: int = 25,
             on_step: Optional[Callable] = None,
             loss_fn: Optional[Callable] = None,
             grad_filter: Optional[Callable] = None) -> OptimizeResult:
    """Adam-optimize every floating leaf of `arrays` to match target_rgb.

    Runs on the device of `arrays`.  Gradients go through
    torch.nan_to_num (an isolated grazing lane can emit a non-finite
    one), then `grad_filter`: an optional grads-tree -> grads-tree
    transform (e.g. zero every leaf except one group's).

    checkpoint_dir: if set, {params, opt_state, step} is saved every
    `checkpoint_every` steps and at the end (the newest CKPT_KEEP files
    are kept), and a run resumes from the newest one.
    """
    if loss_fn is None:
        loss_fn = pixel_loss_fn(tracer)
    params = tree_map(
        lambda p: (p.detach().clone().requires_grad_(True)
                   if torch.is_floating_point(p) else p), arrays)
    leaves = [p for p in tree_leaves(params) if torch.is_floating_point(p)]
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    start = 0
    if checkpoint_dir is not None:
        found = _checkpoints(checkpoint_dir)
        if found:
            state = torch.load(found[-1][1], map_location=leaves[0].device,
                               weights_only=True)
            with torch.no_grad():
                tree_map2(lambda p, v: (p.copy_(v)
                                        if torch.is_floating_point(p)
                                        else p), params, state["params"])
            opt.load_state_dict(state["opt_state"])
            start = int(state["step"])

    losses = []
    for i in range(start, steps):
        for p in leaves:
            p.grad = None
        loss = loss_fn(params, o, d, target_rgb)
        loss.backward()
        grads = tree_map(
            lambda p: (torch.nan_to_num(
                p.grad if p.grad is not None else torch.zeros_like(p),
                nan=0.0, posinf=0.0, neginf=0.0)
                if torch.is_floating_point(p) else p), params)
        if grad_filter is not None:
            grads = grad_filter(grads)
        def set_grad(p, g):
            if torch.is_floating_point(p):
                p.grad = g.detach()
        tree_map2(set_grad, params, grads)
        opt.step()
        losses.append(float(loss.detach()))
        if on_step is not None:
            on_step(i, losses[-1])
        if checkpoint_dir is not None and ((i + 1) % checkpoint_every == 0
                                           or i + 1 == steps):
            _save(checkpoint_dir, i + 1, params, opt)
    return OptimizeResult(arrays=tree_map(lambda p: p.detach(), params),
                          losses=losses, steps_run=steps - start)
