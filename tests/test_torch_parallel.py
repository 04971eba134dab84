"""Ray sharding in the port (glome_tpu_torch.parallel over
torch.distributed) against the single-process port and glome_tpu.

Two gloo ranks on the CPU (glome_tpu_torch.tools.sharded, spawned as
processes on a free localhost port) render glome_tpu's
tests/test_sharding.py scene (phasescene.two_prim_scene, 32x16, depth
2, the recursive Tracer) and take one SGD step:

  - the sharded frame equals the port's single-process frame exactly
    (each ray is traced alone of the others);
  - it lies within test_sharding.py:45-48's tolerances (rgb rtol 2e-4 /
    atol 2e-5, depth rtol 1e-5) of glome_tpu's sharded_render_fn on this
    suite's 8-device CPU mesh;
  - after the step the new arrays lie within rtol 1e-5 (atol 1e-7) of
    the single-process full-batch step, and both ranks hold the same
    loss, equal to the full-batch loss within rtol 1e-6;
  - the step also matches glome_tpu's sharded_train_step_fn on the
    8-device CPU mesh, from the same arrays against the same black
    target: the loss within rtol 1e-6 and every floating leaf of the new
    arrays within rtol 1e-5 (atol 1e-7), the other leaves equal.  The
    two differ only in how the per-ray sums are split and ordered (8
    shards of raster rows against 2 of 32x32 tiles).
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import glome_tpu as G
from glome_tpu.parallel import make_mesh as jax_make_mesh
from glome_tpu.parallel import sharded_render_fn as jax_sharded_render_fn
from glome_tpu.parallel import (
    sharded_train_step_fn as jax_sharded_train_step_fn)
from glome_tpu_torch import parallel as TP
from glome_tpu_torch.optimize import tree_leaves
from glome_tpu_torch.scenes.phasescene import two_prim_scene
from glome_tpu_torch.tools import sharded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree, prefix=""):
    """(path, leaf) of a scene-array tree, dict entries in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "glome_tpu_torch.tools.sharded",
         "--device", "cpu", "--scene", "two_prim", "--nprocs", "2",
         "--timeout", "120", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    print(proc.stdout)
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in (0, 1)]


@pytest.fixture(scope="module")
def single():
    compiled, cfg, cam, tracer, arrays = sharded.scene_setup("two_prim",
                                                             "cpu")
    o, d, inv = sharded.frame_rays(tracer, cam, cfg, "cpu")
    with torch.no_grad():
        res = tracer.trace(arrays, o, d)
    rgb = (res.color[..., :3] * res.color[..., 3:4])[inv]
    new_arrays, loss = sharded.full_batch_step(
        tracer, arrays, o, d, torch.zeros_like(o), sharded.LR)
    return dict(cfg=cfg, arrays=arrays,
                rgb=rgb.reshape(cfg.yres, cfg.xres, 3),
                t=res.t[inv].reshape(cfg.yres, cfg.xres),
                new_arrays=new_arrays, loss=loss)


def test_sharded_render_matches_single_process(ranks, single):
    for r in ranks:
        assert r["world"] == 2
        assert r["render_launches"] == 0      # CPU tensors: plain K1
        torch.testing.assert_close(r["rgb"], single["rgb"], rtol=0, atol=0)
        torch.testing.assert_close(r["t"], single["t"], rtol=0, atol=0)


def test_sharded_render_matches_glome_tpu(ranks, single):
    cfg = single["cfg"]
    solid, lights, cam = two_prim_scene(G)
    compiled = G.compile_scene(solid, lights)
    tracer = G.Tracer(compiled, G.RenderConfig(xres=cfg.xres, yres=cfg.yres,
                                               maxdepth=cfg.maxdepth))
    renderer = G.Renderer(tracer, cam, tracer.config)
    ys, xs = np.mgrid[0:cfg.yres, 0:cfg.xres]
    o, d = renderer.rays_for_pixels(xs.reshape(-1).astype(np.float32),
                                    ys.reshape(-1).astype(np.float32))
    mesh = jax_make_mesh(8)
    rgb, t = jax_sharded_render_fn(tracer, mesh)(compiled.arrays(), o, d)
    rgb = np.asarray(rgb).reshape(cfg.yres, cfg.xres, 3)
    t = np.asarray(t).reshape(cfg.yres, cfg.xres)
    np.testing.assert_allclose(ranks[0]["rgb"].numpy(), rgb, rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(ranks[0]["t"].numpy(), t, rtol=1e-5)


def test_sharded_train_step_matches_full_batch(ranks, single):
    l0, l1 = (float(r["loss"]) for r in ranks)
    assert l0 == l1
    assert np.isfinite(l0) and l0 > 0
    np.testing.assert_allclose(l0, float(single["loss"]), rtol=1e-6)
    want = tree_leaves(single["new_arrays"])
    old = tree_leaves(single["arrays"])
    moved = 0.0
    for r in ranks:
        got = tree_leaves(r["new_arrays"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    for g, o in zip(tree_leaves(ranks[0]["new_arrays"]), old):
        moved += float((g - o).abs().sum())
    assert moved > 0
    for g0, g1 in zip(tree_leaves(ranks[0]["new_arrays"]),
                      tree_leaves(ranks[1]["new_arrays"])):
        torch.testing.assert_close(g0, g1, rtol=0, atol=0)


def test_sharded_train_step_matches_glome_tpu(ranks, single):
    cfg = single["cfg"]
    solid, lights, cam = two_prim_scene(G)
    compiled = G.compile_scene(solid, lights)
    tracer = G.Tracer(compiled, G.RenderConfig(xres=cfg.xres, yres=cfg.yres,
                                               maxdepth=cfg.maxdepth))
    renderer = G.Renderer(tracer, cam, tracer.config)
    ys, xs = np.mgrid[0:cfg.yres, 0:cfg.xres]
    o, d = renderer.rays_for_pixels(xs.reshape(-1).astype(np.float32),
                                    ys.reshape(-1).astype(np.float32))
    step = jax_sharded_train_step_fn(tracer, jax_make_mesh(8),
                                     lr=sharded.LR)
    new_arrays, loss = step(compiled.arrays(), o, d,
                            jnp.zeros((o.shape[0], 3), jnp.float32))
    want = {k: np.asarray(v) for k, v in _leaves(new_arrays)}
    old = dict(_leaves(compiled.arrays()))
    n_float = 0
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), float(loss), rtol=1e-6)
        got = {k: v.numpy() for k, v in _leaves(r["new_arrays"])}
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-7,
                                           err_msg=k)
                n_float += not np.array_equal(w, old[k])
            else:
                np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert n_float > 0                   # the step moved some leaves


def test_mesh_needs_a_process_group():
    assert TP.init_distributed() is None        # one process: no group
    with pytest.raises(RuntimeError, match="no process group"):
        TP.make_mesh()
