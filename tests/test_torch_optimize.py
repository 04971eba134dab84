"""The port's optimization loop (glome_tpu_torch/optimize.py) against
glome_tpu's on the CPU, its checkpoints, and the full TestScene's
gradients (BASELINE config 5's scene; glome_tpu_torch/tools/config5_e2e.py).

Tolerances: torch.optim.Adam against optax.adam on the same gradients
within rtol 1e-6 (the same update in float32); three steps of the loop on
tests/test_optimize.py's scene within rtol 1e-4 of glome_tpu's losses and
parameters (the two trace the same winners and shade in another op
order); a run cut after its checkpoint and resumed equals the uncut run
bit for bit (the CPU run is deterministic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu.optimize import optimize as j_optimize
from glome_tpu.render import Renderer as JRenderer
from glome_tpu_torch.optimize import (optimize, pixel_loss_fn, tree_leaves,
                                      tree_map)
from glome_tpu_torch.tools import config5_e2e as C5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(P):
    scene = P.group([
        P.tex(P.sphere((0.0, 1.0, 0.0), 1.0),
              P.t_uniform(P.Surface(color=(0.9, 0.2, 0.2), ambient=0.3,
                                    kd=0.7))),
        P.tex(P.plane((0, 0, 0), (0, 1, 0)),
              P.t_uniform(P.Surface(color=(0.2, 0.7, 0.3), ambient=0.3,
                                    kd=0.7))),
    ])
    lights = (P.light((-3, 5, 3), (25, 25, 25)),)
    return P.compile_scene(scene, lights)


def _cfg(P):
    return P.RenderConfig(xres=48, yres=32, maxdepth=1)


def _pixel_grid():
    ys, xs = np.mgrid[0:32, 0:48]
    return (xs.reshape(-1).astype(np.float32),
            ys.reshape(-1).astype(np.float32))


def _perturbed(arrays_np):
    """tests/test_optimize.py's _perturb: +0.15 on every (1,) float leaf."""
    return jax.tree.map(lambda p: p + 0.15 if p.shape == (1,) else p,
                        arrays_np)


def _setup_port():
    compiled = _scene(T)
    cfg = _cfg(T)
    tracer = T.Tracer(compiled, cfg)
    cam = T.camera((0, 2, 5), (0, 1, 0), (0, 1, 0), 45)
    o, d = T.Renderer(tracer, cam, cfg).rays_for_pixels(*_pixel_grid(),
                                                        "cpu")
    true_arrays = T.to_torch(compiled.arrays(), "cpu")
    res = tracer.trace(true_arrays, o, d)
    target = res.color[..., :3] * res.color[..., 3:4]
    start = T.to_torch(_perturbed(compiled.arrays()), "cpu")
    return tracer, o, d, target.detach(), start


def test_adam_matches_optax_adam():
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0, 0.0, 2.0)]
    opt = optax.adam(1e-2)
    pj = jnp.asarray(p0)
    state = opt.init(pj)
    p = torch.tensor(p0, requires_grad=True)
    topt = torch.optim.Adam([p], lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        p.grad = torch.tensor(g)
        topt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj),
                               rtol=1e-6, atol=1e-7)


def test_three_steps_match_glome_tpu():
    compiled = _scene(G)
    cfg = _cfg(G)
    tracer = G.Tracer(compiled, cfg)
    cam = G.camera((0, 2, 5), (0, 1, 0), (0, 1, 0), 45)
    o, d = JRenderer(tracer, cam, cfg).rays_for_pixels(*_pixel_grid())
    res = tracer.trace(compiled.arrays(), o, d)
    target = res.color[..., :3] * res.color[..., 3:4]
    want = j_optimize(tracer, _perturbed(compiled.arrays()), o, d, target,
                      steps=3, lr=3e-2)

    tr, o_t, d_t, target_t, start = _setup_port()
    got = optimize(tr, start, o_t, d_t, target_t, steps=3, lr=3e-2)
    assert got.steps_run == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    w_leaves = jax.tree.leaves(want.arrays)
    g_leaves = tree_leaves({"scenes": got.arrays["scenes"],
                            "lights": got.arrays["lights"]})
    # jax.tree orders dict keys; compare leaf by leaf under those keys
    for (si, sc) in enumerate(got.arrays["scenes"]):
        for gi, ga in enumerate(sc):
            for k, v in ga.items():
                np.testing.assert_allclose(
                    v.numpy(), np.asarray(want.arrays["scenes"][si][gi][k]),
                    rtol=1e-4, atol=1e-6, err_msg=f"{si}/{gi}/{k}")
    for k, v in got.arrays["lights"].items():
        np.testing.assert_allclose(v.numpy(),
                                   np.asarray(want.arrays["lights"][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert len(w_leaves) == len(g_leaves)
    # the run moved the perturbed sphere radius back toward 1.0
    sphere = next(ga for ga in got.arrays["scenes"][0] if "radius" in ga)
    assert float(sphere["radius"][0]) < 1.15


def test_checkpoint_resume_equals_uncut_run(tmp_path):
    tr, o, d, target, start = _setup_port()
    uncut = optimize(tr, start, o, d, target, steps=4, lr=3e-2,
                     checkpoint_dir=str(tmp_path / "a"), checkpoint_every=1)
    # the newest two checkpoints are kept
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "step_00000003.pt", "step_00000004.pt"]
    cut = optimize(tr, start, o, d, target, steps=2, lr=3e-2,
                   checkpoint_dir=str(tmp_path / "b"), checkpoint_every=5)
    assert cut.steps_run == 2
    resumed = optimize(tr, start, o, d, target, steps=4, lr=3e-2,
                       checkpoint_dir=str(tmp_path / "b"),
                       checkpoint_every=5)
    assert resumed.steps_run == 2
    assert cut.losses + resumed.losses == uncut.losses
    for a, b in zip(tree_leaves(resumed.arrays), tree_leaves(uncut.arrays)):
        assert torch.equal(a, b)
    # a finished run resumes to no step at all
    again = optimize(tr, start, o, d, target, steps=4, lr=3e-2,
                     checkpoint_dir=str(tmp_path / "b"))
    assert again.steps_run == 0 and again.losses == []


def test_non_finite_gradients_are_zeroed_then_filtered():
    """Gradients pass through nan_to_num, then grad_filter: a leaf whose
    gradient is NaN stays where it is while the others train, and a
    filter that zeroes every leaf leaves every parameter where it is."""
    tr, o, d, target, start = _setup_port()

    def poisoned(params, o_, d_, t_):
        r = params["lights"]["radius"]
        # 0 in the forward pass, NaN in the backward pass (inf - inf)
        nan_grad = torch.sqrt(torch.clamp(r - r, min=0.0)).sum()
        return pixel_loss_fn(tr)(params, o_, d_, t_) + nan_grad

    out = optimize(tr, start, o, d, target, steps=2, lr=3e-2,
                   loss_fn=poisoned)
    assert all(np.isfinite(out.losses))
    assert all(torch.isfinite(v).all() for v in tree_leaves(out.arrays))
    assert torch.equal(out.arrays["lights"]["radius"],
                       start["lights"]["radius"])
    assert not torch.equal(out.arrays["lights"]["pos"],
                           start["lights"]["pos"])
    frozen = optimize(tr, start, o, d, target, steps=2, lr=3e-2,
                      loss_fn=poisoned,
                      grad_filter=lambda g: tree_map(torch.zeros_like, g))
    for a, b in zip(tree_leaves(frozen.arrays), tree_leaves(start)):
        assert torch.equal(a, b)


# --- the full TestScene (config 5's scene) ---------------------------------

def _testscene(xres, yres):
    compiled, cfg, cam, tracer, arrays = C5.setup(xres, yres, "cpu")
    o, d = C5.pixel_rays(tracer, cam, cfg, "cpu")
    return compiled, cfg, cam, tracer, arrays, o, d


@pytest.fixture(scope="module")
def testscene():
    return _testscene(45, 30)


def test_testscene_pixel_gradients_are_finite():
    """Every parameter gradient of the hard pixel loss over the whole
    TestScene at 90x60 is finite (a grazing lane must not poison any),
    and most leaves, the lights among them, receive some."""
    compiled, cfg, _cam, tracer, arrays, o, d = _testscene(90, 60)
    params = tree_map(lambda p: p.clone().requires_grad_(True), arrays)
    target = torch.full((o.shape[0], 3), 0.5)
    pixel_loss_fn(tracer)(params, o, d, target).backward()
    n_leaves = n_nonzero = 0
    for v in tree_leaves(params):
        n_leaves += 1
        g = torch.zeros_like(v) if v.grad is None else v.grad
        assert torch.isfinite(g).all()
        n_nonzero += int(bool((g != 0).any()))
    print(f"{n_nonzero} of {n_leaves} leaves with a nonzero gradient")
    assert n_nonzero >= 0.5 * n_leaves
    assert (params["lights"]["pos"].grad != 0).any()


def test_config5_soft_step_trains_only_the_perturbed_row(testscene):
    """One config 5 step at 45x30: the pooled soft loss of the perturbed
    scene against the AA target; after only_group the gradient is finite
    and nonzero on the perturbed row's center and radius and zero on
    every other leaf."""
    from glome_tpu_torch.soft import SoftTracer
    compiled, cfg, cam, tracer, arrays, o, d = testscene
    target, aa = C5.aa_target(tracer, cam, cfg, arrays)
    assert target.shape == (45 * 30, 3) and not any(
        aa.last_overflow.values())
    pert = C5.perturb(arrays)
    e0 = C5.param_error(pert, arrays)
    np.testing.assert_allclose(e0, (0.06, 0.04 * 3.5), rtol=1e-5)
    params = tree_map(lambda p: p.clone().requires_grad_(True), pert)
    loss = C5.coarse_to_fine_loss(SoftTracer(tracer), cfg.yres, cfg.xres)(
        params, o, d, target)
    assert torch.isfinite(loss) and float(loss.detach()) > 0
    loss.backward()
    grads = C5.only_group()(tree_map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad, params))
    g = grads["scenes"][0][C5.GROUP]
    assert torch.isfinite(g["center"]).all() and torch.isfinite(
        g["radius"]).all()
    assert (g["center"][C5.ROW] != 0).any() and g["radius"][C5.ROW] != 0
    kept = {id(g["center"]), id(g["radius"])}
    for v in tree_leaves(grads):
        if id(v) in kept:
            rest = torch.cat([v[:C5.ROW], v[C5.ROW + 1:]])
            assert rest.eq(0).all()
        else:
            assert v.eq(0).all()
