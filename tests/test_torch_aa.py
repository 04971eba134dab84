"""The port's adaptive AA (glome_tpu_torch/aa.py) against glome_tpu's
on the CPU (tests/test_aa.py's scene): the reference's ray budget (pass
1 exactly 1/8 of the padded frame, at most 2 rays/px), flat regions
skipping refinement, per-pass ray counts equal to glome_tpu's, and the
tests/golden/aa_64.npy image.

Image tolerance: atol 1e-6, test_aa.py's own.  The counts decide which
pixels are traced and which interpolated; with every decision equal to
glome_tpu's the two images differ only by float32 shading in another
op order (2.2e-8 at most, measured), far inside it.
"""

import os

import numpy as np
import pytest
import torch

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu.aa import AARenderer as JAARenderer
from glome_tpu_torch.intersect import GROUPS, MEGA
from glome_tpu_torch.aa import AARenderer

GOLD = os.path.join(os.path.dirname(__file__), "golden", "aa_64.npy")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(P):
    matte = P.Uniform(P.Surface(color=(0.9, 0.3, 0.2), alpha=1.0,
                                ambient=0.1, kd=0.9, ks=0.0, shine=1.0))
    floor = P.Uniform(P.Surface(color=(0.4, 0.4, 0.8), alpha=1.0,
                                ambient=0.1, kd=0.8, ks=0.0, shine=1.0))
    solid = P.group([
        P.tex(P.sphere((0.0, 0.0, 0.0), 1.0), matte),
        P.tex(P.plane((0.0, -1.2, 0.0), (0.0, 1.0, 0.0)), floor),
    ])
    lights = [P.light((4.0, 6.0, 4.0), (1.0, 1.0, 1.0))]
    cam = P.camera((0.0, 0.8, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 45.0)
    return solid, lights, cam


def _cfg(P, **kw):
    return P.RenderConfig(xres=64, yres=64, blocksize=32, maxdepth=2,
                          min_tiles=0, **kw)


def _render(solid=None, tracer_cls="WavefrontTracer", route=MEGA, **kw):
    s, lights, cam = _scene(T)
    compiled = T.compile_scene(s if solid is None else solid, lights)
    cfg = _cfg(T, **kw)
    r = AARenderer(getattr(T, tracer_cls)(compiled, cfg, route=route), cam,
                   cfg)
    rgb, depth = r.render(T.to_torch(compiled.arrays(), "cpu"))
    return rgb.numpy(), depth.numpy(), r


@pytest.fixture(scope="module")
def glome_tpu_counts():
    solid, lights, cam = _scene(G)
    compiled = G.compile_scene(solid, lights)
    cfg = _cfg(G)
    r = JAARenderer(G.WavefrontTracer(compiled, cfg), cam, cfg)
    r.render(compiled.arrays())
    return r.last_ray_counts, r.last_overflow


def test_aa_ray_budget():
    rgb, depth, r = _render()
    counts = r.last_ray_counts
    n_pix = 64 * 64
    assert counts["pass1"] == n_pix // 8
    assert n_pix // 8 <= sum(counts.values()) <= 2 * n_pix, counts
    assert counts["pass5"] > 0, counts
    assert np.isfinite(rgb).all()
    assert rgb.shape == (64, 64, 3) and depth.shape == (64, 64)


def test_aa_flat_region_skips_refinement():
    rgb, _depth, r = _render(T.group([]), background=(0.2, 0.3, 0.4))
    counts = r.last_ray_counts
    n_pix = 64 * 64
    assert counts["pass1"] == n_pix // 8
    refine = sum(counts[k] for k in ("pass2", "pass3", "pass4", "pass5"))
    # 4 tiles of 32x32: borders are 4*(4*32) = 512 pixels; each can
    # appear in at most 2 refinement stencils
    assert refine <= 2 * 512, counts
    busy = _render()[2].last_ray_counts
    busy_refine = sum(busy[k] for k in ("pass2", "pass3", "pass4",
                                        "pass5"))
    assert busy_refine > 2 * refine, (counts, busy)
    np.testing.assert_allclose(rgb[5, 5], (0.2, 0.3, 0.4), atol=1e-6)


@pytest.mark.parametrize("tracer_cls,route", [
    ("WavefrontTracer", MEGA), ("Tracer", MEGA),
    ("Tracer", GROUPS)])
def test_aa_counts_and_golden_match_glome_tpu(glome_tpu_counts, tracer_cls,
                                              route):
    """Per-pass counts equal glome_tpu's; the frame within atol 1e-6 of
    tests/golden/aa_64.npy; no overflow, under glome_tpu's keys."""
    want_counts, want_overflow = glome_tpu_counts
    rgb, _depth, r = _render(tracer_cls=tracer_cls, route=route)
    assert r.last_ray_counts == want_counts
    assert set(r.last_overflow) == set(want_overflow)
    assert not any(r.last_overflow.values())
    gold = np.load(GOLD)
    print(f"{tracer_cls}/{route}: max |rgb - aa_64.npy| "
          f"{np.abs(rgb - gold).max():.3g}")
    np.testing.assert_allclose(rgb, gold, atol=1e-6)


def test_aa_uses_the_callers_tracer():
    solid, lights, cam = _scene(T)
    compiled = T.compile_scene(solid, lights)
    cfg = _cfg(T)
    tracer = T.Tracer(compiled, cfg, route=GROUPS)
    assert AARenderer(tracer, cam, cfg).tracer is tracer


@pytest.mark.parametrize("tracer_cls,route", [
    ("WavefrontTracer", MEGA), ("WavefrontTracer", GROUPS),
    ("Tracer", MEGA), ("Tracer", GROUPS)])
def test_tmax_zero_lanes_are_misses(tracer_cls, route):
    """The tracer's tmax reaches the select kernels' seed: a lane with
    tmax 0 is culled (a transparent miss), the rest trace as before."""
    solid, lights, cam = _scene(T)
    compiled = T.compile_scene(solid, lights)
    tracer = getattr(T, tracer_cls)(compiled, _cfg(T), route=route)
    arrays = T.to_torch(compiled.arrays(), "cpu")
    o = torch.tensor([[0.0, 0.8, 4.0]] * 4)
    d = torch.nn.functional.normalize(
        torch.tensor([[0.0, -0.8, -4.0], [0.0, -0.8, -4.0],
                      [0.3, -1.5, -4.0], [0.3, -1.5, -4.0]]), dim=-1)
    tmax = torch.tensor([T.INFINITY, 0.0, T.INFINITY, 0.0])
    full = tracer.trace(arrays, o, d)
    cut = tracer.trace(arrays, o, d, tmax=tmax)
    assert bool((full.t < T.INFINITY).all())
    live = tmax > 0
    np.testing.assert_array_equal(cut.color[live].numpy(),
                                  full.color[live].numpy())
    assert bool((cut.t[~live] == T.INFINITY).all())
    assert bool((cut.color[~live] == 0).all())
