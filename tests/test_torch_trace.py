"""The port's recursive Tracer (glome_tpu_torch/trace.py) against
glome_tpu's Tracer on the CPU, mirroring tests/test_trace.py, on both
intersection routes (intersect.MEGA through the plain K1, intersect.GROUPS
through the plain K4/K5), plus: its compaction helpers, a portal whose
target scene has a light set of its own, and the 90x60 TestScene frame
against the CPU golden.

Tolerances: the analytic shading checks keep test_trace.py's.  Against
glome_tpu: t within rtol 5e-5 / atol 1e-4 (ROADMAP Queue 3), the same
winner, colors within atol 5e-5.  The colors are float32 shading of the
same winners in another op order; behind glass and through the portal
transform a child ray starts from a hit point that differs within that t
tolerance, which moved 3 of the portal scene's 6,144 channel values by
2.9e-5 when traced at depth 3.  Gradients within rtol
1e-3 of the largest |g| (per-parameter sums over lanes in another
order).  The TestScene frame is held to test_golden.py:129-131's drift
canaries.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu.trace import Tracer as JTracer
from glome_tpu_torch.intersect import GROUPS, MEGA
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch.io import quantize, read_png
from glome_tpu_torch.render import pixel_coords, primary_rays
from glome_tpu_torch.scenes import test_scene as torch_test_scene
from glome_tpu_torch.scenes.phasescene import warp_lights_scene
from glome_tpu_torch.trace import (compact_indices, compact_ranks, gather,
                                   scatter)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "testscene_90x60_cpu.png")
ROUTES = (MEGA, GROUPS)
COLOR_ATOL = 5e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(data):
    o = np.asarray([r[0] for r in data], dtype=np.float32)
    d = np.asarray([r[1] for r in data], dtype=np.float64)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _both(make, lights_of, rays, maxdepth=3, route=MEGA, **cfg_kw):
    """The same scene and rays through glome_tpu's Tracer and the port's:
    (jax TraceResult as numpy dict, port TraceResult, port tracer)."""
    cj = G.compile_scene(make(G), lights_of(G))
    ct = T.compile_scene(make(T), lights_of(T))
    o, d = rays
    rj = jax.jit(lambda a: JTracer(cj, G.RenderConfig(
        maxdepth=maxdepth, **cfg_kw)).trace(a, jnp.asarray(o),
                                            jnp.asarray(d)))(cj.arrays())
    tracer = T.Tracer(ct, T.RenderConfig(maxdepth=maxdepth, **cfg_kw),
                      route=route)
    rt = tracer.trace(T.to_torch(ct.arrays(), "cpu"), torch.as_tensor(o),
                      torch.as_tensor(d))
    return ({k: np.asarray(v) for k, v in rj._asdict().items()
             if v is not None}, rt, tracer)


def _assert_matches(want, got):
    np.testing.assert_allclose(got.color.detach().numpy(), want["color"],
                               atol=COLOR_ATOL, rtol=0)
    np.testing.assert_allclose(got.t.detach().numpy(), want["t"],
                               rtol=5e-5, atol=1e-4)
    np.testing.assert_array_equal(got.prim_serial.numpy(),
                                  want["prim_serial"])
    assert got.overflow is None


# --- compaction helpers -----------------------------------------------------

def test_compaction_helpers_are_exact_and_differentiable():
    mask = torch.tensor([False, True, True, False, True, False])
    assert compact_ranks(mask).tolist() == [-1, 0, 1, 1, 2, 2]
    idx = compact_indices(mask)
    assert idx.tolist() == [1, 2, 4]
    assert compact_indices(mask, 3).tolist() == [1, 2, 4]
    # glome_tpu's capacities pad or drop; the port's queues are exact
    with pytest.raises(ValueError):
        compact_indices(mask, 5)
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    x.requires_grad_(True)
    g = gather(x, idx)
    np.testing.assert_array_equal(g.detach().numpy(),
                                  x.detach()[[1, 2, 4]].numpy())
    vals = torch.full((3, 2), 7.0, requires_grad=True)
    template = torch.zeros(6, 2, requires_grad=True)
    out = scatter(template, idx, vals)
    assert out[[1, 2, 4]].eq(7).all() and out[[0, 3, 5]].eq(0).all()
    assert template.eq(0).all()          # out of place
    # gradients reach the gathered rows, the values and the rows of the
    # template that were not overwritten
    (g.sum() + (out * torch.arange(6.0)[:, None]).sum()).backward()
    assert x.grad[[1, 2, 4]].eq(1).all() and x.grad[[0, 3, 5]].eq(0).all()
    assert vals.grad[:, 0].tolist() == [1.0, 2.0, 4.0]
    assert template.grad[:, 0].tolist() == [0.0, 0.0, 0.0, 3.0, 0.0, 5.0]


# --- shading semantics (tests/test_trace.py) --------------------------------

@pytest.mark.parametrize("route", ROUTES)
def test_surface_shading_and_shadows(route):
    def make(P):
        m_red = P.Surface(color=(1, 0, 0), alpha=1, ambient=0.2, kd=1.0)
        m_white = P.Surface(color=(1, 1, 1), alpha=1, ambient=0.1, kd=1.0)
        return P.group([
            P.tex(P.sphere((0, 1, 0), 0.5), P.t_uniform(m_red)),
            P.tex(P.plane((0, 0, 0), (0, 1, 0)), P.t_uniform(m_white))])
    rays = _rays([((0, 3, 0), (0, -1, 0)),      # sphere top: lit
                  ((0.55, 3, 0), (0, -1, 0)),   # plane, in the shadow disk
                  ((3, 3, 0), (0, -1, 0))])     # plane, lit
    want, got, tracer = _both(make, lambda P: (P.light((0, 5, 0),
                                                       (25, 25, 25)),),
                              rays, route=route)
    _assert_matches(want, got)
    c = got.color.numpy()
    np.testing.assert_allclose(got.t[0], 1.5, rtol=1e-4)
    direct = 25.0 / 3.5 ** 2
    np.testing.assert_allclose(c[0, :3], [0.2 + direct, direct, direct],
                               rtol=1e-3)
    llen = np.sqrt(34.0)
    np.testing.assert_allclose(c[2, :3], [0.1 + 25.0 / 34.0 * (5.0 / llen)]
                               * 3, rtol=1e-3)
    np.testing.assert_allclose(c[1, :3], [0.1] * 3, atol=1e-3)
    # one intersect and one shadow batch (maxdepth 3, no child rays)
    assert tracer.last_batches == 2


@pytest.mark.parametrize("route", ROUTES)
def test_backface_light_culled(route):
    def make(P):
        m = P.Surface(color=(0.5, 0.5, 0.5), alpha=1, ambient=0.3, kd=1.0)
        return P.tex(P.plane((0, 0, 0), (0, 1, 0)), P.t_uniform(m))
    want, got, _ = _both(make, lambda P: (P.light((0, -5, 0),
                                                  (100, 100, 100)),),
                         _rays([((0, 3, 0), (0, -1, 0))]), route=route)
    _assert_matches(want, got)
    np.testing.assert_allclose(got.color.numpy()[0, :3], [0.15] * 3,
                               atol=1e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_mirror_reflection(route):
    def make(P):
        m_red = P.Surface(color=(1, 0, 0), alpha=1, ambient=1.0, kd=0.0)
        return P.group([
            P.tex(P.plane((0, 0, 0), (0, 1, 0)), P.t_uniform(P.Reflect(1.0))),
            P.tex(P.sphere((0, 2, 0), 0.5), P.t_uniform(m_red))])
    want, got, _ = _both(make, lambda P: (), _rays([((0, 1, 0),
                                                     (0, -1, 0))]),
                         route=route)
    _assert_matches(want, got)
    c = got.color.numpy()
    assert c[0, 0] > 0.9 and c[0, 1] < 1e-3


@pytest.mark.parametrize("route", ROUTES)
def test_recursion_budget(route):
    def make(P):
        return P.group([
            P.tex(P.plane((0, -1, 0), (0, 1, 0)), P.t_uniform(P.Reflect(1.0))),
            P.tex(P.plane((0, 1, 0), (0, -1, 0)),
                  P.t_uniform(P.Reflect(1.0)))])
    want, got, tracer = _both(make, lambda P: (),
                              _rays([((0, 0, 0), (0, -1, 0))]), route=route)
    _assert_matches(want, got)
    assert torch.isfinite(got.color).all()
    # depth 3: one intersect per level; the floor level's reflection is
    # never traced (no lights: no shadow batch)
    assert tracer.last_batches == 3


def test_pixel_gradients_match_finite_differences():
    """AD of a shaded pixel w.r.t. the sphere center against central FD
    (test_trace.py:108-140's point), and against jax.grad through
    glome_tpu's Tracer (rtol 1e-3 of the largest |g|)."""
    def make(P):
        m = P.Surface(color=(0.8, 0.2, 0.1), alpha=1, ambient=0.1, kd=1.0)
        return P.tex(P.sphere((0.2, 0.1, 0), 1.0), P.t_uniform(m))
    lights = (T.light((3, 4, -5), (200, 200, 200)),)
    compiled = T.compile_scene(make(T), lights)
    tracer = T.Tracer(compiled, T.RenderConfig(maxdepth=2))
    o = torch.tensor([[0.3, -0.2, -4.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])

    def loss(a):
        return tracer.trace(a, o, d).color[..., :3].sum()

    arrays = T.to_torch(compiled.arrays(), "cpu")
    arrays["scenes"][0][0]["center"].requires_grad_(True)
    loss(arrays).backward()
    gc = arrays["scenes"][0][0]["center"].grad.numpy()[0]
    assert np.any(np.abs(gc) > 1e-4)

    eps = 1e-3

    def at(dx):
        a2 = T.to_torch(compiled.arrays(), "cpu")
        a2["scenes"][0][0]["center"][0, 0] += dx
        return float(loss(a2))

    fd = (at(eps) - at(-eps)) / (2 * eps)
    np.testing.assert_allclose(gc[0], fd, rtol=0.05, atol=1e-3)

    cj = G.compile_scene(make(G), (G.light((3, 4, -5), (200, 200, 200)),))
    tj = JTracer(cj, G.RenderConfig(maxdepth=2))
    gj = jax.grad(lambda a: jnp.sum(tj.trace(
        a, jnp.asarray(o.numpy()), jnp.asarray(d.numpy())).color[..., :3]))(
            jax.tree.map(jnp.asarray, cj.arrays()))
    want = np.asarray(gj["scenes"][0][0]["center"])[0]
    np.testing.assert_allclose(gc, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("route", ROUTES)
def test_background_miss_shader(route):
    def make(P):
        m = P.Surface(color=(1, 0, 0), alpha=1, ambient=1.0, kd=0.0)
        return P.tex(P.sphere((0, 0, 0), 0.5), P.t_uniform(m))
    rays = _rays([((0, 0, -3), (0, 0, 1)), ((0, 5, -3), (0, 0, 1))])
    want, got, _ = _both(make, lambda P: (), rays, maxdepth=2, route=route,
                         background=(0.1, 0.2, 0.3))
    _assert_matches(want, got)
    c = got.color.numpy()
    np.testing.assert_allclose(c[1], [0.1, 0.2, 0.3, 1.0], atol=1e-6)
    np.testing.assert_allclose(c[0, :3], [1, 0, 0], atol=1e-5)
    want0, got0, _ = _both(make, lambda P: (), rays, maxdepth=2,
                           route=route)
    _assert_matches(want0, got0)
    np.testing.assert_allclose(got0.color.numpy()[1], 0.0, atol=0)


@pytest.mark.parametrize("route", ROUTES)
def test_background_seen_in_mirror(route):
    def make(P):
        return P.tex(P.plane((0, 0, 0), (0, 1, 0)), P.t_uniform(P.Reflect(1.0)))
    want, got, _ = _both(make, lambda P: (), _rays([((0, 1, 0),
                                                     (0, -1, 0))]),
                         route=route, background=(0.0, 0.5, 0.0))
    _assert_matches(want, got)
    np.testing.assert_allclose(got.color.numpy()[0], [0.0, 0.5, 0.0, 1.0],
                               atol=1e-5)


def test_light_custom_falloff():
    m = T.Surface(color=(1, 1, 1), alpha=1, ambient=0.0, kd=1.0)
    scene = T.tex(T.plane((0, 0, 0), (0, 1, 0)), T.t_uniform(m))
    lights = (T.light((0, 5, 0), (0.6, 0.6, 0.6),
                      falloff=lambda d: torch.ones_like(d)),)
    compiled = T.compile_scene(scene, lights)
    o, d = _rays([((0, 3, 0), (0, -1, 0))])
    res = T.Tracer(compiled, T.RenderConfig(maxdepth=2)).trace(
        T.to_torch(compiled.arrays(), "cpu"), torch.as_tensor(o),
        torch.as_tensor(d))
    np.testing.assert_allclose(res.color.numpy()[0, :3], [0.6] * 3,
                               rtol=1e-5)


@pytest.mark.parametrize("cls", ["Tracer", "WavefrontTracer"])
def test_reflect_depth_exhaustion_is_transparent(cls):
    # Shader.hs:107-118: the child trace at the recursion floor is the
    # transparent miss, so a Reflect seen there is transparent, not black
    scene = T.tex(T.plane((0, 0, 0), (0, 1, 0)), T.t_uniform(T.Reflect(1.0)))
    compiled = T.compile_scene(scene, ())
    o, d = _rays([((0, 1, 0), (0, -1, 0))])
    res = getattr(T, cls)(compiled, T.RenderConfig(maxdepth=1)).trace(
        T.to_torch(compiled.arrays(), "cpu"), torch.as_tensor(o),
        torch.as_tensor(d))
    np.testing.assert_allclose(res.color.numpy()[0], 0.0, atol=0)


def test_depth_zero_is_the_transparent_miss():
    scene = T.tex(T.sphere((0, 0, 0), 1.0), T.t_uniform(T.Surface(color=(1, 1, 1))))
    compiled = T.compile_scene(scene, ())
    tracer = T.Tracer(compiled)
    res = tracer.trace(T.to_torch(compiled.arrays(), "cpu"),
                       torch.tensor([[0.0, 0.0, -3.0]]),
                       torch.tensor([[0.0, 0.0, 1.0]]), recurs=0)
    assert res.color.eq(0).all() and res.t[0] == T.INFINITY
    assert res.prim_serial.tolist() == [-1] and tracer.last_batches == 0


# --- a portal with its own light set ----------------------------------------

def _warp_case():
    sj, lj, _ = warp_lights_scene(G)
    st, lt, cam = warp_lights_scene(T)
    xres, yres = 48, 32
    ys, xs = np.mgrid[0:yres, 0:xres]
    xc, yc = pixel_coords(xres, yres,
                          torch.as_tensor(xs.reshape(-1), dtype=torch.float32),
                          torch.as_tensor(ys.reshape(-1), dtype=torch.float32))
    o, d = primary_rays(cam, xc, yc)
    return G.compile_scene(sj, lj), T.compile_scene(st, lt), o, d


@pytest.fixture(scope="module")
def warp_case():
    cj, ct, o, d = _warp_case()
    rj = jax.jit(lambda a: JTracer(cj, G.RenderConfig(maxdepth=2)).trace(
        a, jnp.asarray(o.numpy()), jnp.asarray(d.numpy())))(cj.arrays())
    return cj, ct, o, d, {k: np.asarray(v) for k, v in rj._asdict().items()
                          if v is not None}


@pytest.mark.parametrize("route", ROUTES)
def test_portal_with_its_own_lights_matches_glome_tpu(warp_case, route):
    _cj, ct, o, d, want = warp_case
    assert ct.warp_mats and tuple(ct.warp_mats[0].lights) != ct.lights
    with pytest.raises(NotImplementedError, match="Tracer"):
        T.WavefrontTracer(ct, T.RenderConfig(maxdepth=3))
    tracer = T.Tracer(ct, T.RenderConfig(maxdepth=2), route=route)
    arrays = T.to_torch(ct.arrays(), "cpu")
    got = tracer.trace(arrays, o, d)
    _assert_matches(want, got)
    # the portal is in view, and the rays through it see the target scene
    # under its own lights
    hit = tracer._intersect(arrays, 0, o, d,
                            torch.full((o.shape[0],), T.INFINITY))
    portal = hit.hit & tracer._stack_uses(hit.tex_stack,
                                          tracer.warp_texids[0])
    assert int(portal.sum()) >= 40
    assert float(got.color[portal, :3].abs().sum()) > 0


def test_portal_kernel_set_switch(warp_case):
    """select=megakernel.PLAIN gives the same frame on CPU tensors (the
    kernel set is what the card switches); an unknown set is refused."""
    _cj, ct, o, d, want = warp_case
    got = T.Tracer(ct, T.RenderConfig(maxdepth=2), select=MK.PLAIN).trace(
        T.to_torch(ct.arrays(), "cpu"), o, d)
    _assert_matches(want, got)
    with pytest.raises(ValueError):
        T.Tracer(ct, select="fast")
    with pytest.raises(ValueError):
        T.Tracer(ct, route="sideways")


# --- the TestScene frame ------------------------------------------------------

def test_testscene_frame_within_golden_canaries():
    solid, lights, cam = torch_test_scene()
    compiled = T.compile_scene(solid, lights)
    cfg = T.RenderConfig.tuned(xres=90, yres=60)
    tracer = T.Tracer(compiled, cfg)
    calls = MK.mega_select_plain.calls
    rgb, depth = T.Renderer(tracer, cam, cfg).render(
        T.to_torch(compiled.arrays(), "cpu"))
    assert rgb.shape == (60, 90, 3) and torch.isfinite(rgb).all()
    assert torch.isfinite(depth[depth < T.INFINITY]).all()
    # one K1 plain call per intersect and shadow batch
    assert MK.mega_select_plain.calls - calls == tracer.last_batches > 6
    got = quantize(rgb.numpy())
    want = read_png(GOLDEN)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    print(f"drift vs CPU golden: mean {diff.mean():.4f} levels, "
          f"{int((diff > 64).sum())}/{diff.size} pixels > 64")
    assert diff.mean() <= 3.0
    assert (diff > 64).sum() <= 0.006 * diff.size
