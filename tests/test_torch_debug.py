"""Work counters in the port (glome_tpu_torch/debug.py) against
glome_tpu's.

The counters are glome_tpu's work model -- dense groups cost their
size, deferred groups their plan's scans, convex CSG its members, a BVH
group the boxes and leaf prims its 256-ray tile walk charges -- so on
the same rays the port's must equal glome_tpu's exactly:

  - ray_debug_counts on every ray of a frame: equal;
  - trace_debug_counts at depth 1 and 2: equal.  The port's queues are
    exact where glome_tpu's hold its rays in 128-lane rows, so a child
    ray's BVH tile-mates differ.  The counts still agree: a ray is
    charged only for the boxes it hits, and each child box lies inside
    its parent's, so a node its tile-mates make the tile enter is one
    whose box it misses;
  - at depth 3 on the reflective scene below, 99.9% of the pixels agree
    on prims and 98.9% on nodes.  The rest are rays that glome_tpu's CPU
    route itself traces differently: the level-2 refracted rays leave
    the glass box with non-unit directions (|d| up to 2.3), and
    glome_tpu's skip-link BVH pass (intersect.bvh_pass) misses sphere
    hits on 35 of them that its own dense pass, and the port, find.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu import debug as JD
from glome_tpu_torch import debug as TD
from glome_tpu_torch.render import tile_order
from glome_tpu_torch.scenes.phasescene import (phase_kinds_lights,
                                               phase_kinds_scene)

XRES, YRES = 48, 32


def test_dense_group_counts_full_size():
    scene = T.group([T.sphere((i, 0, 0), 0.3) for i in range(10)])
    compiled = T.compile_scene(scene, ())
    o = torch.tensor([[0.0, 0.0, -5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    prims, nodes = TD.ray_debug_counts(
        compiled, T.to_torch(compiled.arrays(), "cpu"), o, d)
    assert int(prims[0]) == 10
    assert int(nodes[0]) == 0


def test_bvh_counts_depend_on_ray():
    lat = [T.sphere((0.5 * a, 0.5 * b, 5 + 0.5 * c), 0.2)
           for a in range(15) for b in range(15) for c in range(15)]
    compiled = T.compile_scene(T.group(lat), (), accel_min_size=512)
    g = compiled.scenes[0].groups[0]
    assert g.accel_eligible
    o = torch.tensor([[3.5, 3.5, -5.0], [400.0, 400.0, -5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    prims, nodes = TD.ray_debug_counts(
        compiled, T.to_torch(compiled.arrays(), "cpu"), o, d)
    assert 0 < int(prims[0]) < len(lat)
    assert int(nodes[0]) > 10
    assert int(nodes[1]) == 0 and int(prims[1]) == 0


def test_debug_image_runs():
    from glome_tpu_torch.scenes.testscene import cust_cam
    m = T.Uniform(T.Surface(color=(1, 0, 0), ambient=1.0))
    compiled = T.compile_scene(T.tex(T.sphere((0, 0, 0), 1.0), m), ())
    img, prims, nodes = TD.debug_image(
        compiled, T.to_torch(compiled.arrays(), "cpu"), cust_cam(), 32, 24)
    assert img.shape == (24, 32, 3)
    assert np.all((img >= 0) & (img <= 1))
    assert prims.max() > 0


def _mirror_scene(P):
    mirror = P.Uniform(P.Reflect())
    matte = P.Uniform(P.Surface(color=(0.5, 0.5, 0.5), ambient=0.1,
                                kd=0.9))
    scene = P.group([
        P.tex(P.sphere((0.0, 0.0, 0.0), 1.0), mirror),
        P.tex(P.plane((0.0, -1.5, 0.0), (0.0, 1.0, 0.0)), matte),
    ])
    return scene, [P.light((3.0, 4.0, -6.0), (1.0, 1.0, 1.0))]


def test_trace_debug_full_trace():
    """test_debug.py's full-trace test on the port, and equal to
    glome_tpu's counts for the same two rays."""
    sj, lj = _mirror_scene(G)
    st, lt = _mirror_scene(T)
    cj, ct = G.compile_scene(sj, lj), T.compile_scene(st, lt)
    aj, at = cj.arrays(), T.to_torch(ct.arrays(), "cpu")
    o_np = np.asarray([[0, 0, -4], [50, 0.5, -4]], np.float32)
    d_np = np.asarray([[0, 0, 1], [0, 0, 1]], np.float32)
    o, d = torch.as_tensor(o_np), torch.as_tensor(d_np)
    p0, _n0 = TD.ray_debug_counts(ct, at, o, d)
    p = {r: TD.trace_debug_counts(ct, at, o, d, recurs=r)[0]
         for r in (1, 2, 3)}
    assert int(p[1][0]) > int(p0[0])
    assert int(p[2][0]) > int(p[1][0])
    assert int(p[3][0]) >= int(p[2][0])
    for r in (1, 2, 3):
        pj, nj = jax.jit(lambda a, o_, d_: JD.trace_debug_counts(
            cj, a, o_, d_, recurs=r))(aj, jnp.asarray(o_np),
                                      jnp.asarray(d_np))
        pt, nt = TD.trace_debug_counts(ct, at, o, d, recurs=r)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


def _reflective_scene(P):
    """A mirror sphere inside a 200-sphere lattice (one group, over a
    BVH once compiled with accel_min_size=64), a glass box and a floor:
    reflected and refracted child rays walk the BVH."""
    mirror = P.Uniform(P.Reflect())
    glass = P.t_uniform(P.Refract(0.2, 0.8, 1.4))
    matte = P.Uniform(P.Surface(color=(0.5, 0.5, 0.5), ambient=0.1,
                                kd=0.9))
    lat = [P.sphere((-3 + 0.6 * a, 0.3 + 0.6 * b, 2 + 0.6 * c), 0.22)
           for a in range(10) for b in range(4) for c in range(5)]
    return P.group([
        P.tex(P.sphere((0.0, 0.0, 0.0), 1.0), mirror),
        P.tex(P.box((1.6, -0.6, -1.1), (2.8, 0.6, 0.1)), glass),
        P.tex(P.group(lat), matte),
        P.tex(P.plane((0.0, -1.5, 0.0), (0.0, 1.0, 0.0)), matte),
    ]), [P.light((3.0, 4.0, -6.0), (1.0, 1.0, 1.0))]


def _phase_kinds(P):
    return phase_kinds_scene(P), phase_kinds_lights(P)


SCENES = {
    # scene, camera (pos, at), and per depth the least share of pixels
    # whose (prims, nodes) equal glome_tpu's; 1.0 = every pixel.  The
    # phase-kinds scene has no reflective material, so its depth 1 is
    # its whole trace.
    "phase_kinds": (_phase_kinds, ((0.5, 0.2, -4.0), (0.0, 0.0, 6.0)),
                    {1: (1.0, 1.0)}),
    "reflective": (_reflective_scene, ((0.0, 1.0, -6.0), (0.0, 0.5, 2.0)),
                   {1: (1.0, 1.0), 2: (1.0, 1.0), 3: (0.999, 0.988)}),
}
_FRAMES = {}


def _frame(name):
    """The scene compiled by both packages (BVH groups above 64 prims)
    and the primary rays of an XRES x YRES frame in tile order."""
    if name in _FRAMES:
        return _FRAMES[name]
    scene, (pos, at_), shares = SCENES[name]
    sj, lj = scene(G)
    st, lt = scene(T)
    cj = G.compile_scene(sj, lj, accel_min_size=64)
    ct = T.compile_scene(st, lt, accel_min_size=64)
    cam = T.camera(pos, at_, (0, 1, 0), 60)
    cfg = T.RenderConfig(xres=XRES, yres=YRES)
    r = T.Renderer(T.Tracer(ct, cfg), cam, cfg)
    ys, xs = np.mgrid[0:YRES, 0:XRES]
    perm = tile_order(XRES, YRES)
    o, d = r.rays_for_pixels(xs.reshape(-1)[perm].astype(np.float32),
                             ys.reshape(-1)[perm].astype(np.float32), "cpu")
    _FRAMES[name] = dict(name=name, cj=cj, ct=ct, aj=cj.arrays(),
                         at=T.to_torch(ct.arrays(), "cpu"), o=o, d=d,
                         oj=jnp.asarray(o.numpy()),
                         dj=jnp.asarray(d.numpy()), shares=shares)
    return _FRAMES[name]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_ray_debug_counts_match_glome_tpu(name):
    f = _frame(name)
    pj, nj = jax.jit(lambda a, o_, d_: JD.ray_debug_counts(
        f["cj"], a, o_, d_))(f["aj"], f["oj"], f["dj"])
    pt, nt = TD.ray_debug_counts(f["ct"], f["at"], f["o"], f["d"])
    assert pt.dtype == nt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert int(nt.max()) > 0          # a BVH group was walked


@pytest.mark.parametrize("name,recurs", [
    (name, r) for name in sorted(SCENES) for r in sorted(SCENES[name][2])])
def test_trace_debug_counts_match_glome_tpu(name, recurs):
    f = _frame(name)
    pj, nj = jax.jit(lambda a, o_, d_: JD.trace_debug_counts(
        f["cj"], a, o_, d_, recurs=recurs))(f["aj"], f["oj"], f["dj"])
    pt, nt = TD.trace_debug_counts(f["ct"], f["at"], f["o"], f["d"],
                                   recurs=recurs)
    same_p = float((pt.numpy() == np.asarray(pj)).mean())
    same_n = float((nt.numpy() == np.asarray(nj)).mean())
    print(f"{name} depth {recurs}: prims equal on {same_p:.4f}, "
          f"nodes on {same_n:.4f} of {pt.numel()} pixels")
    want_p, want_n = f["shares"][recurs]
    assert same_p >= want_p and same_n >= want_n
    # the full trace never charges less than the primary rays
    p0, _ = TD.ray_debug_counts(f["ct"], f["at"], f["o"], f["d"])
    assert bool((pt >= p0).all())
