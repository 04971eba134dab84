"""The port's pass-per-group pipeline (intersect.GROUPS, plain versions)
against glome_tpu's intersect_multi / shadow_query_multi on the CPU,
which is glome_tpu's pass-per-group route there (its brute_scan and
bvh_pass stand in for the Pallas kernels), on the all-phase-kinds and
CSG check scenes and on TestScene rays; and the gradient through it.

Tolerances (ROADMAP Queue 3): hit and blocked agree on >= 99.9% of
lanes; t within rtol 5e-5 / atol 1e-4 on >= 99.9% of lanes (the port
evaluates the same formulas in another op order, and grazing hits are
ill-conditioned in float32); the integer fields (texture and tag stacks,
prim serial) equal wherever t agrees; positions, normals and object-space
rays within rtol 1e-4 / atol 5e-3 on >= 99.9% of lanes (the normal of a
grazing cone hit moves with its t).  tests/test_torch_groups.py holds
the route's kernels and its TestScene frame.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glome_tpu as G
import glome_tpu_torch as T
import glome_tpu.intersect  # noqa: F401  (the module, not G.intersect)
from glome_tpu.scenes import test_scene as jax_test_scene
from glome_tpu.scenes.meshscene import mesh_scene as jax_mesh_scene
from glome_tpu_torch.intersect import (GROUPS, MEGA, intersect_multi,
                                       shadow_query_multi,
                                       shadow_query_multi_rays)
from glome_tpu_torch import megakernel as TMK
from glome_tpu_torch.render import pixel_coords, primary_rays, tile_order
from glome_tpu_torch.scenes import mesh_scene as torch_mesh_scene
from glome_tpu_torch.scenes import test_scene as torch_test_scene
from glome_tpu_torch.scenes.phasescene import (csg_rays, csg_scene,
                                               phase_kinds_lights,
                                               phase_kinds_rays,
                                               phase_kinds_scene)

JI = sys.modules["glome_tpu.intersect"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jnp(arrays):
    return jax.tree.map(jnp.asarray, arrays)


def _testscene_rays(cam, n_primary=4096, n_random=1024):
    """A spread subset of TestScene's 720x480 primary rays (scene 0) and
    seeded random rays in random scenes (-1, 0 or the portal scene 1)."""
    xres, yres = 720, 480
    ys, xs = np.mgrid[0:yres, 0:xres]
    perm = tile_order(xres, yres)
    xc, yc = pixel_coords(
        xres, yres, torch.as_tensor(xs.reshape(-1)[perm], dtype=torch.float32),
        torch.as_tensor(ys.reshape(-1)[perm], dtype=torch.float32))
    o, d = primary_rays(cam, xc, yc)
    ix = np.linspace(0, o.shape[0] - 1, n_primary).astype(np.int64)
    rng = np.random.RandomState(0)
    ro = rng.uniform(-8, 8, (n_random, 3)).astype(np.float32)
    rd = rng.normal(size=(n_random, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    sid = np.concatenate([np.zeros(n_primary, np.int32),
                          rng.randint(-1, 2, n_random).astype(np.int32)])
    return (np.concatenate([o[ix].numpy(), ro]),
            np.concatenate([d[ix].numpy(), rd]), sid, 6.0)


def _small_rays(make, shadow_t):
    def rays():
        o, d = make(1024, seed=1)
        sid = np.zeros(len(o), np.int32)
        sid[::29] = -1
        return o, d, sid, shadow_t
    return rays


def _mesh_rays(cam, xres=64, yres=36, n_random=1024):
    """The primary rays of an xres x yres frame (scene 0) and seeded
    random rays from around the mesh toward it, some in no scene."""
    ys, xs = np.mgrid[0:yres, 0:xres]
    xc, yc = pixel_coords(
        xres, yres, torch.as_tensor(xs.reshape(-1), dtype=torch.float32),
        torch.as_tensor(ys.reshape(-1), dtype=torch.float32))
    o, d = primary_rays(cam, xc, yc)
    rng = np.random.RandomState(1)
    ro = rng.uniform(-3, 3, (n_random, 3)).astype(np.float32)
    rd = rng.uniform(-0.8, 0.8, (n_random, 3)) - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    sid = np.zeros(len(o) + n_random, np.int32)
    sid[::29] = -1
    return (np.concatenate([o.numpy(), ro]), np.concatenate([d.numpy(), rd]),
            sid, 4.0)


@pytest.fixture(scope="module",
                params=["phasekinds", "csg", "testscene", "mesh"])
def multi_case(request):
    """The same rays through glome_tpu's intersect_multi /
    shadow_query_multi (its CPU route) and the port's group route (plain
    versions): (compiled pair, rays, glome_tpu's Hit and blocked, the
    port's).  "mesh": mesh_scene(1500, cast_shadows=True) compiled with
    accel_min_size=64 on both sides, so its 1,458 triangles go through
    K5's path (bvh_dispatch) rather than K4's."""
    if request.param == "testscene":
        sj, lj, _ = jax_test_scene()
        st, lt, cam = torch_test_scene()
        cj, ct = G.compile_scene(sj, lj), T.compile_scene(st, lt)
        o, d, sid, sh_t = _testscene_rays(cam)
    elif request.param == "mesh":
        sj, lj, _ = jax_mesh_scene(1500, cast_shadows=True)
        st, lt, cam = torch_mesh_scene(1500, cast_shadows=True)
        cj = G.compile_scene(sj, lj, accel_min_size=64)
        ct = T.compile_scene(st, lt, accel_min_size=64)
        assert [g.accel_eligible for g in ct.scenes[0].groups] == [False,
                                                                  True]
        o, d, sid, sh_t = _mesh_rays(cam)
    else:
        scene, make, sh_t = {"phasekinds": (phase_kinds_scene,
                                            phase_kinds_rays, 9.0),
                             "csg": (csg_scene, csg_rays, 7.0)}[
                                 request.param]
        cj = G.compile_scene(scene(G), phase_kinds_lights(G))
        ct = T.compile_scene(scene(T), phase_kinds_lights(T))
        o, d, sid, sh_t = _small_rays(make, sh_t)()
    aj = _jnp(cj.arrays())
    at = T.to_torch(ct.arrays(), "cpu")
    tmax = np.full(len(o), sh_t, np.float32)
    hj = JI.intersect_multi(cj, aj, jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(sid))
    bj = JI.shadow_query_multi(cj, aj, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(sid), jnp.asarray(tmax))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = (ct, at, torch.as_tensor(o), torch.as_tensor(d),
                torch.as_tensor(sid))
        ht = intersect_multi(*args, select=TMK.PLAIN)
        bt = shadow_query_multi(*args, torch.as_tensor(tmax),
                                   select=TMK.PLAIN)
    finally:
        torch.set_num_threads(n)
    return dict(name=request.param, sid=sid,
                want={k: np.asarray(v) for k, v in hj._asdict().items()},
                got={k: v.detach().numpy() for k, v in ht._asdict().items()},
                blocked_want=np.asarray(bj), blocked_got=bt.numpy())


def test_intersect_multi_matches_glome_tpu(multi_case):
    w, g = multi_case["want"], multi_case["got"]
    n = len(w["t"])
    assert 0 < w["hit"].sum() < n
    assert (g["hit"] != w["hit"]).mean() <= 1e-3
    close = np.isclose(g["t"], w["t"], rtol=5e-5, atol=1e-4)
    print(f"{multi_case['name']}: {int(w['hit'].sum())}/{n} hits, t "
          f"outside rtol 5e-5/atol 1e-4 on {int((~close).sum())} lanes")
    assert (~close).mean() <= 1e-3
    assert not g["hit"][multi_case["sid"] < 0].any()
    for k in ("tex_stack", "tag_stack", "prim_serial"):
        np.testing.assert_array_equal(g[k][close], w[k][close], err_msg=k)
    for k in ("pos", "norm", "obj_o", "obj_d"):
        ok = np.isclose(g[k], w[k], rtol=1e-4, atol=5e-3).all(axis=-1)
        print(f"  {k}: {int((~ok).sum())} lanes outside rtol 1e-4/atol "
              f"5e-3, max |diff| {np.abs(g[k] - w[k]).max():.3g}")
        assert (~ok).mean() <= 1e-3, k


def test_shadow_query_multi_matches_glome_tpu(multi_case):
    w, g = multi_case["blocked_want"], multi_case["blocked_got"]
    print(f"{multi_case['name']}: {int(w.sum())}/{len(w)} blocked, "
          f"disagree on {int((g != w).sum())}")
    assert 0 < w.sum() < len(w)
    assert (g != w).mean() <= 1e-3


def test_group_route_gradient_matches_jax():
    """d sum(t over hits) / d(sphere centers), through convex_pass,
    K4/K5's selection and the differentiable finalizes of the group
    route, against jax.grad of the same sum through glome_tpu's
    intersect_multi, on the CSG check scene.  Per-parameter sums run over
    lanes in another order, hence rtol 1e-3 with a floor of 1e-4 of the
    largest entry."""
    cj = G.compile_scene(csg_scene(G), phase_kinds_lights(G))
    ct = T.compile_scene(csg_scene(T), phase_kinds_lights(T))
    o, d = csg_rays(256, seed=4)
    sid = np.zeros(len(o), np.int32)

    def loss_j(arrs):
        h = JI.intersect_multi(cj, arrs, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(sid))
        return jnp.where(h.hit, h.t, 0.0).sum()

    gj = jax.grad(loss_j)(_jnp(cj.arrays()))
    arrays = T.to_torch(ct.arrays(), "cpu")
    spheres = [gi for gi, g in enumerate(ct.scenes[0].groups)
               if g.ptype == "sphere"]
    for gi in spheres:
        arrays["scenes"][0][gi]["center"].requires_grad_(True)
    h = intersect_multi(ct, arrays, torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(sid), select=TMK.PLAIN)
    torch.where(h.hit, h.t, torch.zeros_like(h.t)).sum().backward()
    nonzero = 0
    for gi in spheres:
        got = arrays["scenes"][0][gi]["center"].grad.numpy()
        want = np.asarray(gj["scenes"][0][gi]["center"])
        assert np.isfinite(got).all()
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=f"group {gi}")
        nonzero += int((got != 0).any())
    assert nonzero >= 2


@pytest.mark.parametrize("route", [GROUPS, MEGA])
def test_shadow_query_multi_rays_matches_glome_tpu(route):
    """glome_tpu's plane-table entry on an (8, 2048) table of the
    phase-kinds scene, every 7th lane dead (tmax 0, sid -1), through
    either of the port's routes (plain versions): blocked agrees on
    >= 99.9% of lanes, and no dead lane is blocked."""
    cj = G.compile_scene(phase_kinds_scene(G), phase_kinds_lights(G))
    ct = T.compile_scene(phase_kinds_scene(T), phase_kinds_lights(T))
    o, d = phase_kinds_rays(2048, seed=3)
    tmax = np.full(2048, 9.0, np.float32)
    sid = np.zeros(2048, np.float32)
    tmax[::7], sid[::7] = 0.0, -1.0
    rays = np.concatenate([o.T, d.T, tmax[None], sid[None]]).astype(
        np.float32)
    want = np.asarray(JI.shadow_query_multi_rays(cj, _jnp(cj.arrays()),
                                                 jnp.asarray(rays)))
    got = shadow_query_multi_rays(ct, T.to_torch(ct.arrays(), "cpu"),
                                  torch.as_tensor(rays), select=TMK.PLAIN,
                                  route=route).numpy()
    print(f"{route}: {int(want.sum())}/2048 blocked, disagree on "
          f"{int((got != want).sum())}")
    assert got.shape == want.shape == (2048,)
    assert 0 < want.sum() < 2048
    assert (got != want).mean() <= 1e-3
    assert not got[::7].any()
