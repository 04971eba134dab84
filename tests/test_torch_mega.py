"""K1 parity: the port's plain mega_select (what CPU tensors run) against
glome_tpu's Pallas mega_select in interpret mode, on test_mega's
all-phase-kinds scene (glome_tpu_torch.scenes.phasescene) built with
each package's own constructors: dense groups, bvh2 groups (plain and
transformed), convex CSG, deferred difference-B prims with restricted
member scans (one with a point-query BVH), inline constraints,
retexture, shadow flags, and test_mega's multi-scene (portal) case.
tests/test_torch_csg.py covers the CSG this scene leaves out.

Tolerances: `hit` must agree exactly; `t` within rtol 5e-5 / atol 1e-4
(test_mega.py's bounds: the port evaluates the same formulas in another
op order) on >= 99.9% of lanes and within 1e-3 on the rest (see
assert_t_close); `wid` may differ on at most 0.1% of lanes, and only
where the two winners' distances tie to that tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu import megakernel as MK
from glome_tpu_torch import megakernel as TMK
from glome_tpu.materials import Warp as JWarp
from glome_tpu_torch.materials import Warp as TWarp
from glome_tpu_torch.scenes.phasescene import (phase_kinds_lights,
                                               phase_kinds_rays,
                                               phase_kinds_scene)

RTOL, ATOL = 5e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_portal_scene(P, Warp):
    """tests/test_mega.py:test_mega_multi_scene's portal scene."""
    def mat(c):
        return P.t_uniform(P.Surface(color=c, ambient=0.3, kd=0.7))
    mirror = P.tex(P.sphere((0, 0, 3), 1.0), mat((1, 0, 0)))
    frame = P.tex(P.box((-1, -1, -0.1), (1, 1, 0.1)), mat((0, 1, 0)))
    warp = Warp(frame=frame, scene=mirror, lights=(),
                xfm=P.translate((0, 0, 1)))
    return P.group([
        P.tex(P.box((-2, -2, 4), (2, 2, 5)), P.t_uniform(warp)),
        P.tex(P.sphere((0, 3, 2), 0.7), mat((0, 0, 1)))])


def _compile_both(build):
    cj = G.compile_scene(build(G), phase_kinds_lights(G))
    ct = T.compile_scene(build(T), phase_kinds_lights(T))
    return cj, ct


@pytest.fixture(scope="module")
def scenes():
    cj, ct = _compile_both(phase_kinds_scene)
    return cj, ct, T.to_torch(ct.arrays(), "cpu")


def _jax_select(cj, o, d, seed, sid=None, shadow=False):
    plan = MK.get_plan(cj)
    pf, bb = MK.pack_tables(plan, cj, cj.arrays())
    out = MK.mega_select(plan, pf, bb, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(seed),
                         sid=None if sid is None else jnp.asarray(sid),
                         shadow=shadow, interpret=True)
    return tuple(np.array(a) for a in out)


def _port_select(ct, arrays, o, d, seed, sid, shadow=False):
    plan = TMK.get_plan(ct)
    tables = TMK.pack_tables(plan, ct, arrays)
    rays = torch.as_tensor(np.stack([o[:, 0], o[:, 1], o[:, 2],
                                     d[:, 0], d[:, 1], d[:, 2],
                                     seed, sid.astype(np.float32)]))
    return tuple(a.numpy() for a in TMK.mega_select(tables, rays, shadow))


def assert_t_close(tg, tw):
    """t within RTOL/ATOL on >= 99.9% of lanes.  The rest are grazing
    hits on thin transformed cones, where the quadratic is
    ill-conditioned: on the one such lane of the 1500-ray case float64
    puts the hit 3.4e-4 from the port and 6.7e-4 from glome_tpu, so
    both sit about 1e-3 apart.  Those lanes still agree to 1e-3."""
    close = np.isclose(tg, tw, rtol=RTOL, atol=ATOL)
    print(f"t outside rtol {RTOL}/atol {ATOL}: {int((~close).sum())}"
          f"/{len(tg)}")
    assert (~close).mean() <= 1e-3
    np.testing.assert_allclose(tg, tw, rtol=1e-3, atol=1e-3)


def _assert_select_close(got, want):
    tg, wg, ag = got
    tw, ww, aw = want
    hit_g, hit_w = wg >= 0, ww >= 0
    np.testing.assert_array_equal(hit_g, hit_w)
    assert_t_close(tg, tw)
    diff = wg != ww
    print(f"wid mismatches: {int(diff.sum())}/{len(wg)}")
    assert diff.mean() <= 1e-3
    # a differing winner is only acceptable at a distance tie
    assert np.all(np.abs(tg[diff] - tw[diff])
                  <= ATOL + RTOL * np.abs(tw[diff]))
    np.testing.assert_array_equal(ag[~diff], aw[~diff])


@pytest.fixture(scope="module")
def intersect_case(scenes):
    cj, ct, arrays = scenes
    n = 1500
    o, d = phase_kinds_rays(n)
    seed = np.full(n, 1e6, np.float32)
    sid = np.zeros(n, np.int32)
    want = _jax_select(cj, o, d, seed)
    got = _port_select(ct, arrays, o, d, seed, sid)
    return o, d, want, got


def test_select_intersect_matches_pallas(scenes, intersect_case):
    plan = TMK.get_plan(scenes[1])
    assert {ph.kind for ph in plan.phases} == {"dense", "bvh2", "convex",
                                               "deferred"}
    _o, _d, want, got = intersect_case
    assert (want[1] >= 0).sum() > 500        # the rays do hit the scene
    _assert_select_close(got, want)


def test_select_shadow_matches_pallas(scenes):
    cj, ct, arrays = scenes
    n = 800
    o, d = phase_kinds_rays(n, seed=3)
    seed = np.full(n, 20.0, np.float32)
    want = _jax_select(cj, o, d, seed, shadow=True)
    got = _port_select(ct, arrays, o, d, seed, np.zeros(n, np.int32),
                       shadow=True)
    # any-hit: only blocked-or-not is defined
    np.testing.assert_array_equal(got[1] >= 0, want[1] >= 0)
    assert 0 < (got[1] >= 0).sum() < n
    blocked = TMK.mega_shadow(ct, arrays, torch.as_tensor(o),
                              torch.as_tensor(d),
                              tmax=torch.as_tensor(seed))
    np.testing.assert_array_equal(blocked.numpy(), want[1] >= 0)


def test_select_multi_scene_matches_pallas():
    cj, ct = _compile_both(lambda P: build_portal_scene(
        P, JWarp if P is G else TWarp))
    arrays = T.to_torch(ct.arrays(), "cpu")
    n = 600
    o, d = phase_kinds_rays(n, seed=9)
    sid = np.random.RandomState(2).randint(-1, len(cj.scenes),
                                           size=n).astype(np.int32)
    seed = np.full(n, 1e6, np.float32)
    want = _jax_select(cj, o, d, seed, sid=sid)
    got = _port_select(ct, arrays, o, d, seed, sid)
    _assert_select_close(got, want)
    assert not (got[1][sid < 0] >= 0).any()


def test_mega_intersect_hit_matches(scenes, intersect_case):
    """The port's mega_intersect Hit against glome_tpu's mega_intersect
    (= its finalize over the Pallas select), test_mega.py:123-138's
    tolerances."""
    cj, ct, arrays = scenes
    o, d, (tw, ww, aw), _got = intersect_case
    ref = MK.finalize(cj, MK.get_plan(cj), cj.arrays(), jnp.asarray(o),
                      jnp.asarray(d), jnp.asarray(tw), jnp.asarray(ww),
                      aux=jnp.asarray(aw))
    got = TMK.mega_intersect(ct, arrays, torch.as_tensor(o),
                             torch.as_tensor(d))
    g = {k: v.numpy() for k, v in got._asdict().items()}
    r = {k: np.asarray(v) for k, v in ref._asdict().items()}
    np.testing.assert_array_equal(g["hit"], r["hit"])
    assert_t_close(g["t"], r["t"])
    m = r["hit"] & (g["prim_serial"] == r["prim_serial"])
    assert (~m & r["hit"]).mean() <= 1e-3
    np.testing.assert_allclose(g["norm"][m], r["norm"][m],
                               rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(g["pos"][m], r["pos"][m],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(g["tex_stack"][m], r["tex_stack"][m])
    np.testing.assert_array_equal(g["tag_stack"][m], r["tag_stack"][m])
    assert TMK.mega_select.launches == 0


def test_finalize_gradients_match_jax(scenes, intersect_case):
    """Differentiable finalize: the gradient of a loss over the Hit
    fields (t, normals, positions) with respect to every scene
    parameter, against jax.grad through glome_tpu's finalize, on the
    same winners.  Per-parameter sums run over lanes in another order,
    hence rtol 1e-4 with an absolute floor of 1e-4 of the largest
    gradient entry."""
    cj, ct, _arrays = scenes
    o, d, (tw, ww, aw), _got = intersect_case
    rng = np.random.RandomState(11)
    wn = rng.randn(len(tw), 3).astype(np.float32)
    plan_j, plan_t = MK.get_plan(cj), TMK.get_plan(ct)

    def loss_j(arrs):
        h = MK.finalize(cj, plan_j, arrs, jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(tw), jnp.asarray(ww), aux=jnp.asarray(aw))
        return (jnp.where(h.hit, h.t, 0.0).sum() + (h.norm * wn).sum()
                + (h.pos * wn).sum())

    gj = jax.grad(loss_j)(jax.tree.map(jnp.asarray, cj.arrays()))

    arrays = T.to_torch(ct.arrays(), "cpu")
    leaves = [v for sc in arrays["scenes"] for ga in sc for v in ga.values()]
    for v in leaves:
        v.requires_grad_(True)
    h = TMK.finalize(ct, plan_t, arrays, torch.as_tensor(o),
                     torch.as_tensor(d), torch.as_tensor(tw),
                     torch.as_tensor(ww), aux=torch.as_tensor(aw))
    wt = torch.as_tensor(wn)
    loss = (torch.where(h.hit, h.t, torch.zeros_like(h.t)).sum()
            + (h.norm * wt).sum() + (h.pos * wt).sum())
    loss.backward()
    n_nonzero = 0
    for si, sc in enumerate(arrays["scenes"]):
        for gi, ga in enumerate(sc):
            for k, v in ga.items():
                want = np.asarray(gj["scenes"][si][gi][k])
                got = (np.zeros_like(want) if v.grad is None
                       else v.grad.numpy())
                assert np.isfinite(got).all(), (si, gi, k)
                scale = max(1.0, float(np.abs(want).max()))
                np.testing.assert_allclose(got, want, rtol=1e-4,
                                           atol=1e-4 * scale,
                                           err_msg=f"{si}/{gi}/{k}")
                n_nonzero += int((got != 0).any())
    assert n_nonzero >= 5
