"""A mesh on the pass-per-group route of the port against glome_tpu, on
the CPU: mesh_scene(1500) compiled with accel_min_size=64 on both sides,
so its 1,458 smooth triangles (a mesh_src group, expanded from vertex
rows on every call) go through K5's path -- the group's skip-link tree
(compile.group_accel, the native builder), bvh_dispatch and
_finalize_winner's smooth normals -- and the ground plane through K4's.

  - the group tree equals the g.accel glome_tpu's compiler attaches;
  - K5's plain version (bvh_select_plain) on the group's leaf-ordered
    triangle rows against glome_tpu's Pallas bvh_intersect in interpret
    mode, on the frame's primary rays and on shadow segments toward the
    key light;
  - a 64x36 depth-1 frame through WavefrontTracer(route=GROUPS), with
    and without cast_shadows, against glome_tpu's CPU route (its
    pass-per-group route there) and against the port's megakernel
    route.

Tolerances: the tables exactly; the kernels as tests/test_torch_groups.py
holds K5 (hit / blocked agree on >= 99.9% of lanes, t within rtol 5e-5 /
atol 1e-4 on >= 99.9%, a differing winner only at a tie; in shadow mode
only "blocked"); the frames within tests/test_golden.py:129-131's drift
canaries (mean |diff| <= 3 levels, <= 0.6% of pixels off by more than
64).  tests/test_torch_group_route.py holds the same group route hit by
hit ("mesh" case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu import pallas_kernels as PK
from glome_tpu.compile import materialize_scene_params as j_materialize
from glome_tpu.config import RenderConfig as JRenderConfig
from glome_tpu.render import Renderer as JRenderer
from glome_tpu.scenes.meshscene import mesh_scene as j_mesh_scene
from glome_tpu_torch import group_kernels as GK
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch.compile import group_accel, materialize_scene_params
from glome_tpu_torch.intersect import GROUPS, MEGA, bvh_args
from glome_tpu_torch.io import quantize
from glome_tpu_torch.render import pixel_coords, primary_rays
from glome_tpu_torch.scenes import mesh_scene as t_mesh_scene
from test_torch_groups import _assert_select_close

N_TRIS, ACCEL_MIN = 1500, 64
CANARY_MEAN, CANARY_FRAC = 3.0, 0.006
XRES, YRES = 64, 36
KEY_LIGHT = np.float32([4.0, 6.0, -4.0])     # meshscene.mesh_scene


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[False, True],
                ids=["no_shadows", "cast_shadows"])
def mesh_pair(request):
    """(glome_tpu's compiled scene, the port's, the port's camera,
    glome_tpu's camera, cast_shadows)."""
    cs = request.param
    sj, lj, camj = j_mesh_scene(N_TRIS, cast_shadows=cs)
    st, lt, camt = t_mesh_scene(N_TRIS, cast_shadows=cs)
    return (G.compile_scene(sj, lj, accel_min_size=ACCEL_MIN),
            T.compile_scene(st, lt, accel_min_size=ACCEL_MIN), camt, camj,
            cs)


def _mesh_gi(sc):
    gi = [i for i, g in enumerate(sc.groups) if g.accel_eligible]
    assert len(gi) == 1
    g = sc.groups[gi[0]]
    assert g.ptype == "trianglenorm" and g.mesh_src is not None
    assert g.size == 1458
    return gi[0]


def test_mesh_group_tree_matches_glome_tpu(mesh_pair):
    cj, ct, _camt, _camj, _cs = mesh_pair
    gi = _mesh_gi(ct.scenes[0])
    got, want = group_accel(ct.scenes[0].groups[gi]), \
        cj.scenes[0].groups[gi].accel
    for k in ("bmin", "bmax", "skip", "leaf_start", "leaf_count", "order"):
        np.testing.assert_array_equal(getattr(got, k),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    # the plane stays with K4: no tree
    assert all(group_accel(g) is None for i, g in
               enumerate(ct.scenes[0].groups) if i != gi)


def _frame_rays(cam):
    ys, xs = np.mgrid[0:YRES, 0:XRES]
    xc, yc = pixel_coords(
        XRES, YRES, torch.as_tensor(xs.reshape(-1), dtype=torch.float32),
        torch.as_tensor(ys.reshape(-1), dtype=torch.float32))
    o, d = primary_rays(cam, xc, yc)
    return o.numpy(), d.numpy()


def _shadow_segments(n, seed=2):
    """Segments from points on and above the ground plane (y = -1.4)
    toward the key light, unit directions, tmax short of the light."""
    rng = np.random.RandomState(seed)
    o = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-1.39, 0.5, n),
                  rng.uniform(-2.5, 2.5, n)], axis=1).astype(np.float32)
    d = KEY_LIGHT - o
    length = np.linalg.norm(d, axis=1)
    return (o, (d / length[:, None]).astype(np.float32),
            (length - 2e-4).astype(np.float32))


@pytest.mark.parametrize("shadow", [False, True])
def test_k5_plain_matches_pallas_on_the_mesh_group(shadow):
    """On the cast_shadows scene, whose shadow batches reach K5."""
    sj, lj, _camj = j_mesh_scene(N_TRIS, cast_shadows=True)
    st, lt, camt = t_mesh_scene(N_TRIS, cast_shadows=True)
    cj = G.compile_scene(sj, lj, accel_min_size=ACCEL_MIN)
    ct = T.compile_scene(st, lt, accel_min_size=ACCEL_MIN)
    scj, sct = cj.scenes[0], ct.scenes[0]
    gi = _mesh_gi(sct)
    g = scj.groups[gi]
    order = np.asarray(g.accel.order)
    garrs_j = j_materialize(scj, jax.tree.map(
        jnp.asarray, cj.arrays())["scenes"][0])
    rows_j = PK.pack_params_rows(g.ptype, {k: v[order]
                                           for k, v in garrs_j[gi].items()})
    garrs_t = materialize_scene_params(
        sct, T.to_torch(ct.arrays(), "cpu")["scenes"][0])
    args, order_t = bvh_args(sct, garrs_t, gi, shadow, "cpu")
    np.testing.assert_array_equal(order_t.numpy(), order)
    np.testing.assert_array_equal(args[2].numpy(), np.asarray(rows_j))
    vis = args[3].numpy()
    if shadow:
        o, d, seeds = _shadow_segments(1024)
    else:
        o, d = _frame_rays(camt)
        o, d = o[::2], d[::2]
        seeds = np.full(len(o), T.INFINITY, np.float32)
    seeds[::17] = 0.0                                 # dead lanes
    tw, lw = PK.bvh_intersect(g.ptype, g.accel, rows_j, jnp.asarray(vis),
                              PK.pack_constraints(scj, garrs_j, g),
                              jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(seeds), shadow=shadow,
                              interpret=True)
    tg, lg = GK.bvh_select(*args, torch.as_tensor(np.concatenate([o.T, d.T])),
                           torch.as_tensor(seeds), shadow=shadow)

    def local(leaf):
        return np.where(leaf >= 0, order[np.maximum(leaf, 0)], -1)
    _assert_select_close((tg.numpy(), local(lg.numpy())),
                         (np.asarray(tw), local(np.asarray(lw))), shadow)


def test_mesh_frame_on_the_group_route(mesh_pair):
    cj, ct, camt, camj, cs = mesh_pair
    jcfg = JRenderConfig(xres=XRES, yres=YRES, maxdepth=1)
    jr = JRenderer(G.WavefrontTracer(cj, jcfg), camj, jcfg)
    want, _ = jr.render(cj.arrays())
    ov = getattr(jr, "last_overflow", None)
    assert ov is None or int(np.asarray(ov).sum()) == 0
    cfg = T.RenderConfig(xres=XRES, yres=YRES, maxdepth=1)
    arrays = T.to_torch(ct.arrays(), "cpu")
    imgs = {}
    for route in (GROUPS, MEGA):
        tr = T.WavefrontTracer(ct, cfg, route=route)
        r = T.Renderer(tr, camt, cfg)
        rgb, depth = r.render(arrays)
        assert int(r.last_overflow.sum()) == 0
        assert torch.isfinite(rgb).all()
        imgs[route] = quantize(rgb.numpy())
        if route == GROUPS:
            # the mesh is in view: most of the frame hits something
            assert (depth.numpy() < T.INFINITY).mean() > 0.5
    for name, a, b in (("vs glome_tpu", imgs[GROUPS], quantize(
            np.asarray(want))), ("vs the megakernel route", imgs[GROUPS],
                                 imgs[MEGA])):
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(axis=-1)
        print(f"cast_shadows={cs} group route {name}: mean "
              f"{diff.mean():.4f} levels, {int((diff > 64).sum())}/"
              f"{diff.size} pixels > 64")
        assert diff.mean() <= CANARY_MEAN
        assert (diff > 64).sum() <= CANARY_FRAC * diff.size


def test_group_route_frame_takes_k5(mesh_pair):
    """The group-route frame reaches the mesh through K5's select and
    the plane through K4's, once each per intersect or shadow batch, and
    no megakernel select: on CPU tensors each runs its plain version,
    which counts its calls.  As in glome_tpu's route, the shadow batch
    runs the mesh's pass even where the mesh casts no shadow (its
    visibility column is then all zero)."""
    _cj, ct, camt, _camj, cs = mesh_pair
    plains = {"dense": GK.dense_select_plain, "bvh": GK.bvh_select_plain,
              "mega": MK.mega_select_plain}
    for fn in plains.values():
        fn.calls = 0
    cfg = T.RenderConfig(xres=XRES, yres=YRES, maxdepth=1)
    tr = T.WavefrontTracer(ct, cfg, route=GROUPS)
    T.Renderer(tr, camt, cfg).render(T.to_torch(ct.arrays(), "cpu"))
    calls = {k: fn.calls for k, fn in plains.items()}
    batches = tr.last_batches
    print(f"cast_shadows={cs}: {batches} batches, {calls}")
    assert batches == 2
    assert calls == {"dense": batches, "bvh": batches, "mega": 0}
