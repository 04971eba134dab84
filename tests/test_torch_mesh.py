"""The mesh path of the port against glome_tpu, on the CPU: the mesh
compile, the plain versions of K2 (block_kernel.block_select_plain) and
K3 (mesh_kernel.mesh_block_select_plain) against glome_tpu's Pallas
kernels in interpret mode, the routed intersect and shadow entries, and
a small mesh frame through both packages' Renderers.

Inputs are made with numpy from fixed seeds and handed to both
packages.  Tolerances, stated per test:
  - host tables (compile, scene arrays, plans) must match exactly;
  - kernel t within rtol 1e-5 / atol 1e-5 (both evaluate the same
    float32 formulas, the port in another op order; 5e-5 for spheres,
    see BLOCK_RTOL); a winner id may differ only where the two winners'
    t tie exactly (a ray through a shared mesh edge) or, on at most 0.5%
    of lanes, at a grazing candidate that float32 rounding keeps in one
    package and drops in the other; the tests print both counts;
  - frames within tests/test_golden.py:129-131's drift canaries (mean
    |diff| <= 3 levels, <= 0.6% of pixels off by more than 64).

Routing to K2/K3 is forced by lowering the size thresholds in both
packages, as tests/test_mesh.py and tests/test_block.py do.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu import block_kernel as JBK
from glome_tpu import megakernel as JMK
from glome_tpu import mesh_kernel as JMSH
from glome_tpu.compile import group_device_params as j_group_params
from glome_tpu.compile import materialize_scene_params
from glome_tpu.config import RenderConfig as JRenderConfig
from glome_tpu.materials import light as jlight
from glome_tpu.render import Renderer as JRenderer
from glome_tpu.scenes.meshscene import mesh_scene as j_mesh_scene
from glome_tpu_torch import block_kernel as BK
from glome_tpu_torch import kernels as TK
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch import mesh_kernel as MSH
from glome_tpu_torch.compile import group_device_params as t_group_params
from glome_tpu_torch.io import quantize
from glome_tpu_torch.materials import light as tlight
from glome_tpu_torch.scenes import mesh_scene as t_mesh_scene
from glome_tpu_torch.scenes.phasescene import (block_rays, block_scene,
                                               chain_scene, tie_grid_rays,
                                               tie_grid_scene)
from test_torch_mega import walk_pair_records

RTOL = 1e-5
# t near 0 (a ray starting at a surface) carries the absolute rounding
# of the object-space origin, not a relative one
ATOL = 1e-5
CANARY_MEAN, CANARY_FRAC = 3.0, 0.006


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _mixed_mesh(P, cast_shadows):
    """A small shared-vertex mesh where half the triangles carry vertex
    normals (trianglenorm) and half do not (triangle), with per-tri
    texture and tag overrides on a few rows."""
    rng = np.random.default_rng(5)
    V = rng.uniform(-1, 1, (30, 3))
    N = rng.normal(size=(30, 3))
    N /= np.linalg.norm(N, axis=1, keepdims=True)
    vi = rng.integers(0, 30, (12, 3)).astype(np.int32)
    ni = np.where(np.arange(12)[:, None] % 2 == 0, vi, -1).astype(np.int32)
    tex = np.where(np.arange(12) % 3 == 0, 0, -1).astype(np.int32)
    tag = np.where(np.arange(12) % 4 == 1, 0, -1).astype(np.int32)
    tris = np.concatenate([vi, ni, tex[:, None], tag[:, None]], axis=1)
    mat = P.Uniform(P.Surface(color=(1, 0, 0), ambient=1.0))
    return P.group([P.mesh(V, N, tris, textures=(mat,), tags=("lid",),
                           cast_shadows=cast_shadows),
                    P.sphere((0, 0, 3.0), 0.5)])


# --- (1) the mesh compile ---------------------------------------------------

@pytest.mark.parametrize("cast_shadows", [False, True])
def test_mesh_compile_matches(cast_shadows):
    lights = [jlight((0, 5, 0), (1, 1, 1))], [tlight((0, 5, 0), (1, 1, 1))]
    cj = G.compile_scene(_mixed_mesh(G, cast_shadows), lights[0])
    ct = T.compile_scene(_mixed_mesh(T, cast_shadows), lights[1])
    gj, gt = cj.scenes[0].groups, ct.scenes[0].groups
    assert [g.ptype for g in gj] == [g.ptype for g in gt]
    assert {"triangle", "trianglenorm"} <= {g.ptype for g in gt}
    for a, b in zip(gj, gt):
        assert (a.mesh_src is None) == (b.mesh_src is None)
        for name in ("tex_stack", "tag_stack", "noshadow", "onlyshadow",
                     "prim_serial"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        if b.mesh_src is not None:
            assert a.mesh_src.keys() == b.mesh_src.keys()
            for k in a.mesh_src:
                np.testing.assert_array_equal(a.mesh_src[k], b.mesh_src[k])
            assert bool(b.noshadow.all()) == (not cast_shadows)
    lj, lt = dict(_leaves(cj.arrays())), dict(_leaves(ct.arrays()))
    assert lj.keys() == lt.keys()
    for k in lj:
        np.testing.assert_array_equal(lj[k], lt[k], err_msg=k)
    # group_device_params: the differentiable vertex gathers
    arr_t = T.to_torch(ct.arrays(), "cpu")
    for gi, (a, b) in enumerate(zip(gj, gt)):
        pj = j_group_params(a, cj.arrays()["scenes"][0][gi])
        pt = t_group_params(b, arr_t["scenes"][0][gi])
        assert pj.keys() == pt.keys()
        for k in pj:
            np.testing.assert_array_equal(np.asarray(pj[k]), pt[k].numpy())


def test_mesh_index_is_uploaded_once():
    """group_device_params keeps one device copy of a mesh's index
    arrays per device instead of converting them on every call."""
    ct = T.compile_scene(_mixed_mesh(T, True), [tlight((0, 5, 0), (1,) * 3)])
    arr_t = T.to_torch(ct.arrays(), "cpu")
    g = next(g for g in ct.scenes[0].groups if g.ptype == "trianglenorm")
    ga = arr_t["scenes"][0][ct.scenes[0].groups.index(g)]
    t_group_params(g, ga)
    first = dict(g._dev_index)
    assert set(first) == {("tri", "cpu"), ("tri_n", "cpu")}
    again = t_group_params(g, ga)
    assert all(g._dev_index[k] is first[k] for k in first)
    np.testing.assert_array_equal(
        again["p2"].numpy(),
        ga["verts"].numpy()[g.mesh_src["tri"][:, 1]])


# --- (2) the mesh scene -----------------------------------------------------

@pytest.mark.parametrize("cast_shadows", [False, True])
def test_meshscene_arrays_match(cast_shadows):
    sj, lj, camj = j_mesh_scene(2000, cast_shadows=cast_shadows)
    st, lt, camt = t_mesh_scene(2000, cast_shadows=cast_shadows)
    cj, ct = G.compile_scene(sj, lj), T.compile_scene(st, lt)
    a, b = dict(_leaves(cj.arrays())), dict(_leaves(ct.arrays()))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ga = [g for g in cj.scenes[0].groups if g.mesh_src is not None]
    gb = [g for g in ct.scenes[0].groups if g.mesh_src is not None]
    assert len(ga) == len(gb) == 1 and ga[0].size == gb[0].size > 1900
    np.testing.assert_array_equal(ga[0].mesh_src["tri"], gb[0].mesh_src["tri"])
    np.testing.assert_array_equal(ga[0].noshadow, gb[0].noshadow)
    for f in ("pos", "fwd", "up", "right"):
        np.testing.assert_array_equal(getattr(camj, f), getattr(camt, f))


# --- (3) K2 plain against glome_tpu's block_select -------------------------

def _mesh(P):
    solid, _l, _c = (j_mesh_scene if P is G else t_mesh_scene)(
        1500, cast_shadows=True)
    return solid


# the 320-sphere chain: a block tree 80 deep (CHAIN_RATIO, see
# test_deep_block_tree_fits_the_walk_stack)
CHAIN_SPHERES, CHAIN_RATIO = 320, 2.0 ** (-1 / 6)
BLOCK_CASES = {"mesh": _mesh,
               "spheres": lambda P: block_scene("spheres", P),
               "difference": lambda P: block_scene("difference", P),
               "transformed": lambda P: block_scene("transformed", P),
               "chain": lambda P: chain_scene(CHAIN_SPHERES, CHAIN_RATIO, P)}
# t tolerance per case: sphere hits near grazing cancel in float32
# (v - sqrt(disc)), so XLA's fused CPU code and torch's eager ops differ
# there by up to 1.5e-5 (K1's tests hold spheres to 5e-5 for the same
# reason, tests/test_torch_mega.py)
BLOCK_RTOL = {"mesh": RTOL, "transformed": RTOL, "spheres": 5e-5,
              "difference": 5e-5, "chain": 5e-5}


def _block_group(cc, constrained=False):
    """(scene, index) of the scene's biggest non-plane group (with
    inline constraints if `constrained`: the spheres of the difference
    scene that overlap its B sphere)."""
    sc = cc.scenes[0]
    gi = max((i for i, g in enumerate(sc.groups) if g.ptype != "plane"
              and bool(g.constraints) == constrained),
             key=lambda i: sc.groups[i].size)
    return sc, gi


def _rays(n, seed, span=6.0, tmax=1e6):
    o, d = block_rays(n, seed, span)
    seed_t = np.full(n, tmax, np.float32)
    seed_t[::17] = 0.0                   # dead lanes
    return o, d, seed_t


def _table(o, d, seed_t):
    n = o.shape[0]
    return torch.as_tensor(np.stack(
        [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], seed_t,
         np.zeros(n, np.float32)])).contiguous()


def _assert_sel_close(name, tg, sg, tw, sw, shadow, rtol=RTOL):
    """Winner ids equal except at exact t ties (a ray through an edge
    two triangles share) and grazing flips (a candidate at the edge of
    validity, e.g. a sphere hit with its discriminant near 0, that one
    package's float32 rounding keeps and the other's drops) on at most
    0.5% of lanes; t within rtol where the winners agree.  Shadow mode is
    any-hit, so only blocked-or-not is compared there."""
    if shadow:
        flip = (sg >= 0) != (sw >= 0)
        print(f"{name}: {int((sw >= 0).sum())}/{len(sw)} blocked, "
              f"{int(flip.sum())} grazing flips")
        assert flip.sum() <= 0.005 * len(sw)
        return
    same = sg == sw
    tie = ~same & (sg >= 0) & (sw >= 0) & (tg == tw)
    flip = ~same & ~tie
    print(f"{name}: {int((sw >= 0).sum())}/{len(sw)} hit, winners differ "
          f"at {int(tie.sum())} exact t ties and {int(flip.sum())} grazing "
          f"flips")
    assert flip.sum() <= 0.005 * len(sw)
    hit = same & (sw >= 0)
    np.testing.assert_allclose(tg[hit], tw[hit], rtol=rtol, atol=ATOL,
                               err_msg=name)


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_select_plain_matches_pallas(case, shadow):
    light = ([jlight((9, 9, 9), (1, 1, 1))], [tlight((9, 9, 9), (1, 1, 1))])
    cj = G.compile_scene(BLOCK_CASES[case](G), light[0])
    ct = T.compile_scene(BLOCK_CASES[case](T), light[1])
    scj, gi = _block_group(cj, case == "difference")
    sct, gi_t = _block_group(ct, case == "difference")
    assert gi == gi_t
    g = sct.groups[gi]
    assert (g.m_inv is not None) == (case == "transformed")
    assert bool(g.constraints) == (case == "difference")
    n = 1024
    o, d, seed_t = _rays(n, seed=4 + shadow, tmax=7.0 if shadow else 1e6)

    garrs_j = materialize_scene_params(scj, cj.arrays()["scenes"][0])
    jplan = JBK.get_block_plan(scj.groups[gi], scj, interpret=True)
    ga = {k: jnp.asarray(v) for k, v in garrs_j[gi].items() if k != "m_fwd"}
    tw, sw = JBK.block_select(
        jplan, JBK.pack_blocks(jplan, ga), JBK.pack_cons(jplan, scj, garrs_j),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(seed_t), shadow=shadow,
        interpret=True)
    tw, sw = np.asarray(tw), np.asarray(sw)

    arr_t = T.to_torch(ct.arrays(), "cpu")["scenes"][0]
    plan = BK.get_block_plan(g, sct)
    assert plan.n_blocks == -(-g.size // BK.BP) and plan.n_blocks > 1
    ga_t = {k: v for k, v in t_group_params(g, arr_t[gi]).items()
            if k != "m_fwd"}
    calls = BK.block_select_plain.calls
    tg, sg = BK.block_select(plan, BK.pack_blocks(plan, ga_t),
                             BK.pack_cons(plan, sct, arr_t, "cpu"),
                             _table(o, d, seed_t), torch.as_tensor(seed_t),
                             shadow=shadow)
    assert BK.block_select_plain.calls == calls + 1
    assert 0 < int((sw >= 0).sum()) < n
    _assert_sel_close(f"K2 {case}", tg.numpy(), sg.numpy(), tw, sw, shadow,
                      BLOCK_RTOL[case])
    assert (sg.numpy()[seed_t == 0] == -1).all()


def test_encode_cons_layout():
    ct = T.compile_scene(block_scene("difference"),
                         [tlight((9, 9, 9), (1, 1, 1))])
    sc, gi = _block_group(ct, constrained=True)
    plan = BK.get_block_plan(sc.groups[gi], sc)
    (positive, ms), = plan.cons
    assert positive is False and len(ms) == 1
    ptype, off, M, Fm, inv = ms[0]
    assert (ptype, off, M, Fm, inv) == ("sphere", 0, 1, 4, False)
    np.testing.assert_array_equal(
        plan.cdesc, [1, 0, 4, 1, MK.PTYPE_CODE["sphere"], 0, 1, 4, 0])


# --- (4) K3 plain against glome_tpu's mesh_block_select --------------------

@pytest.mark.parametrize("shadow", [False, True])
def test_mesh_block_select_plain_matches_pallas(shadow):
    sj, lj, _ = j_mesh_scene(1500, cast_shadows=True)
    st, lt, _ = t_mesh_scene(1500, cast_shadows=True)
    cj, ct = G.compile_scene(sj, lj), T.compile_scene(st, lt)
    scj, gi = _block_group(cj)
    sct, _ = _block_group(ct)
    n = 1024
    o, d, seed_t = _rays(n, seed=11 + shadow, span=3.0,
                         tmax=3.0 if shadow else 1e6)

    garrs_j = materialize_scene_params(scj, cj.arrays()["scenes"][0])
    jplan = JMSH.get_block_plan(scj.groups[gi])
    ga = {k: jnp.asarray(v) for k, v in garrs_j[gi].items()}
    tw, selw = JMSH.mesh_block_select(
        jplan, JMSH.pack_tri_blocks(jplan, ga), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(seed_t), shadow=shadow, interpret=True)
    tw, selw = np.asarray(tw), np.asarray(selw)
    lw = np.where(selw >= 0, jplan.sel_to_local[np.maximum(selw, 0)], -1)

    g = sct.groups[gi]
    plan = MSH.get_block_plan(g)
    assert plan.n_blocks > 1 and plan.n_nodes > 1
    ga_t = t_group_params(g, T.to_torch(ct.arrays(), "cpu")["scenes"][0][gi])
    tri = MSH.pack_tri_blocks(plan, ga_t)
    assert tri.shape == (plan.n_blocks * MSH.BP, MSH.TRI_F)
    tg, selg = MSH.mesh_block_select(plan, tri, _table(o, d, seed_t),
                                     torch.as_tensor(seed_t), shadow=shadow)
    s2l = plan.sel_to_local
    lg = np.where(selg.numpy() >= 0, s2l[np.maximum(selg.numpy(), 0)], -1)
    assert 0 < int((lw >= 0).sum()) < n
    _assert_sel_close("K3", tg.numpy(), lg, tw, lw, shadow)


def test_mesh_plan_maps_every_triangle():
    st, lt, _ = t_mesh_scene(1500)
    ct = T.compile_scene(st, lt)
    sc, gi = _block_group(ct)
    plan = MSH.get_block_plan(sc.groups[gi])
    local = plan.sel_to_local[plan.sel_to_local >= 0]
    np.testing.assert_array_equal(np.sort(local),
                                  np.arange(sc.groups[gi].size))
    assert (plan.sel_to_local < 0).sum() == plan.padP


# --- (5) routed intersect and shadow --------------------------------------

ROUTES = {"blocks": dict(MEGA_EXT_MIN=8, BLOCK_MIN=8),
          "external": dict(MEGA_EXT_MIN=8, BLOCK_VMEM_MAX=0)}


def _route(monkeypatch, route):
    for mod in (JMK, MK):
        for k, v in ROUTES[route].items():
            monkeypatch.setattr(mod, k, v)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routed_entries_match_pallas(monkeypatch, route):
    _route(monkeypatch, route)
    sj, lj, _ = j_mesh_scene(1500, cast_shadows=True)
    st, lt, _ = t_mesh_scene(1500, cast_shadows=True)
    cj, ct = G.compile_scene(sj, lj), T.compile_scene(st, lt)
    pj, pt = JMK.get_plan(cj), MK.get_plan(ct)
    assert (pj.blocks, pj.external) == (pt.blocks, pt.external)
    assert getattr(pt, route) == [(0, 1)]
    n = 512
    o, d, _ = _rays(n, seed=21, span=3.0)
    want = JMK.mega_intersect(cj, cj.arrays(), jnp.asarray(o),
                              jnp.asarray(d), interpret=True)
    arrays = T.to_torch(ct.arrays(), "cpu")
    table = _table(o, d, np.full(n, 1e6, np.float32))
    counts = (MK.mega_select_plain.calls, BK.block_select_plain.calls,
              MSH.mesh_block_select_plain.calls)
    got = MK.mega_intersect_table(ct, arrays, table)
    ran = (MK.mega_select_plain.calls - counts[0],
           BK.block_select_plain.calls - counts[1],
           MSH.mesh_block_select_plain.calls - counts[2])
    assert ran == ((1, 1, 0) if route == "blocks" else (1, 0, 1))
    hw, hg = np.asarray(want.hit), got.hit.numpy()
    np.testing.assert_array_equal(hw, hg)
    assert 100 < int(hw.sum()) < n
    np.testing.assert_allclose(got.t.numpy()[hw], np.asarray(want.t)[hw],
                               rtol=RTOL)
    same = got.prim_serial.numpy() == np.asarray(want.prim_serial)
    print(f"{route}: prim_serial differs on {int((~same).sum())} lanes")
    assert (~same).sum() <= 0.01 * hw.sum()
    np.testing.assert_array_equal(got.t.numpy()[~same],
                                  np.asarray(want.t)[~same])
    m = hw & same
    np.testing.assert_allclose(got.norm.numpy()[m], np.asarray(want.norm)[m],
                               rtol=1e-4, atol=1e-5)
    # shadow: segments from the hit points toward the key light
    pos = np.asarray(want.pos)[hw]
    nrm = np.asarray(want.norm)[hw]
    lpos = np.float32([4.0, 6.0, -4.0])
    so = (pos + nrm * 1e-3).astype(np.float32)
    sd = lpos - so
    slen = np.linalg.norm(sd, axis=1)
    sd = (sd / slen[:, None]).astype(np.float32)
    tmax = (slen - 2e-4).astype(np.float32)
    bw = np.asarray(JMK.mega_shadow(cj, cj.arrays(), jnp.asarray(so),
                                    jnp.asarray(sd), tmax=jnp.asarray(tmax),
                                    interpret=True))
    bg = MK.mega_shadow_table(ct, arrays, _table(so, sd, tmax)).numpy()
    np.testing.assert_array_equal(bg, bw)
    assert 0 < bw.sum() < len(bw)


# --- (6) the plan of the 100k-triangle mesh --------------------------------

def test_mesh100k_plan_matches():
    sj, lj, _ = j_mesh_scene(100_000)
    st, lt, _ = t_mesh_scene(100_000)
    pj = JMK.get_plan(G.compile_scene(sj, lj))
    pt = MK.get_plan(T.compile_scene(st, lt))
    assert pt.blocks == pj.blocks == [(0, 1)]
    assert pt.external == pj.external == []
    assert pt.prim_base == pj.prim_base
    assert pt.prim_base[(0, 1)] == (1, 99_904)


# --- (7) the slice as a whole: a small mesh frame --------------------------

@pytest.mark.parametrize("cast_shadows", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_mesh_frame_matches_glome_tpu(monkeypatch, route, cast_shadows):
    """A 64x36 depth-1 frame of mesh_scene(1500) routed through K2 or
    K3, rendered by both packages on the CPU, under the canaries."""
    _route(monkeypatch, route)
    sj, lj, camj = j_mesh_scene(1500, cast_shadows=cast_shadows)
    st, lt, camt = t_mesh_scene(1500, cast_shadows=cast_shadows)
    cj, ct = G.compile_scene(sj, lj), T.compile_scene(st, lt)
    jcfg = JRenderConfig(xres=64, yres=36, maxdepth=1)
    jr = JRenderer(G.WavefrontTracer(cj, jcfg), camj, jcfg)
    want, _dw = jr.render(cj.arrays())
    ov = getattr(jr, "last_overflow", None)
    assert ov is None or int(np.asarray(ov).sum()) == 0
    cfg = T.RenderConfig(xres=64, yres=36, maxdepth=1)
    assert getattr(MK.get_plan(ct), route) == [(0, 1)]
    tr = T.Renderer(T.WavefrontTracer(ct, cfg), camt, cfg)
    got, depth = tr.render(T.to_torch(ct.arrays(), "cpu"))
    assert int(tr.last_overflow.sum()) == 0
    assert torch.isfinite(got).all()
    a, b = quantize(got.numpy()), quantize(np.asarray(want))
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(axis=-1)
    print(f"{route} cast_shadows={cast_shadows}: mean {diff.mean():.4f} "
          f"levels, {int((diff > 64).sum())}/{diff.size} pixels > 64")
    assert diff.mean() <= CANARY_MEAN
    assert (diff > 64).sum() <= CANARY_FRAC * diff.size
    # the mesh is in view: most of the frame hits something
    assert (depth.numpy() < T.INFINITY).mean() > 0.5


# --- (8) K2's and K3's trees as shared child-pair records -----------------

def block_tree_rows(plan):
    """Per node of a BlockPlan's tree: (box (M, 6), left, right, first row,
    row count) with each leaf's rows those of its block in the unpermuted
    table: block order[leaf_start], BP rows."""
    bvh = plan.bvh
    leaf = bvh.leaf_count > 0
    assert (bvh.leaf_count[leaf] == 1).all()
    block = np.asarray(bvh.order)[np.where(leaf, bvh.leaf_start, 0)]
    return (np.concatenate([bvh.bmin, bvh.bmax], axis=1), bvh.left,
            bvh.right, np.where(leaf, block * BK.BP, 0),
            np.where(leaf, BK.BP, 0))


def _mesh_group(n_tris):
    st, lt, _ = t_mesh_scene(n_tris)
    sc, gi = _block_group(T.compile_scene(st, lt))
    return sc, sc.groups[gi]


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("n_tris", [1500, 100_000])
def test_block_trees_as_child_pair_records(kernel, n_tris):
    """The child-pair records K2 and K3 walk (accel.node_records, the
    layout of K1's records) give back every child box and leaf range of
    their plans' binary block trees, on mesh 1500 and the 100k plan.  A
    K2 leaf's rows are its block's; a K3 leaf's rows are a run of the
    permuted table that holds exactly its blocks' triangles."""
    sc, g = _mesh_group(n_tris)
    if kernel == "K2":
        plan = BK.get_block_plan(g, sc)
        box, left, right, first, count = block_tree_rows(plan)
    else:
        plan = MSH.get_block_plan(g)
        bvh = plan.bvh
        box = np.concatenate([bvh.bmin, bvh.bmax], axis=1)
        left, right = bvh.left, bvh.right
        first, count = bvh.leaf_start * MSH.BP, bvh.leaf_count * MSH.BP
        order = np.asarray(bvh.order)
        for node in np.nonzero(bvh.leaf_count > 0)[0][::37]:
            rows = np.arange(first[node], first[node] + count[node])
            blocks = order[bvh.leaf_start[node]:
                           bvh.leaf_start[node] + bvh.leaf_count[node]]
            want = (blocks[:, None] * MSH.BP + np.arange(MSH.BP)).reshape(-1)
            np.testing.assert_array_equal(plan.row_perm[rows], want)
    recs = plan.nodes.reshape(-1, MK.NODE_W)
    assert len(recs) == 1 + int((np.asarray(count) == 0).sum())
    reached, depth = walk_pair_records(recs, box, left, right, first, count)
    assert reached == plan.n_nodes and depth == plan.depth
    assert TK.walk_stack(plan.depth) == plan.depth - 1
    print(f"{kernel} mesh{n_tris}: {plan.n_blocks} blocks, {plan.n_nodes} "
          f"nodes, depth {plan.depth}")


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_mesh_rows_are_padded_triangles(kernel):
    """K2's and K3's 12-float triangle rows carry p1, p2, p3 unchanged,
    then three zeros: K3's in leaf order (the triangle each permuted row
    maps to through sel_to_local; padding rows all zero), K2's in the
    group's order (padding rows copy the last)."""
    st, lt, _ = t_mesh_scene(1500)
    ct = T.compile_scene(st, lt)
    sc, gi = _block_group(ct)
    g = sc.groups[gi]
    ga = t_group_params(g, T.to_torch(ct.arrays(), "cpu")["scenes"][0][gi])
    p123 = np.concatenate([ga[k].numpy() for k in ("p1", "p2", "p3")], 1)
    if kernel == "K3":
        plan = MSH.get_block_plan(g)
        tri = MSH.pack_tri_blocks(plan, ga).numpy()
        assert tri.shape == (plan.n_blocks * MSH.BP, 12) and MSH.TRI_F == 12
        real = plan.sel_to_local >= 0
        want = p123[plan.sel_to_local[real]]
        assert (tri[~real] == 0).all()
    else:
        plan = BK.get_block_plan(g, sc)
        assert plan.F == BK.TRI_F == 12
        tri = BK.pack_blocks(plan, ga).numpy().reshape(-1, 12)
        assert tri.shape == (plan.n_blocks * BK.BP, 12)
        real = np.arange(len(tri)) < g.size
        want = p123
        np.testing.assert_array_equal(tri[~real], tri[g.size - 1:g.size]
                                      .repeat((~real).sum(), 0))
    np.testing.assert_array_equal(tri[real, :9], want)
    assert (tri[real, 9:] == 0).all()


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_plain_versions_take_the_lowest_tied_row(kernel):
    """On phasescene's flat quad grid, vertical rays through shared
    edges and vertices meet several triangles at bit-exactly the same t
    (asserted: many lanes have more than one row at the winning t).
    block_select_plain and mesh_block_select_plain return the lowest of
    those rows, the rule K2 and K3 follow whatever order their walks
    visit the rows in."""
    ct = T.compile_scene(tie_grid_scene(), [tlight((0, 8, 0), (1, 1, 1))])
    sc = ct.scenes[0]
    (g,) = sc.groups
    assert g.ptype == "triangle" and g.size == 512
    arr = T.to_torch(ct.arrays(), "cpu")["scenes"][0]
    ga = t_group_params(g, arr[0])
    n = 2048
    o, d = tie_grid_rays(n, seed=3)
    seed_t = np.full(n, 1e6, np.float32)
    seed_t[::17] = 0.0                   # dead lanes
    table, seed = _table(o, d, seed_t), torch.as_tensor(seed_t)
    if kernel == "K2":
        plan = BK.get_block_plan(g, sc)
        tab = BK.pack_blocks(plan, ga)
        rows = tab.reshape(-1, plan.F)
        t, sel = BK.block_select(plan, tab, BK.pack_cons(plan, sc, arr, "cpu"),
                                 table, seed)
        row = sel // 2
        assert (sel[sel >= 0] % 2 == 0).all()
    else:
        plan = MSH.get_block_plan(g)
        rows = MSH.pack_tri_blocks(plan, ga)
        t, row = MSH.mesh_block_select(plan, rows, table, seed)
    t0, _t1 = MK._candidates("triangle", rows, 9, False,
                             torch.as_tensor(o), torch.as_tensor(d))
    at = (t0 == t[:, None]) & (t0 > 0)
    hit = (row >= 0).numpy()
    n_tie = int((at.sum(1) > 1).numpy()[hit].sum())
    print(f"{kernel}: {int(hit.sum())}/{n} hit, {n_tie} lanes with more than "
          f"one row at the winning t")
    assert n_tie > n // 4
    lowest = torch.argmax(at.to(torch.int32), dim=1)
    np.testing.assert_array_equal(row.numpy()[hit], lowest.numpy()[hit])
    assert (row.numpy()[seed_t == 0] == -1).all()


def test_deep_block_tree_fits_the_walk_stack():
    """A K2 block tree deeper than the 64 entries of its former fixed
    stack: phasescene.chain_scene(320, 2^(-1/6)), 320 spheres shrinking
    geometrically (the smallest 1e-16 across, still apart in float32),
    cut into 80 blocks of 4, gives a tree 80 deep, one block peeled off
    per level (chip_smoke.py calls block_select on that group directly,
    as here).  The stack helper gives it 79 entries, which the card's
    shared memory holds, and the records give the tree back."""
    ct = T.compile_scene(chain_scene(CHAIN_SPHERES, CHAIN_RATIO),
                         [tlight((0, 8, 0), (1, 1, 1))])
    sc = ct.scenes[0]
    plan = BK.get_block_plan(sc.groups[0], sc)
    assert plan.n_blocks == 80 and plan.depth == 80
    stack = TK.walk_stack(plan.depth)
    assert stack == 79
    assert stack * TK.WALK_THREADS * TK.STACK_ENTRY_BYTES <= TK.SMEM_BLOCK_MAX
    reached, depth = walk_pair_records(plan.nodes.reshape(-1, MK.NODE_W),
                                       *block_tree_rows(plan))
    assert (reached, depth) == (plan.n_nodes, 80)
