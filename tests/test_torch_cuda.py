"""K1-K5, M1 and M2 on the card: each CUDA kernel against its plain
version, the wrappers' contracts, and K1's and K4's work tallies; the
recursive Tracer, adaptive AA and a soft gradient step through the
kernels against the plain set.  Every
test needs a CUDA device and skips without one.  The card's machine has
no JAX, so run these without the suite's conftest (which configures
JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import glome_tpu_torch as T
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch.scenes.phasescene import (chain_rays, chain_scene,
                                               csg_rays, csg_scene,
                                               phase_kinds_lights,
                                               phase_kinds_rays,
                                               phase_kinds_scene,
                                               tie_grid_rays, tie_grid_scene,
                                               warp_lights_scene)

SCENES = {"phase_kinds": (phase_kinds_scene, phase_kinds_rays),
          "csg": (csg_scene, csg_rays)}

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tables(dev, scene="phase_kinds"):
    compiled = T.compile_scene(SCENES[scene][0](), phase_kinds_lights())
    plan = MK.get_plan(compiled)
    return MK.pack_tables(plan, compiled, T.to_torch(compiled.arrays(), dev))


@pytest.fixture(scope="module")
def tables(dev):
    return _tables(dev)


def _rays(dev, n, seed_t, seed, scene="phase_kinds"):
    o, d = SCENES[scene][1](n, seed=seed)
    return torch.as_tensor(np.stack(
        [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
         np.full(n, seed_t, np.float32), np.zeros(n, np.float32)]),
        device=dev).contiguous()


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("shadow", [False, True])
def test_kernel_matches_plain(dev, scene, shadow):
    """Built without multiply-add contraction (kernels.NVCC_FLAGS), K1
    rounds every product as the plain version's eager ops do: on these
    scenes the two agree bit for bit."""
    tables = _tables(dev, scene)
    rays = _rays(dev, 8192, 20.0 if shadow else T.INFINITY, 3 if shadow
                 else 0, scene)
    tk, wk, ak = MK.mega_select(tables, rays, shadow)
    tp, wp, ap = MK.mega_select_plain(tables, rays, shadow)
    torch.cuda.synchronize()
    assert torch.equal(wk >= 0, wp >= 0)
    assert 0 < int((wk >= 0).sum()) < rays.shape[1]
    if not shadow:
        assert torch.equal(tk, tp)
        assert torch.equal(wk, wp)
        assert torch.equal(ak, ap)


def test_clause_work_is_tallied(dev):
    """K1's tally counts the clause work of the constrained check scene
    (inline constraints, deferred difference-B prims): member inside
    tests (row 3) and point-in-node tests (row 2), beside the box and
    prim tests."""
    tables = _tables(dev)
    rays = _rays(dev, 8192, T.INFINITY, 0)
    tally = torch.zeros((MK.TALLY_ROWS, rays.shape[1]), dtype=torch.int32,
                        device=dev)
    MK.mega_select(tables, rays, False, tally=tally)
    per_ray = (tally.sum(dim=1).double() / rays.shape[1]).tolist()
    print(f"box / prim / point / member tests per ray: {per_ray}")
    assert per_ray[0] > 0 and per_ray[1] > 0
    assert per_ray[3] > 0
    with pytest.raises(ValueError):
        MK.mega_select(tables, rays, False, tally=tally[:2].contiguous())


@pytest.mark.parametrize("shadow", [False, True])
def test_kernel_walks_a_deep_tree(dev, shadow):
    """phasescene.chain_scene's bvh2 tree is 47 deep, beyond K1's former
    fixed 32-entry stack: the plan-sized stack walks it, and K1 equals
    its plain version there."""
    compiled = T.compile_scene(chain_scene(), phase_kinds_lights())
    plan = MK.get_plan(compiled)
    assert max(ph.depth for ph in plan.phases if ph.kind == "bvh2") == 47
    tables = MK.pack_tables(plan, compiled,
                            T.to_torch(compiled.arrays(), dev))
    n = 8192
    o, d = chain_rays(n, seed=1)
    rays = torch.as_tensor(np.stack(
        [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
         np.full(n, 1.0 if shadow else T.INFINITY, np.float32),
         np.zeros(n, np.float32)]), device=dev).contiguous()
    tk, wk, ak = MK.mega_select(tables, rays, shadow)
    tp, wp, ap = MK.mega_select_plain(tables, rays, shadow)
    torch.cuda.synchronize()
    assert torch.equal(wk >= 0, wp >= 0)
    assert 0 < int((wk >= 0).sum()) < n
    if not shadow:
        assert torch.equal(tk, tp) and torch.equal(wk, wp)


def test_launch_count(dev, tables):
    rays = _rays(dev, 1024, T.INFINITY, 0)
    before = MK.mega_select.launches
    MK.mega_select(tables, rays, False)
    MK.mega_select(tables, rays[:, :0].contiguous(), False)   # no launch
    torch.cuda.synchronize()
    assert MK.mega_select.launches == before + 1


def test_wrapper_rejects_bad_inputs(dev, tables):
    rays = _rays(dev, 256, T.INFINITY, 0)
    with pytest.raises(ValueError):
        MK.mega_select(tables, rays[:7].contiguous(), False)
    with pytest.raises(TypeError):
        MK.mega_select(tables, rays.double(), False)
    with pytest.raises(ValueError):
        MK.mega_select(tables, rays.t().contiguous().t(), False)
    cpu = dataclasses.replace(tables, pf=tables.pf.cpu())
    with pytest.raises(ValueError):
        MK.mega_select(cpu, rays, False)


# --- K2 and K3 ---------------------------------------------------------------

def _group_case(dev, case):
    """(scene, group index, device arrays) of a K2/K3 check group: the
    20k-triangle mesh of mesh_scene (a K2 group by size) or a
    block_scene group."""
    from glome_tpu_torch.scenes import mesh_scene
    from glome_tpu_torch.scenes.phasescene import block_scene
    if case == "mesh":
        solid, lights, _cam = mesh_scene(20_000, cast_shadows=True)
    else:
        solid, lights = block_scene(case), phase_kinds_lights()
    compiled = T.compile_scene(solid, lights)
    sc = compiled.scenes[0]
    gi = max((i for i, g in enumerate(sc.groups) if g.ptype != "plane"
              and bool(g.constraints) == (case == "difference")),
             key=lambda i: sc.groups[i].size)
    return sc, gi, T.to_torch(compiled.arrays(), dev)["scenes"][0]


def _rays_of(dev, o, d, seed_t):
    """(rays, seed) on dev: the (8, N) table of rays (o, d) with seed t
    seed_t, every 17th lane dead."""
    n = o.shape[0]
    seeds = np.full(n, seed_t, np.float32)
    seeds[::17] = 0.0                         # dead lanes
    rays = torch.as_tensor(np.stack(
        [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], seeds,
         np.zeros(n, np.float32)]), device=dev).contiguous()
    return rays, rays[6].contiguous()


def _block_rays(dev, n, seed_t, seed, span):
    from glome_tpu_torch.scenes.phasescene import block_rays
    o, d = block_rays(n, seed, span)
    return _rays_of(dev, o, d, seed_t)


def _assert_kernel_equals_plain(k, p, shadow):
    """Built without multiply-add contraction, the kernels round each
    candidate as the plain versions do: blocked/hit agree on every
    lane, and in intersect mode t and the winner too (both take the
    lowest row of an exact tie)."""
    (tk, sk), (tp, sp) = k, p
    torch.cuda.synchronize()
    assert torch.equal(sk >= 0, sp >= 0)
    assert 0 < int((sk >= 0).sum()) < sk.numel()
    if not shadow:
        assert torch.equal(tk, tp)
        assert torch.equal(sk, sp)


@pytest.mark.parametrize("case", ["mesh", "spheres", "difference",
                                  "transformed"])
@pytest.mark.parametrize("shadow", [False, True])
def test_block_kernel_matches_plain(dev, case, shadow):
    from glome_tpu_torch import block_kernel as BK
    from glome_tpu_torch.compile import group_device_params
    sc, gi, garrs = _group_case(dev, case)
    g = sc.groups[gi]
    plan = BK.get_block_plan(g, sc)
    tab = BK.pack_blocks(plan, group_device_params(g, garrs[gi]))
    cf = BK.pack_cons(plan, sc, garrs, dev)
    rays, seed = _block_rays(dev, 8192, 7.0 if shadow else T.INFINITY,
                             5 if shadow else 4,
                             3.0 if case == "mesh" else 6.0)
    before = BK.block_select.launches
    k = BK.block_select(plan, tab, cf, rays, seed, shadow)
    p = BK.block_select_plain(plan, tab, cf, rays, seed, shadow)
    assert BK.block_select.launches == before + 1
    _assert_kernel_equals_plain(k, p, shadow)


@pytest.mark.parametrize("shadow", [False, True])
def test_mesh_kernel_matches_plain(dev, shadow):
    from glome_tpu_torch import mesh_kernel as MSH
    from glome_tpu_torch.compile import group_device_params
    sc, gi, garrs = _group_case(dev, "mesh")
    g = sc.groups[gi]
    plan = MSH.get_block_plan(g)
    tri = MSH.pack_tri_blocks(plan, group_device_params(g, garrs[gi]))
    rays, seed = _block_rays(dev, 8192, 3.0 if shadow else T.INFINITY,
                             7 if shadow else 6, 3.0)
    before = MSH.mesh_block_select.launches
    k = MSH.mesh_block_select(plan, tri, rays, seed, shadow)
    p = MSH.mesh_block_select_plain(plan, tri, rays, seed, shadow)
    assert MSH.mesh_block_select.launches == before + 1
    _assert_kernel_equals_plain(k, p, shadow)


def _tie_grid(dev):
    """(scene, group, device arrays) of phasescene.tie_grid_scene."""
    compiled = T.compile_scene(tie_grid_scene(), phase_kinds_lights())
    sc = compiled.scenes[0]
    return sc, sc.groups[0], T.to_torch(compiled.arrays(), dev)["scenes"][0]


@pytest.mark.parametrize("shadow", [False, True])
def test_block_and_mesh_kernels_break_ties_by_row(dev, shadow):
    """On the flat quad grid, whose vertical rays meet several rows at
    bit-exactly the same t, K2 and K3 equal their plain versions on every
    lane, winners included: the lowest tied row."""
    from glome_tpu_torch import block_kernel as BK
    from glome_tpu_torch import mesh_kernel as MSH
    from glome_tpu_torch.compile import group_device_params
    sc, g, garrs = _tie_grid(dev)
    ga = group_device_params(g, garrs[0])
    o, d = tie_grid_rays(8192, seed=2)
    rays, seed = _rays_of(dev, o, d, 5.0 if shadow else T.INFINITY)
    plan = BK.get_block_plan(g, sc)
    tab = BK.pack_blocks(plan, ga)
    cf = BK.pack_cons(plan, sc, garrs, dev)
    _assert_kernel_equals_plain(
        BK.block_select(plan, tab, cf, rays, seed, shadow),
        BK.block_select_plain(plan, tab, cf, rays, seed, shadow), shadow)
    mplan = MSH.get_block_plan(g)
    tri = MSH.pack_tri_blocks(mplan, ga)
    _assert_kernel_equals_plain(
        MSH.mesh_block_select(mplan, tri, rays, seed, shadow),
        MSH.mesh_block_select_plain(mplan, tri, rays, seed, shadow), shadow)


@pytest.mark.parametrize("shadow", [False, True])
def test_block_kernel_walks_a_deep_tree(dev, shadow):
    """The 320-sphere chain's block tree is 80 deep, beyond K2's former
    fixed 64-entry stack (its 79-entry stack takes 79 KB of shared
    memory, above the 48 KB a kernel gets without opting in); K2 equals
    its plain version there."""
    from glome_tpu_torch import block_kernel as BK
    from glome_tpu_torch.compile import group_device_params
    ratio = 2.0 ** (-1 / 6)
    compiled = T.compile_scene(chain_scene(320, ratio), phase_kinds_lights())
    sc = compiled.scenes[0]
    g = sc.groups[0]
    garrs = T.to_torch(compiled.arrays(), dev)["scenes"][0]
    plan = BK.get_block_plan(g, sc)
    assert plan.depth > 64
    tab = BK.pack_blocks(plan, group_device_params(g, garrs[0]))
    cf = BK.pack_cons(plan, sc, garrs, dev)
    o, d = chain_rays(8192, seed=3, n_spheres=320, ratio=ratio)
    rays, seed = _rays_of(dev, o, d, 1.0 if shadow else T.INFINITY)
    _assert_kernel_equals_plain(
        BK.block_select(plan, tab, cf, rays, seed, shadow),
        BK.block_select_plain(plan, tab, cf, rays, seed, shadow), shadow)


def test_mesh_kernel_tests_as_few_as_the_block_kernel(dev):
    """K3 walks K2's near-first walk over leaves of up to 2 blocks: on
    mesh_scene(1500) its box + triangle tests per ray are at most 1.1x
    K2's on the same rays."""
    from glome_tpu_torch import block_kernel as BK
    from glome_tpu_torch import mesh_kernel as MSH
    from glome_tpu_torch.compile import group_device_params
    from glome_tpu_torch.scenes import mesh_scene
    solid, lights, _cam = mesh_scene(1500, cast_shadows=True)
    compiled = T.compile_scene(solid, lights)
    sc = compiled.scenes[0]
    gi = max(range(len(sc.groups)), key=lambda i: sc.groups[i].size)
    g = sc.groups[gi]
    garrs = T.to_torch(compiled.arrays(), dev)["scenes"][0]
    ga = group_device_params(g, garrs[gi])
    rays, seed = _block_rays(dev, 8192, T.INFINITY, 6, 3.0)
    n = rays.shape[1]
    tallies = [torch.zeros((2, n), dtype=torch.int32, device=dev)
               for _ in range(2)]
    plan = BK.get_block_plan(g, sc)
    BK.block_select(plan, BK.pack_blocks(plan, ga),
                    BK.pack_cons(plan, sc, garrs, dev), rays, seed,
                    tally=tallies[0])
    mplan = MSH.get_block_plan(g)
    MSH.mesh_block_select(mplan, MSH.pack_tri_blocks(mplan, ga), rays, seed,
                          tally=tallies[1])
    k2, k3 = (float(t.sum()) / n for t in tallies)
    print(f"box + triangle tests per ray: K2 {k2:.2f}, K3 {k3:.2f}")
    assert 0 < k3 <= 1.1 * k2


def test_block_wrappers_reject_bad_inputs(dev):
    from glome_tpu_torch import block_kernel as BK
    from glome_tpu_torch import mesh_kernel as MSH
    from glome_tpu_torch.compile import group_device_params
    sc, gi, garrs = _group_case(dev, "mesh")
    g = sc.groups[gi]
    ga = group_device_params(g, garrs[gi])
    rays, seed = _block_rays(dev, 256, T.INFINITY, 0, 3.0)
    plan = BK.get_block_plan(g, sc)
    tab = BK.pack_blocks(plan, ga)
    cf = BK.pack_cons(plan, sc, garrs, dev)
    with pytest.raises(ValueError):
        BK.block_select(plan, tab.cpu(), cf, rays, seed)
    with pytest.raises(ValueError):
        BK.block_select(plan, tab, cf, rays, seed[:-1].contiguous())
    with pytest.raises(TypeError):
        BK.block_select(plan, tab.double(), cf, rays, seed)
    mplan = MSH.get_block_plan(g)
    tri = MSH.pack_tri_blocks(mplan, ga)
    with pytest.raises(ValueError):
        MSH.mesh_block_select(mplan, tri[:-1], rays, seed)
    with pytest.raises(ValueError):
        MSH.mesh_block_select(mplan, tri.t().contiguous().t(), rays, seed)


# --- K4 and K5 (the pass-per-group route) ------------------------------------

def _dense_case(dev, case):
    """(scene, group index, device arrays) of a K4 check group: block_scene
    spheres (plain), their difference (inline constraint), the rotated
    boxes, the all-phase-kinds scene's transformed cones, and the CSG
    scene's ground plane (no AABB cull)."""
    from glome_tpu_torch.scenes.phasescene import block_scene
    if case in ("spheres", "difference", "transformed"):
        solid = block_scene(case)
    elif case == "cones":
        solid = phase_kinds_scene()
    else:
        solid = csg_scene()
    compiled = T.compile_scene(solid, phase_kinds_lights())
    sc = compiled.scenes[0]
    ptype = {"cones": "cone", "planes": "plane"}.get(case)
    gi = max((i for i, g in enumerate(sc.groups)
              if g.vclass in ("plain", "inline")
              and (ptype is None or g.ptype == ptype)
              and bool(g.constraints) == (case == "difference")),
             key=lambda i: sc.groups[i].size)
    return sc, gi, T.to_torch(compiled.arrays(), dev)["scenes"][0]


def _dense_inputs(sc, gi, garrs, shadow, dev):
    from glome_tpu_torch import group_kernels as GK
    g = sc.groups[gi]
    ga = garrs[gi]
    params = {k: v for k, v in ga.items() if k not in ("m_inv", "m_fwd")}
    vis = torch.as_tensor((~g.noshadow if shadow else ~g.onlyshadow)
                          .astype(np.float32), device=dev)
    return (g.ptype, GK.pack_params_T(g.ptype, params), ga.get("m_inv"), vis,
            GK.encode_constraints(GK.pack_constraints(sc, garrs, g), dev))


@pytest.mark.parametrize("case", ["spheres", "difference", "transformed",
                                  "cones", "planes"])
@pytest.mark.parametrize("shadow", [False, True])
def test_dense_kernel_matches_plain(dev, case, shadow):
    from glome_tpu_torch import group_kernels as GK
    sc, gi, garrs = _dense_case(dev, case)
    g = sc.groups[gi]
    args = _dense_inputs(sc, gi, garrs, shadow, dev)
    ga = garrs[gi]
    bbox = GK.cull_aabbs(g.ptype, {k: v for k, v in ga.items()
                                   if k not in ("m_inv", "m_fwd")},
                         ga.get("m_fwd"), g.size)
    rays, seed = _block_rays(dev, 8192, 7.0 if shadow else T.INFINITY,
                             5 if shadow else 4, 6.0)
    if case in ("cones", "planes"):
        # their own scenes' rays (dead lanes as in _block_rays)
        rays = _rays(dev, 8192, 20.0 if shadow else T.INFINITY, 3,
                     "csg" if case == "planes" else "phase_kinds")
        rays[6, ::17] = 0.0
        seed = rays[6].contiguous()
    before = GK.dense_select.launches
    k = GK.dense_select(*args, rays, seed, block_bbox=bbox, shadow=shadow)
    p = GK.dense_select_plain(*args, rays, seed, block_bbox=bbox,
                              shadow=shadow)
    assert GK.dense_select.launches == before + 1
    _assert_kernel_equals_plain(k, p, shadow)


def test_dense_cull_on_testscene_cones(dev):
    """K4 on TestScene's 1,024 transformed cones with its L0 rays tests
    fewer cones per ray than the per-128-prim block cull did (117.95 per
    ray on the card), and equals the plain version."""
    from glome_tpu_torch import group_kernels as GK
    from glome_tpu_torch.intersect import dense_args
    from glome_tpu_torch.scenes import test_scene
    from glome_tpu_torch.tools.kernel_ab import l0_batch
    solid, lights, cam = test_scene()
    compiled = T.compile_scene(solid, lights)
    sc = compiled.scenes[0]
    gi = next(i for i, g in enumerate(sc.groups) if g.ptype == "cone")
    arrays = T.to_torch(compiled.arrays(), dev)["scenes"][0]
    args, cull = dense_args(sc, arrays, gi, False, dev)
    rays = l0_batch(cam, 720, 480, dev)
    seed = rays[6].contiguous()
    tally = torch.zeros((2, rays.shape[1]), dtype=torch.int32, device=dev)
    k = GK.dense_select(*args, rays, seed, block_bbox=cull, tally=tally)
    per_ray = (tally.sum(dim=1).double() / rays.shape[1]).tolist()
    print(f"box / cone tests per ray: {per_ray}")
    assert per_ray[1] < 117.95
    p = GK.dense_select_plain(*args, rays, seed)
    _assert_kernel_equals_plain(k, p, False)


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("shadow", [False, True])
def test_bvh_kernel_matches_plain(dev, constrained, shadow):
    from glome_tpu_torch import group_kernels as GK
    from glome_tpu_torch.compile import group_accel
    from glome_tpu_torch.scenes.phasescene import block_scene
    compiled = T.compile_scene(
        block_scene("difference" if constrained else "spheres"),
        phase_kinds_lights(), accel_min_size=64)
    sc = compiled.scenes[0]
    gi = max((i for i, g in enumerate(sc.groups) if g.accel_eligible
              and bool(g.constraints) == constrained),
             key=lambda i: sc.groups[i].size)
    g = sc.groups[gi]
    garrs = T.to_torch(compiled.arrays(), dev)["scenes"][0]
    bvh = group_accel(g)
    order = torch.as_tensor(np.asarray(bvh.order, np.int64), device=dev)
    rows = GK.pack_params_rows(g.ptype, {k: v[order]
                                         for k, v in garrs[gi].items()})
    vis = torch.as_tensor((~g.noshadow if shadow else ~g.onlyshadow)
                          .astype(np.float32), device=dev)[order].contiguous()
    cons = GK.encode_constraints(GK.pack_constraints(sc, garrs, g), dev)
    assert bool(cons.spec) == constrained
    rays, seed = _block_rays(dev, 8192, 7.0 if shadow else T.INFINITY,
                             5 if shadow else 4, 6.0)
    before = GK.bvh_select.launches
    k = GK.bvh_select(g.ptype, bvh, rows, vis, cons, rays, seed, shadow)
    p = GK.bvh_select_plain(g.ptype, bvh, rows, vis, cons, rays, seed, shadow)
    assert GK.bvh_select.launches == before + 1
    _assert_kernel_equals_plain(k, p, shadow)


@pytest.mark.parametrize("case", ["coincident", "tie_grid"])
@pytest.mark.parametrize("shadow", [False, True])
def test_bvh_kernel_breaks_ties_by_row(dev, case, shadow):
    """K5 on exact ties: 1,000 coincident spheres (a skip-link chain 250
    leaves long, walked as a balanced tree at most 12 deep; every hit
    ties all rows) and the tie grid's 512 flat triangles as one K5
    group.  K5 equals its plain version on every lane, winners
    included: the lowest leaf-order row at the least t."""
    from glome_tpu_torch import group_kernels as GK
    from glome_tpu_torch.intersect import bvh_args
    from glome_tpu_torch.compile import materialize_scene_params
    from glome_tpu_torch.scenes.phasescene import coincident_scene
    solid = coincident_scene() if case == "coincident" else tie_grid_scene()
    compiled = T.compile_scene(solid, phase_kinds_lights(), accel_min_size=64)
    sc = compiled.scenes[0]
    garrs = materialize_scene_params(
        sc, T.to_torch(compiled.arrays(), dev)["scenes"][0])
    args, _order = bvh_args(sc, garrs, 0, shadow, dev)
    if case == "coincident":
        assert GK.bvh_records(args[1], dev).depth <= 12
        rays, seed = _block_rays(dev, 8192, 7.0 if shadow else T.INFINITY,
                                 5 if shadow else 4, 6.0)
    else:
        o, d = tie_grid_rays(8192, seed=2)
        rays, seed = _rays_of(dev, o, d, 5.0 if shadow else T.INFINITY)
    k = GK.bvh_select(*args, rays, seed, shadow)
    p = GK.bvh_select_plain(*args, rays, seed, shadow)
    _assert_kernel_equals_plain(k, p, shadow)
    if not shadow:
        rows = args[2]
        t0, t1 = MK._candidates(args[0], rows, rows.shape[1], False,
                                rays[0:3].t(), rays[3:6].t())
        at_t = ((t0 == p[0][:, None]) | (t1 == p[0][:, None])) & (
            args[3] > 0.5)
        assert int((at_t.sum(dim=1) > 1).sum()) > 1000


@pytest.mark.parametrize("shadow", [False, True])
def test_bvh_kernel_on_a_mesh_group(dev, shadow):
    """K5 on a mesh group: mesh_scene(1500, cast_shadows=True) compiled
    with accel_min_size=64, so its 1,458 smooth triangles (expanded from
    vertex rows) are one K5 group over the native builder's tree, the
    rows in leaf order.  K5 equals its plain version on every lane,
    winners included, on rays into the mesh from around it."""
    from glome_tpu_torch import group_kernels as GK
    from glome_tpu_torch.compile import materialize_scene_params
    from glome_tpu_torch.intersect import bvh_args
    from glome_tpu_torch.scenes import mesh_scene
    st, lt, _cam = mesh_scene(1500, cast_shadows=True)
    compiled = T.compile_scene(st, lt, accel_min_size=64)
    sc = compiled.scenes[0]
    gi = next(i for i, g in enumerate(sc.groups) if g.accel_eligible)
    assert sc.groups[gi].ptype == "trianglenorm"
    garrs = materialize_scene_params(
        sc, T.to_torch(compiled.arrays(), dev)["scenes"][0])
    args, _order = bvh_args(sc, garrs, gi, shadow, dev)
    rng = np.random.RandomState(6 if shadow else 7)
    o = rng.uniform(-3, 3, (8192, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (8192, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays, seed = _rays_of(dev, o, d, 4.0 if shadow else T.INFINITY)
    before = GK.bvh_select.launches
    k = GK.bvh_select(*args, rays, seed, shadow)
    p = GK.bvh_select_plain(*args, rays, seed, shadow)
    assert GK.bvh_select.launches == before + 1
    _assert_kernel_equals_plain(k, p, shadow)


def test_group_wrappers_reject_bad_inputs(dev):
    from glome_tpu_torch import group_kernels as GK
    sc, gi, garrs = _dense_case(dev, "transformed")
    ptype, pm, minv, vis, cons = _dense_inputs(sc, gi, garrs, False, dev)
    rays, seed = _block_rays(dev, 256, T.INFINITY, 0, 6.0)
    with pytest.raises(ValueError):
        GK.dense_select(ptype, pm.cpu(), minv, vis, cons, rays, seed)
    with pytest.raises(ValueError):
        GK.dense_select(ptype, pm, minv, vis[:-1].contiguous(), cons, rays,
                        seed)
    with pytest.raises(TypeError):
        GK.dense_select(ptype, pm.double(), minv, vis, cons, rays, seed)
    with pytest.raises(ValueError):
        GK.dense_select(ptype, pm, minv, vis, cons, rays,
                        seed[:-1].contiguous())


def test_group_route_kernels_match_plain_route(dev):
    """The whole group route through K4/K5 against the same route through
    the plain versions, on the all-phase-kinds scene with its lattice
    groups given a BVH."""
    from glome_tpu_torch.intersect import intersect_multi
    compiled = T.compile_scene(phase_kinds_scene(), phase_kinds_lights(),
                               accel_min_size=64)
    arrays = T.to_torch(compiled.arrays(), dev)
    o, d = (torch.as_tensor(a, device=dev) for a in phase_kinds_rays(4096))
    sid = torch.zeros(4096, dtype=torch.int32, device=dev)
    hk = intersect_multi(compiled, arrays, o, d, sid)
    hp = intersect_multi(compiled, arrays, o, d, sid, select=MK.PLAIN)
    torch.cuda.synchronize()
    assert torch.equal(hk.hit, hp.hit)
    assert torch.equal(hk.t, hp.t)
    assert torch.equal(hk.prim_serial, hp.prim_serial)


# --- M1 and M2 (the card microbenchmarks, glome_tpu_torch.tools) -------------

def _micro_names():
    from glome_tpu_torch.tools import micro_kwide, micro_prims
    return ([("prims", v.name) for v in micro_prims.VARIANTS]
            + [("kwide", v.name) for v in micro_kwide.VARIANTS])


@pytest.mark.parametrize("tool_name,name", _micro_names())
def test_micro_kernel_matches_plain(dev, tool_name, name):
    """Every variant at T = 8 against its plain version: bit-equal, except
    f's tensor-core product (micro_prims.MXU_RTOL / MXU_ATOL)."""
    from glome_tpu_torch.tools import micro_kwide, micro_prims
    tool = micro_prims if tool_name == "prims" else micro_kwide
    v = next(v for v in tool.VARIANTS if v.name == name)
    inp = tool.device_inputs(dev, 8)
    args = (inp["rays"], *(inp[t] for t in v.tables))
    before = v.kernel.launches
    k = v.kernel(*args)
    p = v.plain(*args)
    torch.cuda.synchronize()
    assert v.kernel.launches == before + 1
    assert k.shape == p.shape == (8, 8, 128)
    if name == "f_mxu128":
        close = torch.isclose(k, p, rtol=micro_prims.MXU_RTOL,
                              atol=micro_prims.MXU_ATOL)
        assert float(close.float().mean()) >= micro_prims.MXU_AGREE
    else:
        assert torch.equal(k, p)


def test_micro_wrappers_reject_bad_inputs(dev):
    from glome_tpu_torch import kernels
    from glome_tpu_torch.tools import micro_kwide, micro_prims
    inp = micro_prims.device_inputs(dev, 2)
    rays, pf = inp["rays"], inp["pf"]
    with pytest.raises(ValueError):
        micro_prims.dense_fori(rays, pf.cpu())
    with pytest.raises(ValueError):
        micro_prims.mxu128(rays, inp["pf_lane"][:, :4].contiguous())
    with pytest.raises(TypeError):
        micro_prims.gate16(rays, pf.double())
    kin = micro_kwide.device_inputs(dev, 2)
    with pytest.raises(ValueError):
        micro_kwide.WALKS[1](kin["rays"], torch.zeros(6 * 1025, device=dev))
    # the C entries themselves refuse a heap larger than the walk's stack
    # and a K or NREAD with no build
    lib = kernels.micro_kwide_lib()
    out = torch.empty((2, 8, 128), device=dev)
    rp, nfp, op = kin["rays"].data_ptr(), kin["nf"].data_ptr(), out.data_ptr()
    for entry, args in (
            ("glome_micro_walk", (nfp, micro_kwide.STACK + 1, 1)),
            ("glome_micro_walk", (nfp, micro_kwide.M, 3)),
            ("glome_micro_vread", (32,))):
        err = getattr(lib, entry)(rp, 2, *args, op, None)
        with pytest.raises(RuntimeError):
            kernels.check_launch(lib, err, entry)


def test_device_time_on_card(dev):
    from glome_tpu_torch.tools.device_time import device_time
    x = torch.ones(1 << 20, device=dev)
    sec = device_time(lambda: x.mul_(1.0))
    assert 0.0 < sec < 0.01


@pytest.mark.parametrize("route", ["mega", "groups"])
def test_recursive_tracer_matches_plain_set(dev, route):
    """The recursive Tracer on a portal with its own lights: the kernels
    and the plain set give the same colors (the selections are
    bit-equal), with one K1 launch per batch on the megakernel route."""
    solid, lights, cam = warp_lights_scene()
    compiled = T.compile_scene(solid, lights)
    arrays = T.to_torch(compiled.arrays(), dev)
    cfg = T.RenderConfig(xres=96, yres=64, maxdepth=3)
    tracer = T.Tracer(compiled, cfg, route=route)
    launches = MK.mega_select.launches
    rk, tk = T.Renderer(tracer, cam, cfg).render(arrays)
    if route == "mega":
        assert MK.mega_select.launches - launches == tracer.last_batches
    rp, tp = T.Renderer(T.Tracer(compiled, cfg, select=MK.PLAIN,
                                 route=route), cam, cfg).render(arrays)
    torch.testing.assert_close(rk, rp, rtol=0, atol=1e-6)
    torch.testing.assert_close(tk, tp, rtol=0, atol=0)


def test_aa_and_soft_step_match_plain_set(dev):
    """An AA frame and the gradient of a soft pixel loss through the
    kernels equal the plain set's on the card (AA counts exactly;
    gradients within 1e-4 of the largest |g|: the backward's atomic sums
    may run in another order)."""
    from glome_tpu_torch.soft import SoftTracer, soft_pixel_loss_fn
    solid, lights, cam = warp_lights_scene()
    compiled = T.compile_scene(solid, lights)
    cfg = T.RenderConfig(xres=64, yres=48, blocksize=32, maxdepth=2)
    arrays = T.to_torch(compiled.arrays(), dev)
    out = {}
    for select in (MK.KERNELS, MK.PLAIN):
        tracer = T.Tracer(compiled, cfg, select=select)
        aa = T.AARenderer(tracer, cam, cfg)
        rgb, _depth = aa.render(arrays)
        o, d = T.Renderer(tracer, cam, cfg).rays_for_pixels(
            np.arange(64, dtype=np.float32) % 64,
            np.arange(64, dtype=np.float32) % 48, dev)
        params = {"scenes": [[{k: v.clone().requires_grad_(True)
                               for k, v in ga.items()} for ga in sc]
                             for sc in arrays["scenes"]],
                  "lights": arrays["lights"]}
        soft_pixel_loss_fn(SoftTracer(tracer, tau=0.05))(
            params, o, d, torch.full((64, 3), 0.5, device=dev)).backward()
        out[select] = (rgb, aa.last_ray_counts,
                       [v.grad for sc in params["scenes"] for ga in sc
                        for v in ga.values()])
    (rk, ck, gk), (rp, cp, gp) = out[MK.KERNELS], out[MK.PLAIN]
    assert ck == cp
    torch.testing.assert_close(rk, rp, rtol=0, atol=1e-6)
    scale = max(float(g.abs().max()) for g in gp if g is not None)
    for a, b in zip(gk, gp):
        if b is None:
            assert a is None or not a.any()
            continue
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale)


def test_app_frame_and_work_maps_on_card(dev, tmp_path):
    """python -m glome_tpu_torch.app on the card (its default device):
    the frame goes through K1 with no plain call and equals the CPU run
    of the same argv (the selections are bit-equal); the --debug map on
    CUDA tensors equals the CPU's, and --debug-full through the kernels
    equals it through the plain set."""
    from glome_tpu_torch import app, debug
    from glome_tpu_torch.io import read_png
    argv = ["--scene", "simple", "--xres", "48", "--yres", "32"]
    n0, p0 = MK.mega_select.launches, MK.mega_select_plain.calls
    res = app.main(argv + ["--out", str(tmp_path / "gpu.png")])
    # one intersect and one shadow batch: nothing in the scene reflects,
    # so the deeper levels' queues are empty and launch nothing
    assert MK.mega_select.launches - n0 == 2
    assert MK.mega_select_plain.calls == p0
    app.main(argv + ["--device", "cpu", "--out", str(tmp_path / "cpu.png")])
    np.testing.assert_array_equal(read_png(str(tmp_path / "gpu.png")),
                                  read_png(str(tmp_path / "cpu.png")))
    assert res["overflow"] == {}
    solid, lights = phase_kinds_scene(), phase_kinds_lights()
    compiled = T.compile_scene(solid, lights, accel_min_size=64)
    cam = T.camera((0.5, 0.2, -4.0), (0.0, 0.0, 6.0), (0, 1, 0), 60)
    maps = {}
    for device, full, select in (("cpu", False, MK.KERNELS),
                                 (dev, False, MK.KERNELS),
                                 (dev, True, MK.KERNELS),
                                 (dev, True, MK.PLAIN)):
        arrays = T.to_torch(compiled.arrays(), device)
        _img, prims, nodes = debug.debug_image(compiled, arrays, cam, 64, 48,
                                               full=full, select=select)
        maps[(str(device), full, select)] = (prims, nodes)
    for a, b in zip(maps[("cpu", False, MK.KERNELS)],
                    maps[(str(dev), False, MK.KERNELS)]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(maps[(str(dev), True, MK.KERNELS)],
                    maps[(str(dev), True, MK.PLAIN)]):
        np.testing.assert_array_equal(a, b)


def test_picks_and_queries_on_card(dev):
    """Picks through K1 equal those through the plain set; inside and
    metainfo on CUDA tensors equal the CPU's."""
    from glome_tpu_torch.pick import PickSession
    compiled = T.compile_scene(phase_kinds_scene(tagged=True),
                               phase_kinds_lights())
    cam = T.camera((0.5, 0.2, -4.0), (0.0, 0.0, 6.0), (0, 1, 0), 60)
    cfg = T.RenderConfig(xres=64, yres=48, maxdepth=2)
    arrays = T.to_torch(compiled.arrays(), dev)
    sk = PickSession(T.WavefrontTracer(compiled, cfg), cam, arrays)
    sp = PickSession(T.WavefrontTracer(compiled, cfg, select=MK.PLAIN), cam,
                     arrays)
    for y in range(2, 48, 6):
        for x in range(2, 64, 6):
            assert sk.pick(x, y) == sp.pick(x, y), (x, y)
    pts = np.random.default_rng(11).uniform(
        (-4.5, -2.0, -1.5), (6.0, 4.5, 13.0), (4096, 3)).astype(np.float32)
    cpu = T.to_torch(compiled.arrays(), "cpu")
    assert torch.equal(T.inside(compiled, arrays, torch.as_tensor(pts)).cpu(),
                       T.inside(compiled, cpu, torch.as_tensor(pts)))
    for a, b in zip(T.metainfo(compiled, arrays, torch.as_tensor(pts)),
                    T.metainfo(compiled, cpu, torch.as_tensor(pts))):
        assert torch.equal(a.cpu(), b)


def test_sharded_render_and_step_on_card(dev, tmp_path):
    """Two gloo ranks sharing the card (glome_tpu_torch.tools.sharded):
    the sharded frame equals the single-process frame on the card, and
    both ranks hold the same loss and arrays after the step."""
    import os
    import subprocess
    import sys
    from glome_tpu_torch.optimize import tree_leaves
    from glome_tpu_torch.tools import sharded
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "glome_tpu_torch.tools.sharded", "--scene",
         "two_prim", "--timeout", "300", "--out", str(tmp_path)],
        cwd=root, env=dict(os.environ, PYTHONPATH=root),
        capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ranks = [torch.load(os.path.join(tmp_path, f"rank{r}.pt"))
             for r in (0, 1)]
    _c, cfg, cam, tracer, arrays = sharded.scene_setup("two_prim", dev)
    o, d, inv = sharded.frame_rays(tracer, cam, cfg, dev)
    with torch.no_grad():
        res = tracer.trace(arrays, o, d)
    rgb = (res.color[..., :3] * res.color[..., 3:4])[inv].reshape(
        cfg.yres, cfg.xres, 3).cpu()
    new, loss = sharded.full_batch_step(tracer, arrays, o, d,
                                        torch.zeros_like(o), sharded.LR)
    for r in ranks:
        assert r["render_launches"] > 0 and r["train_launches"] > 0
        torch.testing.assert_close(r["rgb"], rgb, rtol=0, atol=0)
        np.testing.assert_allclose(float(r["loss"]), float(loss), rtol=1e-6)
        for a, b in zip(tree_leaves(r["new_arrays"]), tree_leaves(new)):
            torch.testing.assert_close(a, b.cpu(), rtol=1e-5, atol=1e-7)
    assert float(ranks[0]["loss"]) == float(ranks[1]["loss"])


def test_profile_frame_k1_launches_by_stage(dev):
    """One TestScene 720x480 frame split by the frame-profiling tool: the
    K1 launches of its stages sum to 6 (one per intersect and shadow
    batch of each of the three levels), all in the mega_select rows, and
    equal the wrapper's own counter; the profiler's device ops are
    partitioned by the rows; the frame equals the unwrapped one."""
    from glome_tpu_torch.scenes import test_scene
    from glome_tpu_torch.tools import profile_frame as PF
    solid, lights, cam = test_scene()
    compiled = T.compile_scene(solid, lights)
    arrays = T.to_torch(compiled.arrays(), dev)
    w = PF.frame_workload("frame", compiled, arrays, cam,
                          T.RenderConfig.tuned(), "mega")
    ref = w.run()
    before = MK.mega_select.launches
    sp = PF.split(w.run, dev)
    assert PF._same_frames(sp.result, ref)[0]
    k1 = {r.key: r.counts["K1"] for r in sp.stage_rows() if r.counts["K1"]}
    assert sum(k1.values()) == sp.counts["K1"] \
        == MK.mega_select.launches - before == 6
    assert {key[0] for key in k1} == {"mega_select"}
    assert {key[1] for key in k1} == {0, 1, 2}
    assert sum(r.device_ms for r in sp.rows) == pytest.approx(
        sp.device_ms, rel=1e-6)
    assert sp.busy_ms > 0 and not [s for s in w.stages if s not in sp.fired]
