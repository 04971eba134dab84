"""K1-K5, M1 and M2 on the card: each CUDA kernel against its plain
version, the wrappers' contracts, and K1's and K4's work tallies; the
recursive Tracer, adaptive AA and a soft gradient step through the
kernels against the plain set; the compiled frame (graphs.py) against
the eager frame, an in-place edit read by a replay and a replaced
tensor captured anew; the fused finalize (csrc/finalize_hit.cu) against
the torch finalize, bit for bit, and its dispatch (the kernel follows the
reduction orders of torch 2.11.0+cu128's CUDA ops, read off an H100:
another torch may round otherwise, and these tests then fail).  Every
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



def test_kernel_misses_cones_outside_their_cull_boxes(dev):
    """A known defect of K1, pinned.  A cone's cull box (prim_aabb, and
    accel.group_bounds for the tree) takes the radius at z = 0 for the
    whole clip range; a cone clipped below z = 0 is wider there, and K1
    may cull what lies outside the box, which its plain version (no
    cull) keeps.  On phasescene.ptypes_scene, whose two cones are clipped at
    z = -0.5, K1 and the plain version differ only on primary rays whose
    plain winner is a cone hit outside its padded cull box, where K1
    finds something farther or nothing; on every other lane they agree
    bit for bit.  Once the box covers the cone this test fails: then hold
    K1 to its plain version on every lane here."""
    from glome_tpu_torch.compile import group_device_params
    from glome_tpu_torch.scenes.phasescene import ptypes_scene
    solid, lights, cam = ptypes_scene()
    compiled = T.compile_scene(solid, lights)
    plan = MK.get_plan(compiled)
    arrays = T.to_torch(compiled.arrays(), dev)
    cfg = T.RenderConfig.tuned(xres=64, yres=48)
    ys, xs = np.mgrid[0:48, 0:64]
    o, d = T.Renderer(None, cam, cfg).rays_for_pixels(
        xs.reshape(-1).astype(np.float32), ys.reshape(-1).astype(np.float32),
        dev)
    n = o.shape[0]
    rays = MK._ray_table(o, d, torch.full((n,), T.INFINITY, device=dev),
                         torch.zeros(n, dtype=torch.int32, device=dev))
    tabs = MK.pack_tables(plan, compiled, arrays)
    tk, wk, ak = (x.cpu().numpy() for x in MK.mega_select(tabs, rays, False))
    tp, wp, ap = (x.cpu().numpy()
                  for x in MK.mega_select_plain(tabs, rays, False))
    # the padded cull box of every cone prim, by global prim
    boxes, clip1 = {}, []
    for (si, gi), (base, size) in plan.prim_base.items():
        g = compiled.scenes[si].groups[gi]
        if g.ptype != "cone":
            continue
        clip1.append(float(np.min(g.params["clip1"])))
        ga = group_device_params(g, arrays["scenes"][si][gi])
        box = MK.padded_prim_aabb(
            "cone", {k: v for k, v in ga.items()
                     if k not in ("m_inv", "m_fwd")}, ga.get("m_fwd"))
        for k in range(size):
            boxes[base + k] = box[k].cpu().numpy()
    assert min(clip1) < 0
    rays_np = rays.cpu().numpy()
    differ = np.flatnonzero((tk != tp) | (wk != wp) | (ak != ap))
    report = []
    for i in differ:
        prim = int(wp[i]) // 2
        box = boxes.get(prim) if wp[i] >= 0 else None
        hit = rays_np[0:3, i] + rays_np[3:6, i] * tp[i]
        outside = box is not None and bool(
            (hit < box[:3]).any() or (hit > box[3:]).any())
        report.append((int(i), int(wk[i]), float(tk[i]), int(wp[i]),
                       float(tp[i]), outside))
    assert report, "K1 now equals its plain version here: see the docstring"
    assert all(out and t_k > t_p for _i, _wk, t_k, _wp, t_p, out in report), \
        report


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
    # a table or output 4 bytes off a 16-byte boundary: the bulk copies
    # and float4 stores need 16, so the C entries refuse the launch and
    # the wrappers raise
    buf = torch.zeros(1 + pf.numel(), device=dev)
    with pytest.raises(RuntimeError):
        micro_prims.dense_fori(rays, buf[1:].copy_(pf))
    lane = torch.zeros(1 + inp["pf_lane"].numel(), device=dev)
    with pytest.raises(RuntimeError):
        micro_prims.mxu128(rays, lane[1:].view(4, 8, 128))
    nbuf = torch.zeros(1 + kin["nf"].numel(), device=dev)
    with pytest.raises(RuntimeError):
        micro_kwide.WALKS[4](kin["rays"], nbuf[1:].copy_(kin["nf"]))
    obuf = torch.empty(1 + 2 * 1024, device=dev)
    err = lib.glome_micro_vread(rp, 2, 16, obuf.data_ptr() + 4, None)
    with pytest.raises(RuntimeError):
        kernels.check_launch(lib, err, "glome_micro_vread")


def _spheres(p):
    """A row-major (4p,) sphere table drawn as micro_prims.make_inputs
    draws the tool's (r2 = 0.05)."""
    rng = np.random.default_rng(p)
    pf = rng.normal(size=(4 * p,)).astype(np.float32)
    pf[3::4] = 0.05
    return pf


@pytest.mark.parametrize("p", [1023, 3100])
@pytest.mark.parametrize("name", ["a_vote_while", "b_dense_fori", "c_gate8",
                                  "c_gate16", "c_gate32", "d_bits168"])
def test_micro_sphere_kernels_at_other_sizes(dev, name, p):
    """a-d at T = 8 on tables of other sizes, bit-equal to their plain
    versions: P = 1023 (the tool's first 1023 spheres: a's wrap, b's
    remainder after its unrolled passes, c's partial last leaf) and P =
    3100 (a staged table above 48 KB of shared memory, which the launch
    must opt in to)."""
    from glome_tpu_torch.tools import micro_prims
    v = next(v for v in micro_prims.VARIANTS if v.name == name)
    rays = micro_prims.device_inputs(dev, 8)["rays"]
    pf = torch.as_tensor(micro_prims.make_inputs(1)[1][:4 * p] if p < 1024
                         else _spheres(p), device=dev)
    before = v.kernel.launches
    k = v.kernel(rays, pf)
    q = v.plain(rays, pf)
    torch.cuda.synchronize()
    assert v.kernel.launches == before + 1
    assert torch.equal(k, q)


@pytest.mark.parametrize("m", [1022, 512])
@pytest.mark.parametrize("K", [1, 4, 16])
def test_micro_walk_even_heap(dev, K, m):
    """The walk on an even heap (the boxes a whole number of 16-byte
    blocks: the bulk copy alone, no 8-byte tail) is bit-equal to its
    plain version."""
    from glome_tpu_torch.tools import micro_kwide
    kin = micro_kwide.device_inputs(dev, 8)
    nf = kin["nf"][:6 * m]
    walk = micro_kwide.WALKS[K]
    before = walk.launches
    k = walk(kin["rays"], nf)
    q = micro_kwide.walk_plain(kin["rays"], nf, K)
    torch.cuda.synchronize()
    assert walk.launches == before + 1
    assert torch.equal(k, q)


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
    # an intersect and a shadow batch per level: nothing in the scene
    # reflects, so the deeper levels' queues are empty, and the compiled
    # frame runs them as batches of dead lanes
    assert MK.mega_select.launches - n0 == 6
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
    """One TestScene 720x480 eager frame through the frame-profiling
    tool's report: 6 K1 launches (one per intersect and shadow batch of
    each of the three levels) by the wrapper's own counter, no plain
    call; the frame's spans, whose self times with the outside row sum
    to the profiled wall, each busy on the device within the profiler's
    busy time, wavefront.trace busiest among the frame's children."""
    from glome_tpu_torch.scenes import test_scene
    from glome_tpu_torch.tools import profile_frame as PF
    solid, lights, cam = test_scene()
    compiled = T.compile_scene(solid, lights)
    arrays = T.to_torch(compiled.arrays(), dev)
    w = PF.frame_workload("frame", compiled, arrays, cam,
                          T.RenderConfig.tuned(), "mega")
    before = MK.mega_select.launches
    rep = PF.profile(w, dev)
    # the warm-up, 3 timed frames and the profiled one
    assert MK.mega_select.launches - before == 5 * 6
    assert rep.counts["K1"] == 6 and rep.counts["K1 plain"] == 0
    assert rep.frame_ms > 0 and rep.busy_ms > 0 and rep.kernel_ms["K1"] > 0
    assert sum(r.self_ns for r in rep.spans) == rep.wall_ns
    assert all(0 <= r.busy_ms <= rep.busy_ms + 1e-6 for r in rep.spans)
    children = ("render.ray_setup", "wavefront.trace", "render.scatter")
    assert max(children, key=lambda n: rep.row(n).busy_ms) \
        == "wavefront.trace"


# --- the compiled frame (graphs.py) ------------------------------------------

def _compiled_case(dev, xres=180, yres=120):
    from glome_tpu_torch.scenes import test_scene
    solid, lights, cam = test_scene()
    compiled = T.compile_scene(solid, lights)
    cfg = T.RenderConfig.tuned(xres=xres, yres=yres)
    tracer = T.WavefrontTracer(compiled, cfg)
    ys, xs = np.mgrid[0:yres, 0:xres]
    o, d = T.Renderer(tracer, cam, cfg).rays_for_pixels(
        xs.reshape(-1).astype(np.float32), ys.reshape(-1).astype(np.float32),
        dev)
    return tracer, T.to_torch(compiled.arrays(), dev), o, d


def _frames_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))


def _sphere_centres(arrays):
    return next(ga for ga in arrays["scenes"][0] if "center" in ga)


def _segments(tracer):
    """The segments of a trace: the select tables' build, and each
    level's down and up passes."""
    return 1 + 2 * tracer.config.maxdepth


def test_compiled_frame_equals_eager_frame(dev):
    """The TestScene frame at 180x120 depth 3: the capture frame and the
    replays equal the eager frame on every lane; a replay captures
    nothing, reads the host once per level but the deepest, and counts
    the K1 launches the eager frame makes."""
    from glome_tpu_torch.graphs import COMPILED, EAGER
    tracer, arrays, o, d = _compiled_case(dev)
    n0, p0 = MK.mega_select.launches, MK.mega_select_plain.calls
    first = tracer.trace(arrays, o, d, frame=COMPILED)
    assert tracer.last_frame["captures"] == _segments(tracer)
    # the capture frame launches each kernel once (the warm-up), no plain
    assert MK.mega_select.launches - n0 == 2 * tracer.config.maxdepth
    assert MK.mega_select_plain.calls == p0
    n0 = MK.mega_select.launches
    replay = tracer.trace(arrays, o, d, frame=COMPILED)
    k_replay = MK.mega_select.launches - n0
    stats = dict(tracer.last_frame)
    n0 = MK.mega_select.launches
    eager = tracer.trace(arrays, o, d, frame=EAGER)
    k_eager = MK.mega_select.launches - n0
    torch.cuda.synchronize()
    assert stats["captures"] == 0
    assert stats["replays"] == _segments(tracer)
    assert stats["host_reads"] == tracer.config.maxdepth - 1
    assert k_replay == k_eager == 2 * tracer.config.maxdepth
    assert _frames_equal(first, eager) and _frames_equal(replay, eager)
    assert tracer.graphs.pool_bytes() > 0


def test_compiled_frame_reads_an_inplace_edit(dev):
    """A sphere's centre moved in place (an optimizer step) shows in the
    next replay exactly as in the eager frame, with nothing captured."""
    from glome_tpu_torch.graphs import EAGER
    tracer, arrays, o, d = _compiled_case(dev)
    before = tracer.trace(arrays, o, d)
    _sphere_centres(arrays)["center"].add_(
        torch.tensor([0.3, 0.1, 0.0], device=dev))
    got = tracer.trace(arrays, o, d)
    assert tracer.last_frame["captures"] == 0
    want = tracer.trace(arrays, o, d, frame=EAGER)
    assert _frames_equal(got, want)
    assert not torch.equal(got.color, before.color)


def test_compiled_frame_captures_a_replaced_tensor(dev):
    """A scene tensor replaced by a new one is a new scene: the next
    frame drops the old scene's segments (with a warning), captures anew
    and equals the eager frame of the new tensors."""
    from glome_tpu_torch.graphs import EAGER
    tracer, arrays, o, d = _compiled_case(dev)
    tracer.trace(arrays, o, d)
    ga = _sphere_centres(arrays)
    ga["center"] = ga["center"] + torch.tensor([0.0, 0.2, 0.0], device=dev)
    with pytest.warns(RuntimeWarning, match="segments dropped"):
        got = tracer.trace(arrays, o, d)
    assert tracer.graphs.scene_changes == 1
    assert len(tracer.graphs) == _segments(tracer)
    assert tracer.last_frame["captures"] == _segments(tracer)
    assert tracer.last_frame["replays"] == 0
    want = tracer.trace(arrays, o, d, frame=EAGER)
    assert _frames_equal(got, want)
    again = tracer.trace(arrays, o, d)
    assert tracer.last_frame["captures"] == 0
    assert _frames_equal(again, want)


# --- the fused finalize (csrc/finalize_hit.cu) -------------------------------

def _hit_diff(a, b):
    """{field: lanes that differ} of two Hits, bit for bit (floats
    compared as their int32 bits), or a note where a field's shape,
    dtype or strides differ."""
    out = {}
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if (x.shape, x.dtype, x.stride()) != (y.shape, y.dtype, y.stride()):
            out[name] = (f"{tuple(x.shape)} {x.dtype} {x.stride()} against "
                         f"{tuple(y.shape)} {y.dtype} {y.stride()}")
            continue
        if not x.numel():
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        ne = (x != y).reshape(x.shape[0], -1).any(dim=1)
        if bool(ne.any()):
            lane = int(ne.nonzero()[0])
            out[name] = (f"{int(ne.sum())} lanes, first {lane}: "
                         f"{getattr(a, name)[lane].tolist()} against "
                         f"{getattr(b, name)[lane].tolist()}")
    return out


class _FusedAgainstTorch:
    """Runs every fused finalize call outside a capture against
    _finalize_torch on the same inputs; records (lanes, diff, hits,
    combos hit, flipped lanes, retextured lanes, object rays moved)."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = MK._finalize_fused

        def both(compiled, plan, arrays, o, d, t, wid, aux, want_meta):
            h = real(compiled, plan, arrays, o, d, t, wid, aux, want_meta)
            if torch.cuda.is_current_stream_capturing():
                return h
            ref = MK._finalize_torch(compiled, plan, arrays, o, d, t, wid,
                                     aux, want_meta)
            prim = (wid.long() // 2).clamp(min=0).cpu().numpy()
            hit = (wid >= 0).cpu().numpy()
            neg = hit & plan.neg_all[prim]
            retex = (neg & plan.atex_all[prim] & (aux.cpu().numpy() >= 0)
                     if aux is not None and want_meta else neg & False)
            self.calls.append(dict(
                lanes=o.shape[0], diff=_hit_diff(h, ref), hits=int(hit.sum()),
                combos=set(plan.cid_all[prim[hit]].tolist()),
                flipped=int(neg.sum()), retextured=int(retex.sum()),
                warped=int((h.obj_o != o).any(dim=1).sum())))
            return h
        monkeypatch.setattr(MK, "_finalize_fused", both)

    def check(self, plan, n_calls):
        assert len(self.calls) == n_calls
        bad = [c for c in self.calls if c["diff"]]
        assert not bad, bad[:3]
        assert (set().union(*(c["combos"] for c in self.calls))
                == set(range(len(plan.combos))))


def _torch_finalize_only(monkeypatch):
    """The parent's finalize: every call takes the torch ops."""
    monkeypatch.setattr(MK, "_finalize_fused", MK._finalize_torch)


def _render_all(view, arrays, n=2):
    out = [view.render(arrays, 0.25) for _ in range(n)]
    torch.cuda.synchronize()
    return out


def _images_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_fused_finalize_on_testscene_levels(dev, monkeypatch):
    """TestScene at 720x480 depth 3: the fused Hit equals the torch
    finalize's bit for bit on every lane of every level of the compiled
    frame's capture frame (its warm-ups run eagerly on the level's own
    inputs) and of the eager frame, over all 6 combos, the CSG flips,
    the difference-B retexture, the portal's object rays and the dead
    lanes; a replay equals them too."""
    from glome_tpu_torch.graphs import EAGER
    from glome_tpu_torch.scenes import test_scene
    solid, lights, cam = test_scene()
    compiled = T.compile_scene(solid, lights)
    plan = MK.get_plan(compiled)
    arrays = T.to_torch(compiled.arrays(), dev)
    cfg = T.RenderConfig.tuned()
    rec = _FusedAgainstTorch(monkeypatch)
    compiled_frames = _render_all(
        T.Renderer(T.WavefrontTracer(compiled, cfg), cam, cfg), arrays)
    eager = _render_all(T.Renderer(T.WavefrontTracer(
        compiled, cfg, frame=EAGER), cam, cfg), arrays, 1)[0]
    rec.check(plan, 2 * cfg.maxdepth)
    assert all(c["hits"] for c in rec.calls)
    assert rec.calls[0]["flipped"]
    assert sum(c["retextured"] for c in rec.calls) > 0
    assert sum(c["warped"] for c in rec.calls) > 0
    assert all(c["lanes"] > c["hits"] for c in rec.calls)
    assert _images_equal(compiled_frames[0], eager)
    assert _images_equal(compiled_frames[1], eager)


def test_fused_finalize_on_spd_balls(dev, monkeypatch):
    """SPD balls at size 5 (66,430 spheres through K2, the floor's two
    triangles through K1) at its 512x512: the fused Hit equals the torch
    finalize's on every level, and the frame the parent's."""
    from glome_tpu_torch.graphs import EAGER
    from glome_tpu_torch.scenes.spd_balls import balls
    solid, lights, cam = balls(5)
    compiled = T.compile_scene(solid, lights)
    plan = MK.get_plan(compiled)
    arrays = T.to_torch(compiled.arrays(), dev)
    cfg = T.RenderConfig.tuned(xres=512, yres=512)
    rec = _FusedAgainstTorch(monkeypatch)
    got = _render_all(T.Renderer(T.WavefrontTracer(compiled, cfg), cam, cfg),
                      arrays, 1)[0]
    eager = _render_all(T.Renderer(T.WavefrontTracer(
        compiled, cfg, frame=EAGER), cam, cfg), arrays, 1)[0]
    rec.check(plan, 2 * cfg.maxdepth)
    _torch_finalize_only(monkeypatch)
    parent = _render_all(T.Renderer(T.WavefrontTracer(compiled, cfg), cam,
                                    cfg), arrays, 1)[0]
    assert _images_equal(got, eager) and _images_equal(got, parent)


@pytest.mark.parametrize("layout", ["table", "rows"])
def test_fused_finalize_on_every_ptype(dev, monkeypatch, layout):
    """phasescene.ptypes_scene (every FIELDS ptype, plain and under a
    transform, a shared-vertex mesh, a retexture difference): the fused
    Hit equals the torch finalize's on the rows of a ray table (the
    tracer's) and on Renderer.rays_for_pixels' own rays (mega_intersect's:
    an expanded origin, which the kernel reads as a contiguous copy)."""
    from glome_tpu_torch.scenes.phasescene import ptypes_scene
    solid, lights, cam = ptypes_scene()
    compiled = T.compile_scene(solid, lights)
    plan = MK.get_plan(compiled)
    arrays = T.to_torch(compiled.arrays(), dev)
    cfg = T.RenderConfig.tuned(xres=320, yres=240)
    rec = _FusedAgainstTorch(monkeypatch)
    view = T.Renderer(T.WavefrontTracer(compiled, cfg), cam, cfg)
    if layout == "table":
        _render_all(view, arrays, 1)
        rec.check(plan, cfg.maxdepth)
    else:
        ys, xs = np.mgrid[0:240, 0:320]
        o, d = view.rays_for_pixels(xs.reshape(-1).astype(np.float32),
                                    ys.reshape(-1).astype(np.float32), dev)
        assert o.stride(0) == 0
        MK.mega_intersect(compiled, arrays, o, d)
        rec.check(plan, 1)
    assert sum(c["flipped"] for c in rec.calls) > 0
    assert sum(c["retextured"] for c in rec.calls) > 0


def test_fused_finalize_frames_equal_the_parents(dev, monkeypatch):
    """TestScene at 720x480: the compiled and eager frames with the fused
    finalize, still and AA, equal the frames of the torch finalize (the
    parent's path) bit for bit."""
    from glome_tpu_torch.graphs import EAGER
    from glome_tpu_torch.scenes import test_scene
    solid, lights, cam = test_scene()
    compiled = T.compile_scene(solid, lights)
    arrays = T.to_torch(compiled.arrays(), dev)
    cfg = T.RenderConfig.tuned()

    def frames():
        out = []
        for frame in (None, EAGER):
            tracer = (T.WavefrontTracer(compiled, cfg) if frame is None
                      else T.WavefrontTracer(compiled, cfg, frame=frame))
            out.append(_render_all(T.Renderer(tracer, cam, cfg), arrays,
                                   1)[0])
            aa = T.AARenderer(tracer, cam, cfg)
            out.append(aa.render(arrays))
        torch.cuda.synchronize()
        return out
    fused = frames()
    _torch_finalize_only(monkeypatch)
    parent = frames()
    for got, want in zip(fused, parent):
        assert _images_equal(got, want)


def test_fused_finalize_counts_every_call(dev):
    """The frame records' counters: 3 fused finalize calls a still frame
    and 15 an AA frame, replays included, and no torch call."""
    from glome_tpu_torch import telemetry as TM
    from glome_tpu_torch.scenes import test_scene
    solid, lights, cam = test_scene()
    compiled = T.compile_scene(solid, lights)
    arrays = T.to_torch(compiled.arrays(), dev)
    cfg = T.RenderConfig.tuned()
    tracer = T.WavefrontTracer(compiled, cfg)
    view, aa = T.Renderer(tracer, cam, cfg), T.AARenderer(tracer, cam, cfg)
    n0 = len(TM.frames())
    for _ in range(3):
        view.render(arrays, 0.5)
    for _ in range(3):
        aa.render(arrays)
    torch.cuda.synchronize()
    recs = TM.frames()[n0:]
    assert tracer.last_frame["captures"] == 0
    assert [f.counts["megakernel.finalize_fused"] for f in recs] == (
        [cfg.maxdepth] * 3 + [5 * cfg.maxdepth] * 3)
    assert all(f.counts["megakernel.finalize_torch"] == 0 for f in recs)


def test_finalize_takes_torch_ops_where_the_kernel_may_not(dev):
    """On CUDA tensors the torch ops still serve select=PLAIN and a call
    that needs a gradient (a scene tensor that requires grad in grad
    mode); the gradient reaches that tensor as through _finalize_torch.
    Any other call launches the kernel, on rays_for_pixels' expanded
    origin too."""
    from glome_tpu_torch.scenes.phasescene import ptypes_scene
    solid, lights, cam = ptypes_scene()
    compiled = T.compile_scene(solid, lights)
    arrays = T.to_torch(compiled.arrays(), dev)
    cfg = T.RenderConfig.tuned(xres=64, yres=48)
    view = T.Renderer(T.WavefrontTracer(compiled, cfg), cam, cfg)
    ys, xs = np.mgrid[0:48, 0:64]
    o, d = view.rays_for_pixels(xs.reshape(-1).astype(np.float32),
                                ys.reshape(-1).astype(np.float32), dev)
    f0, t0 = MK.finalize.fused_calls, MK.finalize.torch_calls
    with torch.no_grad():
        MK.mega_intersect(compiled, arrays, o, d, select=MK.PLAIN)
        MK.mega_intersect(compiled, arrays, o, d)
    assert (MK.finalize.fused_calls - f0, MK.finalize.torch_calls - t0) == (
        1, 1)
    centre = _sphere_centres(arrays)["center"]
    centre.requires_grad_(True)
    h = MK.mega_intersect(compiled, arrays, o, d)
    assert MK.finalize.torch_calls - t0 == 2
    (g,) = torch.autograd.grad(h.pos.sum() + h.norm.sum(), centre)
    assert bool(g.abs().sum() > 0)


def test_fused_finalize_refuses_rows_it_cannot_read(dev):
    """A group whose rows are not float32 in place stops the kernels'
    finalize with an error that names it; no other ops stand in."""
    from glome_tpu_torch.scenes.phasescene import ptypes_scene
    solid, lights, cam = ptypes_scene()
    compiled = T.compile_scene(solid, lights)
    plan = MK.get_plan(compiled)
    arrays = T.to_torch(compiled.arrays(), dev)
    cfg = T.RenderConfig.tuned(xres=32, yres=24)
    view = T.Renderer(None, cam, cfg)
    ys, xs = np.mgrid[0:24, 0:32]
    o, d = view.rays_for_pixels(xs.reshape(-1).astype(np.float32),
                                ys.reshape(-1).astype(np.float32), dev)
    n = o.shape[0]
    with torch.no_grad():
        t, wid, aux = MK._select_all(
            compiled, plan, arrays,
            MK._ray_table(o, d, torch.full((n,), T.INFINITY, device=dev),
                          torch.zeros(n, dtype=torch.int32, device=dev)),
            False, MK.KERNELS)
        scenes = [[dict(g) for g in sc] for sc in arrays["scenes"]]
        ga = _sphere_centres({**arrays, "scenes": scenes})
        ga["center"] = ga["center"].double()
        f0, t0 = MK.finalize.fused_calls, MK.finalize.torch_calls
        with pytest.raises(ValueError, match="float32"):
            MK.finalize(compiled, plan, {**arrays, "scenes": scenes}, o, d,
                        t, wid, aux)
    assert (MK.finalize.fused_calls, MK.finalize.torch_calls) == (f0, t0)
