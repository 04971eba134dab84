"""megakernel.finalize's dispatch on the CPU.

finalize runs its fused kernel (csrc/finalize_hit.cu) on CUDA tensors
through the kernels when no gradient is needed, and the differentiable
torch ops (_finalize_torch) everywhere else.  Here, without a card:

- the torch ops serve CPU tensors, select=PLAIN and a call that needs a
  gradient, each counted in finalize.torch_calls and, in a frame, in the
  frame record's megakernel.finalize_torch; the fused wrapper is never
  entered, and the gradient reaches the scene tensor as through
  _finalize_torch itself;
- the layouts the fused Hit copies (_hit_layout) are those of the torch
  finalize's outputs on TestScene, SPD balls and phasescene.ptypes_scene,
  on the rows of a ray table and on contiguous rays; _fused_layout's
  three classes of ray tensor;
- the group descriptor (_finalize_groups): each group's first prim,
  fields, transform and mesh index, pointing at the scene tensors in
  place, made once per set of tensors, and an error where a group's
  rows are not float32;
- the fused wrapper on zero lanes: the torch Hit's shapes and dtypes,
  rays of another dtype read as float32, and no launch counted.

The fused kernel against the torch ops, bit for bit, is in
test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import glome_tpu_torch as T
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch import telemetry as TM
from glome_tpu_torch.compile import _mesh_index
from glome_tpu_torch.graphs import COMPILED, EAGER
from glome_tpu_torch.scenes import test_scene as build_testscene
from glome_tpu_torch.scenes.phasescene import ptypes_scene
from glome_tpu_torch.scenes.spd_balls import balls


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_fused(monkeypatch):
    """Fails a test that enters the fused finalize's wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("the fused finalize was entered")
    monkeypatch.setattr(MK, "_finalize_fused", refuse)


def _case(make, *args):
    solid, lights, cam = make(*args)
    compiled = T.compile_scene(solid, lights)
    return compiled, T.to_torch(compiled.arrays(), "cpu"), cam


@pytest.fixture(scope="module")
def ptypes():
    return _case(ptypes_scene)


def _rays(cam, xres=48, yres=32):
    cfg = T.RenderConfig.tuned(xres=xres, yres=yres)
    view = T.Renderer(None, cam, cfg)
    ys, xs = np.mgrid[0:yres, 0:xres]
    return view.rays_for_pixels(xs.reshape(-1).astype(np.float32),
                                ys.reshape(-1).astype(np.float32), "cpu")


def _table(o, d):
    n = o.shape[0]
    return torch.cat([o.t(), d.t(), torch.full((1, n), T.INFINITY),
                      torch.zeros((1, n))]).contiguous()


@pytest.mark.parametrize("frame", [COMPILED, EAGER])
def test_cpu_frames_take_the_torch_finalize(ptypes, no_fused, frame):
    """A CPU frame's intersect batches run the torch ops: one
    finalize_torch a level in the frame record, no fused call."""
    compiled, arrays, cam = ptypes
    cfg = T.RenderConfig.tuned(xres=48, yres=32)
    view = T.Renderer(T.WavefrontTracer(compiled, cfg, frame=frame), cam,
                      cfg)
    f0 = MK.finalize.fused_calls
    with torch.no_grad():
        view.render(arrays)
    rec = TM.frames()[-1]
    assert rec.counts["megakernel.finalize_torch"] == cfg.maxdepth
    assert rec.counts["megakernel.finalize_fused"] == 0
    assert MK.finalize.fused_calls == f0


@pytest.mark.parametrize("select", [MK.KERNELS, MK.PLAIN])
def test_cpu_and_plain_calls_take_the_torch_finalize(ptypes, no_fused,
                                                     select):
    """mega_intersect on CPU tensors, through the kernels' switch or the
    plain versions', counts one torch call and equals _finalize_torch on
    the same winners."""
    compiled, arrays, cam = ptypes
    o, d = _rays(cam)
    t0 = MK.finalize.torch_calls
    with torch.no_grad():
        h = MK.mega_intersect(compiled, arrays, o, d, select=select)
        plan = MK.get_plan(compiled)
        t, wid, aux = MK._select_all(
            compiled, plan, arrays,
            MK._ray_table(o, d, torch.full((o.shape[0],), T.INFINITY),
                          torch.zeros(o.shape[0], dtype=torch.int32)),
            False, select)
        want = MK._finalize_torch(compiled, plan, arrays, o, d, t, wid, aux)
    assert MK.finalize.torch_calls - t0 == 1
    assert 0 < int(h.hit.sum()) < o.shape[0]
    assert all(torch.equal(x, y) for x, y in zip(h, want))


def test_a_gradient_takes_the_torch_finalize(ptypes, no_fused):
    """A scene tensor that requires grad, in grad mode: the torch ops
    run, counted, and the gradient reaches the tensor as it does through
    _finalize_torch called directly."""
    compiled, arrays, cam = ptypes
    o, d = _rays(cam)
    plan = MK.get_plan(compiled)
    ga = next(g for g in arrays["scenes"][0] if "center" in g)
    centre = ga["center"]
    centre.requires_grad_(True)
    try:
        t0 = MK.finalize.torch_calls
        table = _table(o, d)
        h = MK.mega_intersect_table(compiled, arrays, table)
        assert MK.finalize.torch_calls - t0 == 1
        (g,) = torch.autograd.grad(h.pos.sum() + h.norm.sum(), centre)
        t, wid, aux = MK._select_all(compiled, plan, arrays, table, False,
                                     MK.KERNELS)
        ref = MK._finalize_torch(compiled, plan, arrays, table[0:3].t(),
                                 table[3:6].t(), t, wid, aux)
        (g_ref,) = torch.autograd.grad(ref.pos.sum() + ref.norm.sum(),
                                       centre)
    finally:
        centre.requires_grad_(False)
    assert bool(g.abs().sum() > 0)
    assert torch.equal(g, g_ref)


def _sphere_last():
    """A plane and a sphere: the last combo an untransformed sphere's."""
    mat = T.t_uniform(T.Surface(color=(1, 0, 0), ambient=0.2, kd=0.8))
    solid = T.group([T.tex(T.plane((0, -1, 0), (0, 1, 0)), mat),
                     T.tex(T.sphere((0, 0, 0), 1.0), mat)])
    return (solid, (T.light((0, 5, -5), (50, 50, 50)),),
            T.camera((0, 0.5, -4), (0, 0, 0), (0, 1, 0), 60))


@pytest.mark.parametrize("scene", ["testscene", "balls", "ptypes",
                                   "sphere_last"])
@pytest.mark.parametrize("rows", [False, True])
def test_hit_layout_is_the_torch_finalizes(scene, rows):
    """The fused Hit's pos and norm layouts, and whether obj_o / obj_d
    are the rays themselves, are those of the torch finalize's Hit: on a
    ray table's rows (the tracer's batches) and on contiguous rays."""
    make, args = {"testscene": (build_testscene, ()),
                  "balls": (balls, (2,)), "ptypes": (ptypes_scene, ()),
                  "sphere_last": (_sphere_last, ())}[scene]
    compiled, arrays, cam = _case(make, *args)
    plan = MK.get_plan(compiled)
    o, d = _rays(cam, 32, 16)
    if not rows:
        table = _table(o, d)
        o, d = table[0:3].t(), table[3:6].t()
    else:
        o, d = o.contiguous(), d.contiguous()
    assert MK._fused_layout(o) is rows and MK._fused_layout(d) is rows
    with torch.no_grad():
        h = MK.mega_intersect(compiled, arrays, o, d)
    pos_row, norm_row = MK._hit_layout(plan, rows)
    for x, row in ((h.pos, pos_row), (h.norm, norm_row)):
        assert x.stride() == ((3, 1) if row else (1, x.shape[0]))
    warp = any(tr and w for _p, tr, _g, w in plan.combos)
    assert (h.obj_o is o and h.obj_d is d) == (not warp)
    if warp:
        assert h.obj_o.stride() == h.obj_d.stride() == (3, 1)
    if scene == "sphere_last":
        # an untransformed sphere's normals last: norm follows the rays
        assert plan.combos[-1][:2] == ("sphere", False)
        assert norm_row is rows


def test_fused_layout_classes():
    table = torch.zeros((8, 5))
    assert MK._fused_layout(table[0:3].t()) is False
    assert MK._fused_layout(torch.zeros((5, 3))) is True
    assert MK._fused_layout(torch.zeros(3).expand(5, 3)) is None
    assert MK._fused_layout(torch.zeros((5, 3), dtype=torch.float64)) is None
    assert MK._fused_layout(torch.zeros((5, 6))[:, ::2]) is None


def test_finalize_groups_point_at_the_scene_tensors(ptypes):
    """One descriptor row a group with prims: its first global prim,
    field count, ptype code, transform and warp flags, m_inv and each
    field's rows in place (a mesh's shared vertex or normal table with
    its int32 index and column); a ValueError where a group's rows are
    float64."""
    compiled, arrays, _cam = ptypes
    plan = MK.get_plan(compiled)
    desc = MK._finalize_groups(compiled, plan, arrays, torch.device("cpu"))
    assert desc.dtype == torch.int64 and desc.shape[1] == MK.FIN_GW
    groups = [(gi, g) for gi, g in enumerate(compiled.scenes[0].groups)
              if g.size]
    assert desc.shape[0] == len(groups)
    meshes = 0
    for row, (gi, g) in zip(desc.tolist(), groups):
        ga = arrays["scenes"][0][gi]
        fields = MK.FIELDS[g.ptype]
        assert row[:5] == [plan.prim_base[(0, gi)][0], len(fields),
                           MK.PTYPE_CODE[g.ptype], int(g.m_inv is not None),
                           0]
        assert row[5] == (ga["m_inv"].data_ptr() if g.m_inv is not None
                          else 0)
        for k, (name, width) in enumerate(fields):
            ptr, index, col, wd = row[6 + 4 * k:10 + 4 * k]
            if g.mesh_src is None:
                assert (ptr, index, col, wd) == (ga[name].data_ptr(), 0, 0,
                                                 width)
                continue
            meshes += 1
            normals = name.startswith("n")
            ix = _mesh_index(g, "tri_n" if normals else "tri",
                             torch.device("cpu"))
            assert ix.dtype == torch.int32
            assert (ptr, index, col, wd) == (
                ga["norms" if normals else "verts"].data_ptr(),
                ix.data_ptr(), int(name[1]) - 1, 3)
        assert not any(row[6 + 4 * len(fields):])
    assert meshes == 9    # p1..p3 of the triangle rows, p1..n3 of the rest
    ga = next(ga for ga in arrays["scenes"][0] if "center" in ga)
    arrays64 = {**arrays, "scenes": [[dict(g) for g in arrays["scenes"][0]]]}
    next(g for g in arrays64["scenes"][0] if "center" in g)["center"] = (
        ga["center"].double())
    with pytest.raises(ValueError, match="float32"):
        MK._finalize_groups(compiled, plan, arrays64, torch.device("cpu"))


def test_finalize_groups_are_made_once_per_set_of_tensors(ptypes):
    """The descriptor is kept on the plan: the same tensor for the same
    scene tensors, a new one pointing at a replaced tensor, and the first
    kept for a frame that still replays it."""
    compiled, arrays, _cam = ptypes
    plan = MK.get_plan(compiled)
    cpu = torch.device("cpu")
    first = MK._finalize_groups(compiled, plan, arrays, cpu)
    assert MK._finalize_groups(compiled, plan, arrays, cpu) is first
    scenes = [[dict(g) for g in sc] for sc in arrays["scenes"]]
    ga = next(g for g in scenes[0] if "center" in g)
    ga["center"] = ga["center"].clone()
    other = MK._finalize_groups(compiled, plan, {**arrays, "scenes": scenes},
                                cpu)
    assert other is not first
    assert ga["center"].data_ptr() in other.flatten().tolist()
    assert ga["center"].data_ptr() not in first.flatten().tolist()
    assert MK._finalize_groups(compiled, plan, arrays, cpu) is first


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_finalize_on_no_lanes(ptypes, dtype):
    """_finalize_fused on zero lanes launches nothing and counts nothing,
    and its Hit has the torch finalize's shapes and dtypes; float64 rays
    are read as float32 rows, as the select kernels read them, and are
    the Hit's object rays where no combo warps."""
    compiled, arrays, _cam = ptypes
    plan = MK.get_plan(compiled)
    o = torch.zeros((0, 3), dtype=dtype)
    t = torch.zeros(0)
    wid = torch.zeros(0, dtype=torch.int32)
    f0 = MK.finalize.fused_calls
    h = MK._finalize_fused(compiled, plan, arrays, o, o.clone(), t, wid,
                           wid.clone(), True)
    want = MK._finalize_torch(compiled, plan, arrays,
                              o.to(torch.float32), o.to(torch.float32), t,
                              wid, wid.clone())
    assert MK.finalize.fused_calls == f0
    assert h.obj_o is o
    for x, y in zip(h[:4] + h[6:], want[:4] + want[6:]):
        assert (x.shape, x.dtype) == (y.shape, y.dtype)
