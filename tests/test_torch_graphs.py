"""The compiled frame on the CPU: WavefrontTracer(frame=COMPILED), whose
static-width levels (trace_wavefront.bucket, dead lanes, compaction by
device cumsum + scatter, one host read per level) run eagerly on CPU
tensors, and which graphs.py captures as CUDA graphs on a card.

- The static-width levels against the eager frame (exact-size queues),
  bit for bit: max |diff| 0 on colour, t, tag stacks and serials, on the
  90x60 TestScene at depth 3 (reflection, refraction, the portal), the
  all-phase-kinds scene (phasescene.phase_kinds_scene) and a
  1,500-triangle mesh routed through K2 and through K3 with
  self-shadowing.  The static shadow batch and child queue hold the
  eager ones as their live prefix, dead lanes after.
- Against glome_tpu: the mesh frames within test_torch_trace.py's
  tolerances (t rtol 5e-5 / atol 1e-4, colours atol 5e-5, serials
  equal); the TestScene frame within test_golden.py:129-131's drift
  canaries of glome_tpu's CPU golden, as test_torch_render.py holds the
  eager frame (the port's frames differ from glome_tpu's wavefront frame
  beyond those tolerances on portal and glass edge lanes).
- The widths: level 0 at whole 128-lane rows of the caller's rays; the
  bucket ladder of the deeper levels covers the count, is a multiple of
  128 and pads a level of more than 512 rays by less than 25%.
- The refusals: a gradient (grad mode and a tensor that requires grad),
  route=GROUPS, and the recursive Tracer's compiled frame; the frame
  each tracer runs by default and per call.
- The capture key: unchanged by an in-place edit of a scene tensor,
  changed when the tensor is replaced; an in-place edit shows in the
  next compiled frame exactly as in the eager frame (a sphere's centre;
  boxes and cones, whose rows K1's group bounds and padded prim boxes
  read); a new scene key drops the old scene's segments, with a
  warning; the counters a segment carries are the kernels' launches,
  the plain versions' calls and the select tables' builds.
- The select tables (megakernel.select_tables): a compiled trace builds
  them once (the frame record's megakernel.table_packs 1; K2's and K3's
  tables once on the mesh), the eager frame once a batch, and both give
  the same bits.

The card-only cases (replay == eager, an edit read by the next replay,
a replaced tensor captured anew) are in test_torch_cuda.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu import megakernel as JMK
from glome_tpu.scenes.meshscene import mesh_scene as j_mesh_scene
from glome_tpu_torch import block_kernel as BK
from glome_tpu_torch import graphs
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch import mesh_kernel as MSH
from glome_tpu_torch import telemetry as TM
from glome_tpu_torch.graphs import COMPILED, EAGER
from glome_tpu_torch.intersect import GROUPS, MEGA, intersect_multi_table
from glome_tpu_torch.io import quantize, read_png
from glome_tpu_torch.scenes import mesh_scene as t_mesh_scene
from glome_tpu_torch.scenes import test_scene as torch_test_scene
from glome_tpu_torch.scenes.phasescene import (phase_kinds_lights,
                                               phase_kinds_rays,
                                               phase_kinds_scene)
from glome_tpu_torch.trace import _light_arrays
from glome_tpu_torch.trace_wavefront import (bucket, shadow_rays,
                                             shadow_rays_static, whole_rows)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "testscene_90x60_cpu.png")
COLOR_ATOL = 5e-5
# K2 / K3 routing of the small mesh (test_torch_mesh.py's)
MESH_ROUTES = {"blocks": dict(MEGA_EXT_MIN=8, BLOCK_MIN=8),
               "external": dict(MEGA_EXT_MIN=8, BLOCK_VMEM_MAX=0)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pixel_rays(tracer, cam, cfg):
    ys, xs = np.mgrid[0:cfg.yres, 0:cfg.xres]
    return T.Renderer(tracer, cam, cfg).rays_for_pixels(
        xs.reshape(-1).astype(np.float32), ys.reshape(-1).astype(np.float32),
        "cpu")


@pytest.fixture(scope="module")
def testscene():
    solid, lights, cam = torch_test_scene()
    compiled = T.compile_scene(solid, lights)
    cfg = T.RenderConfig.tuned(xres=90, yres=60)
    tracer = T.WavefrontTracer(compiled, cfg)
    o, d = _pixel_rays(tracer, cam, cfg)
    return compiled, cfg, tracer, T.to_torch(compiled.arrays(), "cpu"), o, d


def _sphere_group(arrays):
    """The index of scene 0's first group with sphere centres."""
    return next(i for i, ga in enumerate(arrays["scenes"][0])
                if "center" in ga)


def _assert_bit_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        if x is None:
            assert y is None
            continue
        assert x.shape == y.shape, name
        diff = (x.double() - y.double()).abs().max().item() if x.numel() \
            else 0.0
        assert diff == 0 and torch.equal(x, y), f"{name}: max |diff| {diff}"


def _both_frames(tracer, arrays, o, d):
    got = tracer.trace(arrays, o, d, frame=COMPILED)
    stats = dict(tracer.last_frame)
    want = tracer.trace(arrays, o, d, frame=EAGER)
    return got, want, stats


def _packs(tracer, arrays, o, d, frame):
    """(the trace, megakernel.table_packs of its frame record)."""
    kept = TM.frames()
    before = kept[-1].id if kept else -1
    res = tracer.trace(arrays, o, d, frame=frame)
    rec, = [f for f in TM.frames() if f.id > before]
    return res, rec.counts["megakernel.table_packs"]


# --- the bucket ladder ------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 300, 511, 512, 513, 640,
                               641, 1000, 5400, 65_536, 96_001, 345_600,
                               1_000_003, 2_073_600])
def test_bucket_covers_pads_little_and_is_whole_rows(n):
    b = bucket(n)
    assert b >= max(n, 1) and b % 128 == 0
    assert bucket(b) == b                   # a rung of the ladder
    if n > 512:
        assert b - n < 0.25 * n
    else:
        assert b <= 512
    # the least rung that covers n
    rungs = [128]
    while rungs[-1] < b:
        rungs.append(bucket(rungs[-1] + 1))
    assert rungs[-1] == b and (len(rungs) == 1 or rungs[-2] < n)
    assert all(y <= 1.25 * x or y <= 512 for x, y in zip(rungs, rungs[1:]))


@pytest.mark.parametrize("n, want", [(0, 128), (1, 128), (128, 128),
                                     (129, 256), (5400, 5504),
                                     (345_600, 345_600),
                                     (2_073_600, 2_073_600)])
def test_level0_is_whole_rows(n, want):
    # the caller's frame size, rounded up to whole rows only: TestScene
    # 720x480 and the 1080p mesh frames need no dead lane at level 0
    assert whole_rows(n) == want


# --- bit equality with the eager frame ----------------------------------------

def test_testscene_levels_equal_the_eager_frame(testscene):
    _compiled, cfg, tracer, arrays, o, d = testscene
    got, want, stats = _both_frames(tracer, arrays, o, d)
    _assert_bit_equal(got, want)
    # three levels: one host read after each but the deepest, nothing
    # captured on the CPU, every width a rung covering its level
    assert stats["host_reads"] == cfg.maxdepth - 1
    assert stats["captures"] == stats["replays"] == 0
    assert len(stats["widths"]) == cfg.maxdepth
    assert stats["widths"][0] == whole_rows(o.shape[0])
    assert all(w % 128 == 0 for w in stats["widths"])
    assert tracer.last_batches == 2 * cfg.maxdepth


def test_phase_kinds_levels_equal_the_eager_frame():
    compiled = T.compile_scene(phase_kinds_scene(), phase_kinds_lights())
    tracer = T.WavefrontTracer(compiled, T.RenderConfig(maxdepth=3))
    o, d = (torch.as_tensor(a) for a in phase_kinds_rays(1500, seed=1))
    got, want, stats = _both_frames(
        tracer, T.to_torch(compiled.arrays(), "cpu"), o, d)
    _assert_bit_equal(got, want)
    assert stats["widths"] == [whole_rows(1500), 128, 128]
    assert bool((got.t < T.INFINITY).any())


def _mesh_case(monkeypatch, route):
    """The 1,500-triangle mesh, self-shadowing, routed to K2 or K3:
    (compiled, its 64x36 depth-1 tracer, o, d)."""
    for k, v in MESH_ROUTES[route].items():
        monkeypatch.setattr(MK, k, v)
    st, lt, camt = t_mesh_scene(1500, cast_shadows=True)
    ct = T.compile_scene(st, lt)
    assert getattr(MK.get_plan(ct), route) == [(0, 1)]
    cfg = T.RenderConfig(xres=64, yres=36, maxdepth=1)
    tracer = T.WavefrontTracer(ct, cfg)
    o, d = _pixel_rays(tracer, camt, cfg)
    return ct, tracer, o, d


def _mesh_pair(monkeypatch, route):
    for k, v in MESH_ROUTES[route].items():
        monkeypatch.setattr(JMK, k, v)
    sj, lj, _ = j_mesh_scene(1500, cast_shadows=True)
    return (G.compile_scene(sj, lj),) + _mesh_case(monkeypatch, route)


@pytest.mark.parametrize("route", sorted(MESH_ROUTES))
def test_mesh_levels_equal_eager_and_match_glome_tpu(monkeypatch, route):
    cj, ct, tracer, o, d = _mesh_pair(monkeypatch, route)
    got, want, stats = _both_frames(tracer, T.to_torch(ct.arrays(), "cpu"),
                                    o, d)
    _assert_bit_equal(got, want)
    assert stats["host_reads"] == 0
    assert stats["widths"] == [whole_rows(64 * 36)]
    rj = jax.jit(lambda a: G.WavefrontTracer(cj, G.RenderConfig(
        maxdepth=1)).trace(a, jnp.asarray(o.numpy()),
                           jnp.asarray(d.numpy())))(cj.arrays())
    np.testing.assert_allclose(got.color.numpy(), np.asarray(rj.color),
                               atol=COLOR_ATOL, rtol=0)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(rj.t), rtol=5e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(got.prim_serial.numpy(),
                                  np.asarray(rj.prim_serial))
    assert (got.t.numpy() < T.INFINITY).mean() > 0.5


def test_testscene_compiled_frame_within_golden_canaries(testscene):
    compiled, cfg, _tracer, arrays, _o, _d = testscene
    _solid, _lights, cam = torch_test_scene()
    renderer = T.Renderer(T.WavefrontTracer(compiled, cfg, frame=COMPILED),
                          cam, cfg)
    rgb, _depth = renderer.render(arrays)
    diff = np.abs(quantize(rgb.numpy()).astype(np.int32)
                  - read_png(GOLDEN).astype(np.int32)).max(axis=-1)
    print(f"drift vs glome_tpu's CPU golden: mean {diff.mean():.4f} levels, "
          f"{int((diff > 64).sum())}/{diff.size} pixels > 64")
    assert diff.mean() <= 3.0
    assert (diff > 64).sum() <= 0.006 * diff.size


# --- the select tables, once a trace -----------------------------------------

def test_a_compiled_trace_builds_its_select_tables_once(testscene):
    _compiled, cfg, tracer, arrays, o, d = testscene
    o, d = o[:640], d[:640]
    got, n_compiled = _packs(tracer, arrays, o, d, COMPILED)
    want, n_eager = _packs(tracer, arrays, o, d, EAGER)
    _assert_bit_equal(got, want)
    assert n_compiled == 1
    # the eager frame: one a batch, an intersect and a shadow batch a level
    assert n_eager == tracer.last_batches == 2 * cfg.maxdepth


@pytest.mark.parametrize("route", sorted(MESH_ROUTES))
def test_k2_and_k3_tables_are_built_once_a_compiled_trace(monkeypatch,
                                                          route):
    compiled, tracer, o, d = _mesh_case(monkeypatch, route)
    arrays = T.to_torch(compiled.arrays(), "cpu")
    mod, name = ((BK, "pack_blocks") if route == "blocks"
                 else (MSH, "pack_tri_blocks"))
    packed = []
    pack = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a: packed.append(1) or pack(*a))
    got, n_compiled = _packs(tracer, arrays, o, d, COMPILED)
    k_compiled = len(packed)
    want, n_eager = _packs(tracer, arrays, o, d, EAGER)
    _assert_bit_equal(got, want)
    # depth 1: an intersect and a shadow batch, the mesh in both
    assert (n_compiled, k_compiled) == (1, 1)
    assert (n_eager, len(packed) - k_compiled) == (2, 2)


# --- the static shadow batch and child queue ----------------------------------

def _level0(testscene, width):
    compiled, _cfg, tracer, arrays, o, d = testscene
    n = o.shape[0]
    q = torch.zeros((8, width))
    q[7] = -1.0
    q[0:3, :n], q[3:6, :n] = o.t(), d.t()
    q[6, :n] = T.INFINITY
    q[7, :n] = 0.0
    return compiled, tracer, arrays, q


def test_static_shadow_batch_holds_the_eager_batch(testscene):
    n = testscene[4].shape[0]
    compiled, _tracer, arrays, q = _level0(testscene, whole_rows(n))
    lights = compiled.lights
    lpos, _lcol, lrad = _light_arrays(compiled, arrays, lights)
    he = intersect_multi_table(compiled, arrays, q[:, :n])
    hs = intersect_multi_table(compiled, arrays, q)
    pre_e, segs, table_e = shadow_rays(he, q[7, :n], lights, lpos, lrad)
    pre_s, slots, table_s = shadow_rays_static(hs, q[7], lights, lpos, lrad)
    m = table_e.shape[1]
    assert 0 < m < table_s.shape[1]
    assert table_s.shape[1] == sum(l.shadow for l in lights) * q.shape[1]
    assert torch.equal(table_s[:, :m], table_e)
    assert (table_s[6, m:] == 0).all() and (table_s[7, m:] == -1).all()
    off = 0
    for (li, idx), (lj, slot) in zip(segs, slots):
        assert li == lj
        active = pre_s[li][2]
        assert torch.equal(active[:n], pre_e[li][2])
        assert not active[n:].any()
        # each active lane's slot is its place in the eager batch
        assert torch.equal(slot[:n][pre_e[li][2]],
                           torch.arange(off, off + idx.numel()))
        off += idx.numel()


def test_static_child_queue_holds_the_eager_queue(testscene):
    n = testscene[4].shape[0]
    compiled, tracer, arrays, q = _level0(testscene, whole_rows(n))
    lights = compiled.lights
    lp = _light_arrays(compiled, arrays, lights)
    qe, se = tracer._down_level(arrays, q[:, :n], lights, *lp, last=False)
    qs, ss = tracer._down_level(arrays, q, lights, *lp, last=False,
                                static=True)
    m = qe.shape[1]
    assert ss["counts"].tolist() == [i.numel() for _k, i in se["child"]]
    assert qs.shape[1] == bucket(len(tracer._segments()) * q.shape[1]) >= m
    assert torch.equal(qs[:, :m], qe)
    assert (qs[6, m:] == 0).all() and (qs[7, m:] == -1).all()
    for k, (key, idx) in enumerate(se["child"]):
        mask = ss["mask"][key]
        assert torch.equal(torch.nonzero(mask)[:, 0], idx)
        off = int(ss["counts"][:k].sum())
        assert torch.equal(ss["src"][k][idx],
                           torch.arange(off, off + idx.numel()))


# --- refusals and defaults ---------------------------------------------------

def test_compiled_frame_refuses_a_gradient(testscene):
    compiled, cfg, tracer, arrays, o, d = testscene
    o, d = o[:256], d[:256]
    params = {**arrays, "scenes": [[{k: v.clone() for k, v in ga.items()}
                                    for ga in sc] for sc in arrays["scenes"]]}
    params["scenes"][0][_sphere_group(params)]["center"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="gradient"):
        tracer.trace(params, o, d)
    with pytest.raises(RuntimeError, match="gradient"):
        tracer.trace(arrays, o.clone().requires_grad_(True), d)
    # no gradient asked: it runs
    with torch.no_grad():
        a = tracer.trace(params, o, d)
    b = tracer.trace(params, o, d, frame=EAGER)
    assert b.color.requires_grad
    assert torch.equal(a.color, b.color.detach())


def test_compiled_frame_refuses_the_group_route(testscene):
    compiled, cfg, _tracer, arrays, o, d = testscene
    tracer = T.WavefrontTracer(compiled, cfg, route=GROUPS, frame=COMPILED)
    with pytest.raises(ValueError, match="megakernel route"):
        tracer.trace(arrays, o[:128], d[:128])
    with pytest.raises(NotImplementedError, match="compiled frame"):
        T.Tracer(compiled, cfg).trace(arrays, o[:128], d[:128],
                                      frame=COMPILED)
    with pytest.raises(ValueError, match="frame must be"):
        T.WavefrontTracer(compiled, cfg, frame="jit")


def test_frame_defaults(testscene):
    compiled, cfg, _tracer, arrays, o, d = testscene
    o, d = o[:256], d[:256]
    # the compiled frame records its level widths; the eager one nothing
    for kw, compiled_frame in (({}, True), ({"route": GROUPS}, False),
                               ({"select": MK.PLAIN}, False),
                               ({"frame": EAGER}, False),
                               ({"frame": COMPILED}, True)):
        tracer = T.WavefrontTracer(compiled, cfg, **kw)
        want = tracer.trace(arrays, o, d, frame=EAGER)
        assert not tracer.last_frame
        got = tracer.trace(arrays, o, d)
        assert bool(tracer.last_frame) == compiled_frame, kw
        _assert_bit_equal(got, want)
    # a per-call frame overrides the tracer's
    tracer = T.WavefrontTracer(compiled, cfg, frame=EAGER)
    tracer.trace(arrays, o, d, frame=COMPILED)
    assert tracer.last_frame["widths"][0] == 256
    # the recursive Tracer runs the eager frame, named or not
    a = T.Tracer(compiled, cfg).trace(arrays, o, d)
    b = T.Tracer(compiled, cfg).trace(arrays, o, d, frame=EAGER)
    _assert_bit_equal(a, b)


# --- the capture key -----------------------------------------------------------

def test_scene_key_follows_identity_not_values(testscene):
    compiled = testscene[0]
    arrays = T.to_torch(compiled.arrays(), "cpu")
    key = graphs.scene_key(arrays)
    assert len(key) == len(graphs.tensors(arrays))
    ga = arrays["scenes"][0][_sphere_group(arrays)]
    ga["center"].add_(0.25)                               # in place
    assert graphs.scene_key(arrays) == key
    ga["center"] = ga["center"] + 0.0                     # replaced
    assert graphs.scene_key(arrays) != key


def test_inplace_edit_shows_in_the_next_compiled_frame(testscene):
    compiled, cfg, tracer, _arrays, o, d = testscene
    arrays = T.to_torch(compiled.arrays(), "cpu")
    before = tracer.trace(arrays, o, d)
    ga = arrays["scenes"][0][_sphere_group(arrays)]
    ga["center"].add_(torch.tensor([0.3, 0.1, 0.0]))
    got, want, _stats = _both_frames(tracer, arrays, o, d)
    _assert_bit_equal(got, want)
    assert not torch.equal(got.color, before.color)


def test_inplace_edit_of_boxes_and_cones_shows_in_the_next_compiled_frame(
        testscene):
    # group 1's boxes are a dense phase's rows and its group bounds (the
    # plan's bb_spec); group 5's cones are a BVH phase's rows and its
    # padded prim boxes (pbox_spec), read through their transforms
    compiled, _cfg, tracer, _arrays, o, d = testscene
    plan = MK.get_plan(compiled)
    assert (0, 1) in plan.bb_spec
    assert [(si, gi) for _i, si, gi, _p in plan.pbox_spec] == [(0, 5)]
    arrays = T.to_torch(compiled.arrays(), "cpu")
    # a ray in 8 at depth 1: every batch reads the tables all the same
    o, d = o[::8], d[::8]
    before = tracer.trace(arrays, o, d, recurs=1)
    step = torch.tensor([0.3, 0.1, 0.0])
    boxes, cones = arrays["scenes"][0][1], arrays["scenes"][0][5]
    boxes["bmin"].add_(step)
    boxes["bmax"].add_(step)
    # the cones moved by `step`: the forward transform's translation
    # column, and the inverse's by the inverse's linear part
    cones["m_fwd"][:, :, 3].add_(step)
    cones["m_inv"][:, :, 3].sub_(cones["m_inv"][:, :, :3] @ step)
    got = tracer.trace(arrays, o, d, recurs=1)
    _assert_bit_equal(got, tracer.trace(arrays, o, d, recurs=1,
                                        frame=EAGER))
    # both kinds moved: lanes that hit a box, and lanes that hit a cone,
    # meet it elsewhere now
    for gi in (1, 5):
        base = plan.prim_base[(0, gi)][0]
        serials = torch.as_tensor(plan.serial_all[
            base:base + compiled.scenes[0].groups[gi].size])
        was = torch.isin(before.prim_serial, serials)
        assert bool((got.t[was] != before.t[was]).any()), gi


def test_a_new_scene_drops_the_old_scenes_segments():
    cache = graphs.GraphCache()
    cache.use_scene(("a",))
    cache.segments[("down", 0)] = cache.segments[("up", 0)] = None
    cache.use_scene(("a",))                         # the same scene: kept
    assert len(cache) == 2 and cache.scene_changes == 0
    with pytest.warns(RuntimeWarning, match="2 captured segments dropped"):
        cache.use_scene(("b",))
    assert len(cache) == 0 and cache.scene == ("b",)
    assert cache.scene_changes == 1


def test_segments_carry_launch_and_plain_call_counters():
    cs = graphs.counters()
    assert [a for _f, a in cs] == (["launches"] * 5 + ["calls"] * 6
                                   + ["fused_calls", "torch_calls"])
    assert cs[0][0] is MK.mega_select and cs[5][0] is MK.mega_select_plain
    # the builds of the select tables and finalize's two paths, which a
    # replay counts too, after the kernels' own counters
    assert cs[:10] == graphs.kernel_counters()
    assert cs[10][0] is MK.pack_tables
    assert cs[11][0] is cs[12][0] is MK.finalize
    assert all(isinstance(getattr(f, a), int) for f, a in cs)


def test_frame_run_on_the_cpu_calls_each_segment():
    run = graphs.GraphCache().frame("cpu", {"x": torch.zeros(2)})
    out = run.run(("down", 0), lambda a, b: a + b, (torch.ones(2),),
                  (torch.full((2,), 2.0),))
    assert torch.equal(out, torch.full((2,), 3.0))
    assert run.stats() == {"captures": 0, "replays": 0, "host_reads": 0}
