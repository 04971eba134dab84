"""The program's spans and counters (glome_tpu_torch/telemetry.py).

On the CPU: span nesting, self time and frame ids on a counting clock;
one frame record per Renderer.render / AARenderer.render call, with the
spans the benchmark reads (wavefront.trace on either route, none of its
own from the recursive Tracer); the compiled frame's per-launch K1 lanes
(the static widths) and live lanes (the eager frame's exact batch sizes
on the same rays); host reads and images as the eager frame has them;
the K2 launches of a scene with a block group and the K3 launches of a
scene with an external triangle group, beside K1's, in both frames, and
the benchmark's K3 live-lane share of them (none without such a group);
the spans' intervals, mapped onto the profiler's clock, against
the record_function ranges a CPU torch.profiler records for them; no
range opened while no profiler collects; the ring's bounds.

On the card (`cuda`): a capture frame and a replay frame record equal
per-launch counts, K2's and K3's among them on scenes with a block group
and an external group, and no
span, count or launch is recorded while a stream captures; a replayed
still and AA frame build the select tables once a trace call
(megakernel.table_packs), equal the eager frame, and a replay after an
in-place edit of boxes and cones reads the edit.

    python -m pytest tests/test_torch_telemetry.py -q
    python -m pytest --noconftest -m cuda tests/test_torch_telemetry.py -q
"""

import types

import numpy as np
import pytest
import torch

import glome_tpu_torch as T
from glome_tpu_torch import telemetry as TM
from glome_tpu_torch.graphs import COMPILED, EAGER
from glome_tpu_torch.intersect import GROUPS
from glome_tpu_torch.scenes import test_scene as torch_test_scene
from glome_tpu_torch.trace_wavefront import whole_rows

# the clock mapping's tolerance: a span's mapped interval against the
# profiler's range for it
MAP_NS = 50_000


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    solid, lights, cam = torch_test_scene()
    compiled = T.compile_scene(solid, lights)
    return compiled, T.to_torch(compiled.arrays(), "cpu"), cam


@pytest.fixture
def cfg():
    return T.RenderConfig.tuned(xres=48, yres=32)


def _new(before):
    """The records opened since the record `before` (None: all kept)."""
    return [f for f in TM.frames() if before is None or f.id > before.id]


def _last():
    kept = TM.frames()
    return kept[-1] if kept else None


def _lights_that_shadow(compiled):
    return sum(bool(l.shadow) for l in compiled.lights)


# --- the recorder -----------------------------------------------------------

def test_spans_nest_with_self_time_and_frame_ids(monkeypatch):
    ticks = iter(range(0, 10 ** 9, 10))
    monkeypatch.setattr(TM, "_ns", lambda: next(ticks))
    before = _last()
    with TM.frame("f"):
        with TM.span("a"):
            with TM.span("b"):
                TM.count("n", 2)
        with TM.span("a"):
            pass
    with TM.span("bare"):            # no frame open: a frame of its own
        TM.count("n")
    TM.count("n", 5)                 # no span open: dropped
    f, g = _new(before)
    assert (f.name, g.name, g.id) == ("f", "bare", f.id + 1)
    assert [s[0] for s in f.spans] == ["f", "a", "b", "a"]
    assert [s[3] for s in f.spans] == [-1, 0, 1, 0]
    for name, a, b, parent in f.spans:
        assert a < b
        if parent >= 0:
            pa, pb = f.spans[parent][1:3]
            assert pa < a and b < pb, name
    dur = {}
    for name, a, b, _p in f.spans:
        dur[name] = dur.get(name, 0) + b - a
    assert f.sums["a"] == [2, dur["a"], dur["a"] - dur["b"]]
    assert f.sums["b"] == [1, dur["b"], dur["b"]]
    assert f.sums["f"] == [1, dur["f"], dur["f"] - dur["a"]]
    assert f.counts == {"n": 2} and g.counts == {"n": 1}
    assert [s[3] for s in g.spans] == [-1]


def test_launches_count_lanes_and_live_lanes():
    before = _last()
    with TM.span("x"):
        TM.launch("k1", 0, "intersect", 256, 200)
        TM.launch("k1", 0, "shadow", 512, TM.pending(torch.tensor([301])))
    f, = _new(before)
    assert f.launches == [["k1", 0, "intersect", 256, 200],
                          ["k1", 0, "shadow", 512, 301]]
    assert f.counts == {"k1.lanes": 768, "k1.live_lanes": 501}


def test_no_range_is_opened_while_no_profiler_collects(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(TM._P, "record_function", refuse)
    with TM.frame("f"), TM.span("a"):
        pass


def test_the_ring_is_bounded():
    n = TM.FRAMES_KEPT + 10
    for i in range(n):
        with TM.frame("f"):
            TM.launch("k1", 0, "intersect", 128, i % 128)
    kept = TM.frames()
    assert len(kept) == TM.FRAMES_KEPT
    ids = [f.id for f in kept]
    assert ids == list(range(ids[0], ids[0] + TM.FRAMES_KEPT))
    full = [f for f in kept if f.spans is not None]
    assert full == kept[-TM.INTERVALS_KEPT:]
    assert all(f.launches is None for f in kept[:-TM.INTERVALS_KEPT])
    # the sums and counters outlive the intervals
    assert all(f.counts["k1.lanes"] == 128 and f.sums["f"][0] == 1
               for f in kept)


# --- the frames' records ------------------------------------------------------

@pytest.mark.parametrize("frame", [COMPILED, EAGER, "groups", "recursive"])
def test_one_record_per_renderer_call(scene, cfg, frame):
    """The wavefront tracer's frames on the megakernel route, its eager
    frame on the pass-per-group route (which opens wavefront.trace
    too), and the recursive Tracer, which opens no span of its own."""
    compiled, arrays, cam = scene
    if frame == "recursive":
        tracer = T.Tracer(compiled, cfg)
    elif frame == "groups":
        tracer = T.WavefrontTracer(compiled, cfg, route=GROUPS, frame=EAGER)
    else:
        tracer = T.WavefrontTracer(compiled, cfg, frame=frame)
    view = T.Renderer(tracer, cam, cfg)
    before = _last()
    view.render(arrays)
    if frame == "recursive":
        f, = _new(before)
        assert f.name == "render.frame"
        spans = ["render.frame", "render.ray_setup", "render.scatter"]
        assert [s[0] for s in f.spans] == spans
        assert all(f.sums[k][0] == 1 for k in spans)
        assert not f.launches and "k1.lanes" not in f.counts
        return
    view.render(arrays, subpixel_offset=0.25)
    recs = _new(before)
    assert [f.name for f in recs] == ["render.frame"] * 2
    for f in recs:
        names = [s[0] for s in f.spans]
        assert names[:3] == ["render.frame", "render.ray_setup",
                             "wavefront.trace"]
        assert names[-1] == "render.scatter"
        assert all(f.sums[k][0] == 1 for k in
                   ("render.ray_setup", "render.scatter", "wavefront.trace"))
        # the trace's self time leaves out its count reads
        reads = f.sums.get("wavefront.count_read", [0, 0, 0])
        wt = f.sums["wavefront.trace"]
        assert wt[2] == wt[1] - reads[1]
        assert reads[0] == (cfg.maxdepth - 1 if frame == COMPILED else 0)
        # the group route's passes record no K1 launch
        assert bool(f.launches) == (frame != "groups")


def test_one_record_per_aa_call(scene, cfg):
    compiled, arrays, cam = scene
    view = T.AARenderer(T.WavefrontTracer(compiled, cfg), cam, cfg)
    before = _last()
    view.render(arrays)
    f, = _new(before)
    assert f.name == "aa.frame"
    assert f.sums["wavefront.trace"][0] == 5
    assert f.sums["wavefront.count_read"][0] == 10
    assert f.counts["graphs.host_reads"] == 10
    # one lookup of the static geometry, which a new renderer builds
    assert f.sums["aa.mask_planes"][0] == 1
    assert f.counts["aa.geometry_builds"] == 1
    assert f.sums["aa.variance"][0] == 5
    # two spans around each trace call and two around each pass's
    assert f.sums["aa.pass_setup"][0] == 20
    # the variance spans hold no child span: their self time is their time
    v = f.sums["aa.variance"]
    assert v[2] == v[1]
    for name, _a, _b, p in f.spans:
        if name in ("aa.mask_planes", "aa.variance"):
            assert f.spans[p][0] == "aa.frame"
    # no program span encloses a trace call but the frame
    for name, _a, _b, p in f.spans:
        if name == "wavefront.trace":
            assert f.spans[p][0] == "aa.frame"


def test_compiled_live_lanes_are_the_eager_batch_sizes(scene, cfg):
    compiled, arrays, cam = scene
    tracer = T.WavefrontTracer(compiled, cfg)
    ys, xs = np.mgrid[0:cfg.yres, 0:cfg.xres]
    o, d = T.Renderer(tracer, cam, cfg).rays_for_pixels(
        xs.reshape(-1).astype(np.float32) + 0.5,
        ys.reshape(-1).astype(np.float32) + 0.5, "cpu")
    before = _last()
    tracer.trace(arrays, o, d, frame=COMPILED)
    widths = tracer.last_frame["widths"]
    tracer.trace(arrays, o, d, frame=EAGER)
    got, want = _new(before)
    assert got.name == want.name == "wavefront.trace"
    L = _lights_that_shadow(compiled)
    assert len(got.launches) == len(want.launches) == 2 * cfg.maxdepth
    for g, w in zip(got.launches, want.launches):
        kernel, level, kind, lanes, live = g
        assert (kernel, level, kind) == tuple(w[:3])
        # the eager batch: exact, every lane live
        assert w[3] == w[4] == live, g
        assert lanes == (widths[level] if kind == "intersect"
                         else L * widths[level])
    assert got.launches[0][3] == whole_rows(o.shape[0])
    assert got.counts["k1.live_lanes"] == want.counts["k1.lanes"]
    assert got.counts["k1.lanes"] == sum(g[3] for g in got.launches)
    assert 0 < got.counts["k1.live_lanes"] < got.counts["k1.lanes"]


def test_host_reads_and_images_as_before(scene, cfg):
    compiled, arrays, cam = scene
    comp = T.WavefrontTracer(compiled, cfg, frame=COMPILED)
    eager = T.WavefrontTracer(compiled, cfg, frame=EAGER)
    before = _last()
    got = T.Renderer(comp, cam, cfg).render(arrays, 0.5)
    want = T.Renderer(eager, cam, cfg).render(arrays, 0.5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # one read per level but the deepest, fed by the tracer's own tally
    assert comp.last_frame["host_reads"] == cfg.maxdepth - 1
    f = _new(before)[0]
    assert f.counts["graphs.host_reads"] == comp.last_frame["host_reads"]
    assert f.sums["wavefront.count_read"][0] == cfg.maxdepth - 1


# a triangle between the flake and its first light (4, 3, 2): in K1, it
# blocks some shadow rays before K2 sees them
OCCLUDER = "p 3\n3.6 2.0 1.9\n2.6 3.2 1.9\n3.2 2.6 1.0\n"


@pytest.fixture(scope="module")
def block_scene():
    """SPD balls at size factor 2 with its 91 spheres routed to K2 (the
    routing threshold lowered for the plan's build) and OCCLUDER."""
    from glome_tpu_torch import megakernel as MK
    from glome_tpu_torch import spd
    from glome_tpu_torch.scenes.spd_balls import nff
    s = spd.parse(nff(2) + OCCLUDER)
    compiled = T.compile_scene(s.geom, s.lights)
    old, MK.BLOCK_MIN = MK.BLOCK_MIN, 64
    try:
        assert MK.get_plan(compiled).blocks
    finally:
        MK.BLOCK_MIN = old
    return compiled, T.to_torch(compiled.arrays(), "cpu"), s.cam


@pytest.fixture
def k2_seeds(monkeypatch):
    """The live lanes (seed above 0) of every K2 call, in call order, as
    the plain K2 (the CPU's) is handed them."""
    from glome_tpu_torch import block_kernel as BK
    seen, plain = [], BK.block_select_plain

    def tap(plan, tab, cf, rays, seed, shadow):
        seen.append(int((seed > 0).sum()))
        return plain(plan, tab, cf, rays, seed, shadow)
    tap.calls = 0           # the plain version counts its calls by name
    monkeypatch.setattr(BK, "block_select_plain", tap)
    return seen


@pytest.mark.parametrize("frame", [COMPILED, EAGER])
def test_k2_launches_are_recorded_beside_k1s(block_scene, cfg, k2_seeds,
                                             frame):
    compiled, arrays, cam = block_scene
    view = T.Renderer(T.WavefrontTracer(compiled, cfg, frame=frame), cam,
                      cfg)
    before = _last()
    view.render(arrays)
    f, = _new(before)
    k1 = [g for g in f.launches if g[0] == "k1"]
    k2 = [g for g in f.launches if g[0] == "k2"]
    # one K2 launch per batch, on the batch's lanes, its live lanes those
    # its seed keeps alive
    assert len(k2) == len(k1) == 2 * cfg.maxdepth
    assert [g[1:4] for g in k2] == [g[1:4] for g in k1]
    assert [g[4] for g in k2] == k2_seeds
    assert f.counts["k2.lanes"] == f.counts["k1.lanes"]
    assert f.counts["k2.live_lanes"] == sum(k2_seeds)
    assert f.counts["k2.lanes"] >= f.counts["k2.live_lanes"] > 0
    # the occluder, in K1, leaves K2 fewer live shadow lanes than K1 has
    assert k2[1][2] == "shadow" and 0 < k2[1][4] < k1[1][4]
    if frame == COMPILED:
        assert f.counts["k2.lanes"] > f.counts["k2.live_lanes"]


def test_compiled_k2_live_lanes_are_the_eager_frames(block_scene, cfg):
    compiled, arrays, cam = block_scene
    tracer = T.WavefrontTracer(compiled, cfg)
    ys, xs = np.mgrid[0:cfg.yres, 0:cfg.xres]
    o, d = T.Renderer(tracer, cam, cfg).rays_for_pixels(
        xs.reshape(-1).astype(np.float32) + 0.5,
        ys.reshape(-1).astype(np.float32) + 0.5, "cpu")
    before = _last()
    tracer.trace(arrays, o, d, frame=COMPILED)
    tracer.trace(arrays, o, d, frame=EAGER)
    got, want = _new(before)
    got = [g for g in got.launches if g[0] == "k2"]
    want = [w for w in want.launches if w[0] == "k2"]
    assert len(got) == len(want) == 2 * cfg.maxdepth
    for g, w in zip(got, want):
        assert g[1:3] == w[1:3] and g[4] == w[4] <= w[3]


def test_a_scene_without_block_groups_records_no_k2(scene, cfg):
    compiled, arrays, cam = scene
    before = _last()
    T.Renderer(T.WavefrontTracer(compiled, cfg), cam, cfg).render(arrays)
    f, = _new(before)
    assert all(g[0] == "k1" for g in f.launches)
    assert "k2.lanes" not in f.counts


@pytest.fixture(scope="module")
def external_scene():
    """SPD tetra at 2 subdivisions with its 64 triangles routed to K3 (the
    routing thresholds lowered for the plan's build, as
    tests/test_torch_mesh.py's "external" route)."""
    from glome_tpu_torch import megakernel as MK
    from glome_tpu_torch.scenes.spd_tetra import tetra
    solid, lights, cam = tetra(2)
    compiled = T.compile_scene(solid, lights)
    old = MK.MEGA_EXT_MIN, MK.BLOCK_VMEM_MAX
    MK.MEGA_EXT_MIN, MK.BLOCK_VMEM_MAX = 8, 0
    try:
        plan = MK.get_plan(compiled)
        assert plan.external == [(0, 0)] and not plan.blocks
    finally:
        MK.MEGA_EXT_MIN, MK.BLOCK_VMEM_MAX = old
    return compiled, T.to_torch(compiled.arrays(), "cpu"), cam


@pytest.fixture
def k3_seeds(monkeypatch):
    """The live lanes (seed above 0) of every K3 call, in call order, as
    the plain K3 (the CPU's) is handed them."""
    from glome_tpu_torch import mesh_kernel as MSH
    seen, plain = [], MSH.mesh_block_select_plain

    def tap(plan, tri, rays, seed, shadow=False):
        seen.append(int((seed > 0).sum()))
        return plain(plan, tri, rays, seed, shadow)
    tap.calls = 0           # the plain version counts its calls by name
    monkeypatch.setattr(MSH, "mesh_block_select_plain", tap)
    return seen


def _k3_live_lane_pct():
    """The benchmark's wavefront.k3_live_lane_pct over the last frame."""
    from benchmark.harness import manifest as M
    run = types.SimpleNamespace(frames=1, outside_s=[1.0], prof=None,
                                mix={"profile_frames": 8})
    return M.reader("wavefront.k3_live_lane_pct")(run)


@pytest.mark.parametrize("frame", [COMPILED, EAGER])
def test_k3_launches_are_recorded_beside_k1s(external_scene, cfg, k3_seeds,
                                             frame):
    compiled, arrays, cam = external_scene
    view = T.Renderer(T.WavefrontTracer(compiled, cfg, frame=frame), cam,
                      cfg)
    before = _last()
    view.render(arrays)
    f, = _new(before)
    k1 = [g for g in f.launches if g[0] == "k1"]
    k3 = [g for g in f.launches if g[0] == "k3"]
    # one K3 launch per external group and batch, on the batch's lanes,
    # its live lanes those its seed keeps alive; no K2
    assert len(k3) == len(k1) == 2 * cfg.maxdepth == len(f.launches) / 2
    assert [g[1:4] for g in k3] == [g[1:4] for g in k1]
    assert [g[4] for g in k3] == k3_seeds
    assert f.counts["k3.lanes"] == f.counts["k1.lanes"]
    assert f.counts["k3.live_lanes"] == sum(k3_seeds)
    assert f.counts["k3.lanes"] >= f.counts["k3.live_lanes"] > 0
    assert k3[1][2] == "shadow" and 0 < k3[1][4] <= k1[1][4]
    assert _k3_live_lane_pct() == pytest.approx(
        100.0 * sum(k3_seeds) / f.counts["k3.lanes"])
    if frame == COMPILED:
        assert f.counts["k3.lanes"] > f.counts["k3.live_lanes"]


def test_a_scene_without_external_groups_records_no_k3(scene, cfg):
    compiled, arrays, cam = scene
    before = _last()
    T.Renderer(T.WavefrontTracer(compiled, cfg), cam, cfg).render(arrays)
    f, = _new(before)
    assert "k3.lanes" not in f.counts
    assert not [g for g in f.launches if g[0] == "k3"]
    assert _k3_live_lane_pct() is None


# --- the profiler's clock -------------------------------------------------------

def _profiled_frame(view, arrays):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        view.render(arrays)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            s = e.start_ns()
            ranges.setdefault(e.name(), []).append((s, s + e.duration_ns()))
    return _last(), {k: sorted(v) for k, v in ranges.items()}


def _worst_mapping_ns(rec, ranges):
    """The largest distance between a span's mapped ends and those of
    the profiler's range for it (the ranges of one name in order)."""
    seen = {}
    worst = 0
    for name, a, b, _p in rec.intervals():
        i = seen.get(name, 0)
        seen[name] = i + 1
        ra, rb = ranges[name][i]
        worst = max(worst, abs(ra - a), abs(rb - b))
    assert seen == {k: len(v) for k, v in ranges.items()}
    return worst


def test_mapped_intervals_match_the_profilers_ranges(scene, cfg):
    compiled, arrays, cam = scene
    view = T.Renderer(T.WavefrontTracer(compiled, cfg), cam, cfg)
    view.render(arrays)
    _profiled_frame(view, arrays)        # the profiler's own first call
    # a frame's spans all lie on the profiler's clock within MAP_NS; a
    # descheduled thread can stretch one reading, so three frames are
    # taken and the best must hold
    worst = [_worst_mapping_ns(*_profiled_frame(view, arrays))
             for _ in range(3)]
    assert min(worst) <= MAP_NS, worst


# --- the card -------------------------------------------------------------------

@pytest.mark.cuda
def test_capture_and_replay_frames_record_the_same_launches(scene,
                                                            monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    compiled, _cpu, cam = scene
    dev = torch.device("cuda", 0)
    arrays = T.to_torch(compiled.arrays(), dev)
    cfg = T.RenderConfig.tuned()
    tracer = T.WavefrontTracer(compiled, cfg)
    assert tracer.frame == COMPILED
    # nothing may be recorded while a stream captures: it would never
    # run at a replay
    captured = []
    for name in ("frame", "span", "count", "launch", "pending"):
        def guarded(*a, _f=getattr(TM, name), _name=name, **k):
            if torch.cuda.is_current_stream_capturing():
                captured.append(_name)
            return _f(*a, **k)
        monkeypatch.setattr(TM, name, guarded)
    view = T.Renderer(tracer, cam, cfg)
    before = _last()
    view.render(arrays, 0.5)
    capture_frame = dict(tracer.last_frame)
    reads = tracer.graphs.totals["host_reads"]
    view.render(arrays, 0.5)
    assert tracer.graphs.totals["host_reads"] - reads == cfg.maxdepth - 1
    T.Renderer(T.WavefrontTracer(compiled, cfg, frame=EAGER), cam,
               cfg).render(arrays, 0.5)
    torch.cuda.synchronize()
    cap, rep, eager = _new(before)
    assert capture_frame["captures"] > 0 and not captured
    assert tracer.last_frame["captures"] == 0
    assert cap.launches == rep.launches
    assert [g[4] for g in rep.launches] == [w[3] for w in eager.launches]
    assert cap.counts["graphs.captures"] == capture_frame["captures"]
    assert rep.counts["graphs.host_reads"] == cfg.maxdepth - 1


@pytest.mark.cuda
def test_k2_capture_and_replay_frames_record_the_same_launches(block_scene):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    compiled, _cpu, cam = block_scene
    arrays = T.to_torch(compiled.arrays(), torch.device("cuda", 0))
    cfg = T.RenderConfig(xres=64, yres=48)
    tracer = T.WavefrontTracer(compiled, cfg)
    assert tracer.frame == COMPILED
    view = T.Renderer(tracer, cam, cfg)
    before = _last()
    view.render(arrays, 0.5)
    view.render(arrays, 0.5)
    T.Renderer(T.WavefrontTracer(compiled, cfg, frame=EAGER), cam,
               cfg).render(arrays, 0.5)
    torch.cuda.synchronize()
    cap, rep, eager = _new(before)
    k2 = [[g for g in f.launches if g[0] == "k2"] for f in (cap, rep, eager)]
    assert len(k2[0]) == 2 * cfg.maxdepth
    assert k2[0] == k2[1]
    # K2's live lanes, the occluder's blocked shadow rays left out, as the
    # eager frame's
    assert [g[4] for g in k2[1]] == [w[4] for w in k2[2]]
    assert k2[2][1][4] < k2[2][1][3]


@pytest.mark.cuda
def test_k3_capture_and_replay_frames_record_the_same_launches(
        external_scene):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    compiled, _cpu, cam = external_scene
    arrays = T.to_torch(compiled.arrays(), torch.device("cuda", 0))
    cfg = T.RenderConfig(xres=64, yres=48)
    tracer = T.WavefrontTracer(compiled, cfg)
    assert tracer.frame == COMPILED
    view = T.Renderer(tracer, cam, cfg)
    before = _last()
    view.render(arrays, 0.5)
    view.render(arrays, 0.5)
    T.Renderer(T.WavefrontTracer(compiled, cfg, frame=EAGER), cam,
               cfg).render(arrays, 0.5)
    torch.cuda.synchronize()
    cap, rep, eager = _new(before)
    k3 = [[g for g in f.launches if g[0] == "k3"] for f in (cap, rep, eager)]
    assert len(k3[0]) == 2 * cfg.maxdepth
    assert k3[0] == k3[1]
    # K3's live lanes as the eager frame's
    assert [g[4] for g in k3[1]] == [w[4] for w in k3[2]]
    assert k3[2][0][4] == k3[2][0][3] == cfg.xres * cfg.yres


@pytest.mark.cuda
def test_replayed_frames_build_the_select_tables_once_a_trace(scene):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    compiled, _cpu, cam = scene
    arrays = T.to_torch(compiled.arrays(), torch.device("cuda", 0))
    cfg = T.RenderConfig.tuned()
    tracer = T.WavefrontTracer(compiled, cfg)
    view = T.Renderer(tracer, cam, cfg)
    eager = T.Renderer(T.WavefrontTracer(compiled, cfg, frame=EAGER), cam,
                       cfg)
    aa = T.AARenderer(tracer, cam, cfg)
    eager_aa = T.AARenderer(T.WavefrontTracer(compiled, cfg, frame=EAGER),
                            cam, cfg)

    def frames(*runs):
        before = _last()
        out = [run() for run in runs]
        torch.cuda.synchronize()
        return out, [f.counts["megakernel.table_packs"] for f in _new(before)]

    (cap, rep, want, a_cap, a_rep, a_want), packs = frames(
        lambda: view.render(arrays, 0.5), lambda: view.render(arrays, 0.5),
        lambda: eager.render(arrays, 0.5), lambda: aa.render(arrays),
        lambda: aa.render(arrays), lambda: eager_aa.render(arrays))
    assert tracer.last_frame["captures"] == 0
    # one build a trace call, replays included; the eager frame one a
    # batch; the AA frame traces five times
    n = 2 * cfg.maxdepth
    assert packs == [1, 1, n, 5, 5, 5 * n]
    for got, ref in ((cap, want), (rep, want), (a_cap, a_want),
                     (a_rep, a_want)):
        assert all(torch.equal(x, y) for x, y in zip(got, ref))
    # boxes (a dense phase's rows and group bounds) and cones (a BVH
    # phase's rows and padded prim boxes) moved in place: the next
    # replay of the tables' segment reads them, as the eager frame does
    # (the deeper levels may capture anew: their widths follow the rays)
    tables = [g for k, g in tracer.graphs.segments.items()
              if k[:2] == ("tables", whole_rows(cfg.xres * cfg.yres))]
    step = torch.tensor([0.3, 0.1, 0.0], device=arrays["lights"]["pos"].device)
    boxes, cones = arrays["scenes"][0][1], arrays["scenes"][0][5]
    boxes["bmin"].add_(step)
    boxes["bmax"].add_(step)
    cones["m_fwd"][:, :, 3].add_(step)
    cones["m_inv"][:, :, 3].sub_(cones["m_inv"][:, :, :3] @ step)
    (moved, want), packs = frames(lambda: view.render(arrays, 0.5),
                                  lambda: eager.render(arrays, 0.5))
    assert len(tables) == 1 and packs[0] == 1
    assert [g for k, g in tracer.graphs.segments.items()
            if k[:2] == ("tables", whole_rows(cfg.xres * cfg.yres))] == tables
    assert all(torch.equal(x, y) for x, y in zip(moved, want))
    assert not torch.equal(moved[0], rep[0])
