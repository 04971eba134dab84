"""The program's spans and counters (glome_tpu_torch/telemetry.py).

On the CPU: span nesting, self time and frame ids on a counting clock;
one frame record per Renderer.render / AARenderer.render call, with the
spans the benchmark reads; the compiled frame's per-launch K1 lanes
(the static widths) and live lanes (the eager frame's exact batch sizes
on the same rays); host reads and images as the eager frame has them;
the spans' intervals, mapped onto the profiler's clock, against the
record_function ranges a CPU torch.profiler records for them; no range
opened while no profiler collects; the ring's bounds.

On the card (`cuda`): a capture frame and a replay frame record equal
per-launch counts, and no span, count or launch is recorded while a
stream captures.

    python -m pytest tests/test_torch_telemetry.py -q
    python -m pytest --noconftest -m cuda tests/test_torch_telemetry.py -q
"""

import numpy as np
import pytest
import torch

import glome_tpu_torch as T
from glome_tpu_torch import telemetry as TM
from glome_tpu_torch.graphs import COMPILED, EAGER
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

@pytest.mark.parametrize("frame", [COMPILED, EAGER])
def test_one_record_per_renderer_call(scene, cfg, frame):
    compiled, arrays, cam = scene
    view = T.Renderer(T.WavefrontTracer(compiled, cfg, frame=frame), cam,
                      cfg)
    before = _last()
    view.render(arrays)
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
