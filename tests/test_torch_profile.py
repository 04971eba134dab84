"""The frame-profiling tool (glome_tpu_torch/tools/profile_frame.py) on
the CPU: each path's report holds the launches the path makes by the
kernel wrappers' counters, the spans that path opens, whose self times
with the "(outside any span)" row sum to the profiled wall, and "not
measured" in every device column; the compiled frame's report equals
the eager frame and captures nothing here; the command line runs on the
CPU and writes the profiler's trace file with --trace.  The device
columns (busy time while a span is open, clipped to its intervals) are
held on synthetic spans and device ops, since this machine has no card.

TestScene at 16x16 on both routes and through the recursive Tracer, a
400-triangle mesh routed through K2 or K3 on the megakernel route, the
AA frame, a config 5 step at 16x16, and SPD balls at size factor 2
through K2 on the compiled frame."""

import json
import os
import subprocess
import sys

import pytest
import torch

import glome_tpu_torch as T
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch import telemetry as TM
from glome_tpu_torch.intersect import GROUPS, MEGA
from glome_tpu_torch import scenes
from glome_tpu_torch.tools import profile_frame as PF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = ("K1", "K2", "K3", "K4", "K5")
# the frames' size: every path's launches and spans at the least cost
W, H = 16, 16
FRAME_SPANS = ["render.frame", "render.ray_setup", "wavefront.trace",
               "render.scatter", PF.OUTSIDE]


@pytest.fixture(autouse=True)
def _share_the_cores():
    # test processes running side by side (pytest-xdist's workers) share
    # the cores: oversubscribed, the frames' many small ops wait on one
    # another's threads (20-40x slower here)
    n = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def testscene():
    solid, lights, cam = scenes.test_scene()
    compiled = T.compile_scene(solid, lights)
    return compiled, T.to_torch(compiled.arrays(), "cpu"), cam


def _check(rep, want, out):
    """What every report on the CPU holds; `want` = {counter: calls},
    `out` the report as printed."""
    assert rep.counts == {**dict.fromkeys(rep.counts, 0), **want}
    assert all(rep.counts[k] == 0 for k in K)      # CPU: plain calls only
    # the spans' self times, with the time no span holds, are the wall
    assert rep.spans[-1].name == PF.OUTSIDE and rep.spans[-1].self_ns >= 0
    assert sum(r.self_ns for r in rep.spans) == rep.wall_ns
    assert all(r.host_ns >= r.self_ns >= 0 for r in rep.spans)
    assert rep.frame_ms is None and rep.busy_ms is None \
        and rep.kernel_ms is None
    assert all(r.busy_ms is None and not r.top for r in rep.spans)
    lines = out.splitlines()
    for r in rep.spans:
        row = [ln for ln in lines if ln.strip().startswith(r.name + " ")]
        assert len(row) == 1 and row[0].endswith(PF.NOT_MEASURED), r.name
    assert "device busy " + PF.NOT_MEASURED in out


@pytest.mark.parametrize("route", [MEGA, GROUPS])
def test_frame_split(testscene, route, capsys):
    compiled, arrays, cam = testscene
    cfg = T.RenderConfig.tuned(xres=W, yres=H)
    w = PF.frame_workload("frame", compiled, arrays, cam, cfg, route)
    rep = PF.profile(w, "cpu")
    b = w.tracer.last_batches
    assert b == 2 * cfg.maxdepth
    if route == MEGA:
        want = {"K1 plain": b}
    else:
        n_bvh = sum(g.accel_eligible and g.size > 0
                    and g.vclass not in ("deferred", "convex")
                    for sc in compiled.scenes for g in sc.groups)
        n_dense = sum(not g.accel_eligible and g.size > 0
                      and g.vclass not in ("deferred", "convex")
                      for sc in compiled.scenes for g in sc.groups)
        assert (n_dense, n_bvh) == (7, 2)
        want = {"K4 plain": n_dense * b, "K5 plain": n_bvh * b}
    _check(rep, want, capsys.readouterr().out)
    # the wavefront tracer opens its span on either route
    assert [r.name for r in rep.spans] == FRAME_SPANS
    assert all(rep.row(n).calls == 1 for n in FRAME_SPANS[:-1])
    assert rep.same is None and rep.per_frame is None


def test_recursive_tracer_split(testscene, capsys):
    compiled, arrays, cam = testscene
    cfg = T.RenderConfig.tuned(xres=W, yres=H)
    w = PF.frame_workload("tracer", compiled, arrays, cam, cfg, MEGA,
                          recursive=True)
    rep = PF.profile(w, "cpu")
    _check(rep, {"K1 plain": w.tracer.last_batches},
           capsys.readouterr().out)
    # the recursive Tracer opens no span: its time is render.frame's own
    assert [r.name for r in rep.spans] == [
        "render.frame", "render.ray_setup", "render.scatter", PF.OUTSIDE]
    frame = rep.row("render.frame")
    assert frame.self_ns > rep.row("render.ray_setup").host_ns


@pytest.mark.parametrize("route,kernel", [
    (dict(MEGA_EXT_MIN=8, BLOCK_MIN=8), "K2"),
    (dict(MEGA_EXT_MIN=8, BLOCK_VMEM_MAX=0), "K3")])
def test_mesh_split(monkeypatch, route, kernel, capsys):
    for k, v in route.items():
        monkeypatch.setattr(MK, k, v)
    solid, lights, cam = scenes.mesh_scene(400, cast_shadows=True)
    compiled = T.compile_scene(solid, lights)
    arrays = T.to_torch(compiled.arrays(), "cpu")
    cfg = T.RenderConfig(xres=64, yres=36, maxdepth=1)
    w = PF.frame_workload("mesh", compiled, arrays, cam, cfg, MEGA)
    rep = PF.profile(w, "cpu")
    _check(rep, {"K1 plain": 2, f"{kernel} plain": 2},
           capsys.readouterr().out)
    assert [r.name for r in rep.spans] == FRAME_SPANS
    if kernel == "K2":
        assert rep.program["k2.lanes"] >= rep.program["k2.live_lanes"] > 0


def test_aa_split(testscene, capsys):
    compiled, arrays, cam = testscene
    cfg = T.RenderConfig.tuned(xres=W, yres=H)
    w = PF.aa_workload("aa", compiled, arrays, cam, cfg, MEGA)
    rep = PF.profile(w, "cpu")
    traces = rep.row("wavefront.trace").calls
    assert traces == 5 and rep.row("aa.frame").calls == 1
    _check(rep, {"K1 plain": 2 * cfg.maxdepth * traces},
           capsys.readouterr().out)
    assert {r.name for r in rep.spans} == {
        "aa.frame", "aa.mask_planes", "aa.pass_setup", "wavefront.trace",
        "aa.variance", PF.OUTSIDE}


def test_config5_split(testscene, capsys):
    compiled, arrays, cam = testscene
    w = PF.config5_workload(compiled, arrays, cam, W, H)
    rep = PF.profile(w, "cpu")
    _check(rep, {"K1 plain": 6}, capsys.readouterr().out)
    # the step's trace is a record of its own; the soft pass, the
    # backward, Adam.step and the checkpoint open no span
    assert [r.name for r in rep.spans] == ["wavefront.trace", PF.OUTSIDE]
    assert rep.row("wavefront.trace").calls == 1
    assert rep.spans[-1].self_ns > 0


def test_attribute_partitions_device_ops():
    """Busy time is the union of device spans; a kernel's name is its
    base name; top_ops sums by base name, most time first."""
    D = PF.DeviceOp
    ops = [D("a", 0, 5), D("b", 5, 9), D("c", 8, 12), D("d", 20, 30),
           D("e", 30, 31), D("f", 31, 32), D("g", 40, 41), D("h", 41, 42),
           D("i", 50, 60)]
    assert PF.busy_ms(ops) == pytest.approx(
        ((12 - 0) + (32 - 20) + (42 - 40) + (60 - 50)) / 1e6)
    assert PF.busy_ms([]) == 0.0
    assert PF.kernel_base("void block_select_kernel<false>(float const*, "
                          "int)") == "block_select_kernel"
    two = [D("void k<1>(int)", 0, 4), D("void k<2>(int)", 10, 13),
           D("m", 0, 5)]
    assert PF.top_ops(two) == [("k", 7e-6, 2), ("m", 5e-6, 1)]


def _clock(monkeypatch, step):
    ticks = iter(range(0, 10 ** 15, step))
    monkeypatch.setattr(TM, "_ns", lambda: next(ticks))
    kept = TM.frames()
    return kept[-1].id if kept else -1


def _new(last):
    return [f for f in TM.frames() if f.id > last]


def test_nested_spans_partition_the_root(monkeypatch):
    last = _clock(monkeypatch, 10)
    with TM.frame("f"):
        with TM.span("a"):
            with TM.span("b"):
                pass
        with TM.span("c"):
            pass
    with TM.span("bare"):            # no span open: a record of its own
        pass
    recs = _new(last)
    roots = sum(r.sums[r.name][1] for r in recs)
    rows = PF.span_rows(recs, roots + 70)
    assert [r.name for r in rows] == ["f", "a", "b", "c", "bare", PF.OUTSIDE]
    by = {r.name: r for r in rows}
    assert by["f"].self_ns == (by["f"].host_ns - by["a"].host_ns
                               - by["c"].host_ns) > 0
    assert by["a"].self_ns == by["a"].host_ns - by["b"].host_ns > 0
    assert by["bare"].self_ns == by["bare"].host_ns > 0
    assert by[PF.OUTSIDE].self_ns == 70
    assert sum(r.self_ns for r in rows) == roots + 70
    assert all(r.calls == 1 for r in rows[:-1])
    assert all(r.busy_ms is None for r in rows)


def test_a_span_opened_twice_gets_the_union_of_its_intervals(monkeypatch):
    last = _clock(monkeypatch, 1000)
    with TM.frame("aa.frame"):                   # 1000-8000
        with TM.span("aa.pass_setup"):           # 2000-3000
            pass
        with TM.span("wavefront.trace"):         # 4000-5000
            pass
        with TM.span("aa.pass_setup"):           # 6000-7000
            pass
    f, = _new(last)
    assert [s[1:3] for s in f.spans] == [[1000, 8000], [2000, 3000],
                                         [4000, 5000], [6000, 7000]]
    u = f.to_unix
    ops = [PF.DeviceOp(n, u(a), u(b)) for n, a, b in (
        ("x", 500, 1200),       # 500 ns before the frame, 200 in it
        ("p", 1500, 2500),      # 500 in the first pass_setup
        ("q", 2200, 2400),      # inside p's: adds nothing to the union
        ("r", 4200, 4300),      # in the trace
        ("s", 5500, 6500),      # 500 in the second pass_setup
        ("t", 6800, 7500),      # 200 in it
        ("y", 8500, 9000))]     # after the frame
    rows = {r.name: r for r in PF.span_rows([f], 9000, ops)}
    assert rows["aa.pass_setup"].calls == 2
    assert rows["aa.pass_setup"].busy_ms == pytest.approx(1200 / 1e6)
    assert {n for n, _ms, _c in rows["aa.pass_setup"].top} == {"p", "q",
                                                               "s", "t"}
    assert rows["wavefront.trace"].busy_ms == pytest.approx(100 / 1e6)
    assert rows["aa.frame"].busy_ms == pytest.approx(
        (200 + 1000 + 100 + 1000 + 700) / 1e6)
    out = rows[PF.OUTSIDE]
    assert out.self_ns == 9000 - 7000
    assert out.busy_ms == pytest.approx(1000 / 1e6)
    assert [n for n, _ms, _c in out.top] == ["x", "y"]


def test_main_on_the_cpu(capsys):
    rc = PF.main(["--scene", "test", "--route", "mega", "--xres", str(W),
                  "--yres", str(H), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[cpu]" in out and "eager frame" in out \
        and "device busy not measured" in out
    rows = [ln for ln in out.splitlines()
            if ln.strip().startswith(("render.frame ", "wavefront.trace "))]
    assert len(rows) == 2 and all(ln.endswith(PF.NOT_MEASURED)
                                  for ln in rows)
    assert "'K1 plain': 6" in out


def test_main_trace_writes_the_spans(tmp_path, capsys):
    rc = PF.main(["--scene", "test", "--xres", str(W), "--yres", str(H),
                  "--device", "cpu", "--trace", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    path, = tmp_path.iterdir()
    assert str(path) in out and path.suffix == ".json"
    with open(path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert set(FRAME_SPANS[:-1]) <= names


@pytest.mark.parametrize("case", [False, True, "k2"])
def test_compiled_frame_report(testscene, case, monkeypatch, capsys):
    compiled, arrays, cam = testscene
    if case == "k2":
        # SPD balls at size factor 2: its 91 spheres routed to K2
        from glome_tpu_torch import spd
        from glome_tpu_torch.scenes.spd_balls import nff
        monkeypatch.setattr(MK, "BLOCK_MIN", 64)
        s = spd.parse(nff(2))
        compiled = T.compile_scene(s.geom, s.lights)
        arrays, cam = T.to_torch(compiled.arrays(), "cpu"), s.cam
        assert MK.get_plan(compiled).blocks
    aa = case is True
    cfg = T.RenderConfig.tuned(xres=W, yres=H)
    w = PF.compiled_workload("compiled", compiled, arrays, cam, cfg, aa)
    rep = PF.profile(w, "cpu")
    out = capsys.readouterr().out
    # on the CPU the static-width levels run eagerly: nothing captured,
    # the plain versions stand in, no device number
    assert rep.same and "equal to the eager frame: True" in out
    assert rep.per_frame == {"captures": 0, "replays": 0, "host_reads": 0}
    assert rep.pool_bytes == 0
    # two K1 batches a level of every trace (the AA frame traces 5)
    per_trace = 2 * cfg.maxdepth
    n = rep.counts["K1 plain"]
    _check(rep, {"K1 plain": n, "K2 plain": rep.counts["K2 plain"]}, out)
    assert n == (5 * per_trace if aa else per_trace)
    if not aa:
        assert w.tracer.last_frame["widths"][0] == W * H
    # the replay frame split by the program's spans
    names = [r.name for r in rep.spans]
    assert names[0] == ("aa.frame" if aa else "wavefront.trace")
    # a level's one host read, where the level spawns child rays (the
    # flake spawns none)
    assert ("wavefront.count_read" in names) == (case != "k2")
    assert 0 < rep.program["k1.live_lanes"] < rep.program["k1.lanes"]
    if case == "k2":
        # one K2 call a batch, beside K1's, its dead lanes counted
        assert rep.counts["K2 plain"] == per_trace
        assert 0 < rep.program["k2.live_lanes"] < rep.program["k2.lanes"]
        assert "K2 lanes launched" in out
    else:
        assert rep.counts["K2 plain"] == 0


def test_main_compiled_frame_on_the_cpu(capsys):
    rc = PF.main(["--scene", "test", "--xres", str(W), "--yres", str(H),
                  "--device", "cpu", "--frame", "compiled"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "compiled frame:" in out and "device busy not measured" in out
    assert "every compiled frame equal to the eager frame: True" in out
    assert "the program's spans" in out
    with pytest.raises(SystemExit, match="megakernel route"):
        PF.main(["--scene", "test", "--route", "groups", "--device", "cpu",
                 "--frame", "compiled"])


def test_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PF.main(["--scene", "test"]) == 2
    assert capsys.readouterr().out == ""


def test_imports_neither_jax_nor_glome_tpu():
    code = ("import sys; import glome_tpu_torch.tools.profile_frame; "
            "print([m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'glome_tpu', 'tools')])")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
