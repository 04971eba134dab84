"""The frame-profiling tool (glome_tpu_torch/tools/profile_frame.py) on
the CPU: every stage a path reaches fires, the frame with the stages
wrapped is bit-equal to the frame without them, every wrapped name
holds its original object again afterwards, the wrappers' launch
counters split by stage add up to the path's counts, the rows'
exclusive host times add up to the root stage's inclusive time, a
missing or unlisted stage target raises, and the command line runs on
the CPU with "not measured" where a device number would stand.  The
device attribution (which stage launched each device op) is held on
synthetic profiler spans, since this machine has no card.

TestScene at 48x32 on both routes, a 400-triangle mesh routed through
K2 or K3 on the megakernel route, the AA frame and a config 5 step at
48x32."""

import os
import subprocess
import sys

import pytest
import torch

import glome_tpu_torch as T
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch.intersect import GROUPS, MEGA
from glome_tpu_torch import scenes
from glome_tpu_torch.tools import profile_frame as PF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = ("K1", "K2", "K3", "K4", "K5")


@pytest.fixture(scope="module")
def testscene():
    solid, lights, cam = scenes.test_scene()
    compiled = T.compile_scene(solid, lights)
    return compiled, T.to_torch(compiled.arrays(), "cpu"), cam


def _sites():
    """{(stage, site): the object the site holds now}."""
    out = {}
    for st in PF.STAGES:
        for site in st.sites:
            h, a = PF._resolve(site)
            out[st.name, site] = (h.__dict__[a] if isinstance(h, type)
                                  else getattr(h, a))
    return out


def _check(w, sp, want):
    """The checks every path shares; `want` = {counter: calls}."""
    missing = [s for s in w.stages if s not in sp.fired]
    assert not missing, missing
    stages = sp.stage_rows()
    for name in want.keys() | {f"{k} plain" for k in K}:
        per_stage = sum(r.counts[name] for r in stages)
        assert per_stage == sp.counts[name] == want.get(name, 0), name
    assert sp.row(PF.OUTSIDE).counts == dict.fromkeys(sp.counts, 0)
    assert all(sp.counts[k] == 0 for k in K)      # CPU: plain calls only
    # exclusive host times partition the root stage's inclusive time
    roots = [r for r in stages if r.stage == w.stages[0]]
    assert len(roots) == 1 and roots[0].calls == 1
    assert sum(r.self_ns for r in stages) == roots[0].host_ns
    assert sum(r.self_ns for r in sp.rows) == round(sp.wall_ms * 1e6)
    assert all(r.device_ms is None and not r.ops for r in sp.rows)
    assert sp.device_ms is None and sp.busy_ms is None


@pytest.mark.parametrize("route", [MEGA, GROUPS])
def test_frame_split(testscene, route):
    compiled, arrays, cam = testscene
    cfg = T.RenderConfig.tuned(xres=48, yres=32)
    w = PF.frame_workload("frame", compiled, arrays, cam, cfg, route)
    before = _sites()
    ref = w.run()
    sp = PF.split(w.run, "cpu")
    now = _sites()
    assert all(now[k] is before[k] for k in before)
    assert PF._same_frames(sp.result, ref)[0]
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
        # K5 runs in bvh_dispatch, one row per group and level
        rows = [r for r in sp.stage_rows() if r.stage == "bvh_dispatch"]
        assert {r.level for r in rows} == {0, 1, 2}
        assert all(r.counts["K5 plain"] == 2 and r.group.startswith("0.g")
                   for r in rows)
    _check(w, sp, want)
    levels = {r.level for r in sp.rows
              if r.stage == "WavefrontTracer._down_level"}
    assert levels == {0, 1, 2}
    lines = PF.table(sp)
    assert any(PF.NOT_MEASURED in ln for ln in lines)


def test_recursive_tracer_split(testscene):
    compiled, arrays, cam = testscene
    cfg = T.RenderConfig.tuned(xres=48, yres=32)
    w = PF.frame_workload("tracer", compiled, arrays, cam, cfg, MEGA,
                          recursive=True)
    ref = w.run()
    sp = PF.split(w.run, "cpu")
    assert PF._same_frames(sp.result, ref)[0]
    _check(w, sp, {"K1 plain": w.tracer.last_batches})
    # the recursion's depth labels its rows
    assert {r.level for r in sp.rows if r.stage == "Tracer._trace"} \
        == set(range(cfg.maxdepth))


@pytest.mark.parametrize("route,kernel", [
    (dict(MEGA_EXT_MIN=8, BLOCK_MIN=8), "K2"),
    (dict(MEGA_EXT_MIN=8, BLOCK_VMEM_MAX=0), "K3")])
def test_mesh_split(monkeypatch, route, kernel):
    for k, v in route.items():
        monkeypatch.setattr(MK, k, v)
    solid, lights, cam = scenes.mesh_scene(400, cast_shadows=True)
    compiled = T.compile_scene(solid, lights)
    arrays = T.to_torch(compiled.arrays(), "cpu")
    cfg = T.RenderConfig(xres=64, yres=36, maxdepth=1)
    w = PF.frame_workload("mesh", compiled, arrays, cam, cfg, MEGA)
    ref = w.run()
    sp = PF.split(w.run, "cpu")
    assert PF._same_frames(sp.result, ref)[0]
    _check(w, sp, {"K1 plain": 2, f"{kernel} plain": 2})
    row = sp.row("_run_blocks" if kernel == "K2" else "_run_external", 0)
    assert row.calls == 2 and row.counts[f"{kernel} plain"] == 2


def test_aa_split(testscene):
    compiled, arrays, cam = testscene
    cfg = T.RenderConfig.tuned(xres=48, yres=32)
    w = PF.aa_workload("aa", compiled, arrays, cam, cfg, MEGA)
    ref = w.run()
    sp = PF.split(w.run, "cpu")
    assert PF._same_frames(sp.result, ref)[0]
    aa_row = sp.row("AARenderer._masked_trace")
    assert aa_row.calls == 5
    traced = sp.row("AARenderer._trace_pixels").calls
    _check(w, sp, {"K1 plain": 2 * cfg.maxdepth * traced})


def test_config5_split(testscene):
    compiled, arrays, cam = testscene
    w = PF.config5_workload(compiled, arrays, cam, 48, 32)
    ref = w.run()
    sp = PF.split(w.run, "cpu")
    ok, text = w.same(sp.result, ref)
    assert ok, text
    _check(w, sp, {"K1 plain": 6})
    for stage in ("backward", "Adam.step", "optimize._save"):
        row = sp.row(stage)
        assert row.calls == 1 and row.host_ns > 0, stage


def test_staged_restores_after_an_error(testscene):
    before = _sites()
    with pytest.raises(RuntimeError, match="inside"):
        with PF.staged():
            assert all(a is not b for a, b in
                       zip(_sites().values(), before.values()))
            # a kernel wrapper's launch counter stays the original's
            MK.mega_select.launches += 1
            MK.mega_select.launches -= 1
            raise RuntimeError("inside")
    now = _sites()
    assert all(now[k] is before[k] for k in before)


@pytest.mark.parametrize("stage,error", [
    (PF.Stage("gone", ("glome_tpu_torch.megakernel:pack_tabels",)),
     AttributeError),
    (PF.Stage("gone", ("glome_tpu_torch.render:Renderer.rendr",)),
     AttributeError),
    # a method the class inherits: patch it where it is defined
    (PF.Stage("inherited",
              ("glome_tpu_torch.trace_wavefront:"
               "WavefrontTracer._fold_textures",)), AttributeError),
    # trace.py and trace_wavefront.py read it by name: both must be listed
    (PF.Stage("unlisted", ("glome_tpu_torch.intersect:"
                           "intersect_multi_table",)), LookupError),
    (PF.Stage("mixed", ("glome_tpu_torch.intersect:intersect_multi",
                        "glome_tpu_torch.trace:intersect")), ValueError)])
def test_missing_target_raises(stage, error):
    before = _sites()
    with pytest.raises(error):
        with PF.staged((stage,)):
            pass
    now = _sites()
    assert all(now[k] is before[k] for k in before)


def test_attribute_partitions_device_ops():
    """Each op goes to the innermost stage range whose host span holds
    its launch; ops launched outside every range, or with no host launch
    found, to none; busy time is the union of device spans."""
    D = PF.DeviceOp
    ranges = [(0, 100, 0), (10, 40, 1), (20, 30, 2), (50, 60, 3),
              (200, 300, 4)]
    ops = [D("a", 0, 5, 25), D("b", 5, 9, 35), D("c", 8, 12, 45),
           D("d", 20, 30, 55), D("e", 30, 31, 150), D("f", 31, 32, None),
           D("g", 40, 41, 5), D("h", 41, 42, 300), D("i", 50, 60, 10)]
    assert PF.attribute(ops, ranges) == [2, 1, 0, 3, None, None, 0, 4, 1]
    assert PF.busy_ms(ops) == pytest.approx(
        ((12 - 0) + (32 - 20) + (42 - 40) + (60 - 50)) / 1e6)
    assert PF.busy_ms([]) == 0.0
    assert PF.kernel_base("void block_select_kernel<false>(float const*, "
                          "int)") == "block_select_kernel"


def test_main_on_the_cpu(capsys):
    rc = PF.main(["--scene", "test", "--route", "mega", "--xres", "32",
                  "--yres", "24", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[cpu]" in out and "device busy not measured" in out
    assert "bit-equal to the unprofiled frame: True" in out
    rows = [ln for ln in out.splitlines()
            if ln.strip().startswith(("mega_select ", "finalize "))]
    assert rows and all(PF.NOT_MEASURED in ln for ln in rows)


@pytest.mark.parametrize("aa", [False, True])
def test_compiled_frame_report(testscene, aa):
    compiled, arrays, cam = testscene
    cfg = T.RenderConfig.tuned(xres=48, yres=32)
    name, run, eager, tracer = PF.compiled_workload(
        "compiled", compiled, arrays, cam, cfg, aa)
    rep = PF.profile_compiled(name, run, eager, tracer, "cpu")
    # on the CPU the static-width levels run eagerly: nothing captured,
    # the plain versions stand in, no device number
    assert rep.same and rep.busy_ms is None and rep.kernel_ms is None
    assert rep.per_frame == {"captures": 0, "replays": 0, "host_reads": 0}
    assert all(rep.counts[k] == 0 for k in K)
    # two K1 batches a level of every trace (the AA frame traces up to 5)
    per_trace = 2 * cfg.maxdepth
    n = rep.counts["K1 plain"]
    assert n == per_trace if not aa else (n % per_trace == 0 and n > 0)
    if not aa:
        assert tracer.last_frame["widths"][0] == 48 * 32
    # the replay frame split by the program's spans; no device number
    names = [r[0] for r in rep.spans]
    assert names[0] == ("aa.frame" if aa else "wavefront.trace")
    assert "wavefront.count_read" in names
    assert all(r[4] is None and r[2] >= r[3] >= 0 for r in rep.spans)
    assert 0 < rep.lanes["k1.live_lanes"] < rep.lanes["k1.lanes"]


def test_main_compiled_frame_on_the_cpu(capsys):
    rc = PF.main(["--scene", "test", "--xres", "32", "--yres", "24",
                  "--device", "cpu", "--frame", "compiled"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "compiled frame: replay" in out and "device busy not measured" \
        in out
    assert "every compiled frame equal to the eager frame: True" in out
    assert "the program's spans in that frame" in out
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
