"""The port's benchmark report (glome_tpu_torch/tools/bench.py) against
the repository's bench.py and glome_tpu on the CPU, through the kernels'
plain versions, at small sizes.

- The headline's and the mesh's rays are the rays bench.py's lines
  build (bench.py:67-73, :239-243) with glome_tpu's render.tile_order
  and Renderer.rays_for_pixels on the same camera: atol 1e-6 (the same
  float32 arithmetic in another framework).
- The headline's warm-up frame at 90x60 lies within test_golden.py's
  drift canaries of tests/golden/testscene_90x60_cpu.png (the bench's
  own gate).
- bench_aa on test_torch_aa.py's 64x64 scene traces glome_tpu's
  per-pass ray counts.
- main's JSON line holds every key bench.py's line has, and every timed
  reading is positive.
- A 200-second frame reads as a positive rate from the sections; only
  main's printed line rounds it to bench.py's 4 decimals (0.0).
- A frame with one tile zeroed, an extra plain call or a reported
  overflow, and a section that raises, each make main exit 1; the keys
  of the failed section are absent and the others present.

main runs with its TestScene swapped for test_torch_aa.py's 64x64 scene
(a sphere over a plane, its own golden: glome_tpu's frame of it) and a
1,500-triangle mesh at 64x32 routed through K2 (the size thresholds
lowered as in test_torch_mesh.py), so that one run takes seconds.
"""

import ast
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import glome_tpu as G
from glome_tpu.aa import AARenderer as JAARenderer
from glome_tpu.render import Renderer as JRenderer
from glome_tpu.render import tile_order as j_tile_order
from glome_tpu.scenes import test_scene as j_test_scene
from glome_tpu.scenes.meshscene import mesh_scene as j_mesh_scene

import glome_tpu_torch as T
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch.config import INFINITY
from glome_tpu_torch.io import write_png
from glome_tpu_torch.scenes import mesh_scene
from glome_tpu_torch.scenes import test_scene as t_test_scene
from glome_tpu_torch.tools import bench

from test_torch_aa import _cfg, _scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# main's sizes here: the mesh small enough for the plain versions, its
# side a multiple of bench.MESH_STEP
SIZES = dict(mesh_tris=1500, mesh_xres=64, mesh_yres=32)


def bench_py_keys():
    """Every key of bench.py's JSON line: the keys of the dict it dumps
    and of the dicts its sections return, the mesh's f-string keys with
    both tags."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    dicts = [n.value for n in ast.walk(tree)
             if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    dicts += [n.args[0] for n in ast.walk(tree)
              if isinstance(n, ast.Call) and getattr(n.func, "attr", "")
              == "dumps" and isinstance(n.args[0], ast.Dict)]
    keys = set()
    for d in dicts:
        for k in d.keys:
            if isinstance(k, ast.Constant):
                keys.add(k.value)
            elif isinstance(k, ast.JoinedStr):
                keys |= {"".join(v.value if isinstance(v, ast.Constant)
                                 else tag for v in k.values)
                         for tag in bench.MESH_TAGS}
    return keys


# -- the rays ---------------------------------------------------------------------

@pytest.mark.parametrize("which", ["testscene", "mesh"])
def test_rays_are_bench_pys(which):
    if which == "testscene":
        jcam, cam = j_test_scene()[2], t_test_scene()[2]
        jcfg = G.RenderConfig.tuned(xres=72, yres=48)
        cfg = T.RenderConfig.tuned(xres=72, yres=48)
    else:
        jcam, cam = j_mesh_scene(1500)[2], mesh_scene(1500)[2]
        jcfg = G.RenderConfig(xres=72, yres=48, maxdepth=1)
        cfg = T.RenderConfig(xres=72, yres=48, maxdepth=1)
    # bench.py:67-73 (and :239-243)
    ys, xs = np.mgrid[0:jcfg.yres, 0:jcfg.xres]
    perm = j_tile_order(jcfg.xres, jcfg.yres)
    jo, jd = JRenderer(None, jcam, jcfg).rays_for_pixels(
        xs.reshape(-1)[perm].astype(np.float32),
        ys.reshape(-1)[perm].astype(np.float32))
    o, d, p = bench.frame_rays(T.Renderer(None, cam, cfg), CPU)
    np.testing.assert_array_equal(p, perm)
    assert o.shape == d.shape == (72 * 48, 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


# -- the headline on TestScene -----------------------------------------------------

def test_headline_warmup_frame_within_golden_canaries(capsys):
    """bench_frame at 90x60 passes its gates: 6 K1 selections through
    the plain version, zero overflow, and the warm-up frame within the
    canaries of tests/golden/testscene_90x60_cpu.png."""
    scene = bench.testscene(CPU, 90, 60)
    assert bench.golden_path(scene.cfg).endswith(
        os.path.join("tests", "golden", "testscene_90x60_cpu.png"))
    stats = bench.bench_frame(CPU, scene, reps=1)
    err = capsys.readouterr().err
    print(err)
    assert "canaries" in err and "-> ok" in err
    assert tuple(stats) == bench.HEADLINE_KEYS
    assert stats["metric"] == "TestScene_720x480_depth3_primary_Mrays_per_s"
    assert stats["value"] > 0 and stats["compile_s"] > 0
    assert stats["compile_cache"] in ("cold", "warm")


# -- main on the small scene -------------------------------------------------------

def simple_scene(tracer_cls=None):
    """test_torch_aa.py's scene at 64x64, depth 2, as the headline's
    set-up."""
    solid, lights, cam = _scene(T)
    compiled = T.compile_scene(solid, lights)
    cfg = _cfg(T)
    tracer = (tracer_cls or T.WavefrontTracer)(compiled, cfg)
    return bench.Scene(compiled, T.to_torch(compiled.arrays(), CPU), cam,
                       cfg, tracer, 0.0)


@pytest.fixture(scope="module")
def simple_golden(tmp_path_factory):
    """glome_tpu's CPU frame of test_torch_aa.py's scene, as a PNG."""
    solid, lights, cam = _scene(G)
    compiled = G.compile_scene(solid, lights)
    cfg = _cfg(G)
    rgb, _depth = JRenderer(G.WavefrontTracer(compiled, cfg), cam,
                            cfg).render(compiled.arrays())
    path = str(tmp_path_factory.mktemp("bench") / "simple_64x64.png")
    write_png(path, np.asarray(rgb))
    return path


def run_main(mp, golden, tracer_cls=None, **sizes):
    """main(['--device', 'cpu']) with the small scene and mesh: (exit
    code, the JSON line as a dict, stderr)."""
    mp.setattr(bench, "testscene",
               lambda device, xres, yres: simple_scene(tracer_cls))
    mp.setattr(bench, "golden_path", lambda cfg: golden)
    # the mesh group through K2 (test_torch_mesh.py's "blocks" route)
    mp.setattr(MK, "MEGA_EXT_MIN", 8)
    mp.setattr(MK, "BLOCK_MIN", 8)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(["--device", "cpu"], **{**SIZES, **sizes})
    lines = out.getvalue().splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0]), err.getvalue()


@pytest.fixture(scope="module")
def good(simple_golden):
    with pytest.MonkeyPatch.context() as mp:
        return run_main(mp, simple_golden, reps=3)


def test_main_line_holds_bench_py_keys(good):
    rc, line, err = good
    print(err)
    assert rc == 0
    want = bench_py_keys()
    assert set(bench.KEYS) == want
    assert list(line) == list(bench.KEYS) + list(bench.DEVICE_KEYS)
    assert line["backend"] == "cpu" and line["device"] == "cpu"
    assert line["power_limit_w"] is None
    assert line["unit"] == "Mrays/s"
    assert line["compile_cache"] in ("cold", "warm")
    assert line["aa_compile_cache"] in ("cold", "warm")


def test_every_timed_reading_is_positive(good):
    rc, line, err = good
    assert rc == 0
    timed = [k for k in line if k.endswith(("_ms_per_frame", "_Mrays_per_s",
                                            "compile_s"))]
    assert len(timed) == 8
    for k in timed + ["value", "vs_baseline"]:
        assert line[k] > 0, (k, line[k])
    frames = [ln for ln in err.splitlines() if " frames ms: " in ln]
    assert len(frames) == 4, frames
    for ln in frames:
        ms = [float(v) for v in ln.split(" frames ms: ")[1].split(", ")]
        assert len(ms) == 3 and min(ms) > 0, ln
    assert 1 / 8 <= line["aa_rays_per_px"] <= 2


def test_aa_counts_are_glome_tpus(monkeypatch):
    """bench_aa at 64x64 traces glome_tpu's per-pass ray counts
    (test_torch_aa.py:105), and reports their sum per pixel."""
    solid, lights, cam = _scene(G)
    compiled = G.compile_scene(solid, lights)
    cfg = _cfg(G)
    jaa = JAARenderer(G.WavefrontTracer(compiled, cfg), cam, cfg)
    jaa.render(compiled.arrays())
    want = {k: int(v) for k, v in jaa.last_ray_counts.items()}
    counts = []

    class Recorded(T.AARenderer):
        def render(self, arrays):
            out = super().render(arrays)
            counts.append(dict(self.last_ray_counts))
            return out
    monkeypatch.setattr(T, "AARenderer", Recorded)
    stats = bench.bench_aa(CPU, simple_scene(), reps=1)
    # the warm-up frame's; the timed frame's lights are jittered
    print(f"bench_aa counts {counts}, glome_tpu {want}")
    assert len(counts) == 2
    assert counts[0] == want
    assert tuple(stats) == bench.AA_KEYS
    assert stats["aa_rays_per_px"] == sum(want.values()) / (64 * 64)


def test_slow_frame_reads_positive_until_printed(monkeypatch,
                                                simple_golden):
    """Every frame timed at 200 s (the frame timer monkeypatched): the
    headline's rate from bench_frame is 4,096 rays / 200 s, positive;
    main's printed line rounds it, and the mesh's and AA's rates, to
    bench.py's 4 decimals, 0.0."""
    monkeypatch.setattr(bench, "golden_path", lambda cfg: simple_golden)
    monkeypatch.setattr(bench, "time_frames",
                        lambda frame, device, reps: [200_000.0] * reps)
    stats = bench.bench_frame(CPU, simple_scene(), reps=1)
    assert stats["value"] == 64 * 64 / 200_000.0 / 1e3
    assert stats["value"] > 0 and stats["vs_baseline"] > 0
    assert bench.printed(stats)["value"] == 0.0
    rc, line, err = run_main(monkeypatch, simple_golden, reps=1)
    print(err)
    assert rc == 0
    rates = ["value", "vs_baseline", "aa_720x480_Mrays_per_s"] + [
        bench.mesh_keys(tag)[1] for tag in bench.MESH_TAGS]
    assert all(line[k] == 0.0 for k in rates), {k: line[k] for k in rates}
    assert line["aa_720x480_ms_per_frame"] == 200_000.0


# -- mutants -------------------------------------------------------------------------

class ZeroTile(T.WavefrontTracer):
    """Zeroes the last 32x32 tile of every trace (its last 1,024 rays in
    tile order: the 64x64 frame's lower right quarter, floor and
    sphere)."""

    def trace(self, arrays, o, d, *a, **k):
        res = super().trace(arrays, o, d, *a, **k)
        color = res.color.clone()
        color[-1024:] = 0.0
        return res._replace(color=color)


class ExtraPlain(T.WavefrontTracer):
    """One more plain K1 call per trace, on one of its rays."""

    def trace(self, arrays, o, d, *a, **k):
        tables = MK.pack_tables(MK.get_plan(self.compiled), self.compiled,
                                arrays)
        ray = torch.cat([o[:1], d[:1]], dim=1).t()
        MK.mega_select_plain(tables, torch.cat(
            [ray, torch.tensor([[INFINITY], [0.0]])]).contiguous())
        return super().trace(arrays, o, d, *a, **k)


class Overflows(T.WavefrontTracer):
    """Reports one dropped ray in its first queue segment."""

    def trace(self, arrays, o, d, *a, **k):
        res = super().trace(arrays, o, d, *a, **k)
        overflow = res.overflow.clone()
        overflow[0] = 1
        return res._replace(overflow=overflow)


@pytest.mark.parametrize("mutant", [ZeroTile, ExtraPlain, Overflows],
                         ids=lambda m: m.__name__)
def test_headline_mutant_exits_1(monkeypatch, simple_golden, mutant):
    rc, line, err = run_main(monkeypatch, simple_golden, tracer_cls=mutant,
                             reps=1)
    print(err)
    assert rc == 1
    assert "headline" in err.split("BENCH SECTIONS FAILED")[1]
    assert not set(bench.HEADLINE_KEYS) & set(line)
    for tag in bench.MESH_TAGS:
        assert set(bench.mesh_keys(tag)) <= set(line)


def test_section_that_raises_exits_1(monkeypatch, simple_golden):
    real = bench.bench_mesh

    def bench_mesh(device, cast_shadows=False, tag="", **kw):
        if cast_shadows:
            raise RuntimeError("mutant: the self-shadowing mesh section")
        return real(device, cast_shadows, tag, **kw)
    monkeypatch.setattr(bench, "bench_mesh", bench_mesh)
    rc, line, err = run_main(monkeypatch, simple_golden, reps=1)
    assert rc == 1
    assert "mutant: the self-shadowing mesh section" in err
    gone = set(bench.mesh_keys("_meshshadow"))
    assert not gone & set(line)
    assert list(line) == [k for k in bench.KEYS if k not in gone] + list(
        bench.DEVICE_KEYS)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
