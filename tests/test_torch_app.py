"""The port's CLI (python -m glome_tpu_torch.app) on the CPU against
glome_tpu's (glome_tpu.app.main) on the same argv.

glome_tpu's app runs where its CPU compile is quick: the simple scene
at 48x32, the two NFF fixtures at their own 96x64, and the work maps.
Its TestScene compile takes minutes on the CPU, so the TestScene picks
are held to the port's own pick() and to the tags of the objects under
those pixels.  glome_tpu's persistent executable cache is swapped for a
plain jax.jit, so its runs write nothing outside the test's directory.

Tolerances, on the written PNGs: the simple scene, gears.nff and both
work maps equal glome_tpu's byte for byte; miniflake.nff lies within
the drift canaries (test_golden.py:129-131: mean <= 3 levels, <= 0.6%
of pixels off by more than 64) with only its centre row differing (the
edge ties test_torch_spd.py explains).  --aa is held to glome_tpu's
AARenderer (its app crashes after an AA render: `np.asarray` of the
overflow dict is 0-d, and the warning iterates it): equal ray counts
and the same PNG bytes.
"""

import io
import os

import numpy as np
import jax
import pytest
import torch

from glome_tpu_torch import app
from glome_tpu_torch.io import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
SMALL = ["--xres", "48", "--yres", "32"]


def _canaries(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(axis=-1)
    return float(diff.mean()), float((diff > 64).mean()), diff


@pytest.fixture
def jax_app(monkeypatch):
    import glome_tpu.app as JA
    import glome_tpu.cache as JC
    monkeypatch.setattr(JC, "cached_jit",
                        lambda tag, fn, *args: (jax.jit(fn), "cold"))
    return JA.main


def _both(argv, tmp_path, jax_app, capsys):
    """Run both CLIs on argv + --out; returns (port result, port png,
    glome_tpu png, port stdout, glome_tpu stdout)."""
    pt, pj = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    res = app.main(argv + ["--out", pt, "--device", "cpu"])
    out_t = capsys.readouterr().out
    jax_app(argv + ["--out", pj])
    out_j = capsys.readouterr().out
    return res, read_png(pt), read_png(pj), out_t, out_j


def _lines(text):
    """The output lines without timings."""
    return [l for l in text.splitlines()
            if not l.startswith(("scene setup", "render", "write",
                                 "debug render"))]


@pytest.mark.parametrize("scene", ["simple", "miniflake.nff", "gears.nff"])
def test_render_matches_glome_tpu_app(scene, tmp_path, jax_app, capsys):
    argv = (["--scene", "simple", *SMALL, "--iters", "2"] if scene == "simple"
            else ["--scene", os.path.join(FIX, scene)])
    res, got, want, out_t, out_j = _both(argv, tmp_path, jax_app, capsys)
    assert _lines(out_t) == _lines(out_j)       # the primcount line
    assert len(res["render_s"]) == (2 if scene == "simple" else 1)
    assert res["overflow"] == {}
    assert got.shape == want.shape == (
        (32, 48, 3) if scene == "simple" else (64, 96, 3))
    mean, frac, diff = _canaries(got, want)
    print(f"{scene}: {int((diff > 0).sum())}/{diff.size} pixels differ, "
          f"canaries mean {mean:.4f} levels, {100 * frac:.4f}% > 64")
    if scene == "miniflake.nff":
        assert mean <= 3.0 and frac <= 0.006
        assert set(np.nonzero(diff)[0].tolist()) <= {32}
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flag", ["--debug", "--debug-full"])
def test_work_maps_match_glome_tpu_app(flag, tmp_path, jax_app, capsys):
    res, got, want, out_t, out_j = _both(
        ["--scene", "simple", *SMALL, flag], tmp_path, jax_app, capsys)
    np.testing.assert_array_equal(got, want)
    # the per-ray means and maxima printed on the debug render line
    tail = [l.split(";", 1)[1] for l in (out_t + out_j).splitlines()
            if l.startswith("debug render")]
    assert len(tail) == 2 and tail[0] == tail[1]
    assert res["prims"].shape == (32, 48) and res["prims"].max() > 0


def test_aa_matches_glome_tpu(tmp_path, capsys):
    import glome_tpu as G
    from glome_tpu.aa import AARenderer
    from glome_tpu.io import quantize
    from glome_tpu.scenes import simple_scene
    from glome_tpu.scenes.testscene import cust_cam, lights
    res = app.main(["--scene", "simple", *SMALL, "--aa", "--device", "cpu",
                    "--out", str(tmp_path / "aa.png")])
    compiled = G.compile_scene(simple_scene(), lights())
    cfg = G.RenderConfig.tuned(xres=48, yres=32, maxdepth=3)
    aa = AARenderer(G.WavefrontTracer(compiled, cfg), cust_cam(), cfg)
    rgb, _ = aa.render(compiled.arrays())
    assert res["ray_counts"] == aa.last_ray_counts
    assert res["overflow"] == {}
    np.testing.assert_array_equal(read_png(str(tmp_path / "aa.png")),
                                  quantize(np.asarray(rgb)))


# TestScene pixels over each tagged object at 720x480 (and a miss)
PICKS = {(136, 204): ["dodecahedron"], (488, 268): ["icosahedron"],
         (392, 124): ["tree"], (200, 192): ["door frame"], (0, 0): []}


def test_pick_names_the_tagged_objects(capsys):
    from glome_tpu_torch.pick import pick
    for (x, y), tags in PICKS.items():
        res = app.main(["--pick", str(x), str(y), "--device", "cpu"])
        lines = capsys.readouterr().out.splitlines()
        assert res["tags"] == tags, (x, y)
        assert lines[-1 - len(tags):] == [f"{x} {y}:"] + tags
    # the CLI's pick is pick() on the CLI's own tracer and camera
    import glome_tpu_torch as T
    from glome_tpu_torch.scenes import test_scene
    solid, lights, cam = test_scene()
    compiled = T.compile_scene(solid, lights)
    tracer = T.WavefrontTracer(compiled, T.RenderConfig.tuned())
    assert pick(tracer, cam, T.to_torch(compiled.arrays(), "cpu"),
                136, 204) == ["dodecahedron"]


def test_interactive_session(monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin",
                        io.StringIO("136 204\nnot a pick\n0 0\nq\n488 268\n"))
    app.main(["--interactive", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    i = lines.index("pick session: 'X Y' picks, 'q' quits")
    assert lines[i + 1].startswith("136 204: t=")
    assert lines[i + 1].endswith(" dodecahedron")
    assert lines[i + 2] == "? 'not a pick'"
    assert lines[i + 3] == "0 0: t=1000000.0000 serial=-1 (no tags)"
    assert len(lines) == i + 4                  # 'q' ended the session


def test_cuda_is_the_default_and_raises_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            app.main(argv + ["--scene", "simple", *SMALL,
                             "--out", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()
