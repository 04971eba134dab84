"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and manifest entries in a copy of the benchmark are found by
name and run, with no file that was there edited: one on TestScene, one
with a scene of its own (the program's scene module, the reference's
scenes/<builder>.py and a background).  TestScene reads as it did before
its description moved to a file of its own."""

import dataclasses
import hashlib
import json
import os
import shutil
import sys
import time
import types

import numpy as np
import pytest
import torch

from benchmark.harness import core
from benchmark.harness import manifest as M
from benchmark.harness import traffic as TR
from benchmark.reference import Reference


def digest(root):
    out = {}
    for d, _dirs, files in os.walk(os.path.join(root, "benchmark")):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def write(path, obj):
    with open(path, "w") as f:
        if isinstance(obj, str):
            f.write(obj)
        else:
            json.dump(obj, f)


def copy_benchmark(root):
    shutil.copytree(os.path.join(M.ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(M.ROOT, "BENCHMARK.json"), root)
    return digest(root)


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    before = copy_benchmark(root)

    conf = M.config(M.load(root), "testscene", root)
    conf.update(name="testscene_small", xres=24, yres=16,
                reduced=["xres", "yres"])
    write(os.path.join(root, "benchmark/configs/testscene_small.json"), conf)
    mix = dict(M.traffic("still", root), warmup_frames=1, check_from_first=1,
               check_frames=1, check_pixels=32)
    write(os.path.join(root, "benchmark/traffic/still_short.json"), mix)
    write(os.path.join(root, "benchmark/limits/small-still.json"),
          M.limits("testscene-still", root))
    write(os.path.join(root, "benchmark/metrics/harness.frames_seen.py"),
          "def read(run):\n    return float(run.frames)\n")

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"].append({"name": "testscene_small", "source":
                           conf["source"], "file":
                           "benchmark/configs/testscene_small.json",
                           "reduced": ["xres", "yres"], "why": "a test"})
    man["workloads"].append({"name": "small-still",
                             "config": "testscene_small",
                             "traffic": "still_short", "chips": 1,
                             "why": "a test"})
    man["per_layer"].append({"name": "harness.frames_seen", "unit": "frames",
                             "better": "higher", "source": "host_clock",
                             "layer": "harness", "moves": "setup_s",
                             "workloads": ["small-still"]})
    write(os.path.join(root, "BENCHMARK.json"), man)

    args = core.parse(["--workload", "small-still", "--seed", "9",
                       "--seconds", "0.2", "--trace", "1"])
    out = core.run(args, time.perf_counter(), device=torch.device("cpu"),
                   root=root)
    assert out["correct"] is True
    assert out["metrics"]["harness.frames_seen"]["value"] >= 1
    after = digest(root)
    assert all(after[k] == v for k, v in before.items())


# --- a configuration with a scene of its own --------------------------------

GEARS = os.path.join(M.ROOT, "tests", "fixtures", "gears.nff")
GEARS_SKY = [0.05, 0.05, 0.08]

# tests/fixtures/gears.nff as plain nodes: its quad and triangle (`p`) in
# the first fill, its smooth patch (`pp`) in the transmissive second.  Its
# one light faces the back of every surface (their normals point down, or
# away from it), so both sides add two bright lights, below and behind,
# which light their fronts: the shading of both kinds is compared too.
GEARS_REFERENCE = """
from benchmark.reference.scene import (Group, Light, Tex, camera, surface,
                                       triangles, trianglesnorms)


def build():
    quad = triangles([(-1.5, 0, -1.5), (1.5, 0, -1.5), (1.5, 0.4, 1.5),
                      (-1.5, 0.4, 1.5)])
    tri = triangles([(-1.2, 0.41, -1.2), (1.2, 0.41, -1.2), (0, 0.41, 1.2)])
    patch = trianglesnorms([((-1, 1.2, 0), (0, 0.2, -1)),
                            ((1, 1.2, 0), (0.2, 0, -1)),
                            ((0, 2.2, 0.2), (-0.2, -0.2, -1))])
    first = ("uniform", surface((0.7, 0.7, 0.25), 1.0, 0.0, 0.8, 0.2, 10))
    second = ("uniform", surface((0.3, 0.6, 0.9), 0.6, 0.0, 0.6, 0.4, 30))
    root = Group([Tex(Group(quad + tri), first), Tex(Group(patch), second)])
    lights = (Light((3.0, 5.0, 3.0), (1.0, 1.0, 1.0)),
              Light((0.0, -5.0, -3.0), (40.0, 40.0, 40.0)),
              Light((0.0, 3.0, -6.0), (40.0, 40.0, 40.0)))
    return root, lights, camera((0, 2, 5), (0, 0, 0), (0, 1, 0), 45)
"""


def gears_program_module():
    """The program's scene module of the fixture: its builder parses the
    NFF file with the program's own reader."""
    def gears():
        from glome_tpu_torch import spd
        from glome_tpu_torch.materials import light
        s = spd.load(GEARS)
        more = (light((0.0, -5.0, -3.0), (40.0, 40.0, 40.0)),
                light((0.0, 3.0, -6.0), (40.0, 40.0, 40.0)))
        return s.geom, s.lights + more, s.cam
    mod = types.ModuleType("glome_tpu_torch.scenes.nff_gears")
    mod.gears = gears
    return mod


@pytest.fixture
def gears_checkout(tmp_path, monkeypatch):
    """A copy of the benchmark with the gears configuration and a cell
    that checks every pixel of a 48x32 frame, added as new files and
    entries only; (checkout, digests of the files that were there)."""
    monkeypatch.setitem(sys.modules, "glome_tpu_torch.scenes.nff_gears",
                        gears_program_module())
    root = str(tmp_path)
    before = copy_benchmark(root)
    conf = {"name": "gears", "source": "tests/fixtures/gears.nff",
            "scene": {"module": "nff_gears", "builder": "gears", "args": {}},
            "xres": 48, "yres": 32, "maxdepth": 3,
            "render_config": "default", "background": GEARS_SKY,
            "precision": "float32", "reduced": ["xres", "yres"]}
    write(os.path.join(root, "benchmark/configs/gears.json"), conf)
    write(os.path.join(root, "benchmark/reference/scenes/gears.py"),
          GEARS_REFERENCE)
    mix = dict(M.traffic("still", root), warmup_frames=1,
               check_from_first=1, check_frames=1, check_pixels=None)
    write(os.path.join(root, "benchmark/traffic/still_whole.json"), mix)
    # limits of its own: both sides read 0, 0 and under 1e-8 here
    write(os.path.join(root, "benchmark/limits/gears-still.json"),
          {"px_off_pct": 1.0, "depth_off_pct": 0.5, "rgb_mean_abs": 0.001})
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"].append({"name": "gears", "source": conf["source"],
                           "file": "benchmark/configs/gears.json",
                           "reduced": ["xres", "yres"], "why": "a test"})
    man["workloads"].append({"name": "gears-still", "config": "gears",
                             "traffic": "still_whole", "chips": 1,
                             "why": "a test"})
    write(os.path.join(root, "BENCHMARK.json"), man)
    return root, before


def run_gears(root):
    args = core.parse(["--workload", "gears-still", "--seed", "11",
                       "--seconds", "0.2", "--trace", "0"])
    return core.run(args, time.perf_counter(), device=torch.device("cpu"),
                    root=root)


def test_a_scene_of_its_own_is_found_by_file(gears_checkout):
    root, before = gears_checkout
    ref = Reference(M.config(M.load(root), "gears", root), 48, 32, "cpu",
                    checkout=root)
    kinds = {t.kind for t in ref.tracer.root.tables.values()}
    assert kinds == {"triangle", "trianglenorm"}
    out = run_gears(root)
    assert out["correct"] is True and out["failed"] == 0
    # every pixel of the frame was compared, and none is off; most show
    # the sky
    checks = {k: c["value"] for k, c in out["checks"].items()}
    assert checks["px_off_pct"] == checks["depth_off_pct"] == 0.0
    assert checks["rgb_mean_abs"] < 1e-6
    rgb, t = ref.pixels(ref.cam.fwd, np.arange(48 * 32))
    sky = t >= 1.0e6
    assert 0.2 < sky.mean() < 0.9
    assert np.allclose(rgb[sky], GEARS_SKY)
    assert (rgb[~sky].max(1) > 0.1).mean() > 0.5
    after = digest(root)
    assert all(after[k] == v for k, v in before.items())


def test_a_wrong_background_in_the_reference_alone_is_not_correct(
        gears_checkout, monkeypatch):
    import benchmark.reference as R

    class WrongSky(R.Tracer):
        def __init__(self, *args):
            super().__init__(*args[:6], (0.5, 0.2, 0.1))
    monkeypatch.setattr(R, "Tracer", WrongSky)
    out = run_gears(gears_checkout[0])
    assert out["correct"] is False


def test_an_unknown_builder_names_the_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="scenes/nowhere.py"):
        Reference({"scene": {"builder": "nowhere"}, "maxdepth": 1}, 4, 4,
                  "cpu", checkout=str(tmp_path))


# --- TestScene held still ------------------------------------------------

# the reference's TestScene trace at 48x32, every pixel at two camera
# offsets (float64 rgba and depth), as it read before its description
# moved from reference/scene.py to reference/scenes/test_scene.py
TESTSCENE_48x32 = ("f56aab5f630383cdc8c3d383044f28d5"
                   "a82603d9b6f7da9bde31742ef6396278")


def test_the_testscene_reference_frame_is_bit_identical():
    ref = Reference(M.config(M.load(), "testscene"), 48, 32, "cpu")
    h = hashlib.sha256()
    px = np.arange(48 * 32)
    xf = torch.tensor(px % 48, dtype=torch.float32)
    yf = torch.tensor(px // 48, dtype=torch.float32)
    for off in ((0.0, 0.0), (0.37, -0.21)):
        fwd = TR.shifted_fwd(ref.cam.fwd, ref.cam.right, ref.cam.up, 32, *off)
        color, t = ref.tracer.trace(*ref.rays(ref.camera(fwd), xf, yf))
        h.update(color.numpy().tobytes())
        h.update(t.numpy().tobytes())
    assert h.hexdigest() == TESTSCENE_48x32


def test_the_testscene_render_config_is_as_before():
    import glome_tpu_torch as T
    from benchmark.harness import program
    cfg = program.render_config(T, M.config(M.load(), "testscene"), 720, 480)
    assert dataclasses.asdict(cfg) == {
        "xres": 720, "yres": 480, "maxdepth": 3, "blocksize": 65,
        "thresholds": (0.14, 0.15, 0.16, 0.18), "modulate_diffuse": False,
        "secondary_capacity": 1.0, "reflect_capacity": (0.45, 0.27, 0.22),
        "refract_capacity": (0.025, 0.025, 0.1),
        "warp_capacity": (0.065, 0.035), "shadow_capacity": (1.0, 0.8, 0.75),
        "min_tiles": 6, "aa_caps": (0.125, 0.09, 0.14, 0.21, 0.31),
        "background": None}
