"""SPD `balls` (glome_tpu_torch/scenes/spd_balls.py) against the
benchmark's plain reference of it (benchmark/reference/scenes/balls.py).

The two generators are written apart, from the published description:
the program's NFF text, read back through spd.parse, and the reference's
nodes give the same spheres, floor, fills, lights and camera.  At size
factor 2 (91 spheres) the program's frame equals the reference's on
every pixel of a 48x32 frame at seeded sub-pixel offsets, under the
`spd-balls5-still` cell's tolerances and limits: once on the route the
scene takes (the spheres in K1's tree) and once with the routing
threshold below 91, so that the sphere group goes through K2's plain
version (block_select_plain).  The compiled frame equals the eager one,
a frame with one light removed fails the check, and the CLI renders the
scene from the NFF file.  At size factor 5 the plan routes the 66,430
spheres to K2 and keeps the floor in K1.

    python -m pytest tests/test_torch_spd_balls.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import glome_tpu_torch as T
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch import solids as S
from glome_tpu_torch import spd
from glome_tpu_torch.graphs import COMPILED, EAGER
from glome_tpu_torch.scenes import spd_balls

from benchmark.harness import check as CK
from benchmark.harness import manifest as M
from benchmark.harness import traffic as TR
from benchmark.reference import Reference
from benchmark.reference import scene as RS

CELL = "spd-balls5-still"
W, H = 48, 32
SEED = 2_600_000_021


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cell_conf(size):
    man = M.load()
    conf = M.config(man, M.cell(man, CELL)["config"])
    conf["scene"] = dict(conf["scene"], args={"size": size})
    return conf


def mix():
    man = M.load()
    return M.traffic(M.cell(man, CELL)["traffic"])


def leaves(solid, kind):
    """The `kind` leaves of a solid in tree order, each with the texture
    above it."""
    out = []

    def walk(node, tex):
        if isinstance(node, kind):
            out.append((node, tex))
        elif isinstance(node, S.Tex):
            walk(node.item, node.texture)
        elif isinstance(node, (S.Group, S.BihMarker)):
            for it in node.items:
                walk(it, tex)
    walk(solid, None)
    return out


def ref_leaves(node, kind, tex=None, out=None):
    out = [] if out is None else out
    if isinstance(node, RS.Prim):
        if node.kind == kind:
            out.append((node.p, tex))
    elif isinstance(node, RS.Tex):
        ref_leaves(node.item, kind, node.texture, out)
    elif isinstance(node, RS.Group):
        for it in node.items:
            ref_leaves(it, kind, tex, out)
    return out


def surface_numbers(texture):
    s = texture.material
    return (tuple(s.color), s.alpha, s.ambient, s.kd, s.ks, s.shine)


# --- the two generators ------------------------------------------------------

@pytest.mark.parametrize("size,n", [(2, 91), (5, 66_430)])
def test_the_generators_give_the_same_scene(size, n):
    s = spd.parse(spd_balls.nff(size))
    root, lights, cam = RS.build({"builder": "balls",
                                  "args": {"size": size}})
    got = leaves(s.geom, S.Sphere)
    want = ref_leaves(root, "sphere")
    assert len(got) == len(want) == n
    g = np.array([[*sp.center, sp.radius] for sp, _t in got])
    w = np.array([p for p, _t in want])
    assert np.abs(g - w).max() < 1e-9
    # every sphere under the ball fill, the floor fan under the floor's
    (ball,) = {id(t): t for _s, t in got}.values()
    (ref_ball,) = {id(t): t for _p, t in want}.values()
    assert surface_numbers(ball) == ref_ball[1][1:]
    tris = leaves(s.geom, S.Triangle)
    ref_tris = ref_leaves(root, "triangle")
    assert len(tris) == len(ref_tris) == 2
    for (tri, tex), (p, rtex) in zip(tris, ref_tris):
        assert np.array_equal(np.concatenate([tri.p1, tri.p2, tri.p3]), p)
        assert surface_numbers(tex) == rtex[1][1:]
    assert [(l.pos, l.color) for l in s.lights] == [tuple(l) for l in lights]
    for a, b in ((s.cam.pos, cam.pos), (s.cam.fwd, cam.fwd),
                 (s.cam.up, cam.up), (s.cam.right, cam.right)):
        assert np.abs(np.asarray(a) - b).max() < 1e-12
    assert s.resolution == (512, 512)
    assert s.background == tuple(cell_conf(size)["background"])


def test_the_published_first_spheres():
    # balls.c's text at six significant digits: the root, then the first
    # child (above, at azimuth 45 degrees) before its own children
    lines = [ln for ln in spd_balls.nff(1).splitlines() if ln[:2] == "s "]
    first = [[float(v) for v in ln.split()[1:]] for ln in lines[:2]]
    assert np.allclose(first, [[0, 0, 0, 0.5],
                               [0.272166, 0.272166, 0.544331, 0.166667]],
                       atol=5e-7)
    assert len(lines) == 10


def test_size_5_routes_the_flake_to_k2_and_the_floor_to_k1():
    solid, lights, _cam = spd_balls.balls(5)
    compiled = T.compile_scene(solid, lights)
    groups = compiled.scenes[0].groups
    assert sorted((g.ptype, g.size) for g in groups) == [
        ("sphere", 66_430), ("triangle", 2)]
    plan = MK.get_plan(compiled)
    (si, gi), = plan.blocks
    assert groups[gi].ptype == "sphere" and si == 0
    assert not plan.external


# --- the frames -----------------------------------------------------------------

def program(size, lights=None):
    """(compiled, arrays, cam, cfg) of the flake on the CPU, at the cell's
    render config and background; `lights` replaces the scene's."""
    solid, scene_lights, cam = spd_balls.balls(size)
    compiled = T.compile_scene(solid, scene_lights if lights is None
                               else lights)
    conf = cell_conf(size)
    cfg = T.RenderConfig(xres=W, yres=H, maxdepth=conf["maxdepth"],
                         background=tuple(conf["background"]))
    return compiled, T.to_torch(compiled.arrays(), "cpu"), cam, cfg


def frame(prog, off, frame_kind=None):
    compiled, arrays, cam, cfg = prog
    view = T.Renderer(T.WavefrontTracer(compiled, cfg, frame=frame_kind),
                      cam, cfg)
    fwd = TR.shifted_fwd(cam.fwd, cam.right, cam.up, H, *off)
    view.cam = dataclasses.replace(cam, fwd=fwd)
    rgb, t = view.render(arrays)
    return rgb.numpy().reshape(-1, 3), t.numpy().reshape(-1)


def offsets(n=2):
    o = TR.Offsets(mix(), SEED, TR.WINDOW)
    return [o[i] for i in range(n)]


@pytest.fixture(scope="module")
def reference():
    ref = Reference(cell_conf(2), W, H, "cpu")
    out = []
    for off in offsets():
        fwd = TR.shifted_fwd(ref.cam.fwd, ref.cam.right, ref.cam.up, H, *off)
        out.append(ref.pixels(fwd, np.arange(W * H)))
    return out


def numbers(frames, reference):
    tol = {k: mix()[k] for k in ("rgb_tol", "depth_rel")}
    return CK.merge(CK.compare(rgb, t, rr, rt, tol)
                    for (rgb, t), (rr, rt) in zip(frames, reference))


def limits():
    return M.limits(CELL)


@pytest.mark.parametrize("route", ["k1", "k2"])
def test_the_program_matches_the_reference_on_every_pixel(route, reference,
                                                          monkeypatch):
    if route == "k2":
        monkeypatch.setattr(MK, "BLOCK_MIN", 64)
    prog = program(2)
    blocks = MK.get_plan(prog[0]).blocks
    assert bool(blocks) == (route == "k2")
    got = numbers([frame(prog, off) for off in offsets()], reference)
    ok, _rows = CK.verdict(got, limits())
    assert ok, got
    assert got["px_off_pct"] == got["depth_off_pct"] == 0.0, got
    assert got["rgb_mean_abs"] < 1e-5, got


@pytest.mark.parametrize("route", ["k1", "k2"])
def test_the_compiled_frame_equals_the_eager_frame(route, monkeypatch):
    if route == "k2":
        monkeypatch.setattr(MK, "BLOCK_MIN", 64)
    prog = program(2)
    for off in offsets():
        got = frame(prog, off, COMPILED)
        want = frame(prog, off, EAGER)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("dropped", [0, 1, 2])
def test_a_frame_with_one_light_removed_fails_the_check(dropped, reference):
    _solid, lights, _cam = spd_balls.balls(2)
    prog = program(2, lights[:dropped] + lights[dropped + 1:])
    got = numbers([frame(prog, off) for off in offsets()], reference)
    ok, _rows = CK.verdict(got, limits())
    assert not ok, got
    # the light is missed by the rgb tolerance, not by the depth
    assert got["depth_off_pct"] == 0.0
    assert got["px_off_pct"] > 2.0 * limits()["px_off_pct"], got


def test_the_cli_renders_the_flake_from_its_nff_file(tmp_path):
    from glome_tpu_torch import app
    path = tmp_path / "balls2.nff"
    path.write_text(spd_balls.nff(2).replace("resolution 512 512",
                                             f"resolution {W} {H}"))
    out = app.main(["--scene", str(path), "--device", "cpu",
                    "--out", str(tmp_path / "balls2.png")])
    assert (out["xres"], out["yres"]) == (W, H)
    rgb, t = frame(program(2), (0.0, 0.0))
    assert np.array_equal(out["rgb"].reshape(-1, 3), rgb)
    assert np.array_equal(out["depth"].reshape(-1), t)
