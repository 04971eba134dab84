"""SPD `tetra` (glome_tpu_torch/scenes/spd_tetra.py) against the
benchmark's plain reference of it (benchmark/reference/scenes/tetra.py).

The two generators are written apart, from the published description:
the program's NFF text, read back through spd.parse, and the reference's
nodes give the same triangles, fill, light and camera.  At 3
subdivisions (256 triangles) the program's frame equals the reference's
on every pixel of a 48x32 frame at seeded sub-pixel offsets, under the
`spd-tetra-262k-still` cell's tolerances and limits: once on the route
the scene takes (the triangles in K1's tree) and once routed as K3 takes
a giant triangle group (MEGA_EXT_MIN 8, BLOCK_VMEM_MAX 0, as
tests/test_torch_mesh.py's "external" route), through K3's plain version
(mesh_block_select_plain).  The compiled frame equals the eager one on
K3's route, and a frame with its light removed fails the check.  At 8
subdivisions the plan sends the one triangle group of 262,144 to K3 and
at 7 (65,536) to K2, checked on the compiled group's own tables without
compiling the full scene (~30 s on a CPU); the benchmark finds the
configuration by file, and its reference scene counts 262,144 triangles
of 36 bytes.

    python -m pytest tests/test_torch_spd_tetra.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import glome_tpu_torch as T
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch import mesh_kernel as MSH
from glome_tpu_torch import solids as S
from glome_tpu_torch import spd
from glome_tpu_torch.graphs import COMPILED, EAGER
from glome_tpu_torch.scenes import spd_tetra

from benchmark.harness import check as CK
from benchmark.harness import manifest as M
from benchmark.harness import traffic as TR
from benchmark.metrics import _roofline as RF
from benchmark.reference import Reference
from benchmark.reference import scene as RS

CELL = "spd-tetra-262k-still"
CONFIG = "spd-tetra-262k"
W, H = 48, 32
LEVELS = 3
SEED = 2_600_000_033
# tests/test_torch_mesh.py's ROUTES["external"]: a plain triangle group
# above 8 prims goes to K3
EXTERNAL = dict(MEGA_EXT_MIN=8, BLOCK_VMEM_MAX=0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cell_conf(levels):
    man = M.load()
    conf = M.config(man, M.cell(man, CELL)["config"])
    conf["scene"] = dict(conf["scene"], args={"levels": levels})
    return conf


def mix():
    man = M.load()
    return M.traffic(M.cell(man, CELL)["traffic"])


def ref_triangles(root):
    """The reference description's triangles (n, 9) and the texture of
    each, in tree order."""
    out = []

    def walk(node, tex):
        if isinstance(node, RS.Prim):
            assert node.kind == "triangle"
            out.append((node.p, tex))
        elif isinstance(node, RS.Tex):
            walk(node.item, node.texture)
        else:
            for it in node.items:
                walk(it, tex)
    walk(root, None)
    return np.array([p for p, _t in out]), [t for _p, t in out]


def program_triangles(solid):
    out = []

    def walk(node, tex):
        if isinstance(node, S.Triangle):
            out.append((np.concatenate([node.p1, node.p2, node.p3]), tex))
        elif isinstance(node, S.Tex):
            walk(node.item, node.texture)
        elif isinstance(node, (S.Group, S.BihMarker)):
            for it in node.items:
                walk(it, tex)
    walk(solid, None)
    return np.array([p for p, _t in out]), [t for _p, t in out]


# --- the two generators ------------------------------------------------------

@pytest.mark.parametrize("levels", [1, 2, 3])
def test_the_generators_give_the_same_triangles(levels):
    s = spd.parse(spd_tetra.nff(levels))
    root, lights, cam = RS.build({"builder": "tetra",
                                  "args": {"levels": levels}})
    got, texs = program_triangles(s.geom)
    want, ref_texs = ref_triangles(root)
    assert got.shape == want.shape == (4 ** (levels + 1), 9)
    assert np.array_equal(got, want)
    # one fill over all of them
    (tex,) = {id(t): t for t in texs}.values()
    (ref_tex,) = {id(t): t for t in ref_texs}.values()
    m = tex.material
    assert (tuple(m.color), m.alpha, m.ambient, m.kd, m.ks, m.shine) == \
        ref_tex[1][1:]
    # every face's flat normal points out of its tetrahedron
    tet = got.reshape(-1, 4, 3, 3)
    centre = tet.reshape(len(tet), -1, 3).mean(1)
    p1, p2, p3 = got[:, 0:3], got[:, 3:6], got[:, 6:9]
    out = np.einsum("ni,ni->n", np.cross(p2 - p1, p3 - p1),
                    p1 - np.repeat(centre, 4, axis=0))
    assert (out > 0).all()
    assert [(l.pos, l.color) for l in s.lights] == [tuple(l) for l in lights]
    for a, b in ((s.cam.pos, cam.pos), (s.cam.fwd, cam.fwd),
                 (s.cam.up, cam.up), (s.cam.right, cam.right)):
        assert np.abs(np.asarray(a) - b).max() < 1e-12
    assert s.resolution == (512, 512)
    assert s.background == tuple(cell_conf(levels)["background"])


def test_the_leaves_and_their_text():
    # 4^L leaves of edge sqrt(8) / 2^L inside [-1, 1]^3, their vertices
    # multiples of 2^-L, written exactly
    tris = spd_tetra.triangles(4)
    edges = np.linalg.norm(tris[:, 1] - tris[:, 0], axis=-1)
    assert np.allclose(edges, np.sqrt(8.0) / 16.0, rtol=0, atol=1e-15)
    v = tris.reshape(-1, 3)
    assert np.abs(v).max() == 1.0
    assert np.array_equal(v * 16.0, np.round(v * 16.0))
    text = spd_tetra.nff(1)
    assert text.count("p 3\n") == 16
    # the first leaf, at corner (1, 1, 1), its face opposite that corner
    assert "f 1 0.2 0.2 0.8 0 0 0 0\np 3\n1.0 0.0 0.0\n0.0 0.0 1.0\n" \
        "0.0 1.0 0.0\n" in text


# --- routing at the cell's size -------------------------------------------------

def big_group(g, levels):
    """The compiled pyramid's one triangle group `g` with the triangles
    of `levels` subdivisions in its tables: its per-prim rows tiled, its
    serials renumbered."""
    tris = spd_tetra.triangles(levels)
    reps = len(tris) // g.size
    tiled = {f: np.tile(getattr(g, f), (reps,) + (1,) * (getattr(g, f).ndim
                                                         - 1))
             for f in ("tex_stack", "tag_stack", "local_tex_stack",
                       "local_tag_stack", "noshadow", "onlyshadow",
                       "csg_id", "csg_clause")}
    return dataclasses.replace(
        g, params={"p1": tris[:, 0], "p2": tris[:, 1], "p3": tris[:, 2]},
        prim_serial=np.arange(len(tris), dtype=np.int32), **tiled)


@pytest.mark.parametrize("levels,route", [(8, "external"), (7, "blocks")])
def test_the_plan_sends_262144_triangles_to_k3_and_65536_to_k2(levels,
                                                                 route):
    compiled = T.compile_scene(*spd_tetra.tetra(2)[:2])
    (g,) = compiled.scenes[0].groups
    assert (g.ptype, g.vclass, g.constraints, g.mesh_src) == (
        "triangle", "plain", None, None)
    assert g.m_inv is None and not g.noshadow.any()
    big = big_group(g, levels)
    assert big.size == 4 ** (levels + 1)
    cc = dataclasses.replace(compiled, scenes=[
        dataclasses.replace(compiled.scenes[0], groups=[big])])
    plan = MK.build_plan(cc)
    assert getattr(plan, route) == [(0, 0)]
    assert not getattr(plan, {"external": "blocks",
                              "blocks": "external"}[route])


# --- the frames -----------------------------------------------------------------

def program(levels, lights=None):
    """(compiled, arrays, cam, cfg) of the pyramid on the CPU, at the
    cell's render config and background; `lights` replaces the scene's."""
    solid, scene_lights, cam = spd_tetra.tetra(levels)
    compiled = T.compile_scene(solid, scene_lights if lights is None
                               else lights)
    conf = cell_conf(levels)
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
    ref = Reference(cell_conf(LEVELS), W, H, "cpu")
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


def _route(monkeypatch, route):
    if route == "k3":
        for k, v in EXTERNAL.items():
            monkeypatch.setattr(MK, k, v)


@pytest.mark.parametrize("route", ["k1", "k3"])
def test_the_program_matches_the_reference_on_every_pixel(route, reference,
                                                          monkeypatch):
    _route(monkeypatch, route)
    prog = program(LEVELS)
    plan = MK.get_plan(prog[0])
    assert bool(plan.external) == (route == "k3") and not plan.blocks
    calls = MSH.mesh_block_select_plain.calls
    got = numbers([frame(prog, off) for off in offsets()], reference)
    ran = MSH.mesh_block_select_plain.calls - calls
    # one K3 call per intersect and shadow batch of each level run
    assert (ran > 0) == (route == "k3")
    ok, _rows = CK.verdict(got, limits())
    assert ok, got
    assert got["px_off_pct"] == got["depth_off_pct"] == 0.0, got
    assert got["rgb_mean_abs"] < 1e-5, got


def test_the_compiled_frame_equals_the_eager_frame_on_k3(monkeypatch):
    _route(monkeypatch, "k3")
    prog = program(LEVELS)
    assert MK.get_plan(prog[0]).external == [(0, 0)]
    for off in offsets():
        got = frame(prog, off, COMPILED)
        want = frame(prog, off, EAGER)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def test_a_frame_with_its_light_removed_fails_the_check(reference):
    got = numbers([frame(program(LEVELS, ()), off) for off in offsets()],
                  reference)
    ok, _rows = CK.verdict(got, limits())
    assert not ok, got
    # the light is missed by the rgb tolerance, not by the depth
    assert got["depth_off_pct"] == 0.0
    assert got["px_off_pct"] > limits()["px_off_pct"], got


# --- the configuration in the benchmark -------------------------------------

def test_the_benchmark_finds_the_configuration_by_file():
    man = M.load()
    cell = M.cell(man, CELL)
    assert cell["config"] == CONFIG and cell["chips"] == 1
    conf = M.config(man, CONFIG)
    assert conf["scene"] == {"module": "spd_tetra", "builder": "tetra",
                             "args": {"levels": 8}}
    assert conf["prims"] == 4 ** 9 == 262_144 and conf["reduced"] == []
    root, lights, _cam = RS.build(conf["scene"])
    tris, _texs = ref_triangles(root)
    assert tris.shape == (262_144, 9) and len(lights) == 1
    assert RF.scene_bytes(root) == 262_144 * 36
    for name in ("K3_roofline", "k3.device_ms",
                 "wavefront.k3_live_lane_pct"):
        assert callable(M.reader(name))
        assert CELL in {m["name"]: m for m in man["per_layer"]}[name][
            "workloads"]
