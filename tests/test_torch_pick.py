"""Picking in the port (glome_tpu_torch/pick.py) against glome_tpu's.

A grid of pixels over phasescene.phase_kinds_scene(tagged=True) (each
item under a tag of its own) must name the same tags, prim serials and
depths (rtol 1e-5) as glome_tpu's pick path: its PickSession, which
jits glome_tpu's pick trace once, for the grid, and its one-shot `pick`
for the centre pixel.  The port passes `scene_id` to the trace from
`pick`, `PickSession` and `pick_hit` (glome_tpu's `pick` and `pick_hit`
take it and drop it)."""

import io
import time

import numpy as np
import pytest

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu import pick as JP
from glome_tpu_torch import pick as TP
from glome_tpu_torch.scenes.phasescene import (phase_kinds_lights,
                                               phase_kinds_scene,
                                               warp_lights_scene)

XRES, YRES = 64, 48


def _two_prim(P):
    solid = P.group([
        P.tag(P.tex(P.sphere((0, 0, 0), 1.0),
                    P.Uniform(P.Surface(color=(1, 0, 0)))), "ball"),
        P.tag(P.tex(P.plane((0, -1.5, 0), (0, 1, 0)),
                    P.Uniform(P.Surface(color=(0, 1, 0)))), "floor"),
    ])
    lights = [P.light((3, 4, 3), (1, 1, 1))]
    cam = P.camera((0, 0.5, 4), (0, 0, 0), (0, 1, 0), 45)
    return solid, lights, cam


def test_pick_session_reuses_compile():
    """test_scene.py's pick-session test on the port: tag stacks match
    the one-shot pick path, a pick takes well under the time glome_tpu
    allows a cached one, and the session loop answers picks, invalid
    lines and 'q'."""
    solid, lights, cam = _two_prim(T)
    compiled = T.compile_scene(solid, lights)
    cfg = T.RenderConfig(xres=64, yres=48, maxdepth=1, min_tiles=1)
    tracer = T.Tracer(compiled, cfg)
    arrays = T.to_torch(compiled.arrays(), "cpu")

    sess = TP.PickSession(tracer, cam, arrays)
    h1 = sess.pick(32, 24)
    assert h1["tags"] == ["ball"], h1
    assert h1["tags"] == TP.pick(tracer, cam, arrays, 32, 24)
    t0 = time.time()
    h2 = sess.pick(32, 46)
    dt = time.time() - t0
    assert h2["tags"] == ["floor"], h2
    assert dt < 2.0, f"pick took {dt:.1f}s"

    out = io.StringIO()
    sess.run(inp=io.StringIO("32 24\nbogus\n\n32 46\nq\n32 24\n"), out=out)
    lines = out.getvalue().splitlines()
    assert lines[0] == "pick session: 'X Y' picks, 'q' quits"
    assert lines[1].startswith("32 24: t=") and lines[1].endswith("ball")
    assert lines[2] == "? 'bogus'"
    assert lines[3].startswith("32 46: t=") and lines[3].endswith("floor")
    assert len(lines) == 4          # 'q' ended the loop


@pytest.fixture(scope="module")
def phase_pair():
    out = {}
    for name, P in (("jax", G), ("torch", T)):
        c = P.compile_scene(phase_kinds_scene(P, tagged=True),
                            phase_kinds_lights(P))
        cam = P.camera((0.5, 0.2, -4.0), (0.0, 0.0, 6.0), (0, 1, 0), 60)
        cfg = P.RenderConfig(xres=XRES, yres=YRES, maxdepth=1, min_tiles=1)
        out[name] = (c, cam, P.Tracer(c, cfg))
    return out


def test_pick_grid_matches_glome_tpu(phase_pair):
    cj, camj, trj = phase_pair["jax"]
    ct, camt, trt = phase_pair["torch"]
    arrays = T.to_torch(ct.arrays(), "cpu")
    sess_j = JP.PickSession(trj, camj, cj.arrays())
    sess_t = TP.PickSession(trt, camt, arrays)
    seen = set()
    for y in range(2, YRES, 6):
        for x in range(2, XRES, 6):
            hj, ht = sess_j.pick(x, y), sess_t.pick(x, y)
            assert ht["tags"] == hj["tags"], (x, y)
            assert ht["prim_serial"] == hj["prim_serial"], (x, y)
            np.testing.assert_allclose(ht["t"], hj["t"], rtol=1e-5)
            assert TP.pick(trt, camt, arrays, x, y) == ht["tags"]
            seen.update(ht["tags"])
    print(f"tags seen on the grid: {sorted(seen)}")
    assert len(seen) >= 4
    # glome_tpu's one-shot pick (eager) at the centre pixel
    assert TP.pick(trt, camt, arrays, 32, 24) == JP.pick(
        trj, camj, cj.arrays(), 32, 24)
    hit = TP.pick_hit(trt, camt, arrays, 32, 24)
    assert hit["tags"] == sess_j.pick(32, 24)["tags"]
    assert hit["color"].shape == (4,)


class _SpyTracer(T.Tracer):
    def trace(self, *args, **kwargs):
        self.scene_ids.append(kwargs.get("scene_id"))
        return super().trace(*args, **kwargs)


def test_scene_id_reaches_the_trace():
    """On a portal scene (scene 1 the portal's frame, 2 its target) a
    pick in scene 2 reaches the trace as scene_id=2 through all three
    entry points and hits the target scene's floor and spheres."""
    ws, wl, wcam = warp_lights_scene()
    wc = T.compile_scene(ws, wl)
    assert wc.warp_mats[0].target_scene == 2
    wa = T.to_torch(wc.arrays(), "cpu")
    wt = _SpyTracer(wc, T.RenderConfig(xres=64, yres=48, maxdepth=1))
    serials = [set(np.concatenate([g.prim_serial for g in sc.groups]).tolist())
               for sc in wc.scenes]
    for sid in (0, 2):
        wt.scene_ids = []
        sess = TP.PickSession(wt, wcam, wa, scene_id=sid)
        for x in (8, 32, 56):
            h = TP.pick_hit(wt, wcam, wa, x, 40, scene_id=sid)
            assert h["prim_serial"] in serials[sid], (sid, x, h)
            assert sess.pick(x, 40)["prim_serial"] == h["prim_serial"]
            assert TP.pick(wt, wcam, wa, x, 40, scene_id=sid) == h["tags"]
        assert wt.scene_ids == [sid] * 9
