"""NFF import in the port (glome_tpu_torch/spd.py) against glome_tpu's.

The parser is a numpy copy, so both packages must build the same scene
from the same text: the same SPD fields, and compiled tables equal
exactly (test_torch_host's helpers).  The committed fixtures then
render through the port's WavefrontTracer on the CPU against their
goldens (glome_tpu's own CPU renders).  glome_tpu meets them within
atol 1e-5 (test_spd_conformance.py); the port holds gears.nff to the
same atol 1e-5 and miniflake.nff to it on all but 0.5% of its pixels,
and both to the drift canaries of test_golden.py:129-131.  miniflake's
centre row (y = 32) looks exactly along the camera axis, which meets
the ground quad on its far edge (z = -4): the hit is a float tie on the
triangle's edge, and the port's op order keeps 17 of those 96 rays on
the quad where glome_tpu's misses it.
"""

import os

import numpy as np
import pytest

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu import spd as JS
from glome_tpu_torch import spd as TS
from glome_tpu_torch.io import quantize
from test_spd import NFF
from test_torch_host import _leaves
from test_torch_host import test_plan_tables_match as _plan_tables_match

HERE = os.path.dirname(__file__)
FIXTURES = ("miniflake.nff", "gears.nff")


def _same_spd(a, b):
    assert a.resolution == b.resolution
    assert a.background == b.background
    np.testing.assert_array_equal(a.cam.pos, b.cam.pos)
    np.testing.assert_array_equal(a.cam.fwd, b.cam.fwd)
    np.testing.assert_array_equal(a.cam.up, b.cam.up)
    np.testing.assert_array_equal(a.cam.right, b.cam.right)
    assert [(l.pos, l.color, l.radius) for l in a.lights] == \
        [(l.pos, l.color, l.radius) for l in b.lights]
    assert G.primcount(a.geom) == T.primcount(b.geom)


def test_parse_nff():
    """test_spd.py's test_parse_nff on the port."""
    s = TS.parse(NFF)
    assert s.resolution == (512, 512)
    np.testing.assert_allclose(s.background, (0.078, 0.361, 0.753))
    assert len(s.lights) == 2
    np.testing.assert_allclose(s.lights[1].color, (0.5, 0.5, 0.5))
    assert s.cam is not None
    prims, xfms, bounds = T.primcount(s.geom)
    assert prims == 5
    compiled = T.compile_scene(s.geom, s.lights)
    types = sorted((g.ptype, g.size) for g in compiled.scenes[0].groups)
    assert ("trianglenorm", 1) in types
    assert ("triangle", 2) in types
    assert ("sphere", 1) in types
    assert ("cone", 1) in types
    assert len(compiled.textures) == 2


def test_light_default_color():
    s = TS.parse("l 1 2 3")
    np.testing.assert_allclose(s.lights[0].color, (1, 1, 1))


def test_unknown_directive_raises():
    with pytest.raises(ValueError, match="unknown NFF directive"):
        TS.parse("zz 1 2 3")
    with pytest.raises(ValueError, match="unknown NFF directive"):
        JS.parse("zz 1 2 3")


def test_empty_scene_is_nothing():
    s, sj = TS.parse("b 0.1 0.2 0.3"), JS.parse("b 0.1 0.2 0.3")
    assert s.cam is None and s.resolution is None
    assert T.primcount(s.geom) == G.primcount(sj.geom) == (0, 0, 0)


@pytest.mark.parametrize("source", ("inline",) + FIXTURES)
def test_parse_matches_glome_tpu(source):
    """Same SPD fields, and the compiled arrays and megakernel plan
    tables equal glome_tpu's exactly."""
    if source == "inline":
        st, sj = TS.parse(NFF), JS.parse(NFF)
    else:
        path = os.path.join(HERE, "fixtures", source)
        st, sj = TS.load(path), JS.load(path)
    _same_spd(sj, st)
    cj = G.compile_scene(sj.geom, sj.lights)
    ct = T.compile_scene(st.geom, st.lights)
    lj, lt = dict(_leaves(cj.arrays())), dict(_leaves(ct.arrays()))
    assert lj.keys() == lt.keys()
    for k in lj:
        np.testing.assert_array_equal(lj[k], lt[k], err_msg=k)
    assert [(g.ptype, g.size, g.vclass) for g in cj.scenes[0].groups] == \
        [(g.ptype, g.size, g.vclass) for g in ct.scenes[0].groups]
    assert len(cj.textures) == len(ct.textures)
    _plan_tables_match((cj, ct))


def _render(name):
    s = TS.load(os.path.join(HERE, "fixtures", name))
    compiled = T.compile_scene(s.geom, s.lights)
    xres, yres = s.resolution
    cfg = T.RenderConfig(xres=xres, yres=yres, maxdepth=2,
                         background=s.background, min_tiles=1)
    renderer = T.Renderer(T.WavefrontTracer(compiled, cfg), s.cam, cfg)
    rgb, depth = renderer.render(T.to_torch(compiled.arrays(), "cpu"))
    return rgb.numpy(), depth.numpy()


@pytest.mark.parametrize("name", FIXTURES)
def test_nff_scene_renders_like_golden(name):
    rgb, depth = _render(name)
    assert rgb.shape == (64, 96, 3)
    assert np.isfinite(rgb).all()
    assert (depth < 1e6).mean() > 0.1, (depth < 1e6).mean()
    assert (depth >= 1e6).any()
    gold = np.load(os.path.join(HERE, "golden",
                                name.replace(".nff", "_rgb.npy")))
    off = np.abs(rgb - gold).max(axis=-1) > 1e-5
    diff = np.abs(quantize(rgb).astype(np.int32)
                  - quantize(gold).astype(np.int32)).max(axis=-1)
    print(f"{name}: max |diff| {np.abs(rgb - gold).max():.6g}, "
          f"{int(off.sum())}/{off.size} pixels beyond atol 1e-5, "
          f"canaries: mean {diff.mean():.4f} levels, "
          f"{int((diff > 64).sum())} pixels > 64")
    assert diff.mean() <= 3.0
    assert (diff > 64).sum() <= 0.006 * diff.size
    if name == "gears.nff":
        np.testing.assert_allclose(rgb, gold, atol=1e-5)
    else:
        assert off.mean() <= 0.005
        # the off pixels are the centre row's edge ties (docstring)
        assert set(np.nonzero(off)[0].tolist()) <= {32}


def test_nff_parse_fields():
    s = TS.load(os.path.join(HERE, "fixtures", "miniflake.nff"))
    assert s.resolution == (96, 64)
    assert len(s.lights) == 2
    assert s.background == (0.08, 0.1, 0.2)
    assert T.primcount(s.geom)[0] == 8
