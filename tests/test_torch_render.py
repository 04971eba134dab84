"""The port's main path on the CPU: TestScene through
glome_tpu_torch's compile_scene -> WavefrontTracer -> Renderer at 90x60,
depth 3, against glome_tpu's own CPU golden of the same frame
(tests/golden/testscene_90x60_cpu.png) under test_golden.py:129-131's
drift canaries: mean |diff| <= 3 levels and <= 0.6% of pixels off by
more than 64.  The port's plain K1 and torch op order differ from the
JAX pipeline's, so boundary pixels may flip; structure may not."""

import os

import numpy as np
import pytest
import torch

import glome_tpu_torch as T
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch.io import quantize, read_png
from glome_tpu_torch import scenes

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "testscene_90x60_cpu.png")


@pytest.fixture(scope="module")
def frame():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        solid, lights, cam = scenes.test_scene()
        compiled = T.compile_scene(solid, lights)
        cfg = T.RenderConfig.tuned(xres=90, yres=60)
        renderer = T.Renderer(T.WavefrontTracer(compiled, cfg), cam, cfg)
        launches = MK.mega_select.launches
        calls = MK.mega_select_plain.calls
        rgb, depth = renderer.render(T.to_torch(compiled.arrays(), "cpu"))
        return dict(rgb=rgb, depth=depth, overflow=renderer.last_overflow,
                    launches=MK.mega_select.launches - launches,
                    plain_calls=MK.mega_select_plain.calls - calls)
    finally:
        torch.set_num_threads(n)


def test_render_shape_and_overflow(frame):
    assert frame["rgb"].shape == (60, 90, 3)
    assert frame["depth"].shape == (60, 90)
    assert torch.isfinite(frame["rgb"]).all()
    assert int(frame["overflow"].sum()) == 0


def test_render_within_golden_canaries(frame):
    got = quantize(frame["rgb"].numpy())
    want = read_png(GOLDEN)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    n = diff.size
    print(f"drift vs CPU golden: mean {diff.mean():.4f} levels, "
          f"{int((diff > 64).sum())}/{n} pixels > 64, "
          f"{int((diff > 0).sum())}/{n} pixels differ")
    assert diff.mean() <= 3.0
    assert (diff > 64).sum() <= 0.006 * n


def test_cpu_frame_never_launches_the_kernel(frame):
    # CPU tensors take the plain version: one intersect and one shadow
    # batch per level
    assert frame["launches"] == 0
    assert frame["plain_calls"] == 6


@pytest.mark.parametrize("offset", [0.0, 0.37])
def test_ray_setup_on_the_device_equals_the_numpy_rays(offset, monkeypatch):
    """Renderer.render's set-up and scatter from the frame size's tile
    order, kept on the device, give the rays and the frame that the
    set-up built in numpy every frame gives, bit for bit; a second frame
    of the same size builds no table and a new size rebuilds it."""
    from glome_tpu_torch import render as R
    from glome_tpu_torch.scenes.spd_balls import balls
    solid, lights, cam = balls(1)
    compiled = T.compile_scene(solid, lights)
    arrays = T.to_torch(compiled.arrays(), "cpu")
    cfg = T.RenderConfig(xres=37, yres=21, maxdepth=2)
    view = T.Renderer(T.WavefrontTracer(compiled, cfg), cam, cfg)
    builds, traced = [], []
    tile_order = R.tile_order
    monkeypatch.setattr(R, "tile_order",
                        lambda *a: builds.append(a) or tile_order(*a))
    trace = view.tracer.trace
    monkeypatch.setattr(view.tracer, "trace",
                        lambda arrays, o, d: traced.append((o, d))
                        or trace(arrays, o, d))
    got = [view.render(arrays, offset) for _ in range(2)]
    assert builds == [(37, 21)]

    # the set-up as it ran in numpy every frame
    ys, xs = np.mgrid[0:cfg.yres, 0:cfg.xres]
    perm = tile_order(cfg.xres, cfg.yres)
    o, d = view.rays_for_pixels(
        xs.reshape(-1)[perm].astype(np.float32) + offset,
        ys.reshape(-1)[perm].astype(np.float32) + offset, "cpu")
    for o2, d2 in traced:
        assert torch.equal(o2, o) and torch.equal(d2, d)
    res = trace(arrays, o, d)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    rgb = (res.color[..., :3] * res.color[..., 3:4])[inv]
    want = torch.clamp(rgb.reshape(cfg.yres, cfg.xres, 3), 0.0, 1.0)
    for rgb_got, depth_got in got:
        assert torch.equal(rgb_got, want)
        assert torch.equal(depth_got,
                           res.t[inv].reshape(cfg.yres, cfg.xres))

    view.config = T.RenderConfig(xres=16, yres=8, maxdepth=2)
    assert view.render(arrays, offset)[0].shape == (8, 16, 3)
    assert builds == [(37, 21), (16, 8)]
