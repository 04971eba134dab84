"""The traffic generator: the same seed gives the same inputs, and the
camera shift moves every primary ray by the drawn sub-pixel offset."""

import numpy as np

from benchmark.harness import manifest as M
from benchmark.harness import traffic as TR
from benchmark.reference.scene import camera

BIG = 2 ** 31 + 12345       # seeds run past 32 signed bits


def mix(name="still"):
    return M.traffic(name)


def test_offsets_repeat_per_seed_and_stream():
    a = TR.Offsets(mix(), BIG, TR.WINDOW)
    b = TR.Offsets(mix(), BIG, TR.WINDOW)
    first = [a[i] for i in range(300)]       # crosses a block
    assert first == [b[i] for i in range(300)]
    c = TR.Offsets(mix(), BIG, TR.WINDOW)
    assert c[299] == first[299]              # asked out of order
    assert TR.Offsets(mix(), BIG + 1, TR.WINDOW)[0] != first[0]
    assert TR.Offsets(mix(), BIG, TR.WARMUP)[0] != first[0]
    lo, hi = mix()["jitter_px"]
    assert all(lo <= v < hi for xy in first for v in xy)


def test_check_plan_repeats_and_stays_in_range():
    m = mix()
    p1 = TR.check_plan(m, BIG, 500, 720 * 480)
    p2 = TR.check_plan(m, BIG, 500, 720 * 480)
    assert [i for i, _ in p1] == [i for i, _ in p2]
    for (i, a), (_, b) in zip(p1, p2):
        assert np.array_equal(a, b)
        assert 0 <= i < m["check_from_first"]
        assert len(a) == m["check_pixels"] == len(np.unique(a))
        assert a.min() >= 0 and a.max() < 720 * 480
    assert len(p1) == m["check_frames"]
    # a window shorter than the pool checks the frames it has
    short = TR.check_plan(m, BIG, 1, 720 * 480)
    assert [i for i, _ in short] == [0]
    # a whole-frame mix checks every pixel
    whole = TR.check_plan(mix("aa"), BIG, 500, 48 * 32)
    assert all(np.array_equal(px, np.arange(48 * 32)) for _, px in whole)


def _dirs(fwd, cam, W, H, xs, ys):
    """Primary ray directions of pixels (Glome.hs:27-33,133-140), in
    float64."""
    xc = (xs / W * 2 - 1) * (W / H)
    yc = -(ys / H * 2 - 1)
    d = fwd[None] - xc[:, None] * cam.right[None] + yc[:, None] * cam.up[None]
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def test_shifted_fwd_moves_rays_by_the_offset():
    cam = camera((-2, 4.3, 15), (0, 2, 0), (0, 1, 0), 45)
    W, H = 72, 48
    dx, dy = 0.3125, -0.25       # exact in binary
    xs = np.array([3.0, 40.0, 71.0])
    ys = np.array([0.0, 17.0, 47.0])
    moved = TR.shifted_fwd(cam.fwd, cam.right, cam.up, H, dx, dy)
    d1 = _dirs(moved, cam, W, H, xs, ys)
    d2 = _dirs(cam.fwd, cam, W, H, xs + dx, ys + dy)
    assert np.allclose(d1, d2, rtol=0, atol=1e-12)


def test_check_tiles_repeat_and_cover_whole_tiles():
    m = dict(mix("aa"), check_tiles=5)
    t1 = TR.check_tiles(m, BIG, 720, 480, 65)
    assert t1 == TR.check_tiles(m, BIG, 720, 480, 65)
    assert len(t1) == 5 == len(set(t1))
    assert TR.check_tiles(m, BIG + 1, 720, 480, 65) != t1
    assert all(x % 65 == 0 and y % 65 == 0 and x < 720 and y < 480
               for x, y in t1)
    # a tile of the padded last column holds only the frame's pixels
    px = TR.tile_pixels([(715, 0), (0, 0)], 720, 480, 65)
    assert len(px) == 5 * 65 + 65 * 65
    assert np.array_equal(px[:5], [715, 716, 717, 718, 719])
    assert px[5] == 720 + 715 and px.max() < 720 * 480


def test_a_per_run_mix_holds_one_offset():
    a = TR.Offsets(mix("aa"), BIG, TR.WINDOW)
    w = TR.Offsets(mix("aa"), BIG, TR.WARMUP)
    assert a[0] == a[57] == w[3]
    assert TR.Offsets(mix("aa"), BIG + 1, TR.WINDOW)[0] != a[0]
