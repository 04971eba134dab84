"""The window's arithmetic, the device-span union and the roofline's
bytes, on numbers worked out by hand."""

import statistics
import types

import numpy as np
import pytest

from benchmark.harness import check as CK
from benchmark.harness import window as W
from benchmark.metrics import _roofline as RF
from benchmark.reference import scene as S


def test_per_item_ms_is_the_whole_window_over_the_count():
    # a stall counts in full: 9 frames of 10 ms and one of 310 ms
    frames = [0.010] * 9 + [0.310]
    assert W.per_item_ms(sum(frames), len(frames)) == pytest.approx(40.0)
    assert statistics.median(frames) * 1e3 == pytest.approx(10.0)
    with pytest.raises(ValueError):
        W.per_item_ms(1.0, 0)


def test_p95_and_its_tail_count():
    s = np.arange(1, 201) / 1e3          # 1..200 ms
    assert W.p95_ms(s) == pytest.approx(np.percentile(np.arange(1, 201),
                                                      95))
    assert W.beyond_p95(s) == 10         # ten frames past the 95th
    assert W.beyond_p95(s[:100]) == 5


def test_busy_union_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40), (38, 45), (100, 110)]
    assert W.busy_ns(spans) == 20 + 15 + 10
    assert W.busy_ns(spans, 8, 35) == 12 + 5
    assert W.busy_ns([], 0, 10) == 0
    gaps = W.idle_gaps(spans, 0, 120)
    assert gaps == [(45, 100), (20, 30), (110, 120)]


def test_scene_bytes_from_the_description():
    sphere = S.sphere((0, 0, 0), 1)
    root = S.Group([
        sphere,
        S.xform(S.box((0, 0, 0), (1, 1, 1)), [S.scale((2, 2, 2))]),
        S.Tex(sphere, None),                           # shared: once
        S.Diff(S.half_space((0, 1, 0), 0), S.cone((0, 0, 0), 1,
                                                  (0, 1, 0), 0.5)),
    ])
    assert RF.scene_bytes(root) == 4 * (4 + 6 + 12 + 4 + 4 + 12)


def test_roofline_share_of_first_launches(monkeypatch):
    # two frames, K1 launched twice in each; the first of each counts
    ns = 1e9
    prof = {"ops": [("mega_select_kernel(float const*)", 100, 100 + 2000),
                    ("mega_select_kernel(float const*)", 5000, 9000),
                    ("void other_kernel", 2500, 4000),
                    ("mega_select_kernel(float const*)", 20000, 22000),
                    ("xmega_select_kernel", 23000, 23100)],
            "frames": [(0, 10000), (15000, 30000)],
            "traces": [], "lo": 0, "hi": 30000}
    run = types.SimpleNamespace(prof=prof, prof_rays=[1000, 1000])
    root = S.Group([S.sphere((0, 0, 0), 1)])
    monkeypatch.setattr(RF, "description", lambda _run: root)
    got = RF.share_pct(run, r"(?<![A-Za-z0-9_])mega_select_kernel")
    bound = 2 * (1000 * 36 + 16) / RF.PEAK_BYTES_PER_S
    assert got == pytest.approx(100 * bound / (4000 / ns))
    run.prof = None
    assert RF.share_pct(run, "mega_select_kernel") is None


def test_compare_counts_off_pixels():
    ref_rgb = np.zeros((4, 3))
    ref_t = np.array([1.0, 10.0, 1e6, 2.0])
    rgb = ref_rgb.copy()
    rgb[0, 1] = 0.5                       # colour off
    t = ref_t.copy()
    t[1] = 10.02                          # depth off (> 1e-3 relative)
    t[2] = 1e6 * (1 + 1e-4)               # a miss, within tolerance
    got = CK.compare(rgb, t, ref_rgb, ref_t,
                     {"rgb_tol": 0.02, "depth_rel": 1e-3})
    assert got["px_off_pct"] == pytest.approx(50.0)
    assert got["depth_off_pct"] == pytest.approx(25.0)
    assert got["rgb_mean_abs"] == pytest.approx(0.5 / 12)
    t[3] = np.nan                         # NaN is off
    got = CK.compare(rgb, t, ref_rgb, ref_t,
                     {"rgb_tol": 0.02, "depth_rel": 1e-3})
    assert got["px_off_pct"] == pytest.approx(75.0)
    assert got["depth_off_pct"] == pytest.approx(50.0)
