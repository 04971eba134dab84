"""The check fails what it must.  A whole run on the CPU (the look for a
card skipped, the sizes small) with the timed path broken underneath comes
out not correct, once for each fault a still cell can have; the control
(the reference with its data in bfloat16, computed in float32) fails the
cell's limits where the program passes them."""

import time

import numpy as np
import pytest
import torch

from benchmark import calibrate
from benchmark.harness import check as CK
from benchmark.harness import core
from benchmark.harness import manifest as M

SIZES = {"xres": 48, "yres": 32, "warmup_frames": 1, "check_from_first": 3,
         "check_frames": 2, "check_pixels": 512}


def run_still(seed=21):
    args = core.parse(["--workload", "testscene-still", "--seed", str(seed),
                       "--seconds", "0.5", "--trace", "0"])
    return core.run(args, time.perf_counter(), device=torch.device("cpu"),
                    sizes=SIZES)


def stale(render):
    """Each frame returns the one before it: a step that hands back its
    state unchanged."""
    last = []

    def broken(self, arrays, *a, **k):
        out = render(self, arrays, *a, **k)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return broken


def half(render):
    """Half of the frame's pixels left out: their rays never traced."""
    def broken(self, arrays, *a, **k):
        rgb, t = render(self, arrays, *a, **k)
        rgb, t = rgb.clone(), t.clone()
        rgb.view(-1, 3)[rgb.numel() // 6:] = 0.0
        t.view(-1)[t.numel() // 2:] = 1.0e6
        return rgb, t
    return broken


def altered(render):
    """Every answer altered where it is produced: the red channel off by
    a few levels."""
    def broken(self, arrays, *a, **k):
        rgb, t = render(self, arrays, *a, **k)
        rgb = rgb.clone()
        rgb[..., 0] = torch.clamp(rgb[..., 0] + 0.04, 0.0, 1.0)
        return rgb, t
    return broken


def test_the_unbroken_run_is_correct():
    out = run_still()
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [stale, half, altered])
def test_a_broken_frame_is_not_correct(monkeypatch, fault):
    from glome_tpu_torch.render import Renderer
    monkeypatch.setattr(Renderer, "render", fault(Renderer.render))
    out = run_still()
    assert out["correct"] is False
    assert out["failed"] >= 1


def test_the_control_fails_the_limits_the_program_meets():
    rows, _ = calibrate.readings("testscene-still", [33], [33],
                                 device=torch.device("cpu"),
                                 sizes=dict(SIZES, check_pixels=1024))
    limits = M.limits("testscene-still")
    prog = [r for r in rows if r["side"] == "program"][0]
    ctl = [r for r in rows if r["side"] == "control"][0]
    assert CK.verdict(prog, limits)[0]
    assert not CK.verdict(ctl, limits)[0]
    assert np.isfinite(ctl["px_off_pct"])
