"""The program's own spans and counters as the benchmark reads them
(benchmark/metrics/_spans.py and the readers beside it).

On the CPU, a --trace 1 run of each cell at 24x16 reads every new window
metric as a finite number, and the program's spans fit inside what the
harness times from outside in the same run: the spans outside the trace
calls sum to no more than the cell's outside_trace metric, and the
tracer's host time and count waits to no more than the harness's own
time inside the trace calls (each frame's seconds less its outside_s).

On the card (`cuda`), a short traced run of each cell at full size also
reads wavefront.device_busy_pct, and every frame span of the profiled
stretch lies inside its 'bench.frame' range and every wavefront.trace
inside a 'bench.trace' range, within 0.05 ms, once mapped onto the
profiler's clock.

    python -m pytest benchmark/tests/test_bench_program_spans.py -q
"""

import math
import statistics
import sys
import time

import pytest
import torch

from benchmark.harness import core

# the new window metrics of each cell
WINDOW = {
    "testscene-still": ("render.ray_setup_ms", "render.scatter_ms",
                        "wavefront.host_ms", "wavefront.count_wait_ms",
                        "wavefront.live_lane_pct"),
    "testscene-aa": ("aa.mask_planes_ms", "aa.variance_ms",
                     "aa.pass_setup_ms", "wavefront.host_ms",
                     "wavefront.count_wait_ms", "wavefront.live_lane_pct"),
}
# the outside-timed metric and the program's spans that lie inside it
OUTSIDE = {
    "testscene-still": ("render.outside_trace_ms",
                        ("render.ray_setup_ms", "render.scatter_ms")),
    "testscene-aa": ("aa.outside_trace_ms",
                     ("aa.mask_planes_ms", "aa.variance_ms",
                      "aa.pass_setup_ms")),
}
FRAME_SPAN = {"testscene-still": "render.frame", "testscene-aa": "aa.frame"}
SMALL = {"xres": 24, "yres": 16, "warmup_frames": 1, "check_from_first": 1,
         "check_frames": 1, "check_pixels": 64, "check_tiles": 1}
MAP_NS = 50_000


def traced(cell, monkeypatch, seconds, device=None, sizes=None):
    """A --trace 1 run of `cell`: (its result line, its run record)."""
    seen = {}
    measure = core.measure_frames

    def keep(rec):
        seen["rec"] = rec
        return measure(rec)
    monkeypatch.setattr(core, "measure_frames", keep)
    args = core.parse(["--workload", cell, "--seed", str(2 ** 31 + 17),
                       "--seconds", str(seconds), "--trace", "1"])
    out = core.run(args, time.perf_counter(), device=device, sizes=sizes)
    assert out is not None and out["correct"] is True
    return out, seen["rec"]


def check_fits(cell, out, rec):
    m = {k: v["value"] for k, v in out["metrics"].items()}
    for name in WINDOW[cell]:
        assert math.isfinite(m[name]) and m[name] >= 0, name
    assert 0 < m["wavefront.live_lane_pct"] <= 100
    outside, parts = OUTSIDE[cell]
    assert sum(m[p] for p in parts) <= m[outside]
    inside_ms = 1e3 * statistics.fmean(
        f - o for f, o in zip(rec.frame_s, rec.outside_s))
    assert m["wavefront.host_ms"] + m["wavefront.count_wait_ms"] <= inside_ms
    return m, inside_ms


@pytest.mark.parametrize("cell", list(WINDOW))
def test_a_traced_cpu_run_reads_the_programs_spans(cell, monkeypatch):
    out, rec = traced(cell, monkeypatch, 0.5, torch.device("cpu"), SMALL)
    m, _inside = check_fits(cell, out, rec)
    # no profiled stretch on the CPU
    assert "wavefront.device_busy_pct" not in m


def _outside_by(inner, outer):
    """How far (ns) the interval `inner` reaches outside `outer`."""
    return max(outer[0] - inner[0], inner[1] - outer[1], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(WINDOW))
def test_the_profiled_spans_nest_in_the_harness_ranges(cell, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out, rec = traced(cell, monkeypatch, 3)
    m, inside = check_fits(cell, out, rec)
    busy = m["wavefront.device_busy_pct"]
    assert 0 < busy <= 100
    recs = sys.modules["glome_tpu_torch.telemetry"].frames()
    recs = recs[-len(rec.prof["frames"]):]
    frame_off, trace_off = [], []
    for f, bench_frame in zip(recs, rec.prof["frames"]):
        spans = f.intervals()
        assert spans[0][0] == FRAME_SPAN[cell]
        frame_off.append(_outside_by(spans[0][1:3], bench_frame))
        for name, a, b, _p in spans:
            if name == "wavefront.trace":
                trace_off.append(min(_outside_by((a, b), r)
                                     for r in rec.prof["traces"]))
    print(f"{cell}: frame spans outside bench.frame by at most "
          f"{max(frame_off)} ns, wavefront.trace outside bench.trace by at "
          f"most {max(trace_off)} ns over {len(trace_off)} traces; "
          f"host+wait {m['wavefront.host_ms'] + m['wavefront.count_wait_ms']}"
          f" ms of {inside} ms inside the trace calls; device busy "
          f"{busy}% in wavefront.trace")
    assert max(frame_off) <= MAP_NS and max(trace_off) <= MAP_NS
