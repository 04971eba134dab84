"""A profiled stretch of frames: torch.profiler's device spans and the
harness's own host ranges, as plain numbers the metric readers take.

The device ops are the profiler's CUDA events (kernels, copies, memsets;
not the device's copies of host ranges).  The host ranges are the
harness's record_function marks: 'bench.frame' around each frame and
'bench.trace' around each call into the tracer.  Each frame ends with its
image copied to the host, which waits for the device, so every device op
of a frame lies inside that frame's host range.
"""

from __future__ import annotations

import re

import torch

from . import window as W


def _name(op: str) -> str:
    """A kernel's name without its argument list."""
    return op.split("(")[0].strip()[:120]


def stretch(frame, n: int):
    """Run frame(i) for i in range(n) under the profiler; returns
    {"ops": [(name, start_ns, end_ns)], "frames": [(start_ns, end_ns)],
     "traces": [(start_ns, end_ns)], "lo": ns, "hi": ns}."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            with torch.profiler.record_function("bench.frame"):
                frame(i)
        torch.cuda.synchronize()
    DT = torch.autograd.DeviceType
    ops, frames, traces = [], [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        span = (s, s + e.duration_ns())
        if e.device_type() == DT.CUDA:
            if not e.is_user_annotation():
                ops.append((e.name(), *span))
        elif e.is_user_annotation():
            if e.name() == "bench.frame":
                frames.append(span)
            elif e.name() == "bench.trace":
                traces.append(span)
    frames.sort()
    traces.sort()
    if len(frames) != n:
        raise RuntimeError(f"profiler: {len(frames)} frame ranges for {n} "
                           f"frames")
    return {"ops": ops, "frames": frames, "traces": traces,
            "lo": frames[0][0], "hi": frames[-1][1]}


def busy_s(prof) -> float:
    return W.busy_ns([(a, b) for _n, a, b in prof["ops"]],
                     prof["lo"], prof["hi"]) / 1e9


def window_s(prof) -> float:
    return (prof["hi"] - prof["lo"]) / 1e9


def kernel_launches(prof, pattern: str):
    """Per frame, the (start, end) of each device op whose name matches
    `pattern` (a regex searched in the name), in time order."""
    rx = re.compile(pattern)
    hits = sorted((a, b) for name, a, b in prof["ops"] if rx.search(name))
    return [[(a, b) for a, b in hits if f0 <= a < f1]
            for f0, f1 in prof["frames"]]


def _inside(t, ranges):
    return any(a <= t < b for a, b in ranges)


def breakdown(prof, trace_label: str, outside_label: str) -> dict:
    """The device ops that took most time and the longest idle gaps, named
    by what the host was doing (inside a trace call, elsewhere in a
    frame, between frames); at most 10 each, seconds unrounded."""
    tot = {}
    for name, a, b in prof["ops"]:
        if b > prof["lo"] and a < prof["hi"]:
            k = _name(name)
            tot[k] = tot.get(k, 0.0) + (b - a) / 1e9
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    for a, b in W.idle_gaps([(a, b) for _n, a, b in prof["ops"]],
                            prof["lo"], prof["hi"])[:10]:
        mid = (a + b) // 2
        if _inside(mid, prof["traces"]):
            label = trace_label
        elif _inside(mid, prof["frames"]):
            label = outside_label
        else:
            label = "between frames (harness)"
        gaps.append([label, (b - a) / 1e9])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}
