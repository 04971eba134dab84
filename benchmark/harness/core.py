"""One run of one cell: set-up, the measured window, the traced metrics,
the check against the plain reference, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up is everything from the process's start to the first timed frame:
imports, the scene's compile, the upload, the kernels' builds (only the
first run in a checkout builds them, into build/), and the warm-up frames
of the mix, which build the megakernel plan and capture the compiled
frame's graphs at the widths the traffic uses.  Then the entry is called
back to back (a closed loop) until `seconds` have passed; the window ends
with the frame that crosses it.

--trace 0 prints the cell's end-to-end metrics.  --trace 1 runs the same
window with the harness's spans (the tracer behind a forwarding proxy,
synced at both edges), then a short profiled stretch of frames, and
prints the cell's per-layer metrics, `busy_s`, `window_s` and a
breakdown.  Both check the window's frames against the plain reference
once the window has closed, the peak memory has been read and the
program's state is freed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

import numpy as np
import torch

from . import check as CK
from . import guard
from . import manifest as M
from . import traffic as TR
from . import window as W

TRACE_LABEL = {"render": "render.trace", "aa": "aa.trace"}
OUTSIDE_LABEL = {"render": "render.outside_trace (ray set-up, scatter, copy)",
                 "aa": "aa.outside_trace (variance planes, pass set-up, copy)"}


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(M.ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")


def cuda_ready(chips: int) -> bool:
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return False
    if torch.cuda.device_count() < chips:
        log(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
            f"{chips}")
        return False
    return True


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(entry, offsets, seconds: float, device, keep: int, spans=None):
    """The closed-loop window: frames back to back until `seconds` have
    passed.  Returns (window seconds, each frame's seconds, the first
    `keep` frames' (rgb, depth), each frame's seconds outside its trace
    calls when `spans` is the tracer's SpanTracer)."""
    sync(device)
    kept, frame_s, outside_s = [], [], []
    t_start = time.perf_counter()
    t_end = t_start
    i = 0
    while t_end - t_start < seconds:
        n_spans = len(spans.spans_s) if spans is not None else 0
        t0 = time.perf_counter()
        rgb, t = entry.frame(offsets[i])
        t_end = time.perf_counter()
        frame_s.append(t_end - t0)
        if spans is not None:
            outside_s.append(frame_s[-1] - sum(spans.spans_s[n_spans:]))
        if i < keep:
            kept.append((rgb, t))
        i += 1
    return t_end - t_start, frame_s, kept, outside_s


def reference_frames(ref, mix, seed, frames_done):
    """The reference's answers for the run's check plan: [(frame index,
    flat pixel indices, rgb (n, 3), depth (n,))].  An AA frame is checked
    on whole tiles drawn from the seed, since AA decides by tile."""
    xres, yres = ref.cfg.xres, ref.cfg.yres
    offsets = TR.Offsets(mix, seed, TR.WINDOW)
    out = []
    for i, px in TR.check_plan(mix, seed, frames_done, xres * yres):
        fwd = TR.shifted_fwd(ref.cam.fwd, ref.cam.right, ref.cam.up, yres,
                             *offsets[i])
        if mix["entry"] == "aa":
            size = ref.cfg.blocksize
            tiles = TR.check_tiles(mix, seed, xres, yres, size)
            px = TR.tile_pixels(tiles, xres, yres, size)
            rgb, t = ref.aa_tiles(fwd, tiles)
        else:
            rgb, t = ref.pixels(fwd, px)
        out.append((i, px, rgb.reshape(-1, 3), t.reshape(-1)))
    return out


def tolerances(mix) -> dict:
    return {"rgb_tol": mix["rgb_tol"], "depth_rel": mix["depth_rel"]}


def compare_kept(kept, answers, mix):
    """The numbers of each checked frame of the window (`kept`, by frame
    index) against the reference's answers."""
    return [CK.compare(kept[i][0].reshape(-1, 3)[px],
                       kept[i][1].reshape(-1)[px], rgb, t, tolerances(mix))
            for i, px, rgb, t in answers]


def device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(args, start: float, device=None, sizes=None, root: str = M.ROOT):
    """One run; returns the result line's dict, or None when the card is
    missing.  `device` and `sizes` ({"xres", "yres"} and mix keys) are
    for the CPU tests, `root` for a checkout elsewhere; the benchmark
    passes none of them."""
    manifest = M.load(root)
    cell = M.cell(manifest, args.workload)
    conf = M.config(manifest, cell["config"], root)
    mix = dict(M.traffic(cell["traffic"], root))
    limits = M.limits(cell["name"], root)
    sizes = dict(sizes or {})
    xres = sizes.pop("xres", conf["xres"])
    yres = sizes.pop("yres", conf["yres"])
    mix.update(sizes)
    if device is None:
        if not cuda_ready(cell["chips"]):
            return None
        device = torch.device("cuda", 0)
    cache_dirs()
    rec = types.SimpleNamespace(
        cell=cell["name"], conf=conf, mix=mix, entry=mix["entry"],
        xres=xres, yres=yres, pixels=xres * yres, chips=cell["chips"],
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=device, start=start, prof=None, breakdown=None, busy=None,
        root=root)
    e2e, numbers, parts = measure_frames(rec)
    correct, rows = CK.verdict(numbers, limits)
    failed = sum(not CK.verdict(p, limits)[0] for p in parts)

    dev = rec.dev
    if args.trace:
        metrics = {}
        for m in M.per_layer(manifest, cell["name"]):
            v = M.reader(m["name"], root)(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if rec.busy is not None:
            dev["busy_s"], dev["window_s"] = rec.busy
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in M.end_to_end(manifest, cell["name"])}
    out = {"correct": bool(correct), "attempted": rec.items,
           "failed": failed, "metrics": metrics, "device": dev}
    if rec.breakdown is not None:
        out["breakdown"] = rec.breakdown
    out["setup_split"] = rec.split
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    found = guard.forbidden_loaded()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return {"forbidden": found}
    for k, v, lim in rows:
        log(f"check {k} {v!r} limit {lim!r}")
    return out


def free_device(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()


def measure_frames(rec):
    """A still or AA cell: set-up, the window of frames, the profiled
    stretch, then the check of the sampled frames against the reference.
    Returns (end-to-end values, compared numbers, per-frame numbers)."""
    from .program import SpanTracer, Entry, build_seconds
    device, mix = rec.device, rec.mix
    t0 = time.perf_counter()
    process_s = t0 - rec.start
    entry = Entry(rec.conf, mix["entry"], device, rec.xres, rec.yres)
    t0 = time.perf_counter()
    warm = TR.Offsets(mix, rec.seed, TR.WARMUP)
    for i in range(int(mix["warmup_frames"])):
        entry.frame(warm[i])
    sync(device)
    rec.split = dict(process_s=process_s, **entry.split,
                     warmup_s=time.perf_counter() - t0,
                     **build_seconds())
    totals0 = entry.graph_totals()
    setup_s = time.perf_counter() - rec.start
    rec.split["captures"] = totals0["captures"]

    offsets = TR.Offsets(mix, rec.seed, TR.WINDOW)
    spans = None
    if rec.trace:
        spans = SpanTracer(entry.tracer, sync=device.type == "cuda")
        entry.set_tracer(spans)
    window_s, frame_s, kept, outside_s = measure(
        entry, offsets, rec.seconds, device, int(mix["check_from_first"]),
        spans)
    n = rec.items = rec.frames = len(frame_s)
    rec.window_s, rec.frame_s, rec.outside_s = window_s, frame_s, outside_s
    rec.rays = list(entry.rays[-n:]) if entry.rays else []
    rec.captures = entry.graph_totals()["captures"] - totals0["captures"]
    rec.pool_bytes = entry.pool_bytes() if device.type == "cuda" else 0
    if rec.trace and device.type == "cuda":
        from . import profile as PF
        spans.sync = False
        n_prof = int(mix["profile_frames"])
        rec.prof = PF.stretch(lambda i: entry.frame(offsets[n + i]), n_prof)
        # each profiled frame's first-pass rays: every pixel, or the AA
        # frame's pass 1
        rec.prof_rays = ([r["pass1"] for r in entry.rays[-n_prof:]]
                         if mix["entry"] == "aa" else [rec.pixels] * n_prof)
        rec.busy = (PF.busy_s(rec.prof), PF.window_s(rec.prof))
        rec.breakdown = PF.breakdown(rec.prof, TRACE_LABEL[mix["entry"]],
                                     OUTSIDE_LABEL[mix["entry"]])
    rec.dev = device_info(device, rec.chips)
    e2e = {"frame_ms": W.per_item_ms(window_s, n),
           "frame_ms_p95": W.p95_ms(frame_s),
           "peak_mem_GiB": rec.dev["memory_peak_bytes"] / W.GiB,
           "setup_s": setup_s}
    log(f"window {window_s:.3f} s, {n} frames, {W.beyond_p95(frame_s)} "
        f"beyond p95; captures in the window {rec.captures}")
    log("set-up split " + json.dumps(rec.split))

    entry.free()
    del entry
    free_device(device)
    from ..reference import Reference
    t0 = time.perf_counter()
    ref = Reference(rec.conf, rec.xres, rec.yres, device, checkout=rec.root)
    parts = compare_kept(kept, reference_frames(ref, mix, rec.seed, n), mix)
    log(f"reference {time.perf_counter() - t0:.3f} s over {len(parts)} "
        f"frames")
    return e2e, CK.merge(parts), parts


def main(argv=None, start=None):
    start = time.perf_counter() if start is None else start
    args = parse(argv)
    out = run(args, start)
    if out is None:
        return 3
    if "forbidden" in out:
        return 4
    print(json.dumps(out), flush=True)
    return 0
