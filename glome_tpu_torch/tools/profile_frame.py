"""One frame of each path split by the program's own telemetry spans:
the frame's wall, the device's busy time and each kernel's, the K1-K5
launches, and per span its calls, host ms, self ms and the device busy
ms while it is open (the port's counterpart of the repository's
frame-profiling tools).

A workload runs once under torch.profiler (on the card; on the CPU only
with --trace) and is reported in one form for every workload and both
frames (--frame eager|compiled chooses the frame the tracer runs):

- on the card, the frame's ms by CUDA events (mean of 3 after a
  warm-up); the profiled run's host wall, device busy time and share,
  each kernel's device ms and the device ops that took the most time;
- the K1-K5 launches and their plain versions' calls, by the kernel
  wrappers' own counters (graphs.kernel_counters);
- on the compiled frame, the capture frame's seconds, the profiled
  frame's captures, replays and host reads (a replay frame captures
  nothing), the graph pools' bytes, and whether every compiled frame
  equalled the eager frame of a twin tracer;
- the spans of the frame records the run opened (telemetry.py, the
  spans the benchmark reads through benchmark/metrics/_spans.py): per
  span name its calls, host ms, self ms (less its child spans) and the
  device busy ms while a span of that name is open, with the device
  ops that took the most of it.  A row "(outside any span)" takes the
  time no span holds, so the rows' self ms sum to the profiled wall;
  then the records' counters and each kernel's live lanes over the
  lanes it launched.

The spans are the ones the program opens: render.* (Renderer.render),
aa.* (AARenderer.render) and wavefront.trace (WavefrontTracer.trace on
either route, with wavefront.count_read on the compiled frame); the
recursive Tracer opens render.* only.  A config 5 step opens no span of
its own: its bare trace calls are frame records of their own, and the
soft pass, the backward, Adam.step and the checkpoint fall in the
outside row.  Nothing in the program is patched, so the tool does not
show per-stage rows of the eager frame (finalize, pack_tables, the
texture fold, the group passes, per level), nor the config 5 step's
split into backward, Adam.step and the checkpoint; the device ops of
that time are named in the rows' top lists and in the --trace file.

Map from the repository's TPU tools:

| root tool | in the port |
| --- | --- |
| profile_frame.py (level marginal cost, queries per level width) | K1's lanes launched and live (the records' launches, one per batch and level) |
| profile_shade.py (fold / preshade / spawn / up-scatter) | the top device ops of wavefront.trace; not split by stage |
| profile_mega.py (mega_select vs finalize) | K1's device ms against the device busy time |
| profile_groups.py, profile_pieces.py, profile_honest.py (per group pass) | K4 and K5 launches and device ms on the group route; no row per group |
| profile_gap.py (standalone queries vs the frame) | the spans' self ms against the wall; (outside any span) |
| profile_trace.py, profile_xla.py (device-op table, trace file) | the top device ops; --trace |

Usage:

    python -m glome_tpu_torch.tools.profile_frame --scene test --route mega
    python -m glome_tpu_torch.tools.profile_frame --scene mesh100k \\
        --shadows --route groups
    python -m glome_tpu_torch.tools.profile_frame --scene test --aa
    python -m glome_tpu_torch.tools.profile_frame --scene test --config5
    python -m glome_tpu_torch.tools.profile_frame --scene mesh100k \\
        --shadows --frame compiled
        [--tracer wavefront|recursive] [--trace DIR]
        [--xres X --yres Y] [--device cuda|cpu] [--frame eager|compiled]

Full widths by default: TestScene 720x480 depth 3 (RenderConfig.tuned),
the meshes at 1920x1080 depth 1, the AA frame at 720x480, one config 5
step at 180x120.  The device is the card; without one the tool exits 2.
--device cpu runs the same frame on CPU tensors through the plain
kernel set and reports host columns only ("not measured" where a device
number would stand).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import os
import re
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from .. import graphs as G
from .. import telemetry as TM
from ..graphs import COMPILED, EAGER

OUTSIDE = "(outside any span)"
NOT_MEASURED = "not measured"
# the kernels' entry names on the card (csrc/*.cu)
KERNEL_NAMES = {"mega_select_kernel": "K1", "block_select_kernel": "K2",
                "mesh_block_select_kernel": "K3",
                "dense_select_kernel": "K4", "bvh_select_kernel": "K5"}
TOP = 5


def _counts():
    """K1-K5 launches on the card and their plain versions' calls, by the
    kernel wrappers' own counters."""
    return {f"K{i % 5 + 1}{' plain' if a == 'calls' else ''}": getattr(f, a)
            for i, (f, a) in enumerate(G.kernel_counters())}


# --- the profiler ------------------------------------------------------------

def kernel_base(name):
    """"void block_select_kernel<false>(float const*, ...)" ->
    "block_select_kernel"; "void at::native::(anonymous
    namespace)::indexSelectLargeIndex<...>(...)" ->
    "at::native::indexSelectLargeIndex"."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0].split()[-1] if name else name


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int            # Unix-epoch ns, the device's timeline
    end: int


def device_ops(prof):
    """The device ops (kernels, memcpys, memsets; not the device's copy of
    a record_function range) of a finished torch.profiler run, from the
    raw kineto events."""
    DT = torch.autograd.DeviceType
    return [DeviceOp(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DT.CUDA and not e.is_user_annotation()]


def busy_ms(ops):
    """Union of the ops' device spans, ms."""
    spans = sorted((o.start, o.end) for o in ops)
    if not spans:
        return 0.0
    busy, a0, b0 = 0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > b0:
            busy += b0 - a0
            a0, b0 = a, b
        else:
            b0 = max(b0, b)
    return (busy + b0 - a0) / 1e6


def top_ops(ops):
    """[(kernel base name, device ms, ops)] of `ops`, most time first."""
    by = {}
    for o in ops:
        acc = by.setdefault(kernel_base(o.name), [0.0, 0])
        acc[0] += (o.end - o.start) / 1e6
        acc[1] += 1
    return sorted(((n, ms, c) for n, (ms, c) in by.items()),
                  key=lambda r: -r[1])


def _activities(device):
    from torch.profiler import ProfilerActivity
    # CPU-only torch logs a stack trace per op under CUDA activity
    return ([ProfilerActivity.CPU, ProfilerActivity.CUDA]
            if torch.device(device).type == "cuda"
            else [ProfilerActivity.CPU])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _profiled(run, device, collect=True):
    """(run()'s result, host wall ns to the device's end of it, the
    finished torch.profiler run, or None without `collect`) of one call."""
    from torch.profiler import profile
    _sync(device)
    with (profile(activities=_activities(device)) if collect
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter_ns()
        result = run()
        _sync(device)
        wall = time.perf_counter_ns() - t0
    return result, wall, prof


def profile_kernels(run, names=(), top=0):
    """(host wall ms, device busy ms, {kernel name: device ms}) of one
    call of run() under torch.profiler on the card, for the named
    kernels (busy and the dict None where it saw no device time); with
    `top`, also prints the device ops that took the most time."""
    _res, wall, prof = _profiled(run, "cuda")
    ops = device_ops(prof)
    ranked = top_ops(ops)
    for nm, ms, cnt in ranked[:top]:
        print(f"    {ms:9.3f} ms in {cnt:6d} launches: {nm}")
    if not ops:
        return wall / 1e6, None, None
    per = dict.fromkeys(names, 0.0)
    per.update((n, ms) for n, ms, _c in ranked if n in per)
    return wall / 1e6, busy_ms(ops), per


def launch_split(fn, name, reps=10):
    """(host ms per wrapper call, device ms per recorded launch of the
    kernel `name` under torch.profiler, launches recorded) of `reps`
    calls of fn: CUDA events around back-to-back launches read the
    host's issue time instead of the kernel's when the wrapper is the
    slower of the two."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps

    def calls():
        for _ in range(reps):
            fn()
    _res, _wall, prof = _profiled(calls, "cuda")
    spans = [o.end - o.start for o in device_ops(prof)
             if kernel_base(o.name) == name]
    return host, sum(spans) / 1e6 / max(len(spans), 1), len(spans)


def timed(run):
    """ms per call of run() on the card by CUDA events, mean of 3 after a
    warm-up call."""
    run()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(3):
        run()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / 3


# --- the spans ---------------------------------------------------------------

@dataclasses.dataclass
class SpanRow:
    """A span name's calls, host ns and self ns (less its child spans)
    over a run's frame records; the device busy ms while a span of that
    name is open and top_ops of that time (None and [] where not
    measured)."""
    name: str
    calls: int
    host_ns: int
    self_ns: int
    busy_ms: Optional[float] = None
    top: list = dataclasses.field(default_factory=list)


def _clip(ops, spans):
    """The parts of the device ops that fall inside the (start, end)
    spans."""
    return [DeviceOp(o.name, max(o.start, a), min(o.end, b))
            for a, b in spans for o in ops if o.end > a and o.start < b]


def span_rows(recs, wall_ns, ops=None):
    """The spans of the telemetry frame records `recs` by name, in the
    order each name first opens, then the row OUTSIDE: `wall_ns` less
    each record's root span (the one it is named after, which holds the
    rest), so the rows' self ns sum to `wall_ns` where the self times
    partition the roots.  With `ops`, the profiler's DeviceOps of the
    run, a row's device busy ms is the union of the ops clipped to its
    spans' intervals, OUTSIDE's to the gaps between the root spans."""
    rows, spans, roots, root_ns = {}, {}, [], 0
    for rec in recs:
        if ops is not None and rec.spans is None:
            raise ValueError(f"frame record {rec.id} ({rec.name}) keeps no "
                             f"span intervals: the run opened more than "
                             f"{TM.INTERVALS_KEPT} records")
        for name, a, b, parent in rec.intervals():
            rows.setdefault(name, SpanRow(name, 0, 0, 0))
            spans.setdefault(name, []).append((a, b))
            if parent < 0:
                roots.append((a, b))
        for name, (calls, host, own) in rec.sums.items():
            r = rows.setdefault(name, SpanRow(name, 0, 0, 0))
            r.calls += calls
            r.host_ns += host
            r.self_ns += own
        root_ns += rec.sums[rec.name][1]
    out = SpanRow(OUTSIDE, 0, wall_ns - root_ns, wall_ns - root_ns)
    if ops is not None:
        edges = [t for ab in sorted(roots) for t in ab]
        spans[OUTSIDE] = list(zip([float("-inf")] + edges[1::2],
                                  edges[0::2] + [float("inf")]))
        for r in list(rows.values()) + [out]:
            part = _clip(ops, spans[r.name])
            r.busy_ms, r.top = busy_ms(part), top_ops(part)[:TOP]
    return list(rows.values()) + [out]


# --- the workloads -----------------------------------------------------------

@dataclasses.dataclass
class Workload:
    """One frame or step to profile: run() renders it through `tracer`;
    where the frame is compiled, eager() renders the same frame through
    the eager frame of a twin tracer, which every compiled frame must
    equal."""
    name: str
    run: Callable[[], object]
    tracer: object
    eager: Optional[Callable[[], object]] = None


def _same_frames(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def frame_workload(name, compiled, arrays, cam, cfg, route, recursive=False):
    """A Renderer.render frame through the wavefront tracer's eager frame
    (or the recursive Tracer) on `route`."""
    import glome_tpu_torch as T
    tracer = (T.Tracer(compiled, cfg, route=route) if recursive else
              T.WavefrontTracer(compiled, cfg, route=route, frame=EAGER))
    renderer = T.Renderer(tracer, cam, cfg)
    return Workload(name, lambda: renderer.render(arrays), tracer)


def aa_workload(name, compiled, arrays, cam, cfg, route):
    """An AARenderer.render frame over the wavefront tracer's eager
    frame."""
    import glome_tpu_torch as T
    tracer = T.WavefrontTracer(compiled, cfg, route=route, frame=EAGER)
    aa = T.AARenderer(tracer, cam, cfg)
    return Workload(name, lambda: aa.render(arrays), tracer)


def config5_workload(compiled, arrays, cam, xres, yres):
    """One Adam step of BASELINE config 5 (tools/config5_e2e.py's loss,
    perturbation and filter) from the perturbed scene, with a checkpoint
    written into a fresh temporary directory."""
    import glome_tpu_torch as T
    from glome_tpu_torch.soft import SoftTracer
    from glome_tpu_torch.tools import config5_e2e as C5
    # the package exports the function optimize, which hides the module
    OPT = importlib.import_module("glome_tpu_torch.optimize")
    cfg = T.RenderConfig.tuned(xres=xres, yres=yres)
    tracer = T.WavefrontTracer(compiled, cfg, frame=EAGER)
    target, _aa = C5.aa_target(tracer, cam, cfg, arrays)
    o, d = C5.pixel_rays(tracer, cam, cfg, arrays["lights"]["pos"].device)
    pert = C5.perturb(arrays)
    loss_fn = C5.coarse_to_fine_loss(SoftTracer(tracer), yres, xres)

    def run():
        ckpt = tempfile.mkdtemp(prefix="profile_frame_ckpt_")
        try:
            return OPT.optimize(tracer, pert, o, d, target, steps=1,
                                lr=5e-3, checkpoint_dir=ckpt,
                                checkpoint_every=1, loss_fn=loss_fn,
                                grad_filter=C5.only_group())
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
    return Workload(f"config 5 step {xres}x{yres}", run, tracer)


def compiled_workload(name, compiled, arrays, cam, cfg, aa=False):
    """The compiled frame of a megakernel-route wavefront tracer, with the
    eager frame of its twin: the frame's trace on rays built once, every
    pixel in tile order (tools/bench.py's frame, so the reading holds no
    ray set-up of Renderer.render), or with `aa` an AARenderer.render
    frame."""
    import glome_tpu_torch as T
    from . import bench
    tracer = T.WavefrontTracer(compiled, cfg, frame=COMPILED)
    eager = T.WavefrontTracer(compiled, cfg, frame=EAGER)
    if aa:
        r, e = T.AARenderer(tracer, cam, cfg), T.AARenderer(eager, cam, cfg)
        return Workload(name, lambda: r.render(arrays), tracer,
                        lambda: e.render(arrays))
    o, d, _perm = bench.frame_rays(T.Renderer(tracer, cam, cfg),
                                   arrays["lights"]["pos"].device)
    return Workload(name, lambda: tuple(tracer.trace(arrays, o, d)), tracer,
                    lambda: tuple(eager.trace(arrays, o, d)))


# --- the report --------------------------------------------------------------

@dataclasses.dataclass
class Report:
    """One profiled run of a Workload; device numbers are None where not
    measured.  frame_ms: the frame by CUDA events, mean of 3 after a
    warm-up; wall_ns, busy_ms, kernel_ms: the profiled run's host wall,
    device busy time and each kernel's device ms; counts: its K1-K5
    launches and plain calls; spans: span_rows of the records it opened,
    and program: their counters summed.  On the compiled frame:
    capture_s, the profiled frame's captures, replays and host reads
    (per_frame), the graph pools' bytes and whether every compiled frame
    equalled the eager frame (same); None on the eager frame."""
    name: str
    frame_ms: Optional[float]
    wall_ns: int
    busy_ms: Optional[float]
    kernel_ms: Optional[Dict[str, float]]
    counts: Dict[str, int]
    spans: List[SpanRow]
    program: Dict[str, int]
    capture_s: Optional[float] = None
    per_frame: Optional[Dict[str, int]] = None
    pool_bytes: Optional[int] = None
    same: Optional[bool] = None

    def row(self, name):
        return next((r for r in self.spans if r.name == name), None)


def _ms(v):
    return f"{v:10.3f}" if v is not None else f"{NOT_MEASURED:>10}"


def profile(w: Workload, device, smi=None, trace_dir=None):
    """Profile w and print its report (see Report): on the compiled frame
    the capture frame and the eager frame first; on the card the frame's
    ms by CUDA events; then one run under torch.profiler, which on the
    CPU runs only to write the trace file into `trace_dir`."""
    cuda = torch.device(device).type == "cuda"
    compiled = w.eager is not None
    capture_s = same = per_frame = pool = None
    if compiled:
        _sync(device)
        t0 = time.perf_counter()
        first = w.run()
        _sync(device)
        capture_s = time.perf_counter() - t0
        ref = w.eager()
        same = _same_frames(first, ref)
    frame_ms = timed(w.run) if cuda else None
    totals = w.tracer.graphs.totals if compiled else {}
    before = dict(totals)
    c0 = _counts()
    kept = TM.frames()
    last = kept[-1].id if kept else -1
    result, wall, prof = _profiled(w.run, device, cuda or bool(trace_dir))
    counts = {k: v - c0[k] for k, v in _counts().items()}
    recs = [f for f in TM.frames() if f.id > last]
    ops = device_ops(prof) if cuda else None
    busy = kernel_ms = None
    if ops:
        busy = busy_ms(ops)
        kernel_ms = {KERNEL_NAMES[n]: ms for n, ms, _c in top_ops(ops)
                     if n in KERNEL_NAMES}
    spans = span_rows(recs, wall, ops or None)
    program = {}
    for rec in recs:
        for k, v in rec.counts.items():
            program[k] = program.get(k, 0) + v
    if compiled:
        per_frame = {k: totals[k] - before[k] for k in totals}
        same = same and _same_frames(result, ref)
        pool = w.tracer.graphs.pool_bytes() if cuda else 0

    tag = f"[{smi}] " if smi else "[cpu] "
    print(f"{tag}{w.name}, {'compiled' if compiled else 'eager'} frame: "
          + (f"{frame_ms:.3f} ms by CUDA events (mean of 3 after a "
             f"warm-up)" if cuda else f"ms by CUDA events {NOT_MEASURED}")
          + f"; profiled host wall {wall / 1e6:.3f} ms, device busy "
          + (f"{busy:.3f} ms ({100 * busy / (wall / 1e6):.1f}% of the wall)"
             if busy is not None else NOT_MEASURED))
    if compiled:
        print(f"  capture frame {capture_s:.3f} s; the profiled frame's "
              f"{per_frame}; graph pools {pool} bytes; every compiled "
              f"frame equal to the eager frame: {same}")
    print(f"  launches and plain calls {counts}")
    if ops:
        print("  kernels' device ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in kernel_ms.items()))
        print("  top device ops: " + "; ".join(
            f"{ms:.3f} ms x{n} {nm}" for nm, ms, n in top_ops(ops)[:TOP]))
    print("  the program's spans (telemetry): calls, host ms, self ms, "
          "device busy ms while open")
    for r in spans:
        print(f"    {r.name:24s} {r.calls:4d} {r.host_ns / 1e6:10.3f} "
              f"{r.self_ns / 1e6:10.3f} {_ms(r.busy_ms)}")
        if r.top:
            print("      top: " + "; ".join(
                f"{ms:.3f} ms x{n} {nm}" for nm, ms, n in r.top))
    print(f"  the records' counters: {program}")
    for k in sorted({n[:-len(".lanes")] for n in program
                     if n.endswith(".lanes")}):
        print(f"  {k.upper()} lanes launched {program[k + '.lanes']}, live "
              f"{program.get(k + '.live_lanes', 0)}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, re.sub(r"[^\w.-]+", "_", w.name)
                            + ".json")
        prof.export_chrome_trace(path)
        print(f"  Chrome trace of the profiled run: {path}")
    return Report(w.name, frame_ms, wall, busy, kernel_ms, counts, spans,
                  program, capture_s, per_frame, pool, same)


def build(args, device):
    """The Workload the command line names."""
    import glome_tpu_torch as T
    from glome_tpu_torch.intersect import GROUPS, MEGA
    from glome_tpu_torch.scenes import mesh_scene, test_scene
    route = GROUPS if args.route == "groups" else MEGA
    wavefront_mega = route == MEGA and args.tracer == "wavefront"
    if args.config5 and not (args.scene == "test" and wavefront_mega
                             and not args.aa and args.frame == EAGER):
        raise SystemExit("--config5 is the TestScene step on the megakernel "
                         "route through the wavefront tracer's eager frame")
    if args.frame == COMPILED and not wavefront_mega:
        raise SystemExit("--frame compiled is the wavefront tracer's frame "
                         "on the megakernel route")
    if args.scene == "test":
        solid, lights, cam = test_scene()
    else:
        n = {"mesh100k": 100_000, "mesh250k": 250_000}[args.scene]
        solid, lights, cam = mesh_scene(n, cast_shadows=args.shadows)
    compiled = T.compile_scene(solid, lights)
    arrays = T.to_torch(compiled.arrays(), device)
    if args.config5:
        return config5_workload(compiled, arrays, cam, args.xres or 180,
                                args.yres or 120)
    size = {}
    if args.xres:
        size["xres"] = args.xres
    if args.yres:
        size["yres"] = args.yres
    if args.scene == "test":
        cfg = T.RenderConfig.tuned(**size)
    else:
        cfg = T.RenderConfig(**{"xres": 1920, "yres": 1080, **size},
                             maxdepth=1)
    what = (f"{args.scene}{' self-shadowing' if args.shadows else ''} "
            f"{cfg.xres}x{cfg.yres} depth {cfg.maxdepth}, {args.route} "
            f"route")
    if args.frame == COMPILED:
        return compiled_workload(f"{'AA ' if args.aa else ''}{what}",
                                 compiled, arrays, cam, cfg, args.aa)
    if args.aa:
        return aa_workload(f"AA {what}", compiled, arrays, cam, cfg, route)
    return frame_workload(f"{what}, {args.tracer} tracer", compiled, arrays,
                          cam, cfg, route, args.tracer == "recursive")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="test",
                    choices=("test", "mesh100k", "mesh250k"))
    ap.add_argument("--shadows", action="store_true",
                    help="mesh self-shadowing (cast_shadows)")
    ap.add_argument("--route", default="mega", choices=("mega", "groups"))
    ap.add_argument("--tracer", default="wavefront",
                    choices=("wavefront", "recursive"))
    ap.add_argument("--aa", action="store_true",
                    help="the adaptive-AA frame")
    ap.add_argument("--config5", action="store_true",
                    help="one BASELINE config 5 step (180x120)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a Chrome trace of the profiled run")
    ap.add_argument("--xres", type=int, default=None)
    ap.add_argument("--yres", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--frame", default=EAGER, choices=(EAGER, COMPILED),
                    help="the frame the wavefront tracer runs: eager (op "
                    "by op, the default) or compiled (graph replays)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_frame: no CUDA device (--device cpu runs the plain "
              "kernel set on the CPU)", file=sys.stderr)
        return 2
    from glome_tpu_torch.tools.config5_e2e import nvidia_smi
    device = torch.device("cuda", 0) if args.device == "cuda" else \
        torch.device("cpu")
    smi = nvidia_smi() if device.type == "cuda" else None
    if smi:
        print(smi)
    rep = profile(build(args, device), device, smi, args.trace)
    return 0 if rep.same is not False and not (
        rep.per_frame or {}).get("captures") else 1


if __name__ == "__main__":
    sys.exit(main())
