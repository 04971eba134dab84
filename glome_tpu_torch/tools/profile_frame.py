"""One frame of each path split by the port's own stages: host time,
the device time of the kernels each stage launched, and the launches
(the port's counterpart of the repository's frame-profiling tools).

For every stage of STAGES that the frame reaches, one row per (stage,
level, group): its calls and rays, its host ms inclusive and exclusive
of the nested stages, the device ms of the kernels launched inside it
and not inside a nested stage, K1-K5 launches by the kernel wrappers'
own counters beside the profiler's count, and the five device ops that
took it the most time (PyTorch's own kernels included).  A row
"(outside any stage)" takes what no stage encloses, so the rows' device
ms partition the profiler's device time and their exclusive host ms sum
to the profiled wall.  A stage's host time includes the device time it
waited for at a synchronising call (exact compaction's torch.nonzero,
.item(), .cpu()); the level of a row is the index of the enclosing
WavefrontTracer._down_level (or _up_level) call, or the depth of
Tracer._trace, and the group is "scene.g<group>" (or "scene.csg<id>")
on the pass-per-group route.  Every workload runs the wavefront
tracer's eager frame (graphs.EAGER): its stages are Python functions,
which a replay of the compiled frame never calls.

--frame compiled reports the compiled frame instead (graphs.COMPILED,
the default of Renderer and AARenderer on the card), which has no
stages to split, on the frame's trace of rays built once (as
tools/bench.py's frames) or the AA frame: its capture frame's seconds,
the replay frame's ms
unprofiled, one profiled replay frame's host wall, device busy time and
share, each kernel's device ms, K1-K5 launches and plain calls per
frame, captures, replays and host reads per frame, and the graph
pools' bytes; each compiled frame must equal the eager frame of the
same tracer, and a replay frame must capture nothing.  The profiled
replay frame is also split by the program's own spans (telemetry.py):
per span name its calls, host ms, self ms (less its child spans) and
the device busy ms while it is open, and K1's live lanes over its
launched lanes.

The stages are wrapped from outside, where their callers look them up,
for one profiled run (staged()), and the original objects are put back
afterwards; no module of the package changes.  The backward of a config
5 step runs on autograd's engine threads: its row is the host time of
Tensor.backward plus the kernels launched, on any thread, while it ran.

Map from the repository's TPU tools:

| root tool | in the port |
| --- | --- |
| profile_frame.py (level marginal cost, queries per level width) | --depths; stage rows by level and rays |
| profile_shade.py (fold / preshade / spawn / up-scatter) | Tracer._fold_textures, the self time of _down_level (light contributions + child spawn), shadow_rays, _up_level |
| profile_mega.py (mega_select vs finalize) | the pack_tables / mega_select / finalize rows |
| profile_groups.py, profile_pieces.py, profile_honest.py (per group pass) | the group-route rows by group |
| profile_gap.py (standalone queries vs the frame) | the rows' sum against the frame; (outside any stage) |
| profile_trace.py, profile_xla.py (device-op table, trace file) | top device ops per stage; --trace |

Usage:

    python -m glome_tpu_torch.tools.profile_frame --scene test --route mega
    python -m glome_tpu_torch.tools.profile_frame --scene mesh100k \\
        --shadows --route groups
    python -m glome_tpu_torch.tools.profile_frame --scene test --aa
    python -m glome_tpu_torch.tools.profile_frame --scene test --config5
    python -m glome_tpu_torch.tools.profile_frame --scene mesh100k \\
        --shadows --frame compiled
        [--tracer wavefront|recursive] [--depths] [--trace DIR]
        [--xres X --yres Y] [--device cuda|cpu] [--frame eager|compiled]

Full widths by default: TestScene 720x480 depth 3 (RenderConfig.tuned),
the meshes at 1920x1080 depth 1, the AA frame at 720x480, one config 5
step at 180x120.  The device is the card; without one the tool exits 2.
--device cpu runs the same stages on CPU tensors through the plain
kernel set and reports host columns only ("not measured" where a device
number would stand).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import inspect
import os
import re
import shutil
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import graphs as G
from .. import telemetry as TM
from ..graphs import COMPILED, EAGER

OUTSIDE = "(outside any stage)"
NOT_MEASURED = "not measured"
# the kernels' entry names on the card (csrc/*.cu)
KERNEL_NAMES = {"mega_select_kernel": "K1", "block_select_kernel": "K2",
                "mesh_block_select_kernel": "K3",
                "dense_select_kernel": "K4", "bvh_select_kernel": "K5"}
TOP = 5


# --- the stages --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Stage:
    """One stage: `sites` are the "module:attribute" (or
    "module:Class.attribute") names its callers look it up by, the first
    where it is defined; `label(arguments, session)` reads the call's
    bound arguments into row fields (rays, level, si, gi, csg)."""
    name: str
    sites: Tuple[str, ...]
    label: Optional[Callable] = None


def _rays(key, axis=0):
    return lambda a, s: {"rays": int(a[key].shape[axis])}


def _group(key="o"):
    return lambda a, s: {"gi": int(a["gi"]), "rays": int(a[key].shape[0])}


def _csg(a, s):
    cid = next(i for i, c in enumerate(a["sc"].csgs) if c is a["csg"])
    return {"csg": cid, "rays": int(a["o"].shape[0])}


_P = "glome_tpu_torch."
_TRACE, _WF, _INT = _P + "trace", _P + "trace_wavefront", _P + "intersect"
_MK, _RENDER, _AA, _SOFT = (_P + "megakernel", _P + "render", _P + "aa",
                            _P + "soft")

STAGES = (
    # the frame
    Stage("Renderer.render", (f"{_RENDER}:Renderer.render",),
          lambda a, s: {"rays": a["self"].config.xres
                        * a["self"].config.yres}),
    Stage("Renderer.rays_for_pixels", (f"{_RENDER}:Renderer.rays_for_pixels",),
          lambda a, s: {"rays": len(a["xf"])}),
    Stage("WavefrontTracer.trace", (f"{_WF}:WavefrontTracer.trace",),
          lambda a, s: s.begin_trace(int(a["o"].shape[0]))),
    Stage("WavefrontTracer._down_level",
          (f"{_WF}:WavefrontTracer._down_level",),
          lambda a, s: {"level": s.next_down(),
                        "rays": int(a["Q"].shape[1])}),
    Stage("shadow_rays", (f"{_WF}:shadow_rays",),
          lambda a, s: {"rays": int(a["hit"].t.shape[0])}),
    Stage("WavefrontTracer._up_level", (f"{_WF}:WavefrontTracer._up_level",),
          lambda a, s: {"level": s.next_up(),
                        "rays": int(a["stored"]["t"].shape[0])}),
    Stage("Tracer._fold_textures", (f"{_TRACE}:Tracer._fold_textures",),
          lambda a, s: {"rays": int(a["shape"][0])}),
    Stage("Tracer.trace", (f"{_TRACE}:Tracer.trace",),
          lambda a, s: s.begin_trace(int(a["o"].shape[0]))),
    Stage("Tracer._trace", (f"{_TRACE}:Tracer._trace",),
          lambda a, s: {"level": s.depth("Tracer._trace"),
                        "rays": int(a["o"].shape[0])}),
    Stage("Tracer._trace_children", (f"{_TRACE}:Tracer._trace_children",),
          _rays("o")),
    # the intersection entries of both routes
    Stage("intersect_multi_table",
          (f"{_INT}:intersect_multi_table", f"{_TRACE}:intersect_multi_table",
           f"{_WF}:intersect_multi_table"), _rays("table", 1)),
    Stage("shadow_query_table",
          (f"{_INT}:shadow_query_table", f"{_TRACE}:shadow_query_table",
           f"{_WF}:shadow_query_table"), _rays("table", 1)),
    # the megakernel route
    Stage("pack_tables", (f"{_MK}:pack_tables",)),
    Stage("mega_select", (f"{_MK}:mega_select",), _rays("rays", 1)),
    Stage("_run_blocks", (f"{_MK}:_run_blocks",), _rays("rays", 1)),
    Stage("_run_external", (f"{_MK}:_run_external",), _rays("rays", 1)),
    Stage("finalize", (f"{_MK}:finalize",), _rays("o")),
    # the pass-per-group route
    Stage("intersect_multi", (f"{_INT}:intersect_multi",), _rays("o")),
    Stage("shadow_query_multi", (f"{_INT}:shadow_query_multi",), _rays("o")),
    Stage("intersect", (f"{_INT}:intersect", f"{_TRACE}:intersect",
                        "glome_tpu_torch:intersect"),
          lambda a, s: {"si": int(a["scene_id"]),
                        "rays": int(a["o"].shape[0])}),
    Stage("materialize_scene_params",
          (f"{_P}compile:materialize_scene_params",
           f"{_INT}:materialize_scene_params",
           f"{_P}query:materialize_scene_params")),
    Stage("convex_pass", (f"{_INT}:convex_pass",), _csg),
    Stage("_finalize_convex", (f"{_INT}:_finalize_convex",), _csg),
    Stage("dense_args", (f"{_INT}:dense_args",),
          lambda a, s: {"gi": int(a["gi"])}),
    Stage("dense_pass", (f"{_INT}:dense_pass",), _group()),
    Stage("bvh_args", (f"{_INT}:bvh_args",),
          lambda a, s: {"gi": int(a["gi"])}),
    Stage("bvh_dispatch", (f"{_INT}:bvh_dispatch",), _group()),
    Stage("_finalize_winner", (f"{_INT}:_finalize_winner",), _group()),
    Stage("_deferred_group", (f"{_INT}:_deferred_group",), _group()),
    Stage("group_inside_any", (f"{_INT}:group_inside_any",
                               f"{_P}query:group_inside_any"), _group("pts")),
    # adaptive AA (the rest of render is the variance planes)
    Stage("AARenderer.render", (f"{_AA}:AARenderer.render",)),
    Stage("AARenderer._trace_pixels", (f"{_AA}:AARenderer._trace_pixels",),
          lambda a, s: {"rays": len(a["xf"])}),
    Stage("AARenderer._masked_trace", (f"{_AA}:AARenderer._masked_trace",)),
    # config 5: the soft pass, the backward, Adam and the checkpoints
    Stage("SoftTracer.render", (f"{_SOFT}:SoftTracer.render",), _rays("o")),
    Stage("SoftTracer._soft_pass", (f"{_SOFT}:SoftTracer._soft_pass",),
          _rays("o")),
    Stage("SoftTracer._csg_margin", (f"{_SOFT}:SoftTracer._csg_margin",),
          _rays("p")),
    Stage("SoftTracer._shade_point", (f"{_SOFT}:SoftTracer._shade_point",),
          _rays("d")),
    Stage("optimize", (f"{_P}optimize:optimize", "glome_tpu_torch:optimize"),
          _rays("o")),
    Stage("backward", ("torch:Tensor.backward",)),
    Stage("Adam.step", ("torch.optim:Adam.step",)),
    Stage("optimize._save", (f"{_P}optimize:_save",)),
)


def _counters():
    """(name, function, attribute) of the kernel wrappers' own counters:
    K1-K5 launches on the card, and their plain versions' calls."""
    return tuple((f"K{i % 5 + 1}{' plain' if a == 'calls' else ''}", f, a)
                 for i, (f, a) in enumerate(G.kernel_counters()))


@dataclasses.dataclass
class Row:
    """One (stage, level, group) of a split; host times in ns, device
    time in ms (None where not measured)."""
    stage: str
    level: Optional[int]
    group: str
    calls: int = 0
    rays: Optional[int] = None
    host_ns: int = 0
    self_ns: int = 0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    device_ms: Optional[float] = None
    ops: Dict[str, List] = dataclasses.field(default_factory=dict)

    @property
    def key(self):
        return (self.stage, self.level, self.group)

    @property
    def host_ms(self):
        return self.host_ns / 1e6

    @property
    def self_ms(self):
        return self.self_ns / 1e6

    def profiled_launches(self):
        """{"K1": n, ...} of the kernel launches the profiler recorded."""
        out = {}
        for name, (_ms, n) in self.ops.items():
            k = KERNEL_NAMES.get(kernel_base(name))
            if k:
                out[k] = out.get(k, 0) + n
        return out


@dataclasses.dataclass
class _Frame:
    key: tuple
    level: Optional[int]
    si: Optional[int]
    c0: List[int]
    t0: int
    child_ns: int = 0
    child_counts: Optional[List[int]] = None


class Session:
    """What staged() records: a Row per (stage, level, group), the
    profiler range of every call (by its sequence number), and the
    counters' totals of the calls that no stage encloses."""

    def __init__(self):
        self.thread = threading.get_ident()
        self.counters = _counters()
        self.stack: List[_Frame] = []
        self.rows: Dict[tuple, Row] = {}
        self.keys: Dict[int, tuple] = {}
        self.seq = 0
        self.top_ns = 0
        self.top_counts = [0] * len(self.counters)
        self._down = self._up = 0

    # label helpers: the level of the wavefront tracer's levels
    def begin_trace(self, rays):
        self._down = self._up = 0
        return {"level": None, "rays": rays}

    def next_down(self):
        self._down += 1
        return self._down - 1

    def next_up(self):
        self._up += 1
        return self._down - self._up

    def depth(self, stage):
        return sum(1 for f in self.stack if f.key[0] == stage)

    def counts(self):
        return [getattr(fn, attr) for _n, fn, attr in self.counters]

    def call(self, stage, sig, orig, args, kwargs):
        if threading.get_ident() != self.thread:
            return orig(*args, **kwargs)
        try:
            bound = sig.bind(*args, **kwargs).arguments
        except TypeError:
            return orig(*args, **kwargs)
        fields = stage.label(bound, self) if stage.label else {}
        parent = self.stack[-1] if self.stack else None
        level = (fields["level"] if "level" in fields
                 else parent.level if parent else None)
        si = fields.get("si", parent.si if parent else None)
        group = ""
        if "gi" in fields:
            group = f"{si}.g{fields['gi']}"
        elif "csg" in fields:
            group = f"{si}.csg{fields['csg']}"
        key = (stage.name, level, group)
        seq = self.seq
        self.seq += 1
        self.keys[seq] = key
        row = self.rows.get(key)
        if row is None:
            row = self.rows[key] = Row(*key)
            row.counts = {n: 0 for n, _f, _a in self.counters}
        fr = _Frame(key, level, si, self.counts(), time.perf_counter_ns(),
                    child_counts=[0] * len(self.counters))
        self.stack.append(fr)
        try:
            with torch.profiler.record_function(f"{_key_text(key)} #{seq}"):
                return orig(*args, **kwargs)
        finally:
            t1 = time.perf_counter_ns()
            dc = [b - a for a, b in zip(fr.c0, self.counts())]
            self.stack.pop()
            incl = t1 - fr.t0
            row.calls += 1
            if fields.get("rays") is not None:
                row.rays = (row.rays or 0) + fields["rays"]
            row.host_ns += incl
            row.self_ns += incl - fr.child_ns
            for (n, _f, _a), d, c in zip(self.counters, dc, fr.child_counts):
                row.counts[n] += d - c
            if self.stack:
                up = self.stack[-1]
                up.child_ns += incl
                up.child_counts = [a + b for a, b in zip(up.child_counts, dc)]
            else:
                self.top_ns += incl
                self.top_counts = [a + b for a, b in
                                   zip(self.top_counts, dc)]


def _key_text(key):
    stage, level, group = key
    return (stage + ("" if level is None else f" L{level}")
            + (f" {group}" if group else ""))


def _resolve(site):
    """(holder, attribute) of a "module:qualname" site; raises
    AttributeError where it does not exist (a class must define the
    attribute itself)."""
    mod, _, qual = site.partition(":")
    holder = importlib.import_module(mod)
    parts = qual.split(".")
    for p in parts[:-1]:
        holder = getattr(holder, p)
    attr = parts[-1]
    if isinstance(holder, type):
        if attr not in holder.__dict__:
            raise AttributeError(f"{site}: {holder.__qualname__} defines no "
                                 f"{attr!r}")
    elif not hasattr(holder, attr):
        raise AttributeError(f"{site}: {mod} has no {attr!r}")
    return holder, attr


def _wrapper(stage, orig, session):
    sig = inspect.signature(orig)

    def wrapped(*args, **kwargs):
        return session.call(stage, sig, orig, args, kwargs)
    # the same attribute dict: a kernel wrapper's body counts its launches
    # on the object its module name holds, which is now this one
    wrapped.__dict__ = orig.__dict__
    wrapped.__name__ = orig.__name__
    wrapped.__qualname__ = orig.__qualname__
    wrapped.__doc__ = orig.__doc__
    return wrapped


@contextlib.contextmanager
def staged(stages=STAGES):
    """Wrap every stage where its callers look it up, in a
    torch.profiler.record_function range that counts its calls and
    records its labels; yields the Session.  On exit every site holds
    its original object again.  A site that does not exist, a site that
    holds another object than the stage's first, or a module of the
    package that reads a stage by a name its sites do not list raises,
    so a renamed function fails instead of reading 0."""
    session = Session()
    plan = []
    for st in stages:
        sites = [_resolve(site) for site in st.sites]
        objs = [h.__dict__[a] if isinstance(h, type) else getattr(h, a)
                for h, a in sites]
        if any(o is not objs[0] for o in objs):
            raise ValueError(f"stage {st.name}: its sites {st.sites} hold "
                             f"different objects")
        plan.append((st, objs[0], sites))
    listed = {(h.__name__, a) for _st, _o, sites in plan for h, a in sites
              if not isinstance(h, type)}
    by_id = {id(o): st.name for st, o, _s in plan}
    for name, mod in list(sys.modules.items()):
        if not (name == "glome_tpu_torch" or name.startswith(_P)) \
                or name.startswith(_P + "tools") or mod is None:
            continue
        for attr, val in vars(mod).items():
            if id(val) in by_id and (name, attr) not in listed:
                raise LookupError(
                    f"stage {by_id[id(val)]}: {name}.{attr} reads it by "
                    f"name; add {name}:{attr} to its sites")
    patched = []
    try:
        for st, orig, sites in plan:
            w = _wrapper(st, orig, session)
            for h, a in sites:
                setattr(h, a, w)
                patched.append((h, a, orig))
        yield session
    finally:
        for h, a, orig in reversed(patched):
            setattr(h, a, orig)


# --- the profiler -----------------------------------------------------------

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
    start: int            # device ns
    end: int
    host: Optional[int]   # host ns of its launch (None: not linked)


def device_ops(prof):
    """(device ops, stage ranges) of a finished torch.profiler run, from
    the raw kineto events.  A device op (kernel, memcpy, memset; not the
    device's copy of a record_function range) carries the host time of
    its launch: the runtime call with its correlation id, else the start
    of the PyTorch op its launch is linked to.  Stage ranges are
    (start ns, end ns, sequence number) of staged()'s records."""
    DT = torch.autograd.DeviceType
    ops, runtime, front, ranges = [], {}, {}, []
    for e in prof.profiler.kineto_results.events():
        dt = e.device_type()
        if dt == DT.CUDA:
            if not e.is_user_annotation():
                ops.append(e)
        elif dt == DT.CPU:
            name = e.name()
            if e.is_user_annotation():
                m = re.search(r" #(\d+)$", name)
                if m:
                    s = e.start_ns()
                    ranges.append((s, s + e.duration_ns(), int(m.group(1))))
            elif name.startswith("cu"):   # runtime / driver API calls
                runtime[e.correlation_id()] = e.start_ns()
            elif e.linked_correlation_id() == 0:
                front[e.correlation_id()] = e.start_ns()
    out = []
    for e in ops:
        host = runtime.get(e.correlation_id())
        if host is None:
            host = front.get(e.linked_correlation_id())
        s = e.start_ns()
        out.append(DeviceOp(e.name(), s, s + e.duration_ns(), host))
    return out, sorted(ranges)


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


def attribute(ops, ranges):
    """[sequence number of the innermost stage range whose host span
    holds each op's launch, or None] in the order of `ops`; `ranges`
    sorted by start, nested (one thread)."""
    order = sorted(range(len(ops)), key=lambda i: (ops[i].host is None,
                                                   ops[i].host or 0))
    out = [None] * len(ops)
    stack, j = [], 0
    for i in order:
        t = ops[i].host
        if t is None:
            continue
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def _activities(device):
    from torch.profiler import ProfilerActivity
    # CPU-only torch logs a stack trace per op under CUDA activity
    return ([ProfilerActivity.CPU, ProfilerActivity.CUDA]
            if torch.device(device).type == "cuda"
            else [ProfilerActivity.CPU])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def profile_kernels(run, names=(), top=0, keep_ops=None):
    """(host wall ms, device busy ms, {kernel name: device ms}) of one
    call of run() under torch.profiler on the card, for the named
    kernels (busy and the dict None where it saw no device time); with
    `top`, also prints the device ops that took the most time; the
    list `keep_ops`, where given, receives the DeviceOps."""
    from torch.profiler import profile
    torch.cuda.synchronize()
    with profile(activities=_activities("cuda")) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops, _ranges = device_ops(prof)
    if keep_ops is not None:
        keep_ops.extend(ops)
    per, by_name = dict.fromkeys(names, 0.0), {}
    for o in ops:
        ms = (o.end - o.start) / 1e6
        if kernel_base(o.name) in per:
            per[kernel_base(o.name)] += ms
        tot, cnt = by_name.get(o.name[:90], (0.0, 0))
        by_name[o.name[:90]] = (tot + ms, cnt + 1)
    for nm, (ms, cnt) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top or 0]:
        print(f"    {ms:9.3f} ms in {cnt:6d} launches: {nm}")
    if not ops:
        return wall, None, None
    return wall, busy_ms(ops), per


def launch_split(fn, name, reps=10):
    """(host ms per wrapper call, device ms per recorded launch of the
    kernel `name` under torch.profiler, launches recorded) of `reps`
    calls of fn: CUDA events around back-to-back launches read the
    host's issue time instead of the kernel's when the wrapper is the
    slower of the two."""
    from torch.profiler import profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    with profile(activities=_activities("cuda")) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [o.end - o.start for o in device_ops(prof)[0]
             if kernel_base(o.name) == name]
    return host, sum(spans) / 1e6 / max(len(spans), 1), len(spans)


@dataclasses.dataclass
class Split:
    """One profiled run split by stage.  Device numbers are None on a
    CPU device (not measured)."""
    device: str
    wall_ms: float
    rows: List[Row]               # stages in first-call order, then OUTSIDE
    counts: Dict[str, int]        # the wrappers' counters over the run
    busy_ms: Optional[float]
    device_ms: Optional[float]    # the profiler's device op time
    n_ops: Optional[int]
    unlinked: Optional[int]       # device ops with no host launch found
    result: object
    prof: object

    @property
    def fired(self):
        """The names of the stages that ran."""
        return {r.stage for r in self.stage_rows()}

    def row(self, stage, level=None, group=""):
        return next((r for r in self.rows
                     if r.key == (stage, level, group)), None)

    def stage_rows(self):
        return [r for r in self.rows if r.stage != OUTSIDE]


def split(run, device, stages=STAGES):
    """Run run() once under torch.profiler (CPU and CUDA activity on the
    card, CPU only on a CPU device) inside staged(), and split it by
    stage: a Split with the profiled host wall (to
    torch.cuda.synchronize), the device busy time (the union of device
    op spans), one Row per (stage, level, group) and the row OUTSIDE.
    The rows' device ms partition the profiler's device op time."""
    from torch.profiler import profile
    device = torch.device(device)
    with staged(stages) as ses:
        c0 = ses.counts()
        _sync(device)
        with profile(activities=_activities(device)) as prof:
            t0 = time.perf_counter_ns()
            result = run()
            _sync(device)
            wall = time.perf_counter_ns() - t0
        c1 = ses.counts()
    total = {n: b - a for (n, _f, _a), a, b in zip(ses.counters, c0, c1)}
    rows = list(ses.rows.values())
    out = Row(OUTSIDE, None, "", calls=0, host_ns=wall - ses.top_ns,
              self_ns=wall - ses.top_ns)
    out.counts = {n: total[n] - t for (n, _f, _a), t in
                  zip(ses.counters, ses.top_counts)}
    rows.append(out)
    busy = dev_ms = n_ops = unlinked = None
    if device.type == "cuda":
        ops, ranges = device_ops(prof)
        by_key = {r.key: r for r in rows}
        for r in rows:
            r.device_ms = 0.0
        seqs = attribute(ops, ranges)
        for o, seq in zip(ops, seqs):
            r = by_key[ses.keys[seq]] if seq is not None else out
            ms = (o.end - o.start) / 1e6
            r.device_ms += ms
            acc = r.ops.setdefault(o.name, [0.0, 0])
            acc[0] += ms
            acc[1] += 1
        busy, n_ops = busy_ms(ops), len(ops)
        dev_ms = sum(o.end - o.start for o in ops) / 1e6
        unlinked = sum(o.host is None for o in ops)
    return Split(device.type, wall / 1e6, rows, total, busy, dev_ms, n_ops,
                 unlinked, result, prof)


# --- the table ---------------------------------------------------------------

def table(sp: Split):
    """The stage table of a Split, as lines."""
    dev = sp.device == "cuda"
    lines = [
        "  stage rows: host ms inclusive and exclusive of nested stages "
        "(a stage's host time includes the device time it waited for at "
        "a synchronising call: exact compaction's torch.nonzero, .item(), "
        ".cpu()); dev ms: device ops launched in the stage and not in a "
        "nested stage" + ("" if dev else f" ({NOT_MEASURED} on the CPU)")
        + "; launches: the wrappers' counters"
        + (" / the profiler's count" if dev else ""),
        f"  {'stage':<28} {'L':>2} {'group':<8} {'calls':>6} {'rays':>9} "
        f"{'host ms':>9} {'self ms':>9} {'dev ms':>9}  launches"]
    for r in sp.rows:
        prof = r.profiled_launches()
        names = [n for n, c in r.counts.items() if c]
        if dev:
            names += [k for k in prof if k not in names]
        launch = ", ".join(
            f"{n} {r.counts.get(n, 0)}" + (f"/{prof.get(n, 0)}" if dev
                                           else "") for n in names)
        dms = f"{r.device_ms:9.3f}" if r.device_ms is not None else \
            f"{NOT_MEASURED:>9}"
        lines.append(
            f"  {r.stage[:28]:<28} {'-' if r.level is None else r.level:>2} "
            f"{r.group or '-':<8} {r.calls:>6} "
            f"{'-' if r.rays is None else r.rays:>9} {r.host_ms:9.3f} "
            f"{r.self_ms:9.3f} {dms}  {launch or '-'}")
        if r.ops:
            by_base = {}
            for nm, (ms, n) in r.ops.items():
                acc = by_base.setdefault(kernel_base(nm), [0.0, 0])
                acc[0] += ms
                acc[1] += n
            top = sorted(by_base.items(), key=lambda kv: -kv[1][0])[:TOP]
            lines.append("      top: " + "; ".join(
                f"{ms:.3f} ms x{n} {nm}" for nm, (ms, n) in top))
    host_sum = sum(r.self_ms for r in sp.rows)
    lines.append(f"  rows' exclusive host ms {host_sum:.3f} of the profiled "
                 f"wall {sp.wall_ms:.3f}")
    lines.append("  by stage, summed over levels and groups (self ms, dev "
                 "ms, calls), most host time first:")
    by_stage = {}
    for r in sp.rows:
        acc = by_stage.setdefault(r.stage, [0, 0.0, 0])
        acc[0] += r.self_ns
        acc[1] += r.device_ms or 0.0
        acc[2] += r.calls
    for name, (ns, dms, calls) in sorted(by_stage.items(),
                                         key=lambda kv: -kv[1][0]):
        lines.append(f"    {name:<28} {ns / 1e6:9.3f} "
                     + (f"{dms:9.3f}" if dev else f"{NOT_MEASURED:>9}")
                     + f" {calls:6d}  {100 * ns / 1e6 / sp.wall_ms:5.1f}% "
                     f"of the wall")
    if dev:
        rows_dev = sum(r.device_ms for r in sp.rows)
        lines.append(f"  rows' device ms {rows_dev:.3f} of the profiler's "
                     f"{sp.device_ms:.3f} in {sp.n_ops} device ops "
                     f"({sp.unlinked} with no host launch found, in "
                     f"{OUTSIDE})")
    return lines


# --- the workloads -----------------------------------------------------------

FRAME = ("Renderer.render", "Renderer.rays_for_pixels")
WAVEFRONT = ("WavefrontTracer.trace", "WavefrontTracer._down_level",
             "shadow_rays", "WavefrontTracer._up_level",
             "Tracer._fold_textures", "intersect_multi_table",
             "shadow_query_table")
MEGA_ROUTE = ("pack_tables", "mega_select", "_run_blocks", "_run_external",
              "finalize")
AA = ("AARenderer.render", "AARenderer._trace_pixels",
      "AARenderer._masked_trace")
CONFIG5 = ("optimize", "SoftTracer.render", "SoftTracer._soft_pass",
           "SoftTracer._shade_point", "backward", "Adam.step",
           "optimize._save")


def path_stages(compiled, route, recursive=False, maxdepth=3):
    """The stages a trace of `compiled` reaches on `route` through the
    wavefront tracer or (recursive) the recursive Tracer."""
    from glome_tpu_torch.intersect import MEGA
    if recursive:
        out = ["Tracer.trace", "Tracer._trace", "Tracer._fold_textures"]
        if maxdepth > 1:
            out.append("Tracer._trace_children")
        if route == MEGA:
            out += ["intersect_multi_table", "shadow_query_table"]
    else:
        out = list(WAVEFRONT)
    if route == MEGA:
        return tuple(out) + MEGA_ROUTE
    if not recursive:
        out += ["intersect_multi", "shadow_query_multi"]
    out += ["intersect", "materialize_scene_params"]
    groups = [g for sc in compiled.scenes for g in sc.groups if g.size]
    routed = [g for g in groups if g.vclass not in ("deferred", "convex")]
    if any(c.convex for sc in compiled.scenes for c in sc.csgs):
        out += ["convex_pass", "_finalize_convex"]
    if any(not g.accel_eligible for g in routed):
        out += ["dense_args", "dense_pass"]
    if any(g.accel_eligible for g in routed):
        out += ["bvh_args", "bvh_dispatch"]
    if routed:
        out.append("_finalize_winner")
    if any(g.vclass == "deferred" for g in groups):
        out += ["_deferred_group", "group_inside_any"]
    return tuple(out)


@dataclasses.dataclass
class Workload:
    """One frame or step to profile: run() returns what same(a, b)
    compares; `stages` are the stages its path reaches; `tracer` reads
    last_batches after a run."""
    name: str
    run: Callable[[], object]
    stages: Tuple[str, ...]
    same: Callable
    tracer: object


def _same_frames(a, b):
    eq = all(torch.equal(x, y) for x, y in zip(a, b))
    return eq, f"bit-equal to the unprofiled frame: {eq}"


def frame_workload(name, compiled, arrays, cam, cfg, route, recursive=False):
    """A Renderer.render frame through the wavefront tracer (or the
    recursive Tracer) on `route`."""
    import glome_tpu_torch as T
    tracer = (T.Tracer(compiled, cfg, route=route) if recursive else
              T.WavefrontTracer(compiled, cfg, route=route, frame=EAGER))
    renderer = T.Renderer(tracer, cam, cfg)
    return Workload(name, lambda: renderer.render(arrays),
                    FRAME + path_stages(compiled, route, recursive,
                                        cfg.maxdepth),
                    _same_frames, tracer)


def aa_workload(name, compiled, arrays, cam, cfg, route):
    """An AARenderer.render frame over the wavefront tracer."""
    import glome_tpu_torch as T
    tracer = T.WavefrontTracer(compiled, cfg, route=route, frame=EAGER)
    aa = T.AARenderer(tracer, cam, cfg)
    return Workload(name, lambda: aa.render(arrays),
                    AA + path_stages(compiled, route), _same_frames, tracer)


def config5_workload(compiled, arrays, cam, xres, yres):
    """One Adam step of BASELINE config 5 (tools/config5_e2e.py's loss,
    perturbation and filter) from the perturbed scene, with a checkpoint
    written into a fresh temporary directory.  Two steps are the same
    when their losses are equal and the updated row agrees within 1e-6
    relative (the backward's atomic sums may reorder)."""
    import glome_tpu_torch as T
    from glome_tpu_torch.intersect import MEGA
    from glome_tpu_torch.soft import SoftTracer
    from glome_tpu_torch.tools import config5_e2e as C5
    # the package exports the function optimize, which hides the module
    OPT = importlib.import_module("glome_tpu_torch.optimize")
    cfg = T.RenderConfig.tuned(xres=xres, yres=yres)
    tracer = T.WavefrontTracer(compiled, cfg, frame=EAGER)
    target, _aa = C5.aa_target(tracer, cam, cfg, arrays)
    o, d = C5.pixel_rays(tracer, cam, cfg, arrays["lights"]["pos"].device)
    pert = C5.perturb(arrays)
    soft = SoftTracer(tracer)
    loss_fn = C5.coarse_to_fine_loss(soft, yres, xres)

    def run():
        ckpt = tempfile.mkdtemp(prefix="profile_frame_ckpt_")
        try:
            return OPT.optimize(tracer, pert, o, d, target, steps=1,
                                lr=5e-3, checkpoint_dir=ckpt,
                                checkpoint_every=1, loss_fn=loss_fn,
                                grad_filter=C5.only_group())
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)

    def same(a, b):
        ra, rb = a.arrays["scenes"][0][C5.GROUP], b.arrays["scenes"][0][
            C5.GROUP]
        rel = max(float(((ra[k][C5.ROW] - rb[k][C5.ROW]).abs()
                         / rb[k][C5.ROW].abs().clamp(min=1e-30)).max())
                  for k in ("center", "radius"))
        ok = a.losses == b.losses and rel <= 1e-6
        return ok, (f"loss {a.losses[0]:.10g} against {b.losses[0]:.10g} "
                    f"unprofiled, the updated row within {rel:.3g} "
                    f"relative (<= 1e-6): {ok}")
    stages = (CONFIG5 + (("SoftTracer._csg_margin",) if soft.has_csg else ())
              + path_stages(compiled, MEGA))
    return Workload(f"config 5 step {xres}x{yres}", run, stages, same, tracer)


@dataclasses.dataclass
class CompiledReport:
    """The compiled frame of one renderer: capture frame s, replay ms
    (unprofiled), one profiled replay frame's host wall and device busy
    ms (None: not measured) and each kernel's device ms, the launches
    and plain calls of one replay frame, its captures, replays and host
    reads, the graph pools' bytes, and whether every compiled frame
    equalled the eager frame."""
    name: str
    capture_s: float
    replay_ms: float
    wall_ms: float
    busy_ms: Optional[float]
    kernel_ms: Optional[Dict[str, float]]
    counts: Dict[str, int]
    per_frame: Dict[str, int]
    pool_bytes: int
    same: bool
    spans: List[Tuple[str, int, float, float, Optional[float]]]
    lanes: Dict[str, int]


def span_rows(rec, ops=None):
    """A telemetry frame record's spans by name, in the order each name
    first opens: (name, calls, host ms, self ms, device busy ms while a
    span of that name is open, or None without `ops`, the profiler's
    DeviceOps of the frame)."""
    inside = {}
    for name, a, b, _p in rec.intervals():
        inside.setdefault(name, []).append((a, b))
    rows = []
    for name, spans in inside.items():
        calls, total, own = rec.sums[name]
        busy = None
        if ops is not None:
            busy = sum(busy_ms([DeviceOp(o.name, max(o.start, a),
                                         min(o.end, b), None)
                                for o in ops if o.end > a and o.start < b])
                       for a, b in spans)
        rows.append((name, calls, total / 1e6, own / 1e6, busy))
    return rows


def compiled_workload(name, compiled, arrays, cam, cfg, aa=False):
    """(name, compiled-frame run, eager run, tracer) over one
    megakernel-route wavefront tracer and its eager twin: the frame's
    trace on rays built once, every pixel in tile order (tools/bench.py's
    frame, so the reading holds no per-frame numpy ray set-up of
    Renderer.render), or with `aa` an AARenderer.render frame."""
    import glome_tpu_torch as T
    from . import bench
    tracer = T.WavefrontTracer(compiled, cfg, frame=COMPILED)
    eager = T.WavefrontTracer(compiled, cfg, frame=EAGER)
    if aa:
        r, e = T.AARenderer(tracer, cam, cfg), T.AARenderer(eager, cam, cfg)
        return (name, lambda: r.render(arrays), lambda: e.render(arrays),
                tracer)
    o, d, _perm = bench.frame_rays(T.Renderer(tracer, cam, cfg),
                                   arrays["lights"]["pos"].device)
    return (name, lambda: tuple(tracer.trace(arrays, o, d)),
            lambda: tuple(eager.trace(arrays, o, d)), tracer)


def profile_compiled(name, run, eager_run, tracer, device, smi=None):
    """Time and profile the compiled frame run() (see CompiledReport):
    the capture frame, then the eager frame, then the replays (3 timed
    after a warm-up, one profiled); prints it all."""
    cuda = torch.device(device).type == "cuda"
    tag = f"[{smi}] " if smi else "[cpu] "
    totals = tracer.graphs.totals
    _sync(device)
    t0 = time.perf_counter()
    first = run()
    _sync(device)
    capture_s = time.perf_counter() - t0
    ref = eager_run()
    same = _same_frames(first, ref)[0]
    _res, ms = timed(run, device)
    before = dict(totals)
    c0 = {k: getattr(f, a) for k, f, a in _counters()}
    last = []
    ops = [] if cuda else None

    def replay():
        last.append(run())
    if cuda:
        wall, busy, per = profile_kernels(replay, tuple(KERNEL_NAMES),
                                          top=TOP, keep_ops=ops)
    else:
        t0 = time.perf_counter()
        replay()
        wall, busy, per = (time.perf_counter() - t0) * 1e3, None, None
    counts = {k: getattr(f, a) - c0[k] for k, f, a in _counters()}
    per_frame = {k: totals[k] - before[k] for k in totals}
    same = same and _same_frames(last[0], ref)[0]
    pool = tracer.graphs.pool_bytes() if cuda else 0
    how = "CUDA events" if cuda else "host clock"
    print(f"{tag}{name}, compiled frame: replay {ms:.3f} ms ({how}, mean "
          f"of 3 after a warm-up); capture frame {capture_s:.3f} s; one "
          f"profiled replay frame: host wall {wall:.3f} ms, device busy "
          + (f"{busy:.3f} ms ({100 * busy / wall:.1f}% of the wall)"
             if busy is not None else NOT_MEASURED))
    if per is not None:
        print("  kernels' device ms in that frame: " + ", ".join(
            f"{KERNEL_NAMES[k]} {v:.3f}" for k, v in per.items() if v))
    print(f"  launches and plain calls {counts}; per frame {per_frame}; "
          f"graph pools {pool} bytes; every compiled frame equal to the "
          f"eager frame: {same}")
    rec = TM.frames()[-1]
    spans = span_rows(rec, ops)
    print("  the program's spans in that frame (telemetry): calls, host "
          "ms, self ms, device busy ms while open")
    for nm, calls, host, own, dev in spans:
        print(f"    {nm:24s} {calls:4d} {host:10.3f} {own:10.3f} "
              + (f"{dev:10.3f}" if dev is not None else NOT_MEASURED))
    lanes = {k: rec.counts.get(k, 0) for k in ("k1.lanes", "k1.live_lanes")}
    k1 = sum(g[0] == "k1" for g in rec.launches)
    print(f"  K1 lanes launched {lanes['k1.lanes']}, live "
          f"{lanes['k1.live_lanes']} over {k1} launches")
    return CompiledReport(name, capture_s, ms, wall, busy, per, counts,
                          per_frame, pool, same, spans, lanes)


def build(args, device, maxdepth=None):
    """The Workload the command line names (at `maxdepth` where given)."""
    import glome_tpu_torch as T
    from glome_tpu_torch.intersect import GROUPS, MEGA
    from glome_tpu_torch.scenes import mesh_scene, test_scene
    route = GROUPS if args.route == "groups" else MEGA
    if args.scene == "test":
        solid, lights, cam = test_scene()
    else:
        n = {"mesh100k": 100_000, "mesh250k": 250_000}[args.scene]
        solid, lights, cam = mesh_scene(n, cast_shadows=args.shadows)
    compiled = T.compile_scene(solid, lights)
    arrays = T.to_torch(compiled.arrays(), device)
    if args.config5:
        if args.scene != "test" or route != MEGA or args.aa \
                or args.tracer != "wavefront":
            raise SystemExit("--config5 is the TestScene step on the "
                             "megakernel route through the wavefront tracer")
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
    if maxdepth:
        cfg = dataclasses.replace(cfg, maxdepth=maxdepth)
    what = (f"{args.scene}{' self-shadowing' if args.shadows else ''} "
            f"{cfg.xres}x{cfg.yres} depth {cfg.maxdepth}, {args.route} "
            f"route")
    if args.frame == COMPILED:
        if route != MEGA or args.tracer != "wavefront" or args.depths:
            raise SystemExit("--frame compiled is the wavefront tracer's "
                             "frame on the megakernel route, one depth")
        return compiled_workload(f"{'AA ' if args.aa else ''}{what}",
                                 compiled, arrays, cam, cfg, args.aa)
    if args.aa:
        return aa_workload(f"AA {what}", compiled, arrays, cam, cfg, route)
    return frame_workload(f"{what}, {args.tracer} tracer", compiled, arrays,
                          cam, cfg, route, args.tracer == "recursive")


def timed(run, device, reps=3):
    """(the warm-up call's result, ms per call: CUDA events on the card,
    the host clock on the CPU, mean of `reps` after the warm-up)."""
    ref = run()
    _sync(device)
    if torch.device(device).type == "cuda":
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            run()
        e.record()
        torch.cuda.synchronize()
        return ref, s.elapsed_time(e) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    return ref, (time.perf_counter() - t0) * 1e3 / reps


@dataclasses.dataclass
class Report:
    workload: Workload
    frame_ms: float
    split: Split
    same: bool
    missing: Tuple[str, ...]     # path stages that did not fire


def profile(w: Workload, device, smi=None, trace_dir=None):
    """Time w unprofiled (mean of 3 after a warm-up), split one run by
    stage, hold the profiled result to the warm-up's, and print it all;
    returns a Report."""
    cuda = torch.device(device).type == "cuda"
    tag = f"[{smi}] " if smi else "[cpu] "
    ref, ms = timed(w.run, device)
    sp = split(w.run, device)
    same, text = w.same(sp.result, ref)
    missing = tuple(s for s in w.stages if s not in sp.fired)
    how = "CUDA events" if cuda else "host clock"
    print(f"{tag}{w.name}: unprofiled {ms:.3f} ms ({how}, mean of 3 after "
          f"a warm-up); profiled host wall {sp.wall_ms:.3f} ms "
          f"({sp.wall_ms / ms:.2f}x: the profiler's own cost, not "
          f"corrected); device busy "
          + (f"{sp.busy_ms:.3f} ms ({100 * sp.busy_ms / sp.wall_ms:.1f}% "
             f"of the profiled wall)" if cuda else NOT_MEASURED))
    print(f"  {text}; stages of the path that did not fire: "
          f"{list(missing) or 'none'}")
    for line in table(sp):
        print(line)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, re.sub(r"[^\w.-]+", "_", w.name)
                            + ".json")
        sp.prof.export_chrome_trace(path)
        print(f"  Chrome trace of the profiled run: {path}")
    return Report(w, ms, sp, same, missing)


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
    ap.add_argument("--depths", action="store_true",
                    help="also the frame at maxdepth 1, 2 and 3")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a Chrome trace of the profiled run")
    ap.add_argument("--xres", type=int, default=None)
    ap.add_argument("--yres", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--frame", default=EAGER, choices=(EAGER, COMPILED),
                    help="the eager frame split by stage (default), or "
                    "the compiled frame's replay")
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
    if args.frame == COMPILED:
        rep = profile_compiled(*build(args, device), device, smi)
        return 0 if rep.same and not rep.per_frame["captures"] else 1
    rep = profile(build(args, device), device, smi, args.trace)
    ok = rep.same and not rep.missing
    if args.depths and not (args.aa or args.config5):
        tag = f"[{smi}] " if smi else "[cpu] "
        prev = None
        for depth in (1, 2, 3):
            w = build(args, device, depth)
            _ref, ms = timed(w.run, device)
            print(f"{tag}{w.name}: {ms:.3f} ms"
                  + ("" if prev is None else
                     f" (level {depth - 1}'s marginal cost "
                     f"{ms - prev:.3f} ms)"))
            prev = ms
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
