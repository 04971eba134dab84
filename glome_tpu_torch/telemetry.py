"""Spans and counters inside the program, kept in memory.

One recorder for the process, used from the thread that renders.  A
frame record opens when a user-facing entry is entered
(Renderer.render, AARenderer.render: `frame(name)`); one entry call is
one frame.  A span entered while no span is open opens a frame record of
its own, so a bare WavefrontTracer.trace call is a frame too.  Every
span and count lands in the frame of the innermost open span.

  span(name)      a context manager: the span's name, start, end and
                  parent span; per frame, the calls, total and self time
                  (total less the child spans) by name
  count(name, n)  adds n to the frame's counter `name`
  launch(kernel, level, kind, lanes, live)
                  one kernel launch: the lanes it ran and the lanes that
                  held a live ray; adds to the counters `<kernel>.lanes`
                  and `<kernel>.live_lanes`.  `live` is an int, or a
                  value from pending()
  pending(t)      a one-element device tensor copied into pinned host
                  memory without blocking, resolved when the record is
                  read (after the caller's own synchronisation)
  frames()        the kept records, oldest first, resolved

With no profiler collecting, a span costs two perf_counter_ns reads and
a few additions to its frame record.  While a torch profiler collects,
each span also opens torch.profiler.record_function(name), so it shows
on the device trace's timeline.  Spans are timed by perf_counter_ns;
each frame keeps an anchor, (perf_counter_ns, time_ns) read together
when it opens, and Frame.to_unix maps the frame's span times onto the
Unix-epoch ns of the profiler's events.

Bounded: the per-frame sums and counters of the last FRAMES_KEPT frames,
the span intervals and the per-launch list of the last INTERVALS_KEPT.

Nothing here may run inside a function that a CUDA graph captures: it
would run at the capture and never at a replay.  A count made by
captured code is a device value read through pending(), or a kernel
wrapper's counter, which graphs.py adds at every replay.
"""

from __future__ import annotations

import collections
import time

import torch
import torch.autograd.profiler as _P

FRAMES_KEPT = 4096
INTERVALS_KEPT = 64

_ns = time.perf_counter_ns


class _Pending:
    """A device value on its way to pinned host memory."""

    __slots__ = ("host", "event")

    def __init__(self, host, event):
        self.host = host
        self.event = event

    def value(self, block: bool):
        """The value as an int, or None while the copy runs and `block`
        is False."""
        if not block and not self.event.query():
            return None
        self.event.synchronize()
        return int(self.host.reshape(-1)[0])


class Frame:
    """One frame's record.  `sums` maps a span name to [calls, total ns,
    self ns]; `counts` a counter's name to its total; `launches` holds
    [kernel, level, kind, lanes, live] per launch in launch order and
    `spans` [name, start ns, end ns, parent index or -1] per span in
    start order (perf_counter_ns; both None once the frame is older than
    the last INTERVALS_KEPT)."""

    __slots__ = ("id", "name", "anchor", "sums", "counts", "launches",
                 "spans", "_pending")

    def __init__(self, fid: int, name: str):
        self.id = fid
        self.name = name
        self.anchor = (_ns(), time.time_ns())
        self.sums = {}
        self.counts = {}
        self.launches = []
        self.spans = []
        self._pending = []          # indices into launches

    def to_unix(self, t_ns: int) -> int:
        """A perf_counter_ns time of this frame as Unix-epoch ns."""
        return self.anchor[1] + (t_ns - self.anchor[0])

    def intervals(self):
        """[(name, start, end, parent)] with Unix-epoch ns times, [] once
        trimmed."""
        return [(n, self.to_unix(a), self.to_unix(b), p)
                for n, a, b, p in self.spans or ()]

    def resolve(self, block: bool = True) -> bool:
        """Turn the pending live counts into ints and add them to the
        counters; returns whether none is left pending."""
        left = []
        for i in self._pending:
            rec = self.launches[i]
            v = rec[4].value(block)
            if v is None:
                left.append(i)
                continue
            rec[4] = v
            _add(self.counts, rec[0] + ".live_lanes", v)
        self._pending = left
        return not left

    def _trim(self):
        self.resolve()
        self.spans = self.launches = None


_frames: "collections.deque[Frame]" = collections.deque(maxlen=FRAMES_KEPT)
_stack = []                 # the open spans, innermost last
_next_id = 0


def _add(d, key, n):
    d[key] = d.get(key, 0) + n


def _open_frame(name: str) -> Frame:
    global _next_id
    if _frames and _frames[-1]._pending:
        _frames[-1].resolve(block=False)
    f = Frame(_next_id, name)
    _next_id += 1
    _frames.append(f)
    if len(_frames) > INTERVALS_KEPT:
        old = _frames[-INTERVALS_KEPT - 1]
        if old.spans is not None:
            old._trim()
    return f


class _Span:
    __slots__ = ("name", "frame", "rec", "index", "t0", "child", "rf")
    opens_frame = False

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _stack and not self.opens_frame:
            outer = _stack[-1]
            f = outer.frame
            parent = outer.index
        else:
            f = _open_frame(self.name)
            parent = -1
        self.frame = f
        if f.spans is None:
            self.rec = None
            self.index = -1
        else:
            self.index = len(f.spans)
            self.rec = [self.name, 0, 0, parent]
            f.spans.append(self.rec)
        self.child = 0
        _stack.append(self)
        if _P._is_profiler_enabled:
            # the range's start is stamped inside its opening call: the
            # span starts at that call's midpoint
            t = _ns()
            self.rf = _P.record_function(self.name)
            self.rf.__enter__()
            self.t0 = (t + _ns()) // 2
        else:
            self.rf = None
            self.t0 = _ns()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            # the range's end is stamped late in its closing call
            self.rf.__exit__(*exc)
        t1 = _ns()
        _stack.pop()
        t0 = self.t0
        dur = t1 - t0
        sums = self.frame.sums
        s = sums.get(self.name)
        if s is None:
            sums[self.name] = [1, dur, dur - self.child]
        else:
            s[0] += 1
            s[1] += dur
            s[2] += dur - self.child
        if _stack:
            _stack[-1].child += dur
        rec = self.rec
        if rec is not None:
            rec[1] = t0
            rec[2] = t1
        return False


class _FrameSpan(_Span):
    __slots__ = ()
    opens_frame = True


def frame(name: str) -> _Span:
    """A span that opens a new frame record (a user-facing entry)."""
    return _FrameSpan(name)


def span(name: str) -> _Span:
    """A span in the innermost open span's frame (a frame of its own when
    none is open)."""
    return _Span(name)


def count(name: str, n: int = 1):
    """Add n to the counter `name` of the innermost open span's frame
    (nothing when no span is open)."""
    if _stack:
        _add(_stack[-1].frame.counts, name, n)


def launch(kernel: str, level: int, kind: str, lanes: int, live):
    """Record one launch of `kernel` in the innermost open span's frame:
    its level, its kind ("intersect", "shadow"), the lanes it ran and the
    lanes that held a live ray (an int or a pending() value)."""
    if not _stack:
        return
    f = _stack[-1].frame
    _add(f.counts, kernel + ".lanes", lanes)
    waits = isinstance(live, _Pending)
    if not waits:
        _add(f.counts, kernel + ".live_lanes", live)
    if f.launches is not None:
        f.launches.append([kernel, level, kind, lanes, live])
        if waits:
            f._pending.append(len(f.launches) - 1)


def pending(t: torch.Tensor):
    """The value of a one-element integer tensor, read later: on a CUDA
    device copied into pinned host memory without blocking (an event
    marks the copy's end), elsewhere read now."""
    if t.device.type != "cuda":
        return int(t.reshape(-1)[0])
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return _Pending(host, event)


def frames():
    """The kept frame records, oldest first, with every pending value
    resolved (it waits for a copy the caller has not synchronised yet)."""
    out = list(_frames)
    for f in out:
        if f._pending:
            f.resolve()
    return out
