"""The compiled frame: the wavefront frame captured as CUDA graphs.

glome_tpu does not run its frame op by op from Python: it compiles the
frame into one device program at static shapes (jax.jit at
glome_tpu/render.py:115 and glome_tpu/aa.py:107, cached_jit over
glome_tpu/cache.py in bench.py) and replays that program.  This module
is the port's counterpart.  WavefrontTracer(frame=COMPILED) runs each
level of its frame at a static width (trace_wavefront.bucket: the level's
queue padded with dead lanes, compacted into fixed capacities), so each
level is a SEGMENT of device work whose shapes depend on its width only;
a segment is captured once as a CUDA graph and replayed by every later
frame of those widths.  Between two segments the host reads one vector,
the level's child counts, which sizes the next level.

  - Key.  A segment is keyed on (stage, level, widths, ...) and on the
    identity of every scene tensor the frame reads (data_ptr, shape,
    dtype, stride).  The graph reads the scene tensors in place, so an
    in-place edit (an optimizer step) shows in the next replay as in the
    eager frame, and a tensor replaced by a new one changes the key and
    is captured anew.  A frame whose scene key differs from the cached
    segments' drops them all first (GraphCache.scene_changes counts it,
    with a warning): a caller that hands in new scene tensors every frame
    captures every frame, and this keeps one scene's segments alive, not
    MAX_SEGMENTS of old ones.  A segment holds references to the scene
    tensors it read: their memory is never freed or reused under it.
  - Inputs and outputs.  A segment's inputs are copied or placed.  A
    replay copies the copied ones (the first level's rays, built anew
    every frame) into the segment's static buffers; it reads the placed
    ones where they lie, and their identity is part of the key.  The
    placed inputs are the static outputs of the segments before it (a
    level's queue, its stored hits, the deeper level's colours), which
    stay at their addresses from replay to replay, so the steady frame
    copies nothing between segments.  A replay hands back the outputs
    the capture returned (static memory, overwritten by the next replay:
    the tracer clones what it returns).
  - Warm-up.  Before its capture a segment runs once eagerly on its
    inputs, so that lazy library loading, the C entries' shared-memory
    opt-in and every device constant (vec.const and the per-device table
    caches) happen outside the capture.  That eager run is the capture
    frame's result: it is copied into the capture's static outputs, so
    the next segment of the capture frame is captured reading those, and
    a capture frame launches each kernel once, as a replay frame does.
  - Counters.  Inside a capture the kernel wrappers run, and add to
    their .launches (the plain versions and megakernel.pack_tables to
    their .calls, megakernel.finalize to its .fused_calls or
    .torch_calls), without running anything.  The capture's counter
    deltas are taken back and kept with the segment, and every replay
    adds them: the counters count what ran.
  - Memory.  The segments captured by one frame share one memory pool:
    they are captured in the order every frame replays them (down the
    levels, then up), so a segment's scratch can only reuse memory of a
    segment that runs before it, and the outputs a later segment reads
    stay allocated.  At most MAX_SEGMENTS segments stay cached, least
    recently used first out; a pool's memory is released with its last
    segment.  pool_bytes() is the memory the live pools hold.
  - Failure.  A capture or replay that fails clears the cache and
    raises; no frame carries on eagerly.  Python's garbage collector is
    off during a capture: a dead cycle holding another segment's graph
    must not destroy it mid-capture.

On a CPU tensor nothing is captured: FrameRun calls each segment's
function directly, so the CPU runs the same static-width levels eagerly.
"""

from __future__ import annotations

import collections
import gc
import warnings
from typing import Callable, Dict, List, Sequence

import torch

# the two frames of WavefrontTracer.trace
EAGER = "eager"          # op by op from Python, exact-size queues
COMPILED = "compiled"    # static-width levels, captured as CUDA graphs
FRAMES = (EAGER, COMPILED)

MAX_SEGMENTS = 64


def check_frame(frame: str):
    if frame not in FRAMES:
        raise ValueError(f"frame must be {EAGER!r} or {COMPILED!r}, "
                         f"got {frame!r}")


def tensors(tree) -> List[torch.Tensor]:
    """The tensor leaves of a nest of dicts, lists and tuples, in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return []


def scene_key(arrays) -> tuple:
    """The identity of every scene tensor: (data_ptr, shape, stride,
    dtype) in leaf order."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for t in tensors(arrays))


def unflatten(like, leaves):
    """A nest shaped as `like` with its tensor leaves replaced, in
    tensors() order, by `leaves`."""
    it = iter(leaves)

    def go(x):
        if torch.is_tensor(x):
            return next(it)
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(go(v) for v in x)
        return x
    return go(like)


def needs_grad(*trees) -> bool:
    """Whether autograd must see ops on the trees: grad mode is on and a
    tensor of theirs requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for tree in trees
                                           for t in tensors(tree))


def check_no_grad(*trees):
    """The compiled frame records no autograd graph: raise when a tensor
    of the trees needs a gradient (needs_grad)."""
    if needs_grad(*trees):
        raise RuntimeError(
            "the compiled frame records no gradient: a scene tensor or ray "
            "requires grad (trace with frame=EAGER, or under "
            "torch.no_grad())")


def kernel_counters():
    """(function, attribute) of every counter of the select kernels:
    K1-K5's .launches and their plain versions' .calls."""
    from . import block_kernel as BK
    from . import group_kernels as GK
    from . import megakernel as MK
    from . import mesh_kernel as MSH
    return tuple((f, "launches") for f in (
        MK.mega_select, BK.block_select, MSH.mesh_block_select,
        GK.dense_select, GK.bvh_select)) + tuple((f, "calls") for f in (
            MK.mega_select_plain, BK.block_select_plain,
            MSH.mesh_block_select_plain, GK.dense_select_plain,
            GK.bvh_select_plain))


def counters():
    """(function, attribute) of every counter a segment carries: the
    kernel_counters(), the builds of the select tables,
    megakernel.pack_tables' .calls, and megakernel.finalize's fused and
    torch calls."""
    from . import megakernel as MK
    return kernel_counters() + ((MK.pack_tables, "calls"),
                                (MK.finalize, "fused_calls"),
                                (MK.finalize, "torch_calls"))


class Segment:
    """One captured graph: its static input buffers, the outputs its
    capture returned, the counter deltas of one replay, the tensors it
    keeps alive (the scene's and its placed inputs) and its memory
    pool."""

    __slots__ = ("graph", "inputs", "outputs", "deltas", "keep", "pool")

    def __init__(self, graph, inputs, outputs, deltas, keep, pool):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.deltas = deltas
        self.keep = keep
        self.pool = pool


class GraphCache:
    """The captured segments of one tracer's current scene, at most
    MAX_SEGMENTS, least recently used first out."""

    def __init__(self):
        self.segments: "collections.OrderedDict[tuple, Segment]" = \
            collections.OrderedDict()
        self.scene = None           # the scene key of the cached segments
        self.scene_changes = 0      # frames that dropped another scene's
        # over every frame: segments captured and replayed, host reads
        self.totals = {"captures": 0, "replays": 0, "host_reads": 0}

    def __len__(self):
        return len(self.segments)

    def clear(self):
        self.segments.clear()

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds in the live segments' memory
        pools (its segments of those pools, torch.cuda.memory_snapshot)."""
        ids = {tuple(s.pool) for s in self.segments.values()}
        if not ids:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in ids)

    def frame(self, device, arrays) -> "FrameRun":
        return FrameRun(self, device, arrays)

    def use_scene(self, scene: tuple):
        """Keep only the segments of `scene`: a new scene key drops the
        cached segments of the old one."""
        if scene == self.scene:
            return
        if self.segments:
            self.scene_changes += 1
            warnings.warn(
                f"compiled frame: the scene tensors changed identity, "
                f"{len(self.segments)} captured segments dropped and the "
                f"frame captured anew (edit scene tensors in place to "
                f"replay)", RuntimeWarning, stacklevel=4)
            self.clear()
        self.scene = scene

    def run(self, frame: "FrameRun", key, fn: Callable,
            inputs: Sequence[torch.Tensor], placed: Sequence[torch.Tensor]):
        seg = self.segments.get(key)
        if seg is None:
            return self._capture(frame, key, fn, inputs, placed)
        self.segments.move_to_end(key)
        try:
            for dst, src in zip(seg.inputs, inputs):
                dst.copy_(src)
            seg.graph.replay()
        except Exception as e:
            self.clear()
            raise RuntimeError(f"compiled frame: replay of segment "
                               f"{key[:4]} failed: {e}") from e
        for (f, attr), n in zip(counters(), seg.deltas):
            setattr(f, attr, getattr(f, attr) + n)
        frame.count("replays")
        return seg.outputs

    def _capture(self, frame, key, fn, inputs, placed):
        # the static buffers keep each input's strides (a transposed view
        # stays transposed): a reduction over a copy laid out otherwise may
        # sum in another order, and the frame would not be the eager one's
        static = [x.clone() for x in inputs]
        # the warm-up: this frame's result, and every lazy set-up of the
        # segment's code done outside the capture
        out = fn(*static, *placed)
        cs = counters()
        before = [getattr(f, attr) for f, attr in cs]
        if frame.pool is None:
            frame.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a dead reference cycle
        # that holds another graph would destroy it mid-capture, which
        # CUDA forbids and which invalidates the capture
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=frame.pool):
                outputs = fn(*static, *placed)
        except Exception as e:
            self.clear()
            raise RuntimeError(f"compiled frame: capture of segment "
                               f"{key[:4]} failed: {e}") from e
        finally:
            if gc_on:
                gc.enable()
            deltas = [getattr(f, attr) - b
                      for (f, attr), b in zip(cs, before)]
            for (f, attr), b in zip(cs, before):
                setattr(f, attr, b)
        # the warm-up's result into the static outputs: what a replay
        # would leave there, at the addresses the next segments read
        for dst, src in zip(tensors(outputs), tensors(out)):
            dst.copy_(src)
        self.segments[key] = Segment(graph, static, outputs, deltas,
                                     frame.keep + list(placed), frame.pool)
        while len(self.segments) > MAX_SEGMENTS:
            self.segments.popitem(last=False)
        frame.count("captures")
        return outputs


class FrameRun:
    """One frame's passage through the segments: run(key, fn, inputs,
    placed) replays, or warms up and captures, the segment `key` on a
    CUDA device and calls fn(*inputs, *placed) on the CPU.  Counts the
    frame's captures, replays and host reads (the tracer counts those),
    and adds them to the cache's totals."""

    def __init__(self, cache: GraphCache, device, arrays):
        self.device = torch.device(device)
        self.cache = cache if self.device.type == "cuda" else None
        self.keep = tensors(arrays) if self.cache is not None else []
        self.scene = scene_key(arrays) if self.cache is not None else ()
        if self.cache is not None:
            self.cache.use_scene(self.scene)
        self.pool = None
        self.counts = {"captures": 0, "replays": 0, "host_reads": 0}

    def count(self, what: str):
        self.counts[what] += 1
        if self.cache is not None:
            self.cache.totals[what] += 1

    def run(self, key: tuple, fn: Callable, inputs: Sequence[torch.Tensor],
            placed: Sequence[torch.Tensor] = ()):
        """Segment `key` on `inputs` (copied into static buffers) and
        `placed` (read where they lie: their identity joins the key).  A
        segment may have neither: it then reads the scene tensors only."""
        if self.cache is None:
            return fn(*inputs, *placed)
        return self.cache.run(
            self, key + (str(self.device), scene_key(list(placed)),
                         self.scene),
            fn, inputs, placed)

    def stats(self) -> Dict[str, int]:
        return dict(self.counts)
