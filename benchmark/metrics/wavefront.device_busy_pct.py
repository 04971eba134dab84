"""trace_wavefront.WavefrontTracer: the share of the time a
wavefront.trace span is open in which the card runs an operation, over
the profiled stretch: the union of the profiler's device spans clipped
to each span, over the spans' length, in %.  The program's span times
map onto the profiler's clock through each frame's anchor."""

from benchmark.harness.window import busy_ns
from benchmark.metrics._spans import profiled


def read(run):
    if not run.frames or not run.outside_s:
        return None
    spans = [(a, b) for f in profiled(run) for name, a, b, _p
             in f.intervals() if name == "wavefront.trace"]
    total = sum(b - a for a, b in spans)
    if not total:
        return None
    ops = [(a, b) for _n, a, b in run.prof["ops"]]
    return 100.0 * sum(busy_ns(ops, a, b) for a, b in spans) / total
