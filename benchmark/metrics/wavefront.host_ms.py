"""trace_wavefront.WavefrontTracer: the self time of the program's span
wavefront.trace (the tracer's host time, its count reads left out), ms
per frame over the traced window: every trace call of the frame."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "wavefront.trace", self_time=True)
