"""trace_wavefront.WavefrontTracer: the program's spans
wavefront.count_read (each level's read of its child counts: the host
blocked on the device between levels), ms per frame over the traced
window."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "wavefront.count_read")
