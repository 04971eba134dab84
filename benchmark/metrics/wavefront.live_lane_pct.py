"""trace_wavefront.WavefrontTracer: the share of K1's lanes that held a
live ray, the program's counters k1.live_lanes over k1.lanes summed over
the traced window's launches, in %.  The compiled frame pads each level
to a static width; the eager frame launches live lanes only."""

from benchmark.metrics._spans import count_sum


def read(run):
    lanes = count_sum(run, "k1.lanes")
    live = count_sum(run, "k1.live_lanes")
    if not lanes or live is None:
        return None
    return 100.0 * live / lanes
