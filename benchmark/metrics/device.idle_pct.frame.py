"""device: the share of the profiled stretch of frames in which no
operation ran on the card: one less the union of the profiler's device
spans over the stretch, in %."""

from benchmark.harness.profile import busy_s, window_s


def read(run):
    if run.prof is None or run.entry not in ("render", "aa"):
        return None
    return 100.0 * (1.0 - busy_s(run.prof) / window_s(run.prof))
