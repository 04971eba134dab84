"""The program's own spans and counters (glome_tpu_torch/telemetry.py),
read from the recorder that the run's program loaded.  Nothing here
imports the program: the harness's program side does, and the recorder
is found in sys.modules, so a program without it reads as nothing.

A run's frame records are, oldest first, its warm-up frames, its
run.frames window frames, then, when run.prof is set, the
mix["profile_frames"] frames of the profiled stretch: the readers take
them from the end of the recorder's ring.  A window metric is the mean
over the window's frames; only a traced run (run.outside_s set) is read.
"""

from __future__ import annotations

import sys

RECORDER = "glome_tpu_torch.telemetry"


def _records(run):
    rec = sys.modules.get(RECORDER)
    return rec.frames() if rec is not None else []


def profiled(run):
    """The profiled stretch's frame records ([] without one)."""
    if run.prof is None:
        return []
    n = int(run.mix["profile_frames"])
    recs = _records(run)
    return recs[-n:] if len(recs) >= n else []


def window(run):
    """The window's frame records: at most run.frames, fewer where the
    ring no longer holds the window's first."""
    if not run.frames or not run.outside_s:
        return []
    recs = _records(run)
    end = len(recs) - (int(run.mix["profile_frames"])
                       if run.prof is not None else 0)
    return recs[max(0, end - run.frames):max(0, end)]


def mean_ms(run, name: str, entry=None, self_time: bool = False):
    """The window's mean per frame of span `name`'s total (or self) ms,
    in a cell whose entry is `entry` (any where None); None where
    nothing is recorded."""
    if entry is not None and run.entry != entry:
        return None
    recs = window(run)
    if not recs or not any(name in f.sums for f in recs):
        return None
    k = 2 if self_time else 1
    return sum(f.sums[name][k] for f in recs if name in f.sums) / (
        1e6 * len(recs))


def count_sum(run, name: str):
    """The window's sum of the counter `name`, None where no frame has
    it."""
    recs = [f for f in window(run) if name in f.counts]
    return sum(f.counts[name] for f in recs) if recs else None
