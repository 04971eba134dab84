"""The arithmetic of a measured window and of a profiler's device spans.

Every end-to-end number is taken over the whole window: a rate or a time
per frame is the window's seconds over the frames it completed, and a
tail is the tail of every frame's time.
"""

from __future__ import annotations

import numpy as np

GiB = float(2 ** 30)


def per_item_ms(window_s: float, n: int) -> float:
    """The window's milliseconds over the n items (frames or steps) it
    completed."""
    if n <= 0:
        raise ValueError("the window completed no frame")
    return 1e3 * window_s / n


def p95_ms(item_s) -> float:
    """The 95th percentile of the items' seconds, in ms (numpy's linear
    interpolation)."""
    return float(np.percentile(np.asarray(item_s, np.float64) * 1e3, 95))


def beyond_p95(item_s) -> int:
    """How many items lie above their 95th percentile: the tail's sample
    count (ten or more for a sound p95)."""
    a = np.asarray(item_s, np.float64) * 1e3
    return int((a > np.percentile(a, 95)).sum())


def busy_ns(spans, lo=None, hi=None) -> int:
    """The union of (start, end) spans in ns, clipped to [lo, hi]."""
    iv = []
    for a, b in spans:
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b > a:
            iv.append((a, b))
    if not iv:
        return 0
    iv.sort()
    busy, a0, b0 = 0, iv[0][0], iv[0][1]
    for a, b in iv[1:]:
        if a > b0:
            busy += b0 - a0
            a0, b0 = a, b
        else:
            b0 = max(b0, b)
    return busy + b0 - a0


def idle_gaps(spans, lo, hi):
    """[(start, end)] of the stretches in [lo, hi] where no span runs,
    longest first."""
    iv = sorted((max(a, lo), min(b, hi)) for a, b in spans
                if min(b, hi) > max(a, lo))
    gaps, t = [], lo
    for a, b in iv:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])
