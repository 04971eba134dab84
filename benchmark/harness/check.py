"""The comparison that decides `correct`: the program's frames against the
plain reference's, on the same camera offsets and pixels.

A pixel is off when its premultiplied rgb differs from the reference's
by more than `rgb_tol` in some channel, or its depth by more than
`depth_rel` of the reference's (at least of 1).  The numbers compared,
each against its limit in benchmark/limits/<cell>.json:

  px_off_pct     the share of the compared pixels that are off, in %
  depth_off_pct  the share whose depth alone is off, in % (a surface
                 seen where the reference sees another, or none)
  rgb_mean_abs   the mean absolute rgb difference over the compared
                 pixels and channels

A run is correct when every number is at or under its limit.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("px_off_pct", "depth_off_pct", "rgb_mean_abs")


def compare(rgb, t, ref_rgb, ref_t, tol: dict) -> dict:
    """The numbers of one comparison of (n, 3) rgb and (n,) depth arrays
    against the reference's."""
    rgb = np.asarray(rgb, np.float64).reshape(-1, 3)
    ref_rgb = np.asarray(ref_rgb, np.float64).reshape(-1, 3)
    t = np.asarray(t, np.float64).reshape(-1)
    ref_t = np.asarray(ref_t, np.float64).reshape(-1)
    if rgb.shape != ref_rgb.shape or t.shape != ref_t.shape:
        raise ValueError(f"shapes {rgb.shape}/{t.shape} against "
                         f"{ref_rgb.shape}/{ref_t.shape}")
    drgb = np.abs(rgb - ref_rgb)
    dt = np.abs(t - ref_t)
    depth_off = ~(dt <= tol["depth_rel"] * np.maximum(1.0, np.abs(ref_t)))
    off = (drgb.max(axis=1) > tol["rgb_tol"]) | depth_off
    return {"px_off_pct": 100.0 * float(off.mean()),
            "depth_off_pct": 100.0 * float(depth_off.mean()),
            "rgb_mean_abs": float(np.nan_to_num(drgb, nan=1.0).mean())}


def merge(parts) -> dict:
    """The numbers over several equal-sized comparisons: the mean of each
    (every comparison holds the same number of pixels)."""
    parts = list(parts)
    return {k: float(np.mean([p[k] for p in parts])) for k in NUMBERS}


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) for each number the cell's
    limits name, in their order."""
    rows = [(k, numbers[k], float(limits[k])) for k in limits]
    ok = all(v <= lim for _k, v, lim in rows)
    return ok, rows
