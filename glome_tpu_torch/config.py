"""Global configuration for the glome-tpu renderer.

The reference (jimsnow/glome) hard-codes all of these as compile-time
constants; see GlomeView/Glome.hs:25,112-116,221-224 and
GlomeVec/Data/Glome/Vec.hs:14,40.  We expose them as a dataclass so a
single scene/render config can be threaded through jitted code as
static metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

# Sentinel "infinity" used for miss distances (reference: Vec.hs:14).
INFINITY = 1.0e6

# Geometric tuning epsilon (reference: Vec.hs:40).
DELTA = 1.0e-4

# pi as used by the reference's deg() (Vec.hs:18).
PI = 3.1415926535897


def deg(x):
    """Degrees -> radians (reference Vec.hs:17-18)."""
    return (x * PI) / 180.0


def rot(x):
    """Rotations -> radians; rot 1 == 360 degrees (reference Vec.hs:25-26)."""
    return x * PI * 2.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render-time knobs.

    Defaults mirror the reference executable:
      - xres/yres:   Glome.hs:112-113
      - maxdepth:    Glome.hs:25
      - blocksize:   Glome.hs:116 (tile size for adaptive AA)
      - thresholds:  Glome.hs:221-224 (adaptive AA variance thresholds)
    """

    xres: int = 720
    yres: int = 480
    maxdepth: int = 3
    blocksize: int = 65
    thresholds: Tuple[float, float, float, float] = (0.14, 0.15, 0.16, 0.18)
    # Direct illumination in the reference scales the *light* color only;
    # the surface color modulates just the ambient term (Shader.hs:90-102).
    # Set True for the more conventional albedo-modulated diffuse.
    modulate_diffuse: bool = False
    # Queue capacity factors for compacted secondary-ray passes, as a
    # fraction of the primary ray count per depth level.
    secondary_capacity: float = 1.0
    # Per-level wavefront queue capacities, each a fraction of the
    # CURRENT level's queue size: a tuple clamps at its last entry, a
    # bare float applies to every level.  Child-ray occupancy decays
    # geometrically with depth (secondary rays of secondary rays are
    # rare), so scheduled capacities shrink every level's
    # intersect/shadow batch to the rays that actually exist instead of
    # paying full-queue passes at every depth.  None = derive from
    # secondary_capacity (reflect = s, refract/warp = s/2, shadow
    # exact), the conservative default.  Overflowing child rays are
    # DROPPED (their color falls back to the transparent miss) and
    # counted in TraceResult.overflow.
    reflect_capacity: Optional[Union[float, Tuple[float, ...]]] = None
    refract_capacity: Optional[Union[float, Tuple[float, ...]]] = None
    warp_capacity: Optional[Union[float, Tuple[float, ...]]] = None
    # Shadow-ray batch capacity per light, fraction of the level queue.
    # None / >= 1 = the lossless masked full-width path.  Overflowing
    # shadow rays count as UNBLOCKED, i.e. undersizing leaks light
    # (shadowed points render lit); drops are counted in
    # TraceResult.overflow.
    shadow_capacity: Optional[Union[float, Tuple[float, ...]]] = None
    # Wavefront queue-capacity floor, in 1024-ray tiles: segments keep
    # at least this many tiles, so small renders (where every tile is
    # live) stay lossless under any schedule fraction.
    min_tiles: int = 24
    # Adaptive-AA per-pass trace capacities as fractions of the padded
    # pixel count (passes 1..5).  None = the stencil's structural
    # maxima (1/8, 1/8, 1/4, 1/2, 1/2) -- lossless but pays 1.5
    # rays/px of padded trace capacity regardless of need.  Tuned
    # schedules cap each pass near its measured occupancy; requests
    # beyond a cap keep their interpolated value and are counted in
    # AARenderer.last_overflow.
    aa_caps: Optional[Tuple[float, float, float, float, float]] = None
    # Miss-shader color (the reference Shader.missshade, Trace.hs:15-19):
    # rays that hit nothing return this opaque color instead of the
    # transparent miss.  None = transparent (mmissshade, Shader.hs:187).
    # NFF scenes plumb their `b` background here (Spd.hs:118-122).
    background: Optional[Tuple[float, float, float]] = None

    @classmethod
    def tuned(cls, **kw):
        """Queue-capacity schedule measured on TestScene at 720x480 in
        128-lane ROW units (see the inline occupancy numbers below).
        Row-granular queues keep a row when ANY of its 128 parent
        lanes spawns that child, so row occupancy still runs above
        element occupancy, but 1.5-3x tighter than the old 1024-lane
        tile granularity.  Verified zero-overflow
        (TraceResult.overflow) on the benchmark frame and the golden.
        For other scenes check TraceResult.overflow -- any nonzero
        count means under-tracing; widen the corresponding capacity
        (1.0 = exact)."""
        # Row-granular schedule (round 5): capacities are fractions of
        # the parent queue's 128-lane ROWS.  Row occupancy is
        # resolution-dependent (one row covers 128 pixels of a 32x32
        # beam, so at low resolution the live-region PERIMETER term
        # dominates and fractions rise); tuned() therefore picks by
        # pixel count, with ~1.25-1.4x margin over the measured live
        # rows in both regimes:
        #  - 720x480 (GLOME_OCC=2, lossless): L0/2704r: shadow 2559,
        #    reflect 972 (.36), refract 43, warp 130; L1/~1636r tuned:
        #    shadow 1037 (.63), reflect 333 (.20), refract 24, warp
        #    30; L2/~597r: shadow 345 (.58).
        #  - 180x120: L0/176r: reflect 85 (.48), refract 6, warp 16
        #    (.09); L1 shadow 105 rows.
        small = (kw.get("xres", 720) * kw.get("yres", 480)) < 300_000
        if small:
            kw.setdefault("reflect_capacity", (0.65, 0.45, 0.35))
            kw.setdefault("refract_capacity", (0.05, 0.05, 0.15))
            kw.setdefault("warp_capacity", (0.13, 0.08))
            kw.setdefault("shadow_capacity", (1.0, 0.85, 0.80))
        else:
            kw.setdefault("reflect_capacity", (0.45, 0.27, 0.22))
            kw.setdefault("refract_capacity", (0.025, 0.025, 0.10))
            kw.setdefault("warp_capacity", (0.065, 0.035))
            kw.setdefault("shadow_capacity", (1.0, 0.80, 0.75))
        # row granularity needs an 8x smaller floor for the same
        # small-render losslessness (6 tiles = 48 rows)
        kw.setdefault("min_tiles", 6)
        # AA pass needs measured on the TestScene golden at 720x480
        # (rgb-variance stencil counts x1.3 depth-term scale, +~1.5x
        # margin; checked zero-overflow on the benchmark frame):
        # pass needs ~ .125/.056/.086/.140/.208 of pixels
        kw.setdefault("aa_caps", (0.125, 0.09, 0.14, 0.21, 0.31))
        # shadows default to the masked full-width path (lossless, no
        # compaction); the measured near-full tile occupancy makes
        # capped compaction pointless
        return cls(**kw)


DEFAULT_CONFIG = RenderConfig()
