"""Adaptive subsample/supersample antialiasing (torch).

Port of glome_tpu/aa.py, itself a port of the reference's 5-pass tile
stencil (GlomeView/Glome.hs:226-323), as masked vector passes over the
whole frame at once:

  pass 1: trace every 4th even-grid pixel ((x+y) % 4 == 0)
  pass 2: remaining even-grid pixels: trace if the +-2 axis neighbors
          vary more than threshold1, else interpolate
  pass 3: odd-diagonal pixels vs their 4 diagonal neighbors (threshold2)
  pass 4: remaining pixels vs their 4 axis neighbors (threshold3)
  pass 5: supersample at every pixel corner (x+.5, y+.5) when the 2x2
          cell varies (threshold4), averaging corner + cell
          (Glome.hs:299-321) -> at most 2 rays/pixel, as few as 1/8

Out-of-tile neighbor reads are transparent-infinite (Glome.hs:233-235),
so tiles behave independently, as the reference's parMap over tiles.
The working image is one channel-major (5, Hp, Wp) plane stack
(r, g, b, a, depth) over the tile-padded frame; tile independence is
enforced by static boundary masks.  The stencil's static geometry (the
pass masks, the tile-boundary and tile-edge masks) depends only on
(Hp, Wp, S) and the device: each renderer builds it on the device for
the first frame of a frame size and reuses it (glome_tpu builds the
same planes as constants of its jitted frame).  It is kept in
separable form, 1-D row and column vectors that the frame broadcasts.

Where glome_tpu runs passes 1-4 as one lax.scan at one shared static
width and compacts each pass into occupancy-tuned capacities
(RenderConfig.aa_caps, with its child-queue capacities widened 1.8 /
2.8 / 4.0x), the port runs a Python loop and traces exactly the pixels
each pass asks for, in raster order of the padded frame: nothing is
dropped, so last_overflow holds zeros under glome_tpu's keys.  The
caller's tracer is used as given (its select= and route= included).

The variance metric cCmp (Glome.hs:179-189) sums absolute rgba deltas
plus a proportional depth term.
"""

from __future__ import annotations

import math

import torch

from . import telemetry
from .config import INFINITY, RenderConfig
from .render import Camera, pixel_coords, primary_rays
from .trace import Tracer, compact_indices


def _ccmp(a, b):
    """Color+depth variance between two (5, ...) TColor plane stacks."""
    diff = torch.sum(torch.abs(a[:4] - b[:4]), dim=0)
    d1, d2 = a[4], b[4]
    mx = torch.maximum(d1, d2)
    mn = torch.minimum(d1, d2)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    inf = torch.full((), math.inf, dtype=a.dtype, device=a.device)
    muldiff = torch.where((d1 == 0.0) & (d2 == 0.0), zero,
                          torch.where(mn == 0.0, inf, mx / mn - 1.0))
    return diff + muldiff


def _cavg(*cs):
    return sum(cs) / float(len(cs))


# the neighbor offsets (dx, dy) each of passes 1-4 decides by; pass 1
# has no decide step (it traces its whole mask)
_PASS_OFFSETS = (
    None,                                   # pass 1
    ((-2, 0), (0, 2), (2, 0), (0, -2)),     # pass 2: axis +-2
    ((-1, -1), (1, -1), (1, 1), (-1, 1)),   # pass 3: diagonals
    ((-1, 0), (0, 1), (1, 0), (0, -1)),     # pass 4: axis +-1
)


class _Geometry:
    """The stencil's static geometry over the tile-padded (Hp, Wp) frame
    of S-pixel tiles, on one device, as 1-D vectors: the residues y % 4
    (a column) and x % 4, each pass's mask over the 4x4 residue grid,
    the tile-boundary masks of the neighbour offsets -2..2 along x and
    along y, and the tile-edge masks (lx == S-1 along x, ly == S-1 a
    column)."""

    def __init__(self, Hp: int, Wp: int, S: int, dev):
        y = torch.arange(Hp, device=dev)[:, None]
        x = torch.arange(Wp, device=dev)
        self.y4, self.x4 = y % 4, x % 4
        r = torch.arange(4, device=dev)
        rx, ry = r, r[:, None]
        even = (rx % 2 == 0) & (ry % 2 == 0)
        self.in_pass = torch.stack([
            even & ((rx + ry) % 4 == 0), even & ((rx + ry) % 4 == 2),
            (rx % 2 == 1) & (ry % 2 == 1), (rx + ry) % 2 == 1])
        ly, lx = y % S, x % S
        self.okx = {d: (lx + d >= 0) & (lx + d < S) for d in range(-2, 3)}
        self.oky = {d: (ly + d >= 0) & (ly + d < S) for d in range(-2, 3)}
        self.xe, self.ye = lx == S - 1, ly == S - 1

    def pass_mask(self, i: int):
        """Pass i + 1's (Hp, Wp) mask."""
        return self.in_pass[i][self.y4, self.x4]

    def ok(self, dx: int, dy: int):
        """Where the neighbour at (+dx, +dy) lies in the pixel's own tile,
        (Hp, Wp)."""
        return self.okx[dx] & self.oky[dy]


class AARenderer:
    """Adaptive-AA frame renderer for one compiled scene.  The device is
    that of the scene tensors passed to render()."""

    def __init__(self, tracer: Tracer, cam: Camera, config: RenderConfig):
        self.tracer = tracer
        self.cam = cam
        self.config = config
        self.last_ray_counts = {}
        self.last_overflow = {}
        self._geo = None            # ((Hp, Wp, S, device), _Geometry)

    # -- helpers -----------------------------------------------------------

    def _trace_pixels(self, arrays, xf, yf, off=0.0):
        """Trace rays at global float pixel coords; (n, 5) TColors
        (r, g, b, a, depth)."""
        cfg = self.config
        with telemetry.span("aa.pass_setup"):
            xc, yc = pixel_coords(cfg.xres, cfg.yres, xf + off, yf + off)
            o, d = primary_rays(self.cam, xc, yc)
        res = self.tracer.trace(arrays, o, d)
        with telemetry.span("aa.pass_setup"):
            return torch.cat([res.color, res.t[:, None]], dim=-1)

    def _masked_trace(self, arrays, img, mask, off=0.0):
        """Trace the pixels where mask (Hp, Wp) is set and write the
        results into the (5, Hp, Wp) plane stack: (img', requested
        rays).  The span aa.pass_setup covers all of it but the trace
        call (compact_indices' torch.nonzero waits for the device)."""
        Hp, Wp = mask.shape
        with telemetry.span("aa.pass_setup"):
            idx = compact_indices(mask.reshape(-1))
            req = idx.numel()
            if req == 0:
                return img, 0
            xf = (idx % Wp).to(img.dtype)
            yf = (idx // Wp).to(img.dtype)
        tc = self._trace_pixels(arrays, xf, yf, off=off)
        with telemetry.span("aa.pass_setup"):
            flat = img.reshape(5, Hp * Wp).t()
            out = flat.index_copy(0, idx, tc.to(img.dtype))
            return out.t().reshape(5, Hp, Wp), req

    @staticmethod
    def _shift(img, dx, dy, geo):
        """Neighbor read at (+dx, +dy) with out-of-tile = transparent-
        infinite (Glome.hs:233-235): shift the plane stack, then apply
        the static tile-boundary mask of the offset."""
        _, Hp, Wp = img.shape
        pad = torch.nn.functional.pad(img, (2, 2, 2, 2))
        sh = pad[:, 2 + dy:2 + dy + Hp, 2 + dx:2 + dx + Wp]
        oob = torch.zeros((5, 1, 1), dtype=img.dtype, device=img.device)
        oob[4] = INFINITY
        return torch.where(geo.ok(dx, dy), sh, oob)

    def _geometry(self, Hp, Wp, S, dev):
        """The static geometry of the frame size on `dev`, built when the
        key differs from the last frame's; counts aa.geometry_builds (1
        on a build, 0 on a hit) in every frame."""
        key = (Hp, Wp, S, dev)
        build = self._geo is None or self._geo[0] != key
        if build:
            self._geo = (key, _Geometry(Hp, Wp, S, dev))
        telemetry.count("aa.geometry_builds", int(build))
        return self._geo[1]

    # -- the pipeline ------------------------------------------------------

    def render(self, arrays):
        """Full adaptive-AA frame: ((H, W, 3) rgb, (H, W) depth) on the
        arrays' device.  Per-pass requested-ray counts (the reference's
        1/8..2 rays/px cost model) land in self.last_ray_counts; the
        queues are exact, so self.last_overflow is all zeros.  One call
        is one telemetry frame: the span aa.mask_planes (the static
        geometry's lookup, and its build in a frame that builds it), the
        counter aa.geometry_builds, the spans aa.variance (the decisions
        and the final combine) and aa.pass_setup (each pass's work
        around its trace call)."""
        with telemetry.frame("aa.frame"):
            return self._render(arrays)

    def _render(self, arrays):
        cfg = self.config
        dev = arrays["lights"]["pos"].device
        S = cfg.blocksize
        Hp = math.ceil(cfg.yres / S) * S
        Wp = math.ceil(cfg.xres / S) * S
        th = (None,) + tuple(cfg.thresholds)
        with telemetry.span("aa.mask_planes"):
            geo = self._geometry(Hp, Wp, S, dev)

        counts = {}
        img = torch.zeros((5, Hp, Wp), dtype=torch.float32, device=dev)
        img[4] = INFINITY
        for i in range(4):
            mask = geo.pass_mask(i)
            if _PASS_OFFSETS[i] is None:
                need = mask
            else:
                with telemetry.span("aa.variance"):
                    a, b, c, d = [self._shift(img, dx, dy, geo)
                                  for dx, dy in _PASS_OFFSETS[i]]
                    variance = torch.maximum(_ccmp(a, c), _ccmp(b, d))
                    need = mask & (variance > th[i])
                    interp = _cavg(a, b, c, d)
                    img = torch.where((mask & ~need)[None], interp, img)
            img, counts[f"pass{i + 1}"] = self._masked_trace(arrays, img,
                                                             need)

        # pass 5: supersample at pixel corners and average (Glome.hs:299-321)
        with telemetry.span("aa.variance"):
            a = img
            b = self._shift(img, 0, 1, geo)
            c = self._shift(img, 1, 1, geo)
            d = self._shift(img, 1, 0, geo)
            variance = torch.maximum(_ccmp(a, c), _ccmp(b, d))
            need = variance > th[4]
            corner = _cavg(a, b, c, d)
        corner, counts["pass5"] = self._masked_trace(arrays, corner, need,
                                                     off=0.5)
        with telemetry.span("aa.variance"):
            xe, ye = geo.xe, geo.ye
            cell = torch.where(xe, torch.where(ye, corner, _cavg(a, b)),
                               torch.where(ye, _cavg(a, d),
                                           _cavg(a, b, c, d)))
            out = torch.where(xe & ye, corner, _cavg(corner, cell))

            frame = out[:, :cfg.yres, :cfg.xres]
            rgb = frame[:3].permute(1, 2, 0) * frame[3][..., None]
            rgb = torch.clamp(rgb, 0.0, 1.0)
        self.last_ray_counts = counts
        self.last_overflow = {}
        for i in range(1, 6):
            self.last_overflow[f"pass{i}"] = 0
            self.last_overflow[f"pass{i}/wf"] = 0
        return rgb, frame[4]
