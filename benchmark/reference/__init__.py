"""The plain reference of every configuration's frames.

It builds the configuration's scene from its own description
(scenes/<builder>.py, written from the scene's source with the nodes of
scene.py) and traces it with its own brute-force Whitted tracer
(tracer.py): every ray against every primitive, plain torch, nothing of
the program's.  The harness hands both sides the
same configuration, camera offset and pixels; a configuration's
`background` (NFF's `b`) is the colour of a ray that hits nothing.

The reference computes in float64, so that its own rounding stays far
under the program's float32 (the configuration's precision).  The
control (control=True) is this reference with its precision one step
under the configuration's, as a later change might store it: the
primitives' numbers, the matrices and the primary rays rounded to
bfloat16, computed on in float32.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from . import aa as AA
from . import scene as S
from .tracer import Tracer


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def pixel_rays(cam, xres, yres, xf, yf):
    """Primary rays of pixel coordinates xf, yf (Glome.hs:27-33,133-140):
    the camera plane spans 2 * xres / yres by 2, the ray through (xc, yc)
    is norm(fwd - xc * right + yc * up)."""
    xc = (xf / xres * 2.0 - 1.0) * (xres / yres)
    yc = -(yf / yres * 2.0 - 1.0)
    t = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                  device=xf.device)
    d = t(cam.fwd)[None] - xc[:, None] * t(cam.right)[None] \
        + yc[:, None] * t(cam.up)[None]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return t(cam.pos).expand(d.shape).contiguous(), d


class Reference:
    """One configuration's scene, traced plainly on `device`."""

    def __init__(self, conf: dict, xres: int, yres: int, device,
                 control: bool = False, checkout: str = None):
        root, lights, self.cam = S.build(conf["scene"], checkout)
        self.device = torch.device(device)
        self.control = control
        self.cfg = types.SimpleNamespace(
            xres=xres, yres=yres, maxdepth=conf["maxdepth"],
            blocksize=conf.get("blocksize", 65),
            thresholds=tuple(conf.get("thresholds",
                                      (0.14, 0.15, 0.16, 0.18))))
        store = _bf16 if control else (lambda t: t)
        self.dtype = torch.float32 if control else torch.float64
        self.tracer = Tracer(root, lights, conf["maxdepth"], self.device,
                             self.dtype, store, conf.get("background"))

    def camera(self, fwd):
        return self.cam._replace(fwd=np.asarray(fwd, np.float64))

    def rays(self, cam, xf, yf):
        o, d = pixel_rays(cam, self.cfg.xres, self.cfg.yres, xf, yf)
        if self.control:
            o, d = _bf16(o), _bf16(d)
        return o.to(self.dtype), d.to(self.dtype)

    @torch.no_grad()
    def pixels(self, fwd, px, chunk: int = 1 << 16):
        """(rgb (n, 3), depth (n,)) as numpy of the flat row-major pixels
        `px` of the frame whose camera looks along `fwd`: rgb premultiplied
        by alpha and clamped to [0, 1], and the first hit's distance."""
        cam = self.camera(fwd)
        W = self.cfg.xres
        rgbs, ts = [], []
        for s in range(0, len(px), chunk):
            p = torch.as_tensor(np.asarray(px[s:s + chunk]),
                                device=self.device)
            xf = (p % W).to(torch.float32)
            yf = torch.div(p, W, rounding_mode="floor").to(torch.float32)
            o, d = self.rays(cam, xf, yf)
            color, t = self.tracer.trace(o, d)
            rgbs.append(torch.clamp(color[:, :3] * color[:, 3:4], 0.0, 1.0)
                        .float().cpu().numpy())
            ts.append(t.float().cpu().numpy())
        return np.concatenate(rgbs), np.concatenate(ts)

    @torch.no_grad()
    def aa_tiles(self, fwd, tiles):
        """(rgb (n, 3), depth (n,)) as numpy of the adaptive-AA frame's
        pixels in the tiles whose origins are `tiles`, tile by tile in
        raster order (benchmark/harness/traffic.tile_pixels), as
        AARenderer.render returns them."""
        cam = self.camera(fwd)
        cfg = self.cfg
        S = cfg.blocksize

        def trace(xf, yf):
            o, d = self.rays(cam, xf.float(), yf.float())
            color, t = self.tracer.trace(o, d)
            return torch.cat([color, t[:, None]], 1)
        imgs = AA.tiles(trace, tiles, S, cfg.thresholds, self.dtype,
                        self.device)
        rgbs, ts = [], []
        for img, (x0, y0) in zip(imgs, tiles):
            img = img[:, :cfg.yres - y0, :cfg.xres - x0]
            rgb = torch.clamp(img[:3] * img[3:4], 0.0, 1.0)
            rgbs.append(rgb.permute(1, 2, 0).reshape(-1, 3).float().cpu()
                        .numpy())
            ts.append(img[4].reshape(-1).float().cpu().numpy())
        return np.concatenate(rgbs), np.concatenate(ts)
