"""Camera model and frame rendering (torch).

Camera construction mirrors GlomeTrace/Data/Glome/Scene.hs:48-57; the
screen-to-camera mapping and primary ray generation mirror
GlomeView/Glome.hs:27-33,119-140.  A frame is one flat ray batch
(optionally chunked), traced in 32x32-pixel tile order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import telemetry
from .config import RenderConfig
from .trace import Tracer


@dataclasses.dataclass
class Camera:
    pos: np.ndarray
    fwd: np.ndarray
    up: np.ndarray
    right: np.ndarray


def camera(pos, at, up, angle_deg) -> Camera:
    """Build an orthonormal camera basis scaled by tan(fov/2)
    (reference Scene.hs:48-57)."""
    pos = np.asarray(pos, dtype=np.float64)
    at = np.asarray(at, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = at - pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    up_ = np.cross(fwd, right)
    up_ = up_ / np.linalg.norm(up_)
    cam_scale = math.tan((math.pi / 180.0) * (angle_deg / 2.0))
    return Camera(pos, fwd, up_ * cam_scale, right * cam_scale)


def tile_order(xres, yres, bw=32, bh=32):
    """Permutation putting rays in screen-tile-major order (bw x bh
    pixel tiles): 1024 consecutive rays form a 32x32 beam, so the rays
    of one warp start coherent (same BVH nodes, same prims).  Pure
    reordering -- per-ray results are identical; callers scatter outputs
    back through the permutation."""
    ys, xs = np.mgrid[0:yres, 0:xres]
    ntx = (xres + bw - 1) // bw
    key = (((ys // bh) * ntx + (xs // bw)) * (bw * bh)
           + (ys % bh) * bw + (xs % bw))
    return np.argsort(key.reshape(-1), kind="stable")


def pixel_coords(width, height, xf, yf):
    """Screen (pixel) -> camera plane coordinates (Glome.hs:133-140).
    Accepts float tensors for sub-pixel sampling."""
    xcoord = ((xf / width) * 2.0 - 1.0) * (width / height)
    ycoord = -((yf / height) * 2.0 - 1.0)
    return xcoord, ycoord


def primary_rays(cam: Camera, xcoord, ycoord, dtype=torch.float32):
    """Primary rays for camera-plane coordinates
    (dir = norm(fwd - x*right + y*up), Glome.hs:30-32)."""
    dev = xcoord.device
    fwd = torch.as_tensor(cam.fwd, dtype=dtype, device=dev)
    up = torch.as_tensor(cam.up, dtype=dtype, device=dev)
    right = torch.as_tensor(cam.right, dtype=dtype, device=dev)
    d = (fwd[None, :] - xcoord[:, None] * right[None, :]
         + ycoord[:, None] * up[None, :])
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = torch.as_tensor(cam.pos, dtype=dtype, device=dev).expand(d.shape)
    return o, d


class Renderer:
    """Whole-frame rendering of one compiled scene through a tracer.
    The device is that of the scene tensors passed to render()."""

    def __init__(self, tracer: Tracer, cam: Camera,
                 config: Optional[RenderConfig] = None,
                 ray_chunk: Optional[int] = None):
        self.tracer = tracer
        self.cam = cam
        self.config = config or tracer.config
        self.ray_chunk = ray_chunk
        self.last_overflow = None
        self._order_key = None
        self._order = None

    # differentiable core: rays -> premultiplied rgb + depth (+ queue
    # overflow counts, all zero with exact queues)
    def _render_rays(self, arrays, o, d):
        res = self.tracer.trace(arrays, o, d)
        rgb = res.color[..., :3] * res.color[..., 3:4]
        return rgb, res.t, res.overflow

    def rays_for_pixels(self, xf, yf, device, dtype=torch.float32):
        cfg = self.config
        xc, yc = pixel_coords(cfg.xres, cfg.yres,
                              torch.as_tensor(xf, dtype=dtype, device=device),
                              torch.as_tensor(yf, dtype=dtype, device=device))
        return primary_rays(self.cam, xc, yc, dtype=dtype)

    def _tile_order(self, device):
        """The frame size's tile_order as int32 on `device`, built once
        per (xres, yres, device): the only table a frame keeps on the
        card (1.4 MB at 720x480)."""
        cfg = self.config
        key = (cfg.xres, cfg.yres, str(device))
        if self._order_key != key:
            self._order = torch.as_tensor(
                tile_order(cfg.xres, cfg.yres).astype(np.int32),
                device=device)
            self._order_key = key
        return self._order

    def render(self, arrays, subpixel_offset: float = 0.0):
        """Render a full frame at 1 ray/pixel; returns (H, W, 3) rgb in
        [0, 1] (premultiplied by alpha, like the reference blit,
        Glome.hs:353-358) and the (H, W) depth map.  Rays are traced in
        32x32-tile order (see tile_order) and scattered back.  One call
        is one telemetry frame: the spans render.ray_setup (up to the
        first trace call) and render.scatter (after the last).  The
        set-up and the scatter run on the device from the frame size's
        tile order (_tile_order); the pixel coordinates are passed as
        temporaries, so none is held while the rays are traced."""
        with telemetry.frame("render.frame"):
            cfg = self.config
            with telemetry.span("render.ray_setup"):
                device = arrays["lights"]["pos"].device
                order = self._tile_order(device)
                o, d = self.rays_for_pixels(
                    (order % cfg.xres).float() + subpixel_offset,
                    torch.div(order, cfg.xres, rounding_mode="floor").float()
                    + subpixel_offset, device)
            n = o.shape[0]
            chunk = self.ray_chunk or n
            rgbs, depths = [], []
            self.last_overflow = None
            for s in range(0, n, chunk):
                rgb, t, ov = self._render_rays(arrays, o[s:s + chunk],
                                               d[s:s + chunk])
                rgbs.append(rgb)
                depths.append(t)
                if ov is not None:
                    self.last_overflow = (ov if self.last_overflow is None
                                          else self.last_overflow + ov)
            with telemetry.span("render.scatter"):
                # each ray's result to its pixel: a permutation, so no
                # index repeats
                at = order.long()
                rgb = torch.cat(rgbs)
                rgb = torch.empty_like(rgb).index_copy_(0, at, rgb).reshape(
                    cfg.yres, cfg.xres, 3)
                t = torch.cat(depths)
                t = torch.empty_like(t).index_copy_(0, at, t).reshape(
                    cfg.yres, cfg.xres)
                return torch.clamp(rgb, 0.0, 1.0), t
