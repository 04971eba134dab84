"""Glome's adaptive antialiasing (GlomeView/Glome.hs:179-189,226-323),
written plainly, one tile at a time.

Tiles of S x S pixels are independent: a neighbour outside the tile reads
as transparent at infinite depth.  Within a tile, at the frame's pixel
coordinates (x, y):

  pass 1  trace the pixels with x, y even and x + y = 0 mod 4;
  pass 2  the other even pixels: trace where the pixels 2 away on the
          axes differ by more than threshold 1 (the larger of the two
          opposite pairs' differences), else take their mean;
  pass 3  the odd-odd pixels, by their diagonal neighbours (threshold 2);
  pass 4  the rest, by their axis neighbours (threshold 3);
  pass 5  at each pixel's far corner (x + 1/2, y + 1/2): trace where the
          2 x 2 cell differs by more than threshold 4, else its mean; a
          pixel is the mean of its corner and its cell's mean (the
          tile's last row and column by their own rule).

The difference of two samples is the sum of the absolute rgba
differences plus the depths' ratio less one.
"""

from __future__ import annotations

import math

import torch

INF = 1.0e6


def ccmp(a, b):
    """The difference of (T, 5, ...) samples a and b."""
    diff = (a[:, :4] - b[:, :4]).abs().sum(1)
    hi = torch.maximum(a[:, 4], b[:, 4])
    lo = torch.minimum(a[:, 4], b[:, 4])
    ratio = torch.where(lo == 0.0, math.inf, hi / torch.where(lo == 0.0,
                                                             1.0, lo) - 1.0)
    return diff + torch.where((a[:, 4] == 0.0) & (b[:, 4] == 0.0), 0.0,
                              ratio)


def mean(*cs):
    return sum(cs) / len(cs)


def tiles(trace, origins, S, thresholds, dtype, device):
    """The tiles' (T, 5, S, S) samples (r, g, b, a, depth), for the tiles
    whose first pixels are `origins` [(x0, y0)], all at once;
    `trace(xf, yf)` traces pixel coordinates and returns (n, 5)."""
    ys, xs = torch.meshgrid(torch.arange(S, device=device),
                            torch.arange(S, device=device), indexing="ij")
    org = torch.tensor(origins, device=device).reshape(-1, 2)
    gx = xs[None] + org[:, 0, None, None]
    gy = ys[None] + org[:, 1, None, None]
    T = org.shape[0]

    def read(img, dx, dy):
        out = torch.zeros_like(img)
        out[:, 4] = INF
        ya, yb = max(0, -dy), S - max(0, dy)
        xa, xb = max(0, -dx), S - max(0, dx)
        out[..., ya:yb, xa:xb] = img[..., ya + dy:yb + dy, xa + dx:xb + dx]
        return out

    def fill(img, mask, off=0.0):
        if bool(mask.any()):
            img = img.permute(0, 2, 3, 1).clone()
            img[mask] = trace(gx[mask].to(dtype) + off,
                              gy[mask].to(dtype) + off)
            img = img.permute(0, 3, 1, 2)
        return img

    img = torch.zeros((T, 5, S, S), dtype=dtype, device=device)
    img[:, 4] = INF
    even = (gx % 2 == 0) & (gy % 2 == 0)
    passes = [
        (even & ((gx + gy) % 4 == 0), None),
        (even & ((gx + gy) % 4 == 2), ((-2, 0), (0, 2), (2, 0), (0, -2))),
        ((gx % 2 == 1) & (gy % 2 == 1), ((-1, -1), (1, -1), (1, 1),
                                         (-1, 1))),
        ((gx + gy) % 2 == 1, ((-1, 0), (0, 1), (1, 0), (0, -1))),
    ]
    for i, (mask, offs) in enumerate(passes):
        if offs is not None:
            a, b, c, d = (read(img, dx, dy) for dx, dy in offs)
            need = mask & (torch.maximum(ccmp(a, c), ccmp(b, d))
                           > thresholds[i - 1])
            img = torch.where((mask & ~need)[:, None], mean(a, b, c, d), img)
            mask = need
        img = fill(img, mask)
    a, b, c, d = img, read(img, 0, 1), read(img, 1, 1), read(img, 1, 0)
    need = torch.maximum(ccmp(a, c), ccmp(b, d)) > thresholds[3]
    corner = fill(mean(a, b, c, d), need, off=0.5)
    xe, ye = (xs == S - 1)[None, None], (ys == S - 1)[None, None]
    cell = torch.where(xe, torch.where(ye, corner, mean(a, b)),
                       torch.where(ye, mean(a, d), mean(a, b, c, d)))
    return torch.where(xe & ye, corner, mean(corner, cell))
