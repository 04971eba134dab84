"""RGBA color algebra over (..., 4) tensors.

Port of the alpha-compositing semantics in GlomeTrace/Data/Glome/Clr.hs.
A ColorA is the trailing 4-axis (r, g, b, a); batches are leading axes.
"""

from __future__ import annotations

import torch


def colora(r, g, b, a):
    parts = torch.broadcast_tensors(*(torch.as_tensor(c, dtype=torch.float32)
                                      if not torch.is_tensor(c) else c
                                      for c in (r, g, b, a)))
    return torch.stack(parts, dim=-1)


def ca_transparent(shape=(), dtype=torch.float32, device=None):
    return torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)


def ca_black(shape=(), dtype=torch.float32, device=None):
    c = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    c[..., 3] = 1.0
    return c


def cascale(c, s):
    """Scale rgb, leave alpha (reference Clr.hs:48-50)."""
    s = torch.as_tensor(s, dtype=c.dtype, device=c.device)
    return torch.cat([c[..., :3] * s[..., None], c[..., 3:]], dim=-1)


def aclamp(x):
    return torch.clamp(x, 0.0, 1.0)


def caweight(c1, c2, weight):
    """Lerp: c1*w + c2*(1-w) on all four channels (reference Clr.hs:87-91)."""
    w = torch.as_tensor(weight, dtype=c1.dtype, device=c1.device)[..., None]
    return c1 * w + c2 * (1.0 - w)


def casum(cs):
    """Additive layers: rgb = sum(rgb_i * a_i); a = 1 - prod(1 - clamp a_i)
    (reference Clr.hs:82-103).  `cs` is a sequence of (...,4) colors."""
    rgb = sum(c[..., :3] * c[..., 3:4] for c in cs)
    trans = 1.0
    for c in cs:
        trans = trans * (1.0 - aclamp(c[..., 3]))
    a = 1.0 - trans
    return torch.cat([rgb, a[..., None]], dim=-1)


def cafold(ca, cb):
    """Layer cb under ca (the over operator; reference Clr.hs:106-113)."""
    trans = 1.0 - ca[..., 3:4]
    rgb = ca[..., :3] + cb[..., :3] * trans * cb[..., 3:4]
    a = ca[..., 3:4] + cb[..., 3:4] * trans
    return torch.cat([rgb, a], dim=-1)
