"""Glome's procedural fields (GlomeVec/Data/Glome/Texture.hs), written
plainly over (N, 3) torch points: the triangle wave and Perlin noise."""

from __future__ import annotations

import itertools

import numpy as np
import torch

# the permutation phi (Texture.hs:57-58) and the 12 cube-edge gradients
# in list order (Texture.hs:60-65): tables of Glome's, data
PHI = (3, 0, 2, 7, 4, 1, 5, 11, 8, 10, 9, 6)
GRAD = [v for v in itertools.product((-1, 0, 1), repeat=3)
        if 1.1 < np.sqrt(np.dot(v, v)) < 1.5]


def triangle_wave(x):
    f = x - torch.floor(x)
    return torch.where(f < 0.5, 2.0 * f, 2.0 - 2.0 * f)


def _omega(t):
    t = torch.abs(t)
    return 1.0 - 10.0 * t ** 3 + 15.0 * t ** 4 - 6.0 * t ** 5


def _phi(x, table):
    return table[torch.remainder(torch.abs(x), 12)]


def noise(p):
    """Perlin noise: the sum over the eight lattice corners of each
    corner's gradient dotted with the offset, weighted by omega of the
    offset on each axis (Texture.hs:92-107)."""
    phi = torch.tensor(PHI, dtype=torch.int64, device=p.device)
    grad = torch.tensor(GRAD, dtype=p.dtype, device=p.device)
    cell = torch.floor(p)
    i = cell.to(torch.int64)
    f = p - cell
    out = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for corner in itertools.product((0, 1), repeat=3):
        c = torch.tensor(corner, dtype=torch.int64, device=p.device)
        q = i + c
        h = _phi(q[..., 0] + _phi(q[..., 1] + _phi(q[..., 2], phi), phi),
                 phi)
        v = f - c.to(p.dtype)
        w = _omega(v[..., 0]) * _omega(v[..., 1]) * _omega(v[..., 2])
        out = out + w * (grad[h] * v).sum(-1)
    return out


def perlin(p):
    """Noise mapped to [0, 1] (Texture.hs:109-116)."""
    return (noise(p) + 1.0) * 0.5
