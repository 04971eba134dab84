"""Procedural noise: waves, stripes and Perlin noise (torch).

Port of GlomeVec/Data/Glome/Texture.hs semantics over (..., 3) point
batches.  The permutation and gradient tables are the numpy tables of
glome_tpu/noise.py, built exactly like the reference
(Texture.hs:57-65).
"""

from __future__ import annotations

import numpy as np
import torch

from .vec import const, vdot


# -- interpolation functions (Texture.hs:11-28) ----------------------------

def square_wave(x):
    off = x - torch.floor(x)
    return torch.where(off < 0.5, torch.zeros_like(off), torch.ones_like(off))


def triangle_wave(x):
    off = x - torch.floor(x)
    return torch.where(off < 0.5, off * 2.0, 2.0 - off * 2.0)


def sine_wave(x):
    return torch.sin(x * 2.0 * np.pi) * 0.5 + 0.5


def lump_wave(x):
    return 1.0 - x * x * x


def stripe(pos, axis, interp):
    """Scalar stripe field: interp(dot(pos, axis)) (Texture.hs:35-40)."""
    return interp(vdot(pos, const(axis, pos.dtype, pos.device)))


# -- Perlin noise (Texture.hs:43-116) --------------------------------------

# phi permutation (Texture.hs:57-58)
_PHI = np.array([3, 0, 2, 7, 4, 1, 5, 11, 8, 10, 9, 6], dtype=np.int32)

# gradient table: the 12 edge vectors of a cube, in list-comprehension
# order with 1.1 < |v| < 1.5 (Texture.hs:60-65)
_GRAD = np.array([v for v in
                  [[x, y, z] for x in (-1, 0, 1)
                   for y in (-1, 0, 1)
                   for z in (-1, 0, 1)]
                  if 1.1 < np.sqrt(np.dot(v, v)) < 1.5], dtype=np.float64)
assert _GRAD.shape == (12, 3)

# grad[phi[x]] fused into one table: the corner's last permutation step
# returns the gradient directly
_GRADPHI = _GRAD[_PHI]


def _omega(t):
    """Quintic falloff -6t^5 + 15t^4 - 10t^3 + 1 on |t| (Texture.hs:49-54)."""
    t = torch.abs(t)
    t3 = t * t * t
    return -6.0 * t3 * t * t + 15.0 * t3 * t - 10.0 * t3 + 1.0


def noise(p):
    """Perlin noise in roughly [-1, 1] (Texture.hs:92-107): the sum of
    the 8 lattice-corner knots, with the hash lookups shared between
    corners computed once (a(k) has 2 values, b(j, a) 4) and the last
    permutation fused with the gradient table."""
    phi = const(_PHI, torch.int64, p.device)
    gradphi = const(_GRADPHI, p.dtype, p.device)
    ijk = torch.floor(p)
    i = ijk[..., 0].to(torch.int64)
    j = ijk[..., 1].to(torch.int64)
    k = ijk[..., 2].to(torch.int64)
    u = p - ijk
    om = [[_omega(u[..., c] - 0.0), _omega(u[..., c] - 1.0)]
          for c in range(3)]
    a = [phi[torch.abs(k + dk) % 12] for dk in (0, 1)]
    b = [[phi[torch.abs(j + dj + a[dk]) % 12] for dk in (0, 1)]
         for dj in (0, 1)]
    out = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for di in (0, 1):
        ui = u[..., 0] - di
        for dj in (0, 1):
            uj = u[..., 1] - dj
            w_ij = om[0][di] * om[1][dj]
            for dk in (0, 1):
                g = gradphi[torch.abs(i + di + b[dj][dk]) % 12]
                uk = u[..., 2] - dk
                dot = g[..., 0] * ui + g[..., 1] * uj + g[..., 2] * uk
                out = out + w_ij * om[2][dk] * dot
    return out


def turbulence(p, n):
    """Octave sum of |noise|; octaves get *coarser* (Texture.hs:85-90)."""
    t = torch.abs(noise(p))
    if n <= 1:
        return t
    return t + 0.5 * turbulence(p * 0.5, n - 1)


def perlin(p):
    """Perlin noise mapped to [0, 1] (Texture.hs:109-116)."""
    return (noise(p) + 1.0) * 0.5
