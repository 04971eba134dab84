"""Vector math over batched torch tensors.

The reference implements scalar 3-vector math on an unboxed record
(GlomeVec/Data/Glome/Vec.hs:105-402).  Here every op is defined over
tensors of shape (..., 3): a "Vec" is the trailing axis, and batches of
rays/points are leading axes.
"""

from __future__ import annotations

import torch

from .config import INFINITY


def vec(x, y, z):
    parts = [a if torch.is_tensor(a)
             else torch.as_tensor(a, dtype=torch.float32) for a in (x, y, z)]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def vdot(a, b):
    """Dot product (reference Vec.hs:185-187)."""
    return torch.sum(a * b, dim=-1)


def vcross(a, b):
    """Cross product (reference Vec.hs:193-198)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def vlensqr(v):
    return vdot(v, v)


def vlen(v):
    return torch.sqrt(vdot(v, v))


def vnorm(v):
    """Normalize (reference Vec.hs:314-317).

    Guarded against zero vectors: dead queue lanes carry d = 0, and an
    unguarded 1/sqrt(0) = inf turns their (value-masked) products into
    NaN whose *backward* gradients poison whole-parameter gradients
    (sum over lanes).  clamp() is exact for any real magnitude, so live
    lanes are bit-identical."""
    inv = 1.0 / torch.sqrt(torch.clamp(vdot(v, v), min=1e-30))
    return v * inv[..., None]


def vinvert(v):
    return -v


class _FiniteGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return torch.where(torch.isfinite(ct), ct, torch.zeros_like(ct))


def finite_grad(x):
    """Identity whose backward zeroes non-finite gradient LANES.

    Differentiable-render backward passes hit isolated singular lanes
    (exact tangencies, zero-length dead rays, grazing transposes);
    their inf/NaN gradients are meaningless there, but one such lane
    poisons the whole accumulated parameter gradient the moment a
    gather's backward sums over lanes.  Placing this at the per-lane
    gather boundary filters BEFORE accumulation."""
    return _FiniteGrad.apply(x)


def vscale(v, s):
    return v * torch.as_tensor(s, dtype=v.dtype, device=v.device)[..., None]


def vscaleadd(a, b, s):
    """a + b * s (reference Vec.hs:302-306)."""
    s = torch.as_tensor(s, dtype=b.dtype, device=b.device)
    return a + b * s[..., None]


def bisect(a, b):
    """Unit bisector of two (unit) vectors (reference Vec.hs:331-332)."""
    return vnorm(a + b)


def vdist(a, b):
    return vlen(b - a)


def reflect(v, norm):
    """Reflect v off a surface with normal `norm` (reference
    Vec.hs:340-342)."""
    return vscaleadd(v, norm, -2.0 * vdot(v, norm))


def vrcp(v):
    return 1.0 / v


def ray_move(origin, direction, d):
    """Advance a ray origin along its direction (reference Vec.hs:361-363)."""
    return vscaleadd(origin, direction, d)


def plane_int_dist(orig, direction, p, norm):
    """Distance along ray to the plane through p with normal `norm`
    (reference Vec.hs:391-394)."""
    return -vdot(norm, orig - p) / vdot(norm, direction)


# --- bounding boxes -------------------------------------------------------
# A Bbox is a pair of (..., 3) tensors (bmin, bmax); reference Vec.hs:646.

def bbjoin(a, b):
    return torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1])


def bboverlap(a, b):
    return torch.maximum(a[0], b[0]), torch.minimum(a[1], b[1])


def bbinside(bb, pt):
    """Point-in-box, boundary inclusive (reference Vec.hs:662-664)."""
    bmin, bmax = bb
    return torch.all((bmin <= pt) & (pt <= bmax), dim=-1)


def bbsa(bb):
    """Surface area, clamped at 0 (reference Vec.hs:694-697)."""
    d = bb[1] - bb[0]
    sa = 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2]
                + d[..., 1] * d[..., 2])
    return torch.clamp(sa, min=0.0)


def empty_bbox(device=None):
    return (torch.full((3,), INFINITY, device=device),
            torch.full((3,), -INFINITY, device=device))


def everything_bbox(device=None):
    return (torch.full((3,), -INFINITY, device=device),
            torch.full((3,), INFINITY, device=device))


def bbclip(orig, inv_dir, bmin, bmax):
    """Ray/AABB slab clip with reciprocal directions; returns (near, far).
    Hit iff near <= far (caller decides).  Reference Vec.hs:725-741."""
    t1 = (bmin - orig) * inv_dir
    t2 = (bmax - orig) * inv_dir
    near = torch.amax(torch.minimum(t1, t2), dim=-1)
    far = torch.amin(torch.maximum(t1, t2), dim=-1)
    return near, far
