"""Affine transforms kept as forward+inverse 3x4 matrix pairs.

Mirrors the reference's Xfm design (GlomeVec/Data/Glome/Vec.hs:404-629):
inverting a matrix at trace time is avoided by constructing forward and
inverse matrices together and composing both under multiplication.

Host-side scene building uses numpy float64 (exactness parity with the
reference's Double); torch application helpers at the bottom are used by
traced device code on packed matrix tables.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import DELTA


def _about_equal(a, b):
    # Reference Vec.hs:96-102.
    if a > 1:
        return abs(1 - (a / b)) < DELTA * 10
    return abs(a - b) < DELTA * 10


class Xfm:
    """A forward/inverse pair of 3x4 affine matrices (reference Vec.hs:414)."""

    __slots__ = ("fwd", "inv")

    def __init__(self, fwd, inv, check=True):
        self.fwd = np.asarray(fwd, dtype=np.float64).reshape(3, 4)
        self.inv = np.asarray(inv, dtype=np.float64).reshape(3, 4)
        if check:
            check_xfm(self)

    def __repr__(self):
        return f"Xfm(fwd={self.fwd.tolist()}, inv={self.inv.tolist()})"

    # -- application (host side, float64) --
    def point(self, p):
        p = np.asarray(p, dtype=np.float64)
        return self.fwd[:, :3] @ p + self.fwd[:, 3]

    def inv_point(self, p):
        p = np.asarray(p, dtype=np.float64)
        return self.inv[:, :3] @ p + self.inv[:, 3]

    def vector(self, v):
        return self.fwd[:, :3] @ np.asarray(v, dtype=np.float64)

    def inv_vector(self, v):
        return self.inv[:, :3] @ np.asarray(v, dtype=np.float64)

    def inv_normal(self, n):
        """Transform a normal by the inverse transpose (reference Vec.hs:543-550)."""
        return self.inv[:, :3].T @ np.asarray(n, dtype=np.float64)

    def normal(self, n):
        """Forward-transform a normal = fwd's inverse transpose = inv[:, :3].T
        applied with self.inv in the forward role."""
        return self.fwd[:, :3].T @ np.asarray(n, dtype=np.float64)

    # -- structure queries used by the scene flattener for baking --
    def is_identity(self):
        return (np.allclose(self.fwd, IDENT.fwd, atol=1e-12)
                and np.allclose(self.inv, IDENT.inv, atol=1e-12))

    def linear(self):
        return self.fwd[:, :3]

    def uniform_scale(self):
        """If fwd's linear part is a rotation times a uniform scale (possibly
        with reflection), return the positive scale factor, else None."""
        lin = self.fwd[:, :3]
        g = lin.T @ lin
        s2 = g[0, 0]
        if np.allclose(g, np.eye(3) * s2, rtol=1e-9, atol=1e-9 * max(s2, 1.0)):
            return math.sqrt(s2)
        return None

    def is_axis_aligned(self):
        """True if fwd's linear part is diagonal (axis-aligned scale)."""
        lin = self.fwd[:, :3]
        return np.allclose(lin, np.diag(np.diag(lin)), atol=1e-12)


def mat_mult(a, b):
    """Compose 3x4 affine matrices: result = a . b (reference Vec.hs:426-443)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    out = np.empty((3, 4), dtype=np.float64)
    out[:, :3] = a[:, :3] @ b[:, :3]
    out[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return out


def xfm_mult(a: Xfm, b: Xfm) -> Xfm:
    """Reference Vec.hs:447-449: fwd = a.b, inv = b_inv.a_inv."""
    return Xfm(mat_mult(a.fwd, b.fwd), mat_mult(b.inv, a.inv), check=False)


def check_xfm(x: Xfm) -> Xfm:
    """Verify fwd . inv ~= identity (reference Vec.hs:466-477)."""
    m = mat_mult(x.fwd, x.inv)
    tgt = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]])
    if not np.all(np.abs(m - tgt) < DELTA * 10):
        raise ValueError(f"corrupt matrix: fwd.inv = {m}")
    return x


IDENT = Xfm(np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], dtype=np.float64),
            np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], dtype=np.float64),
            check=False)


def compose(xfms) -> Xfm:
    """Combine transforms so they apply in list order (reference Vec.hs:461-462)."""
    out = IDENT
    for x in reversed(list(xfms)):
        out = xfm_mult(out, x)
    return check_xfm(out)


def translate(v) -> Xfm:
    x, y, z = (float(c) for c in v)
    return Xfm([[1, 0, 0, x], [0, 1, 0, y], [0, 0, 1, z]],
               [[1, 0, 0, -x], [0, 1, 0, -y], [0, 0, 1, -z]], check=False)


def scale(v) -> Xfm:
    x, y, z = (float(c) for c in v)
    return Xfm([[x, 0, 0, 0], [0, y, 0, 0], [0, 0, z, 0]],
               [[1 / x, 0, 0, 0], [0, 1 / y, 0, 0], [0, 0, 1 / z, 0]],
               check=False)


def rotate(axis, angle) -> Xfm:
    """Axis-angle rotation; axis must be normalized (reference Vec.hs:577-598)."""
    v = np.asarray(axis, dtype=np.float64)
    ln = float(np.sqrt(v @ v))
    if not _about_equal(ln, 1.0):
        raise ValueError(f"please use a normalized vector for rotation: {ln}")
    x, y, z = (float(c) for c in v)
    s, c = math.sin(angle), math.cos(angle)
    m = [[x * x + (1 - x * x) * c, x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
         [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c, y * z * (1 - c) - x * s],
         [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, z * z + (1 - z * z) * c]]
    fwd = np.concatenate([np.asarray(m), np.zeros((3, 1))], axis=1)
    inv = np.concatenate([np.asarray(m).T, np.zeros((3, 1))], axis=1)
    return Xfm(fwd, inv, check=False)


def xyz_to_uvw(u, v, w) -> Xfm:
    """Map canonical xyz coordinates into the (u,v,w) frame
    (reference Vec.hs:602-619).  u,v,w must be orthonormal."""
    u = np.asarray(u, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    for name, a in (("u", u), ("v", v), ("w", w)):
        if not _about_equal(float(a @ a), 1.0):
            raise ValueError(f"unnormalized {name}")
    if (abs(u @ v) > DELTA * 10 or abs(u @ w) > DELTA * 10
            or abs(v @ w) > DELTA * 10):
        raise ValueError("vectors aren't orthogonal")
    cols = np.stack([u, v, w], axis=1)  # columns u v w
    fwd = np.concatenate([cols, np.zeros((3, 1))], axis=1)
    inv = np.concatenate([cols.T, np.zeros((3, 1))], axis=1)
    return Xfm(fwd, inv, check=False)


def uvw_to_xyz(u, v, w) -> Xfm:
    x = xyz_to_uvw(u, v, w)
    return Xfm(x.inv, x.fwd, check=False)


def orth(v):
    """A pair of vectors orthogonal to unit v (reference Vec.hs:366-378)."""
    v = np.asarray(v, dtype=np.float64)
    if not _about_equal(float(v @ v), 1.0):
        raise ValueError("orth: unnormalized vector")
    dvx = float(v @ np.array([1.0, 0, 0]))
    if -0.8 < dvx < 0.8:
        v2 = np.cross(v, [1.0, 0, 0])
    else:
        v2 = np.cross(v, [0.0, 1.0, 0])
    v2 = v2 / np.linalg.norm(v2)
    v3 = np.cross(v, v2)
    return v2, v3


# --- device-side application over packed matrix tables --------------------

def apply_point(mats, pts):
    """mats: (..., 3, 4); pts: (..., 3) -> transformed points."""
    return torch.einsum('...ij,...j->...i', mats[..., :, :3], pts) + mats[..., :, 3]

def apply_vector(mats, vs):
    return torch.einsum('...ij,...j->...i', mats[..., :, :3], vs)

def apply_normal_T(mats, ns):
    """Apply transpose of the linear part (for inverse-transpose normals)."""
    return torch.einsum('...ji,...j->...i', mats[..., :, :3], ns)
