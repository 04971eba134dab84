"""Branchless primitive intersection functions (torch).

Each reference primitive (GlomeTrace/Data/Glome/{Sphere,Plane,Box,
Triangle,Cone}.hs) becomes batched tensor functions here:

  *_hits2(params..., o, d)  -> (t0, n0, t1, n1)
      The entry (slot 0) and exit (slot 1) boundary crossings of the ray
      with the solid, as distances along d, with geometric outward
      normals.  Absent crossings are +INF.  No positivity filtering --
      callers (plain hits, CSG validity) filter.  For surface primitives
      (triangle, disc, plane) slot assignment encodes crossing kind:
      planes put their single crossing in slot 0 when the ray is
      entering the half-space (d.n < 0) and slot 1 when exiting.

  *_inside(params..., p)    -> bool
      Strict point-in-solid test (reference `inside` methods).

Conventions: every input broadcasts; rays are (..., 3) float tensors; a
miss is t = +INF.  All control flow is torch.where.  Division hazards
are guarded, and square roots are floored (round 5), so no NaN leaks
through a select into a gradient.

Two copies follow these functions on the card: csrc/finalize_hit.cu
(megakernel.finalize's kernel) evaluates the *_hits2 in the same order
of operations, to give the same Hit bit for bit, and csrc/prims.cuh
computes the select kernels' distances.  A change to a primitive here
changes both.
"""

from __future__ import annotations

import torch

from .config import INFINITY
from .vec import vdot, vcross, vnorm, vscaleadd

INF = INFINITY


def _safe_div(a, b):
    """a / b with b == 0 replaced; caller must mask those lanes."""
    denom = torch.where(b == 0.0, 1.0, b)
    return a / denom


def _miss_like(t):
    return torch.full_like(t, INF)


# --- sphere (Sphere.hs:20-81) ---------------------------------------------

def sphere_hits2(center, radius, o, d):
    eo = center - o
    v = vdot(eo, d)
    disc = radius * radius - (vdot(eo, eo) - v * v)
    ok = disc >= 0.0
    sq = torch.sqrt(torch.where(ok, torch.clamp(disc, min=1e-12), 0.0))
    t0 = torch.where(ok, v - sq, INF)
    t1 = torch.where(ok, v + sq, INF)
    p0 = vscaleadd(o, d, t0)
    p1 = vscaleadd(o, d, t1)
    n0 = vnorm(p0 - center)
    n1 = vnorm(p1 - center)
    return t0, n0, t1, n1


def sphere_inside(center, radius, p):
    off = center - p
    return vdot(off, off) < radius * radius


# --- plane / half-space (Plane.hs:27-38) ----------------------------------

def plane_hits2(norm, offset, o, d):
    dn = vdot(norm, d)
    t = _safe_div(-(vdot(norm, o) - offset), dn)
    t = torch.where(dn == 0.0, INF, t)
    entering = dn < 0.0
    t0 = torch.where(entering, t, INF)
    t1 = torch.where(entering, INF, t)
    n = torch.broadcast_to(norm, t0.shape + (3,))
    return t0, n, t1, n


def plane_inside(norm, offset, p):
    # inside_plane (Plane.hs:34-38): dot(onplane - p, n) > 0
    return vdot(norm, p) < offset


# --- axis-aligned box (Box.hs:18-68) --------------------------------------

def box_hits2(bmin, bmax, o, d):
    BIG = 1e18
    para = d == 0.0
    inv = 1.0 / torch.where(para, 1.0, d)
    ta = (bmin - o) * inv
    tb = (bmax - o) * inv
    tin = torch.minimum(ta, tb)
    tout = torch.maximum(ta, tb)
    in_slab = (o > bmin) & (o < bmax)
    tin = torch.where(para, torch.where(in_slab, -BIG, BIG), tin)
    tout = torch.where(para, torch.where(in_slab, BIG, -BIG), tout)
    lastin = torch.amax(tin, dim=-1)
    firstout = torch.amin(tout, dim=-1)
    ok = lastin <= firstout
    # face normals: one-hot of the deciding axis with first-match
    # tie-breaking
    sgn = torch.sign(d)
    sgn = torch.where(sgn == 0.0, 1.0, sgn)

    def onehot_first(m):
        m0 = m[..., 0]
        m1 = m[..., 1] & ~m0
        m2 = m[..., 2] & ~m0 & ~m1
        return torch.stack([m0, m1, m2], dim=-1)

    m_in = onehot_first(tin == lastin[..., None])
    n0 = -torch.where(m_in, sgn, 0.0)
    m_out = onehot_first(tout == firstout[..., None])
    n1 = torch.where(m_out, sgn, 0.0)
    t0 = torch.where(ok, lastin, INF)
    t1 = torch.where(ok, firstout, INF)
    return t0, n0, t1, n1


def box_inside(bmin, bmax, p):
    return torch.all((p > bmin) & (p < bmax), dim=-1)


# --- triangle, Moller-Trumbore (Triangle.hs:45-141) -----------------------

def triangle_hits2(p1, p2, p3, o, d):
    t, _, _, n = _triangle_core(p1, p2, p3, o, d)
    return t, n, _miss_like(t), n


def trianglenorm_hits2(p1, p2, p3, n1, n2, n3, o, d):
    t, b1, b2, _ = _triangle_core(p1, p2, p3, o, d)
    n = vnorm(n1 * (1.0 - (b1 + b2))[..., None]
              + n2 * b1[..., None] + n3 * b2[..., None])
    return t, n, _miss_like(t), n


def _triangle_core(p1, p2, p3, o, d):
    e1 = p2 - p1
    e2 = p3 - p1
    s1 = vcross(d, e2)
    divisor = vdot(s1, e1)
    ok = divisor != 0.0
    invdiv = _safe_div(torch.ones_like(divisor), divisor)
    dd = o - p1
    b1 = vdot(dd, s1) * invdiv
    ok = ok & (b1 >= 0.0) & (b1 <= 1.0)
    s2 = vcross(dd, e1)
    b2 = vdot(d, s2) * invdiv
    ok = ok & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    t = vdot(e2, s2) * invdiv
    t = torch.where(ok, t, INF)
    n = vnorm(vcross(e1, e2))
    n = torch.broadcast_to(n, t.shape + (3,))
    return t, b1, b2, n


def _never(p):
    return torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device)


def triangle_inside(p1, p2, p3, p):
    return _never(p)


# --- disc (Cone.hs:69-100) ------------------------------------------------

def disc_hits2(pos, norm, radius_sqr, o, d):
    dn = vdot(norm, d)
    t = _safe_div(-vdot(norm, o - pos), dn)
    hit = dn != 0.0
    pt = vscaleadd(o, d, t)
    off = pt - pos
    hit = hit & (vdot(off, off) <= radius_sqr)
    t = torch.where(hit, t, INF)
    n = torch.broadcast_to(norm, t.shape + (3,))
    return t, n, _miss_like(t), n


# --- canonical z-axis cylinder (Cone.hs:104-147) --------------------------

def _stable_roots(a, b, c):
    """Roots of a t^2 + b t + c via the q-trick (Cone.hs:113-118); returns
    (t0, t1, has_roots) with t0 <= t1.  Degenerate a==0 handled by caller."""
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.where(ok, torch.clamp(disc, min=1e-12), 0.0))
    q = torch.where(b < 0.0, (b - sq) * -0.5, (b + sq) * -0.5)
    t0 = _safe_div(q, a)
    t1 = _safe_div(c, q)
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    return lo, hi, ok


def _zslab(h1, h2, o, d):
    """Parameter interval where h1 < z < h2."""
    oz, dz = o[..., 2], d[..., 2]
    inv = _safe_div(torch.ones_like(dz), dz)
    ta = (h1 - oz) * inv
    tb = (h2 - oz) * inv
    lo = torch.minimum(ta, tb)
    hi = torch.maximum(ta, tb)
    para = dz == 0.0
    in_slab = (oz > h1) & (oz < h2)
    lo = torch.where(para, torch.where(in_slab, -INF, INF), lo)
    hi = torch.where(para, torch.where(in_slab, INF, -INF), hi)
    return lo, hi


def cylinder_hits2(r, h1, h2, o, d):
    ox, oy = o[..., 0], o[..., 1]
    dx, dy = d[..., 0], d[..., 1]
    a = dx * dx + dy * dy
    b = 2.0 * (dx * ox + dy * oy)
    c = ox * ox + oy * oy - r * r
    lo, hi, ok = _stable_roots(a, b, c)
    vert = a == 0.0
    inside_circle = c < 0.0
    lo = torch.where(vert, torch.where(inside_circle, -INF, INF),
                     torch.where(ok, lo, INF))
    hi = torch.where(vert, torch.where(inside_circle, INF, -INF),
                     torch.where(ok, hi, -INF))
    zlo, zhi = _zslab(h1, h2, o, d)
    t0 = torch.maximum(lo, zlo)
    t1 = torch.minimum(hi, zhi)
    empty = t0 > t1
    n0 = _cyl_normal(r, h1, h2, o, d, t0, t0 == zlo)
    n1 = _cyl_normal(r, h1, h2, o, d, t1, t1 == zhi)
    t0 = torch.where(empty, INF, t0)
    t1 = torch.where(empty, INF, t1)
    return t0, n0, t1, n1


def _cyl_normal(r, h1, h2, o, d, t, is_cap):
    p = vscaleadd(o, d, t)
    side = torch.stack([p[..., 0] / r, p[..., 1] / r,
                        torch.zeros_like(p[..., 0])], dim=-1)
    # cap normal: bottom cap (z=h1) points -z, top (z=h2) points +z;
    # pick by which cap the point is nearer
    capz = torch.where(p[..., 2] < (h1 + h2) * 0.5, -1.0, 1.0)
    cap = torch.stack([torch.zeros_like(capz), torch.zeros_like(capz), capz],
                      dim=-1)
    return torch.where(is_cap[..., None], cap, side)


def cylinder_inside(r, h1, h2, p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return (z > h1) & (z < h2) & (x * x + y * y < r * r)


# --- canonical z-axis clipped cone (Cone.hs:155-255) ----------------------
# radius `r` at z=0 tapering to 0 at z=height; visible for clip1 < z < clip2
# (clip2 <= height so only the lower nappe is in range).

def cone_hits2(r, clip1, clip2, height, o, d):
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    kp = r / height
    k = kp * kp
    a = dx * dx + dy * dy - k * dz * dz
    b = 2.0 * (dx * ox + dy * oy - k * dz * (oz - height))
    c = ox * ox + oy * oy - k * (oz - height) * (oz - height)
    lo, hi, ok = _stable_roots(a, b, c)
    # a > 0: inside double-cone between roots.  a < 0: on the tails; within
    # the z-slab (z < height) only one tail applies, picked by sign(dz).
    # a == 0: ray parallel to the cone surface; f is linear in t.
    neg_tail_lo = torch.where(dz > 0.0, -INF, hi)
    neg_tail_hi = torch.where(dz > 0.0, lo, INF)
    lin_t = _safe_div(-c, b)
    lin_lo = torch.where(b < 0.0, lin_t, -INF)
    lin_hi = torch.where(b < 0.0, INF, lin_t)
    lin_lo = torch.where(b == 0.0, torch.where(c < 0.0, -INF, INF), lin_lo)
    lin_hi = torch.where(b == 0.0, torch.where(c < 0.0, INF, -INF), lin_hi)
    flo = torch.where(a > 0.0, torch.where(ok, lo, INF),
                      torch.where(a < 0.0, torch.where(ok, neg_tail_lo, -INF),
                                  lin_lo))
    fhi = torch.where(a > 0.0, torch.where(ok, hi, -INF),
                      torch.where(a < 0.0, torch.where(ok, neg_tail_hi, INF),
                                  lin_hi))
    zlo, zhi = _zslab(clip1, clip2, o, d)
    t0 = torch.maximum(flo, zlo)
    t1 = torch.minimum(fhi, zhi)
    empty = t0 > t1
    n0 = _cone_normal(r, clip1, clip2, height, o, d, t0, t0 == zlo)
    n1 = _cone_normal(r, clip1, clip2, height, o, d, t1, t1 == zhi)
    t0 = torch.where(empty, INF, t0)
    t1 = torch.where(empty, INF, t1)
    return t0, n0, t1, n1


def _cone_normal(r, clip1, clip2, height, o, d, t, is_cap):
    p = vscaleadd(o, d, t)
    invhyp = 1.0 / torch.sqrt(height * height + r * r)
    up = r * invhyp
    out = height * invhyp
    r_ = torch.sqrt(torch.clamp(p[..., 0] ** 2 + p[..., 1] ** 2, min=1e-24))
    corr = _safe_div(out, r_)
    corr = torch.where(r_ == 0.0, 0.0, corr)
    side = torch.stack([p[..., 0] * corr, p[..., 1] * corr,
                        torch.broadcast_to(up, r_.shape)], dim=-1)
    capz = torch.where(p[..., 2] < (clip1 + clip2) * 0.5, -1.0, 1.0)
    cap = torch.stack([torch.zeros_like(capz), torch.zeros_like(capz), capz],
                      dim=-1)
    return torch.where(is_cap[..., None], cap, side)


def cone_inside(r, clip1, clip2, height, p):
    # inside_cone (Cone.hs:248-251)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rz = r * (1.0 - (z - clip1) / height)
    return (z > clip1) & (z < clip2) & (x * x + y * y < rz * rz)
