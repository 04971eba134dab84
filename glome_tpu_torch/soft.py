"""Soft-edge visibility relaxation: pixel gradients through silhouettes
(torch port of glome_tpu/soft.py).

The hard tracer's visibility is a select: gradients flow through the
winning hit's parameters within a smooth region, but the coverage step
at a silhouette or occlusion boundary has zero derivative, so an
optimization can never MOVE an edge.  This module is the standard
soft-coverage relaxation (in the spirit of SoftRas): every ray gets a
smooth signed edge field `e` for its winning primitive (positive inside
the silhouette, negative outside, zero on it) and a coverage

    alpha = sigmoid(e / tau)

The rendered color is alpha * hit_color + (1 - alpha) * miss_color.
Rays that MISS also get a two-sided contribution: the nearest-to-
silhouette primitive (largest e < 0) is shaded at its closest-approach
surface point and blended in with its (small) alpha, so gradients pull
coverage outward as well as pushing it inward.  tau -> 0 recovers the
hard image exactly.

Edge fields per primitive type (object space for transformed groups):
  sphere    r^2 - |perp|^2           (quadratic discriminant; smooth)
  box       min over axes of slab overlap (far - near; piecewise linear)
  triangle  min barycentric margin (signed, linear)
  disc      r^2 - |p - pos|^2 at the plane crossing (smooth)
  cylinder  quadratic discriminant vs the z-slab interval overlap
  cone      same scheme with the cone quadratic (Cone.hs:155-204 form)
  plane     no soft edge (hard fallback)

CSG winners additionally take the min of their own prim edge field and
the clause-validity margin: for every other clause of the winner's CSG
object, a smooth inside-margin over the clause's members (positive
inside), signed by the clause polarity (Csg.hs:92-101).  Near-miss
candidates from CSG groups get the same margin at their synthetic
surface point.

The soft pass sweeps the prim groups of scene 0 densely, O(N*P) torch
ops per group, as glome_tpu does with jnp; the hard trace underneath
runs the tracer's kernels.  Miss-side synthetic shading is depth-1
surface shading (no child rays, no shadow query): its weight vanishes
as tau -> 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .compile import TAG_DEPTH, TEX_DEPTH, group_device_params
from .config import INFINITY
from .graphs import EAGER
from .intersect import Hit
from .trace import Tracer, _light_arrays
from .vec import vcross, vdot, vnorm, vscaleadd

BIG = 1e9


def _full(like, v):
    """A 0-dim tensor of value v with like's dtype and device."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _where(c, a, b):
    """jnp.where with python scalars allowed on either side (float32
    when both are)."""
    ref = a if torch.is_tensor(a) else b
    if not torch.is_tensor(ref):
        ref = torch.zeros((), dtype=torch.float32, device=c.device)
    if not torch.is_tensor(a):
        a = _full(ref, a)
    if not torch.is_tensor(b):
        b = _full(ref, b)
    return torch.where(c, a, b)


def _clip(x, lo, hi):
    """jnp.clip: minimum(maximum(x, lo), hi)."""
    lo = lo if torch.is_tensor(lo) else _full(x, lo)
    hi = hi if torch.is_tensor(hi) else _full(x, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def _safe(x, eps=1e-12):
    """x with |x| < eps replaced by eps."""
    return _where(torch.abs(x) < eps, eps, x)


def _edge_and_point(ptype, params, o, d):
    """(e, q, n): smooth signed edge field, closest-approach surface
    point and its outward normal for one prim batch against rays.  o, d
    broadcast against (1, P, ...) params to a common (N, P, 3)."""
    if ptype == "sphere":
        c, r = params["center"], params["radius"]
        oc = c - o
        tca = vdot(oc, d)                       # along-ray closest approach
        perp = oc - d * tca[..., None]
        e = r * r - vdot(perp, perp)            # discriminant: smooth
        n = vnorm(-perp + torch.tensor([0.0, 0.0, 1e-12], dtype=o.dtype,
                                       device=o.device))
        q = c + n * r[..., None]
        inside = vdot(oc, oc) < r * r
        e = _where((tca <= 0.0) & ~inside, -BIG, e)
        return e, q, n
    if ptype == "box":
        bmin, bmax = params["bmin"], params["bmax"]
        inv = 1.0 / _where(torch.abs(d) < 1e-12, 1e-12, d)
        ta = (bmin - o) * inv
        tb = (bmax - o) * inv
        near = torch.amax(torch.minimum(ta, tb), dim=-1)
        far = torch.amin(torch.maximum(ta, tb), dim=-1)
        e = _where(far > 0.0, far - near, -BIG)
        tmid = torch.clamp(0.5 * (near + far), min=0.0)
        q = o + d * tmid[..., None]
        qc = _clip(q, bmin, bmax)
        n = vnorm(q - qc + 1e-12)
        return e, qc, n
    if ptype in ("triangle", "trianglenorm"):
        p1, p2, p3 = params["p1"], params["p2"], params["p3"]
        e1 = p2 - p1
        e2 = p3 - p1
        pv = vcross(d, e2)
        det = vdot(e1, pv)
        inv_det = 1.0 / _safe(det)
        tv = o - p1
        b1 = vdot(tv, pv) * inv_det
        qv = vcross(tv, e1)
        b2 = vdot(d, qv) * inv_det
        t = vdot(e2, qv) * inv_det
        margin = torch.minimum(torch.minimum(b1, b2), 1.0 - b1 - b2)
        e = _where((t > 0.0) & (torch.abs(det) > 1e-12), margin, -BIG)
        q = p1 + e1 * b1[..., None] + e2 * b2[..., None]
        n = vnorm(vcross(e1, e2))
        n = torch.where(vdot(n, d)[..., None] > 0.0, -n, n)
        return e, q, n
    if ptype == "disc":
        pos, norm, rsqr = params["pos"], params["norm"], params["rsqr"]
        dn = vdot(norm, d)
        t = -vdot(norm, o - pos) / _safe(dn)
        p = o + d * t[..., None]
        off = p - pos
        e = rsqr - vdot(off, off)
        e = _where((t > 0.0) & (torch.abs(dn) > 1e-12), e, -BIG)
        # closest point on the disc: clamp the radial offset to r
        olen = torch.sqrt(torch.clamp(vdot(off, off), min=1e-24))
        scale = torch.clamp(torch.sqrt(torch.clamp(rsqr, min=0.0)) / olen,
                            max=1.0)
        q = pos + off * scale[..., None]
        n = torch.where(dn[..., None] > 0.0, -norm, norm)
        return e, q, n.expand(q.shape)
    if ptype == "cylinder":
        # canonical z-axis cylinder (geom.cylinder_hits2 conventions):
        # edge = quadratic discriminant when the xy-ray misses the
        # infinite cylinder (smooth), else the [quadratic] x [z-slab]
        # interval overlap (piecewise linear, > 0 exactly on hits)
        r, h1, h2 = params["radius"], params["h1"], params["h2"]
        ox, oy = o[..., 0], o[..., 1]
        dx, dy = d[..., 0], d[..., 1]
        a = dx * dx + dy * dy
        a_s = torch.clamp(a, min=1e-12)
        b = 2.0 * (dx * ox + dy * oy)
        c = ox * ox + oy * oy - r * r
        disc = b * b - 4.0 * a * c
        has_roots = disc > 0.0
        # sqrt of a clamped-positive guard value: where() does not stop
        # NaN gradients of sqrt(0) leaking into the other branch
        sq = torch.sqrt(_where(has_roots, disc, 1.0))
        lo = _where(has_roots, (-b - sq) / (2.0 * a_s), BIG)
        hi = _where(has_roots, (-b + sq) / (2.0 * a_s), -BIG)
        vert = a < 1e-10
        lo = torch.where(vert, _where(c < 0.0, -BIG, BIG), lo)
        hi = torch.where(vert, _where(c < 0.0, BIG, -BIG), hi)
        zlo, zhi = _slab1(o[..., 2], d[..., 2], h1, h2)
        t0 = torch.maximum(lo, zlo)
        t1 = torch.minimum(hi, zhi)
        ov = _clip(t1 - t0, -BIG, BIG)
        # gate: candidate interval entirely behind the origin (and the
        # origin outside) can never become a hit by growing the prim
        inside_o = (c < 0.0) & (o[..., 2] > h1) & (o[..., 2] < h2)
        ov = _where((t1 <= 0.0) & ~inside_o, -BIG, ov)
        tstar = -b / (2.0 * a_s)
        smooth_miss = ~vert & ~has_roots
        e = torch.where(smooth_miss,
                        _where((tstar <= 0.0) & ~inside_o, -BIG,
                               disc / (4.0 * a_s)),
                        ov)
        pstar = o + d * torch.clamp(tstar, min=0.0)[..., None]
        q, n = _cyl_surface(r, h1, h2, pstar)
        return e, q, n
    if ptype == "cone":
        # canonical clipped cone (geom.cone_hits2 conventions): same
        # scheme with the cone quadratic; a <= 0 tail intervals follow
        # the exact kernel so hits keep e > 0
        r, c1, c2, height = (params["radius"], params["clip1"],
                             params["clip2"], params["height"])
        ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        kp = r / height
        k = kp * kp
        a = dx * dx + dy * dy - k * dz * dz
        b = 2.0 * (dx * ox + dy * oy - k * dz * (oz - height))
        c = ox * ox + oy * oy - k * (oz - height) * (oz - height)
        disc = b * b - 4.0 * a * c
        a_abs = torch.clamp(torch.abs(a), min=1e-12)
        has_roots = disc > 0.0
        sq = torch.sqrt(_where(has_roots, disc, 1.0))
        sq = _where(has_roots, sq, 0.0)
        a_nz = _where(a == 0.0, 1e-12, a)
        lo = (-b - sq * torch.sign(a)) / (2.0 * a_nz)
        hi = (-b + sq * torch.sign(a)) / (2.0 * a_nz)
        # a > 0: inside between roots.  a < 0: tails; within z < height
        # only one tail applies, picked by sign(dz) (geom.cone_hits2)
        pos_lo, pos_hi = lo, hi
        neg_lo = _where(dz > 0.0, -BIG, hi)
        neg_hi = _where(dz > 0.0, lo, BIG)
        lin_t = -c / _safe(b)
        lin_lo = _where(b < 0.0, lin_t, -BIG)
        lin_hi = _where(b < 0.0, BIG, lin_t)
        flo = torch.where(a > 0.0, pos_lo,
                          torch.where(a < 0.0, neg_lo, lin_lo))
        fhi = torch.where(a > 0.0, pos_hi,
                          torch.where(a < 0.0, neg_hi, lin_hi))
        no_roots = (a != 0.0) & (disc < 0.0)
        flo = torch.where(no_roots, _where(a > 0.0, BIG, -BIG), flo)
        fhi = torch.where(no_roots, _where(a > 0.0, -BIG, BIG), fhi)
        zlo, zhi = _slab1(oz, dz, c1, c2)
        t0 = torch.maximum(flo, zlo)
        t1 = torch.minimum(fhi, zhi)
        ov = _clip(t1 - t0, -BIG, BIG)
        miss_smooth = (a > 0.0) & (disc < 0.0)
        e = torch.where(miss_smooth, disc / (4.0 * a_abs), ov)
        rz_o = kp * (height - oz)
        inside_o = (oz > c1) & (oz < c2) & (c < 0.0) & (rz_o > 0.0)
        e = _where((t1 <= 0.0) & ~inside_o & ~miss_smooth, -BIG, e)
        tstar = -b / (2.0 * a_nz)
        e = _where(miss_smooth & (tstar <= 0.0) & ~inside_o, -BIG, e)
        pstar = o + d * torch.clamp(_where(a > 0.0, tstar, 0.0),
                                    min=0.0)[..., None]
        q, n = _cone_surface(r, c1, c2, height, pstar)
        return e, q, n
    return None


def _slab1(oz, dz, h1, h2):
    """Smooth parameter interval where h1 < z < h2 (soft variant of
    geom._zslab: parallel rays resolved by origin containment)."""
    dz_s = _safe(dz)
    ta = (h1 - oz) / dz_s
    tb = (h2 - oz) / dz_s
    lo = torch.minimum(ta, tb)
    hi = torch.maximum(ta, tb)
    para = torch.abs(dz) < 1e-12
    in_slab = (oz > h1) & (oz < h2)
    lo = torch.where(para, _where(in_slab, -BIG, BIG), lo)
    hi = torch.where(para, _where(in_slab, BIG, -BIG), hi)
    return lo, hi


def _cyl_surface(r, h1, h2, pstar):
    """Nearest side-surface point/normal to a probe point (canonical)."""
    xy = pstar[..., :2]
    xylen = torch.sqrt(torch.clamp(vdot(xy, xy), min=1e-24))
    ux = xy[..., 0] / xylen
    uy = xy[..., 1] / xylen
    zc = _clip(pstar[..., 2], h1, h2)
    q = torch.stack([ux * r, uy * r, zc], dim=-1)
    n = torch.stack([ux, uy, torch.zeros_like(ux)], dim=-1)
    return q, n


def _cone_surface(r, c1, c2, height, pstar):
    """Nearest cone-side point/normal to a probe point (canonical)."""
    kp = r / height
    xy = pstar[..., :2]
    xylen = torch.sqrt(torch.clamp(vdot(xy, xy), min=1e-24))
    ux = xy[..., 0] / xylen
    uy = xy[..., 1] / xylen
    zc = _clip(pstar[..., 2], c1, torch.minimum(c2, height - 1e-6))
    rz = torch.clamp(kp * (height - zc), min=1e-6)
    q = torch.stack([ux * rz, uy * rz, zc], dim=-1)
    invhyp = 1.0 / torch.sqrt(height * height + r * r)
    up = r * invhyp
    out = height * invhyp
    n = torch.stack([ux * out, uy * out, up.expand(ux.shape)], dim=-1)
    return q, n


def _inside_margin(ptype, params, p):
    """Smooth signed inside-margin of prims at points: positive exactly
    where the strict inside tests are True, negative outside, zero on
    the boundary.  p: (N, P, 3) object-space points broadcast against
    (1, P, ...) params.  Zero-volume prims (triangle/disc) are never
    inside (-BIG)."""
    if ptype == "sphere":
        off = params["center"] - p
        return params["radius"] ** 2 - vdot(off, off)
    if ptype == "plane":
        return params["offset"] - vdot(params["norm"], p)
    if ptype == "box":
        lo = p - params["bmin"]
        hi = params["bmax"] - p
        return torch.amin(torch.minimum(lo, hi), dim=-1)
    if ptype == "cylinder":
        r, h1, h2 = params["radius"], params["h1"], params["h2"]
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return torch.minimum(r * r - x * x - y * y,
                             torch.minimum(z - h1, h2 - z))
    if ptype == "cone":
        r, c1, c2, height = (params["radius"], params["clip1"],
                             params["clip2"], params["height"])
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        rz = r * (1.0 - (z - c1) / height)
        return torch.minimum(rz * torch.abs(rz) - x * x - y * y,
                             torch.minimum(z - c1, c2 - z))
    return torch.full(p.shape[:-1], -BIG, dtype=p.dtype, device=p.device)


def _xfm_points(m, p):
    """Rows of (P, 3, 4) affine matrices applied to (N, 3) points or
    (N, P, 3) vectors-with-translation: (N, P, 3)."""
    if p.dim() == 2:
        return torch.einsum('pij,nj->npi', m[..., :3], p) + m[:, :, 3]
    return torch.einsum('pij,npj->npi', m[..., :3], p) + m[:, :, 3]


class SoftTracer:
    """Wraps a (hard) Tracer with soft-coverage blending.

    render(arrays, o, d) -> (N, 4) ColorA where visibility at
    silhouettes is a sigmoid of the edge field with temperature `tau`.
    tau <= 0 returns the hard color unchanged.  Runs on the device of
    the arrays and rays it is given."""

    SOFT_TYPES = ("sphere", "box", "triangle", "trianglenorm",
                  "disc", "cylinder", "cone")

    def __init__(self, tracer: Tracer, tau: float = 1e-2):
        self.tracer = tracer
        self.tau = float(tau)
        cc = tracer.compiled
        # scene-0 groups with a soft edge field (CSG members included:
        # their winners/candidates take the min with the clause margin)
        self.soft_groups = [
            (gi, g) for gi, g in enumerate(cc.scenes[0].groups)
            if g.size > 0 and not bool(g.onlyshadow.any())
            and g.ptype in self.SOFT_TYPES]
        self.has_csg = any(np.any(g.csg_id >= 0)
                           for _gi, g in self.soft_groups)
        self._static = {}

    def _meta(self, g, name, device):
        """A group's static per-prim int table on `device`, cached."""
        key = (id(g), name, str(device))
        if key not in self._static:
            self._static[key] = torch.as_tensor(
                np.asarray(getattr(g, name)), dtype=torch.int64,
                device=device)
        return self._static[key]

    # -- edge field of the winner + best near-miss candidate ---------------

    def _soft_pass(self, arrays, o, d, hit_serial):
        """Per-ray: edge field of the winning prim (+BIG when the winner
        has no soft field), and the best near-miss soft candidate
        (largest e among prims that are NOT the winner) with its
        synthetic surface point/normal/texture stack; also the winner's
        and the candidate's (csg_id, clause) for the clause margin, -1
        for plain prims."""
        N = o.shape[0]
        dt, dev = o.dtype, o.device
        e_win = torch.full((N,), BIG, dtype=dt, device=dev)
        e_best = torch.full((N,), -BIG, dtype=dt, device=dev)
        q_best = torch.zeros((N, 3), dtype=dt, device=dev)
        n_best = torch.zeros((N, 3), dtype=dt, device=dev)
        minus1 = torch.full((N,), -1, dtype=torch.int64, device=dev)
        win_cid, win_cl, cand_cid, cand_cl = minus1, minus1, minus1, minus1
        tex_best = torch.full((N, TEX_DEPTH), -1, dtype=torch.int64,
                              device=dev)
        neg = _full(o, -BIG)
        hit_serial = hit_serial.to(torch.int64)
        for gi, g in self.soft_groups:
            garr = group_device_params(g, arrays["scenes"][0][gi])
            params = {k: v.to(dt)[None] for k, v in garr.items()
                      if k not in ("m_inv", "m_fwd")}   # (1, P, ...)
            oo = o[:, None]
            dd = d[:, None]
            if g.m_inv is not None:
                mi = garr["m_inv"].to(dt)                     # (P, 3, 4)
                oo = _xfm_points(mi, o)
                dd = vnorm(torch.einsum('pij,nj->npi', mi[..., :3], d))
            e, q, n = _edge_and_point(g.ptype, params, oo, dd)  # (N, P[, 3])
            if g.m_inv is not None:
                mf = garr["m_fwd"].to(dt)
                q = _xfm_points(mf, q)
                # normals transform by the inverse transpose
                n = vnorm(torch.einsum('pji,npj->npi', mi[..., :3], n))
            serials = self._meta(g, "prim_serial", dev)[None]   # (1, P)
            csg_id = self._meta(g, "csg_id", dev)
            csg_clause = self._meta(g, "csg_clause", dev)
            is_win = serials == hit_serial[:, None]
            any_win = torch.any(is_win, dim=1)
            e_wm = torch.where(is_win, e, neg)
            e_win = torch.where(any_win, torch.amax(e_wm, dim=1), e_win)
            jw = torch.argmax(e_wm, dim=1)
            win_cid = torch.where(any_win, csg_id[jw], win_cid)
            win_cl = torch.where(any_win, csg_clause[jw], win_cl)
            # best near-miss candidate (exclude the winner itself)
            e_m = torch.where(is_win, neg, e)
            j = torch.argmax(e_m, dim=1)
            ej = torch.gather(e_m, 1, j[:, None])[:, 0]
            upd = ej > e_best
            jj = j[:, None, None].expand(N, 1, 3)
            q_best = torch.where(upd[:, None],
                                 torch.gather(q, 1, jj)[:, 0], q_best)
            n_best = torch.where(upd[:, None],
                                 torch.gather(n, 1, jj)[:, 0], n_best)
            tex_g = self._meta(g, "tex_stack", dev)[j]
            tex_best = torch.where(upd[:, None], tex_g, tex_best)
            cand_cid = torch.where(upd, csg_id[j], cand_cid)
            cand_cl = torch.where(upd, csg_clause[j], cand_cl)
            e_best = torch.where(upd, ej, e_best)
        return (e_win, e_best, q_best, n_best, tex_best.to(torch.int32),
                (win_cid, win_cl), (cand_cid, cand_cl))

    # -- CSG clause-validity margin ---------------------------------------

    def _csg_margin(self, arrays, p, cid_arr, cl_arr):
        """Smooth clause-validity margin at points p (N, 3) for rays
        whose prim belongs to CSG object `cid_arr` via clause `cl_arr`:
        min over the OTHER clauses of (positive ? m : -m) where m is the
        clause's smooth inside-margin (max over members).  Exactly
        positive where the kernels' clause check accepted the candidate
        (Csg.hs:92-101), so tau -> 0 keeps the hard image.  +BIG for
        plain prims (cid -1)."""
        cc = self.tracer.compiled
        sc = cc.scenes[0]
        N = p.shape[0]
        dt, dev = p.dtype, p.device
        out = torch.full((N,), BIG, dtype=dt, device=dev)
        if not self.has_csg:
            return out
        big = _full(p, BIG)
        for cid, csg in enumerate(sc.csgs):
            sel = cid_arr == cid
            m_total = torch.full((N,), BIG, dtype=dt, device=dev)
            for ci, clause in enumerate(csg.clauses):
                m_cl = torch.full((N,), -BIG, dtype=dt, device=dev)
                for gi, idx in clause.members:
                    g = sc.groups[gi]
                    garr = group_device_params(g, arrays["scenes"][0][gi])
                    rows = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                                           device=dev)
                    params = {k: v.to(dt)[rows][None]
                              for k, v in garr.items()
                              if k not in ("m_inv", "m_fwd")}
                    pp = p[:, None]
                    if g.m_inv is not None:
                        pp = _xfm_points(garr["m_inv"].to(dt)[rows], p)
                    m = _inside_margin(g.ptype, params, pp)  # (N, M)
                    m_cl = torch.maximum(m_cl, torch.amax(m, dim=1))
                sgn = 1.0 if clause.positive else -1.0
                # the candidate's own clause is not re-validated
                m_signed = torch.where(cl_arr == ci, big, sgn * m_cl)
                m_total = torch.minimum(m_total, m_signed)
            out = torch.where(sel, m_total, out)
        return out

    def _shade_point(self, arrays, d, q, n, tex_stack):
        """Depth-1 surface shading of a synthetic hit (no child rays, no
        shadow query -- the soft sliver's weight vanishes with tau)."""
        N = q.shape[0]
        dt, dev = q.dtype, q.device
        cc = self.tracer.compiled
        lights = cc.lights
        lpos, lcol, lrad = _light_arrays(cc, arrays, lights)
        light_contribs = []
        for li, l in enumerate(lights):
            lvec = lpos[li] - q
            llen = torch.sqrt(vdot(lvec, lvec))
            ldir = lvec / torch.clamp(llen, min=1e-20)[..., None]
            active = (vdot(lvec, n) >= 0.0) & (llen <= lrad[li])
            contrib = torch.where(active[:, None],
                                  lcol[li] * l.falloff_at(llen)[:, None],
                                  _full(q, 0.0))
            light_contribs.append((contrib, ldir, active))
        hit = Hit(t=torch.ones((N,), dtype=dt, device=dev),
                  hit=torch.ones((N,), dtype=torch.bool, device=dev),
                  pos=q, norm=n, obj_o=q, obj_d=d, tex_stack=tex_stack,
                  tag_stack=torch.full((N, TAG_DEPTH), -1, dtype=torch.int32,
                                       device=dev),
                  prim_serial=torch.full((N,), -1, dtype=torch.int32,
                                         device=dev))
        ctx = dict(hit=hit, d=d, eyedir=-d, lights=light_contribs,
                   children={}, recurs=1)
        return self.tracer._fold_textures(ctx, hit, (N,), dt)

    # -- entry ---------------------------------------------------------------

    def render(self, arrays, o, d):
        """(N, 4) soft-coverage color."""
        # the soft loss's gradient needs the eager frame
        res = self.tracer.trace(arrays, o, d, frame=EAGER)
        if self.tau <= 0.0:
            return res.color
        dt, dev = o.dtype, o.device
        N = o.shape[0]
        bgc = self.tracer.config.background
        bg = (torch.tensor(tuple(bgc) + (1.0,), dtype=dt, device=dev)
              if bgc is not None else torch.zeros((4,), dtype=dt,
                                                  device=dev))
        bg = bg.expand(N, 4)
        hitm = res.t < INFINITY
        (e_win, e_best, q_best, n_best, tex_best,
         (win_cid, win_cl), (cand_cid, cand_cl)) = self._soft_pass(
            arrays, o, d, res.prim_serial)
        if self.has_csg:
            # CSG winners/candidates: edge = min(own field, clause
            # margin) so member motion moves the boolean silhouette
            p_hit = vscaleadd(o, d, torch.where(hitm, res.t,
                                                _full(res.t, 0.0)))
            e_win = torch.minimum(
                e_win, self._csg_margin(arrays, p_hit, win_cid, win_cl))
            e_best = torch.minimum(
                e_best, self._csg_margin(arrays, q_best, cand_cid, cand_cl))
        # hit side: coverage of the winner
        a_hit = torch.sigmoid(e_win / self.tau)
        c_hit = a_hit[:, None] * res.color + (1.0 - a_hit)[:, None] * bg
        # miss side: nearest silhouette pulls coverage outward
        c_near = self._shade_point(arrays, d, q_best, n_best, tex_best)
        a_miss = torch.sigmoid(e_best / self.tau)
        has_cand = e_best > -BIG * 0.5
        a_miss = torch.where(has_cand, a_miss, _full(a_miss, 0.0))
        c_miss = a_miss[:, None] * c_near + (1.0 - a_miss)[:, None] * bg
        return torch.where(hitm[:, None], c_hit, c_miss)


def soft_pixel_loss_fn(soft: SoftTracer):
    def loss(arrays, o, d, target_rgb):
        col = soft.render(arrays, o, d)
        rgb = col[..., :3] * col[..., 3:4]
        return torch.mean((rgb - target_rgb) ** 2)
    return loss
