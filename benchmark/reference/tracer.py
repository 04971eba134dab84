"""A plain Whitted tracer with Glome's semantics, by brute force: every
ray is tested against every primitive of the scene description, with no
tree, no table layout and no kernel of the program's.

Semantics (GlomeTrace/Data/Glome: Solid.hs, Csg.hs, Shader.hs, Trace.hs;
the same as the program states them):

- A primitive outside CSG is hit at its entry crossing if that lies ahead
  (t > 0), else at its exit.  Transforms map the ray into the
  primitive's own space unnormalised, so t is the world distance.
- A triangle (Triangle.hs) is a surface with no inside: Moller-Trumbore
  with barycentric rejects, hit from either side at its one crossing,
  never in its own plane.  A transform is baked into it (Triangle.hs:
  164-177): the vertices by the matrix, the vertex normals by its linear
  part, made unit.  Its flat normal is (p2 - p1) x (p3 - p1) of the
  world vertices, whichever side the ray comes from; the smooth one the
  barycentric blend of the vertex normals, made unit.
- CSG: a crossing of a member of clause i is a surface of the object when
  the point is inside (positive clause) or outside (negative) every other
  clause; a crossing of a difference's B must also leave B (the point
  DELTA further on is outside B, Csg.hs:38).  B's surfaces show their
  normal flipped, and with `useatex` the texture stack below the CSG of
  the first A member that holds the point (Csg.hs:39-41).
- Shading (Shader.hs, Trace.hs): the hit's texture stack is folded
  innermost first (Clr.hs cafold) until opaque; a surface is ambient plus,
  per light that faces the point, is in range and is not shadowed,
  light / d^2 times (Blinn specular ks, diffuse kd); mirrors, refraction
  (ior entering, 1 / ior leaving, total internal reflection black) and
  portals trace children one level down; depth 0 is a transparent miss.
  With a background (NFF's `b`, Shader.hs missshade) a ray that hits
  nothing takes that colour, opaque, at every depth above 0.
"""

from __future__ import annotations

import numpy as np
import torch

from . import scene as S

INF = 1.0e6
DELTA = S.DELTA
KINDS = ("sphere", "plane", "box", "cylinder", "cone", "triangle",
         "trianglenorm")
TRIANGLES = ("triangle", "trianglenorm")
# (ray, primitive) pairs a step of the search holds
PAIR_BUDGET = 1 << 24


# --- the description, flattened -----------------------------------------

class Flat:
    """One scene's primitives with their matrices, texture stacks and CSG
    roles, and each CSG object's clauses."""

    def __init__(self, root, textures: dict):
        self.leaves = []      # (kind, p, m, stack, local stack, role)
        self.csgs = []        # {"clauses": [(positive, [leaf])], "useatex"}
        self._tex = textures
        self._walk(root, np.eye(4), (), None, 0)

    def _tid(self, texture):
        try:
            key = hash(texture) and texture
        except TypeError:
            key = id(texture)
        return self._tex.setdefault(key, (len(self._tex), texture))[0]

    def _walk(self, node, m, stack, role, outer):
        if node is None:
            return
        if isinstance(node, S.Prim):
            local = stack[:len(stack) - outer] if role else ()
            p = node.p
            if node.kind in TRIANGLES:
                p, m = _bake(node.kind, p, m), np.eye(4)
            self.leaves.append((node.kind, p, m, stack, local, role))
        elif isinstance(node, S.Group):
            for it in node.items:
                self._walk(it, m, stack, role, outer)
        elif isinstance(node, S.Xform):
            self._walk(node.item, m @ node.m, stack, role, outer)
        elif isinstance(node, S.Tex):
            self._walk(node.item, m, (self._tid(node.texture),) + stack,
                       role, outer)
        elif isinstance(node, (S.Diff, S.Inter)):
            if role is not None:
                raise NotImplementedError("CSG inside a CSG member")
            items = ([(True, node.a), (False, node.b)]
                     if isinstance(node, S.Diff)
                     else [(True, it) for it in node.items])
            cid = len(self.csgs)
            csg = {"clauses": [], "useatex": isinstance(node, S.Diff)
                   and node.useatex}
            self.csgs.append(csg)
            for ci, (pos, it) in enumerate(items):
                first = len(self.leaves)
                self._walk(it, m, stack, (cid, ci), len(stack))
                csg["clauses"].append((pos, list(range(first,
                                                       len(self.leaves)))))
        else:
            raise TypeError(f"unknown node {type(node).__name__}")


def _bake(kind, p, m):
    """A triangle's numbers in world space under the matrix m."""
    q = np.asarray(p, np.float64).reshape(-1, 3)
    out = [q[:3] @ m[:3, :3].T + m[:3, 3]]
    if kind == "trianglenorm":
        n = q[3:] @ m[:3, :3].T
        out.append(n / np.linalg.norm(n, axis=1, keepdims=True))
    return tuple(np.concatenate(out).reshape(-1).tolist())


class Table:
    """A set of leaves of one kind on the device: params (L, k), the
    world-to-object matrices (L, 3, 4) and the leaves' numbers."""

    def __init__(self, flat, ids, device, store, dtype):
        self.ids = torch.tensor(ids, dtype=torch.int64, device=device)
        self.kind = flat.leaves[ids[0]][0]
        p = np.array([flat.leaves[i][1] for i in ids], np.float64)
        inv = np.stack([np.linalg.inv(flat.leaves[i][2])[:3] for i in ids])
        self.p = store(torch.tensor(p, dtype=dtype, device=device))
        self.inv = store(torch.tensor(inv, dtype=dtype, device=device))

    def __len__(self):
        return len(self.ids)

    def slice(self, a, b):
        out = object.__new__(Table)
        out.kind, out.ids = self.kind, self.ids[a:b]
        out.p, out.inv = self.p[a:b], self.inv[a:b]
        return out


def _to_obj(inv, o, d):
    """Rays (R, 3) into each leaf's space (R, L, 3)."""
    oo = torch.einsum("lij,rj->rli", inv[:, :, :3], o) + inv[:, :, 3]
    do = torch.einsum("lij,rj->rli", inv[:, :, :3], d)
    return oo, do


def _quad(a, b, c):
    """Sorted real roots of a t^2 + b t + c (INF, -INF where none)."""
    disc = b * b - 4.0 * a * c
    ok = (disc >= 0.0) & (a != 0.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a2 = torch.where(a == 0.0, 1.0, 2.0 * a)
    r1 = (-b - sq) / a2
    r2 = (-b + sq) / a2
    lo = torch.where(ok, torch.minimum(r1, r2), INF)
    hi = torch.where(ok, torch.maximum(r1, r2), -INF)
    return lo, hi, ok


def _slab(lo_b, hi_b, o, d):
    """The t interval in which lo_b < o + t d < hi_b on one axis."""
    par = d == 0.0
    dd = torch.where(par, 1.0, d)
    ta, tb = (lo_b - o) / dd, (hi_b - o) / dd
    inside = (o > lo_b) & (o < hi_b)
    lo = torch.where(par, torch.where(inside, -INF, INF),
                     torch.minimum(ta, tb))
    hi = torch.where(par, torch.where(inside, INF, -INF),
                     torch.maximum(ta, tb))
    return lo, hi


def _vertices(P):
    """A triangle table's vertices (L, 3) each, and its normals'."""
    return [torch.stack(P[k:k + 3], -1) for k in range(0, len(P), 3)]


def interval(kind, p, o, d):
    """(t_in, t_out, in_part, out_part) of rays o, d (R, L, 3) in each
    leaf's space: the entry and exit distances (INF where none) and which
    part each lies on (box: the axis; cylinder and cone: 3 for a cap).
    A triangle's one crossing is its entry."""
    P = [p[:, k] for k in range(p.shape[1])]
    zero = torch.zeros(o.shape[:2], dtype=torch.int64, device=o.device)
    if kind in TRIANGLES:
        p1, p2, p3 = _vertices(P)[:3]
        e1, e2 = p2 - p1, p3 - p1
        s1 = torch.linalg.cross(d, e2.expand_as(d))
        div = (s1 * e1).sum(-1)
        inv = 1.0 / torch.where(div == 0.0, 1.0, div)
        w = o - p1
        b1 = (w * s1).sum(-1) * inv
        s2 = torch.linalg.cross(w, e1.expand_as(w))
        b2 = (d * s2).sum(-1) * inv
        t = (e2 * s2).sum(-1) * inv
        ok = (div != 0.0) & (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) \
            & (b1 + b2 <= 1.0)
        return torch.where(ok, t, INF), torch.full_like(t, INF), zero, zero
    if kind == "sphere":
        c = torch.stack(P[:3], -1)
        oc = o - c
        lo, hi, ok = _quad((d * d).sum(-1), 2.0 * (d * oc).sum(-1),
                           (oc * oc).sum(-1) - P[3] * P[3])
        return lo, torch.where(ok, hi, INF), zero, zero
    if kind == "plane":
        n = torch.stack(P[:3], -1)
        dn = (n * d).sum(-1)
        t = (P[3] - (n * o).sum(-1)) / torch.where(dn == 0.0, 1.0, dn)
        t_in = torch.where(dn < 0.0, t, INF)
        t_out = torch.where(dn > 0.0, t, INF)
        return t_in, t_out, zero, zero
    if kind == "box":
        los, his = [], []
        for k in range(3):
            lo, hi = _slab(P[k], P[k + 3], o[..., k], d[..., k])
            los.append(lo)
            his.append(hi)
        los, his = torch.stack(los, -1), torch.stack(his, -1)
        t_in, a_in = los.max(-1)
        t_out, a_out = his.min(-1)
        empty = t_in > t_out
        return (torch.where(empty, INF, t_in),
                torch.where(empty, INF, t_out), a_in, a_out)
    x, y, z = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    if kind == "cylinder":
        r, z1, z2 = P
        a = dx * dx + dy * dy
        lo, hi, ok = _quad(a, 2.0 * (x * dx + y * dy), x * x + y * y - r * r)
        inside = x * x + y * y < r * r
        lo = torch.where(a == 0.0, torch.where(inside, -INF, INF), lo)
        hi = torch.where(a == 0.0, torch.where(inside, INF, -INF), hi)
    elif kind == "cone":
        r, z1, z2, h = P
        k = (r / h) ** 2
        w = z - h
        a = dx * dx + dy * dy - k * dz * dz
        b = 2.0 * (x * dx + y * dy - k * w * dz)
        c = x * x + y * y - k * w * w
        lo, hi, ok = _quad(a, b, c)
        # steeper than the cone: the lower nappe is the tail on the side
        # where z falls
        tail_lo = torch.where(dz > 0.0, -INF, hi)
        tail_hi = torch.where(dz > 0.0, lo, INF)
        lo = torch.where(a < 0.0, torch.where(ok, tail_lo, -INF), lo)
        hi = torch.where(a < 0.0, torch.where(ok, tail_hi, INF), hi)
        lin = -c / torch.where(b == 0.0, 1.0, b)
        lo = torch.where(a == 0.0, torch.where(b < 0.0, lin, -INF), lo)
        hi = torch.where(a == 0.0, torch.where(b < 0.0, INF, lin), hi)
    else:
        raise ValueError(kind)
    zlo, zhi = _slab(z1, z2, z, dz)
    t_in = torch.maximum(lo, zlo)
    t_out = torch.minimum(hi, zhi)
    empty = t_in > t_out
    cap_in = torch.where(zlo >= lo, 3, 0)
    cap_out = torch.where(zhi <= hi, 3, 0)
    return (torch.where(empty, INF, t_in), torch.where(empty, INF, t_out),
            cap_in, cap_out)


def inside(kind, p, x):
    """Strictly inside each leaf: x (R, L, 3) in the leaves' spaces."""
    P = [p[:, k] for k in range(p.shape[1])]
    if kind in TRIANGLES:
        return torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
    if kind == "sphere":
        c = torch.stack(P[:3], -1)
        return ((x - c) ** 2).sum(-1) < P[3] * P[3]
    if kind == "plane":
        return (x * torch.stack(P[:3], -1)).sum(-1) < P[3]
    if kind == "box":
        return ((x > torch.stack(P[:3], -1))
                & (x < torch.stack(P[3:], -1))).all(-1)
    rr = x[..., 0] ** 2 + x[..., 1] ** 2
    if kind == "cylinder":
        r, z1, z2 = P
        return (x[..., 2] > z1) & (x[..., 2] < z2) & (rr < r * r)
    r, z1, z2, h = P
    rz = r * (1.0 - (x[..., 2] - z1) / h)
    return (x[..., 2] > z1) & (x[..., 2] < z2) & (rr < rz * rz)


def normal(kind, p, x, d, part, slot):
    """The outward normal in a leaf's space at x (R, 3), from the part of
    the crossing and whether it is the entry (slot 0) or the exit."""
    P = [p[:, k] for k in range(p.shape[1])]
    if kind == "sphere":
        return x - torch.stack(P[:3], -1)
    if kind == "plane":
        return torch.stack(P[:3], -1)
    if kind in TRIANGLES:
        vs = _vertices(P)
        e1, e2 = vs[1] - vs[0], vs[2] - vs[0]
        if kind == "triangle":
            return torch.linalg.cross(e1, e2)
        # the barycentrics of x, by the edges' Gram matrix
        w = x - vs[0]
        d00, d01, d11 = ((e1 * e1).sum(-1), (e1 * e2).sum(-1),
                         (e2 * e2).sum(-1))
        d20, d21 = (w * e1).sum(-1), (w * e2).sum(-1)
        den = d00 * d11 - d01 * d01
        b1 = (d11 * d20 - d01 * d21) / den
        b2 = (d00 * d21 - d01 * d20) / den
        return _unit((1.0 - b1 - b2)[:, None] * vs[3] + b1[:, None] * vs[4]
                     + b2[:, None] * vs[5])
    sgn = torch.where(slot == 0, -1.0, 1.0)
    if kind == "box":
        e = torch.nn.functional.one_hot(part, 3).to(x.dtype)
        dsign = torch.where(d >= 0.0, 1.0, -1.0)
        return e * dsign * sgn[:, None]
    if kind == "cylinder":
        side = torch.stack([x[:, 0], x[:, 1], torch.zeros_like(x[:, 0])], -1)
    else:
        r, _z1, _z2, h = P
        side = torch.stack([x[:, 0], x[:, 1], (r / h) ** 2 * (h - x[:, 2])],
                           -1)
    dzs = torch.where(d[:, 2] >= 0.0, 1.0, -1.0)
    cap = torch.zeros_like(x)
    cap[:, 2] = dzs * sgn
    return torch.where((part == 3)[:, None], cap, side)


# --- the scene on the device ---------------------------------------------

def _budget(device):
    return PAIR_BUDGET if torch.device(device).type == "cuda" else 1 << 20


class Scene:
    """A flattened scene on `device`: plain leaves by kind, CSG objects by
    clause.  `store` rounds the stored numbers (the control's bfloat16).
    An intersection whose clauses are single primitives is convex: its
    surface is where the last member is entered and the first left."""

    def __init__(self, root, textures, device, dtype, store=lambda t: t):
        f = Flat(root, textures)
        self.budget = _budget(device)
        n = len(f.leaves)
        self.kind = torch.tensor([KINDS.index(lf[0]) for lf in f.leaves]
                                 or [0], device=device)
        role = torch.full((max(1, n), 2), -1, dtype=torch.int64)
        for i, lf in enumerate(f.leaves):
            if lf[5] is not None:
                role[i] = torch.tensor(lf[5])
        self.role = role.to(device)

        def pad(stacks):
            t = torch.full((max(1, n), 4), -1, dtype=torch.int64)
            for i, s in enumerate(stacks):
                if len(s) > 4:
                    raise NotImplementedError("texture stack deeper than 4")
                t[i, :len(s)] = torch.tensor(s, dtype=torch.int64)
            return t.to(device)
        self.stack = pad([lf[3] for lf in f.leaves])
        self.local = pad([lf[4] for lf in f.leaves])

        def tables(ids):
            ids = list(ids)
            return [Table(f, [i for i in ids if f.leaves[i][0] == k], device,
                          store, dtype)
                    for k in KINDS if any(f.leaves[i][0] == k for i in ids)]
        self.tables = {t.kind: t for t in tables(range(n))}
        at = torch.zeros(max(1, n), dtype=torch.int64)
        for t in self.tables.values():
            at[t.ids.cpu()] = torch.arange(len(t))
        self.at = at.to(device)
        self.plain = tables(i for i in range(n) if f.leaves[i][5] is None)
        self.convex, self.csgs = [], {}
        for cid, c in enumerate(f.csgs):
            cl = c["clauses"]
            if all(pos and len(ids) == 1 for pos, ids in cl):
                self.convex.append(tables(ids[0] for _p, ids in cl))
            else:
                self.csgs[cid] = {"useatex": c["useatex"],
                                  "clauses": [(pos, tables(ids))
                                              for pos, ids in cl]}
        negs = torch.zeros((max(1, len(f.csgs)), 64), dtype=torch.bool)
        for cid, c in enumerate(f.csgs):
            for ci, (pos, _ids) in enumerate(c["clauses"]):
                negs[cid, ci] = not pos
        self.neg_clause = negs.to(device)

    # -- the search ---------------------------------------------------------

    def _inside_any(self, tabs, x):
        """(R, M) points x (R, M, 3) inside any leaf of the tables."""
        R, M = x.shape[:2]
        flat = x.reshape(-1, 3)
        out = torch.zeros(flat.shape[0], dtype=torch.bool, device=x.device)
        for tab in tabs:
            step = max(1, self.budget // max(1, flat.shape[0]))
            for a in range(0, len(tab), step):
                t = tab.slice(a, a + step)
                xo = (torch.einsum("lij,rj->rli", t.inv[:, :, :3], flat)
                      + t.inv[:, :, 3])
                out |= inside(t.kind, t.p, xo).any(-1)
        return out.reshape(R, M)

    def _plain(self, o, d, best):
        for tab in self.plain:
            step = max(1, self.budget // o.shape[0])
            for a in range(0, len(tab), step):
                t = tab.slice(a, a + step)
                oo, do = _to_obj(t.inv, o, d)
                t_in, t_out, p_in, p_out = interval(t.kind, t.p, oo, do)
                ahead = t_in > 0.0
                self._keep(best, torch.where(ahead, t_in, t_out), t.ids,
                           torch.where(ahead, 0, 1),
                           torch.where(ahead, p_in, p_out))

    def _convex(self, o, d, best):
        for tabs in self.convex:
            los, his, ids, p_lo, p_hi = [], [], [], [], []
            for tab in tabs:
                oo, do = _to_obj(tab.inv, o, d)
                t_in, t_out, p_in, p_out = interval(tab.kind, tab.p, oo, do)
                if tab.kind == "plane":
                    # a half-space: entered or left once, else all or none
                    dn = (do * tab.p[:, :3]).sum(-1)
                    inside_now = (oo * tab.p[:, :3]).sum(-1) < tab.p[:, 3]
                    whole = torch.where(inside_now, -INF, INF)
                    t_in = torch.where(dn < 0.0, t_in,
                                       torch.where(dn > 0.0, -INF, whole))
                    t_out = torch.where(dn > 0.0, t_out,
                                        torch.where(dn < 0.0, INF, -whole))
                los.append(t_in)
                his.append(t_out)
                p_lo.append(p_in)
                p_hi.append(p_out)
                ids.append(tab.ids.expand(o.shape[0], -1))
            lo, j_lo = torch.cat(los, 1).max(-1)
            hi, j_hi = torch.cat(his, 1).min(-1)
            ids = torch.cat(ids, 1)
            pl, ph = torch.cat(p_lo, 1), torch.cat(p_hi, 1)
            ok = lo <= hi
            ahead = lo > 0.0
            tt = torch.where(ok, torch.where(ahead, lo, hi), INF)
            j = torch.where(ahead, j_lo, j_hi)
            part = torch.where(ahead, pl.gather(1, j_lo[:, None])[:, 0],
                               ph.gather(1, j_hi[:, None])[:, 0])
            self._keep(best, tt[:, None], None, torch.where(ahead, 0, 1),
                       part, leaf=ids.gather(1, j[:, None])[:, 0])

    def _csg(self, o, d, best):
        for csg in self.csgs.values():
            clauses = csg["clauses"]
            for ci, (pos, tabs) in enumerate(clauses):
                for tab in tabs:
                    oo, do = _to_obj(tab.inv, o, d)
                    t_in, t_out, p_in, p_out = interval(tab.kind, tab.p,
                                                        oo, do)
                    tt = torch.cat([t_in, t_out], 1)
                    ok = (tt > 0.0) & (tt < best["t"][:, None])
                    # the points of the candidates ahead, for the clauses
                    r, c = torch.nonzero(ok, as_tuple=True)
                    if r.numel() == 0:
                        continue
                    x = (o[r] + tt[r, c, None] * d[r])[:, None]
                    keep = torch.ones_like(r, dtype=torch.bool)
                    for cj, (pos_j, tabs_j) in enumerate(clauses):
                        if cj != ci:
                            keep &= self._inside_any(tabs_j, x)[:, 0] == pos_j
                    if not pos:
                        keep &= ~self._inside_any(
                            tabs, x + DELTA * d[r][:, None])[:, 0]
                    valid = torch.zeros_like(ok)
                    valid[r[keep], c[keep]] = True
                    slot = torch.cat([torch.zeros_like(p_in),
                                      torch.ones_like(p_out)], 1)
                    self._keep(best, torch.where(valid, tt, INF),
                               torch.cat([tab.ids, tab.ids]), slot,
                               torch.cat([p_in, p_out], 1))

    @staticmethod
    def _keep(best, tt, ids, slot, part, leaf=None):
        """Keep the nearest of the candidates tt (R, L) ahead of each
        ray's best: of leaves ids (L,), crossings slot and part (R, L);
        or, with `leaf`, of one candidate a ray (tt (R, 1))."""
        tmin, j = torch.where(tt > 0.0, tt, INF).min(-1)
        upd = tmin < best["t"]
        if leaf is None:
            take = lambda v: v.gather(1, j[:, None])[:, 0]
            leaf, slot, part = ids[j], take(slot), take(part)
        best["t"] = torch.where(upd, tmin, best["t"])
        best["leaf"] = torch.where(upd, leaf, best["leaf"])
        best["slot"] = torch.where(upd, slot, best["slot"])
        best["part"] = torch.where(upd, part, best["part"])

    def nearest(self, o, d, tmax):
        """The nearest valid crossing in (0, tmax) of each ray (R, 3):
        {"t", "leaf" (-1: none), "slot", "part"}."""
        R = o.shape[0]
        z = torch.zeros(R, dtype=torch.int64, device=o.device)
        best = {"t": tmax.clone(), "leaf": z - 1, "slot": z, "part": z}
        self._plain(o, d, best)
        self._convex(o, d, best)
        self._csg(o, d, best)
        return best

    def search(self, o, d, tmax):
        """nearest() over the rays in blocks that bound the pairs held."""
        widest = max([2 * len(t) for t in self.tables.values()] + [1])
        step = max(16, self.budget // widest)
        parts = [self.nearest(o[a:a + step], d[a:a + step], tmax[a:a + step])
                 for a in range(0, o.shape[0], step)]
        if not parts:
            return self.nearest(o, d, tmax)
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def hit(self, o, d, tmax):
        """The hit record of each ray: t (INF on a miss), hit, pos, norm
        (outward of the object), the ray in the leaf's space, the
        texture stack."""
        b = self.search(o, d, tmax)
        hit = b["leaf"] >= 0
        leaf = b["leaf"].clamp(min=0)
        t = torch.where(hit, b["t"], INF)
        pos = o + torch.where(hit, t, 0.0)[:, None] * d
        norm = torch.zeros_like(o)
        obj_o, obj_d = torch.zeros_like(o), torch.zeros_like(o)
        for kind, tab in self.tables.items():
            sel = torch.nonzero(hit & (self.kind[leaf] == KINDS.index(kind))
                                )[:, 0]
            if sel.numel() == 0:
                continue
            k = self.at[leaf[sel]]
            inv = tab.inv[k]
            oo = torch.einsum("rij,rj->ri", inv[:, :, :3], o[sel]) \
                + inv[:, :, 3]
            do = torch.einsum("rij,rj->ri", inv[:, :, :3], d[sel])
            x = oo + b["t"][sel, None] * do
            n_obj = normal(kind, tab.p[k], x, do, b["part"][sel],
                           b["slot"][sel])
            n = torch.einsum("rji,rj->ri", inv[:, :, :3], n_obj)
            norm[sel] = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
            obj_o[sel], obj_d[sel] = oo, do
        role = self.role[leaf]
        on_b = hit & (role[:, 0] >= 0) & self.neg_clause[
            role[:, 0].clamp(min=0), role[:, 1].clamp(min=0)]
        norm = torch.where(on_b[:, None], -norm, norm)
        stack = self.stack[leaf].clone()
        for cid, csg in self.csgs.items():
            if csg["useatex"]:
                self._retexture(csg, on_b & (role[:, 0] == cid), pos, stack)
        return {"t": t, "hit": hit, "pos": pos, "norm": norm,
                "obj_o": obj_o, "obj_d": obj_d, "stack": stack}

    def _retexture(self, csg, on_b, pos, stack):
        """B's surfaces take the local stack of the first A member that
        holds the point (Csg.hs:39-41)."""
        idx = torch.nonzero(on_b)[:, 0]
        if idx.numel() == 0:
            return
        big = 1 << 62
        first = torch.full((idx.numel(),), big, dtype=torch.int64,
                           device=pos.device)
        for tab in csg["clauses"][0][1]:
            xo = (torch.einsum("lij,rj->rli", tab.inv[:, :, :3], pos[idx])
                  + tab.inv[:, :, 3])
            ins = inside(tab.kind, tab.p, xo)
            cand = torch.where(ins, tab.ids[None, :], big).min(-1).values
            first = torch.minimum(first, cand)
        found = first < big
        stack[idx[found]] = self.local[first[found]]


# --- shading --------------------------------------------------------------

def cafold(acc, c):
    tr = 1.0 - acc[:, 3:4]
    return torch.cat([acc[:, :3] + c[:, :3] * tr * c[:, 3:4],
                      acc[:, 3:4] + c[:, 3:4] * tr], -1)


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-20)


def _spawns(m):
    return m[0] in ("reflect", "refract")


def _materials(texture):
    return ([texture[1]] if texture[0] == "uniform"
            else [texture[1], texture[2]])


class Tracer:
    """The reference's trace of one configuration's scene."""

    def __init__(self, root, lights, maxdepth, device, dtype,
                 store=lambda t: t, background=None):
        self.textures = {}
        self.root = Scene(root, self.textures, device, dtype, store)
        self.frames = {}
        for _tid, tex in list(self.textures.values()):
            for m in _materials(tex):
                if m[0] == "warp" and id(m) not in self.frames:
                    self.frames[id(m)] = Scene(m[1], self.textures, device,
                                               dtype, store)
        self.tex = [None] * len(self.textures)
        for tid, tex in self.textures.values():
            self.tex[tid] = tex
        self.lights = tuple(lights)
        self.maxdepth = maxdepth
        self.background = (None if background is None
                           else torch.tensor((*background, 1.0), dtype=dtype,
                                             device=device))

    def _uses(self, stack, pred):
        ids = [i for i, t in enumerate(self.tex)
               if any(pred(m) for m in _materials(t))]
        if not ids:
            return torch.zeros(stack.shape[0], dtype=torch.bool,
                               device=stack.device)
        ids = torch.tensor(ids, device=stack.device)
        return (stack[:, :, None] == ids).any(-1).any(-1)

    def trace(self, o, d, tmax=None, recurs=None, scene=None, lights=None):
        """(color (N, 4), t (N,)) of rays o, d."""
        recurs = self.maxdepth if recurs is None else recurs
        scene = scene or self.root
        lights = self.lights if lights is None else lights
        N = o.shape[0]
        if tmax is None:
            tmax = torch.full((N,), INF, dtype=o.dtype, device=o.device)
        if recurs == 0 or N == 0:
            return (torch.zeros((N, 4), dtype=o.dtype, device=o.device),
                    torch.full((N,), INF, dtype=o.dtype, device=o.device))
        h = scene.hit(o, d, tmax)
        kids = self._children(h, o, d, recurs, scene, lights) \
            if recurs > 1 else {}
        lit = self._lights(h, scene, lights)
        ctx = {"h": h, "d": d, "lit": lit, "kids": kids, "recurs": recurs}
        acc = torch.zeros((N, 4), dtype=o.dtype, device=o.device)
        cols = {}
        for layer in range(4):
            tids = h["stack"][:, layer]
            has = h["hit"] & (tids >= 0)
            if not bool(has.any()):
                continue
            c = torch.zeros_like(acc)
            for tid in torch.unique(tids[has]).tolist():
                if tid not in cols:
                    cols[tid] = self._texture(self.tex[tid], ctx)
                c = torch.where((tids == tid)[:, None], cols[tid], c)
            opaque = acc[:, 3] + DELTA >= 1.0
            acc = torch.where((has & ~opaque)[:, None], cafold(acc, c), acc)
        if self.background is not None:
            acc = torch.where(h["hit"][:, None], acc, self.background)
        return acc, h["t"]

    def _sub(self, mask, o, d, tmax, recurs, scene, lights):
        """Trace the rays of `mask`; (color, t) scattered back to all."""
        N = mask.shape[0]
        col = torch.zeros((N, 4), dtype=o.dtype, device=o.device)
        t = torch.full((N,), INF, dtype=o.dtype, device=o.device)
        idx = torch.nonzero(mask)[:, 0]
        if idx.numel():
            c, tt = self.trace(o[idx], d[idx],
                               None if tmax is None else tmax[idx],
                               recurs, scene, lights)
            col[idx], t[idx] = c, tt
        return col, t

    def _children(self, h, o, d, recurs, scene, lights):
        kids = {}
        n, pos, hit = h["norm"], h["pos"], h["hit"]
        refl_mask = hit & self._uses(h["stack"], _spawns)
        rdir = d - 2.0 * (d * n).sum(-1, keepdim=True) * n
        kids["reflect"] = self._sub(refl_mask, pos + DELTA * rdir, rdir,
                                    None, recurs - 1, scene, lights)[0]
        for tex in self.tex:
            for m in _materials(tex):
                key = id(m)
                if key in kids or m[0] not in ("refract", "warp"):
                    continue
                act = hit & self._uses(h["stack"], lambda x, m=m: x is m)
                if m[0] == "refract":
                    c1 = (d * n).sum(-1)
                    eta = torch.where(c1 < 0.0, m[3], 1.0 / m[3])
                    cs2 = 1.0 - eta * eta * (1.0 - c1 * c1)
                    tir = cs2 < 0.0
                    k = eta * c1 - torch.sqrt(torch.clamp(cs2, min=0.0))
                    tdir = d * eta[:, None] + n * k[:, None]
                    col, _t = self._sub(act & ~tir, pos + DELTA * tdir, tdir,
                                        None, recurs - 1, scene, lights)
                    black = torch.zeros_like(col)
                    black[:, 3] = 1.0
                    kids[key] = torch.where((act & tir)[:, None], black, col)
                elif m[0] == "warp":
                    fcol, ft = self._sub(act, h["obj_o"], h["obj_d"], None,
                                         recurs - 1, self.frames[key],
                                         lights)
                    w = torch.tensor(m[3][:3], dtype=o.dtype,
                                     device=o.device)
                    wo = pos @ w[:, :3].T + w[:, 3]
                    wd = _unit(_unit(d) @ w[:, :3].T)
                    wcol, wt = self._sub(act, wo, wd, ft, recurs - 1,
                                         self.root, m[2])
                    kids[key] = torch.where((ft < wt)[:, None], fcol, wcol)
        return kids

    def _lights(self, h, scene, lights):
        out = []
        pos, n = h["pos"], h["norm"]
        for li in lights:
            lp = torch.tensor(li.pos, dtype=pos.dtype, device=pos.device)
            lc = torch.tensor(li.color, dtype=pos.dtype, device=pos.device)
            lvec = lp - pos
            llen = torch.linalg.vector_norm(lvec, dim=-1)
            ldir = lvec / torch.clamp(llen, min=1e-20)[:, None]
            act = h["hit"] & ((lvec * n).sum(-1) >= 0.0)
            idx = torch.nonzero(act)[:, 0]
            if idx.numel():
                b = scene.search(pos[idx] + DELTA * n[idx], ldir[idx],
                                 llen[idx] - 2.0 * DELTA)
                act = act.clone()
                act[idx] = b["leaf"] < 0
            fall = 1.0 / torch.clamp(llen * llen, min=1e-20)
            contrib = torch.where(act[:, None], lc * fall[:, None], 0.0)
            out.append((contrib, ldir))
        return out

    def _texture(self, tex, ctx):
        if tex[0] == "uniform":
            return self._material(tex[1], ctx)
        w = tex[3](ctx["h"]["pos"])[:, None]
        return (self._material(tex[1], ctx) * w
                + self._material(tex[2], ctx) * (1.0 - w))

    def _material(self, m, ctx):
        h = ctx["h"]
        N = h["t"].shape[0]
        dev, dt = h["pos"].device, h["pos"].dtype
        if m[0] == "surface":
            _, color, alpha, amb, kd, ks, shine = m
            col = torch.tensor(color, dtype=dt, device=dev)
            eye = -ctx["d"]
            n = h["norm"]
            direct = torch.zeros((N, 3), dtype=dt, device=dev)
            for contrib, ldir in ctx["lit"]:
                ln = (ldir * n).sum(-1)
                spec = torch.zeros_like(ln)
                if ks > DELTA:
                    hb = (_unit(ldir + eye) * n).sum(-1)
                    spec = torch.where(hb > 0.0,
                                       torch.clamp(hb, min=1e-30) ** shine
                                       * torch.clamp(ln, min=0.0), 0.0)
                direct = direct + contrib * (spec * ks + ln * kd)[:, None]
            rgb = col * amb + direct
            return torch.cat([rgb, torch.full((N, 1), alpha, dtype=dt,
                                              device=dev)], -1)
        if m[0] == "reflect":
            if m[1] <= 0:
                out = torch.zeros((N, 4), dtype=dt, device=dev)
                out[:, 3] = 1.0
                return out
            c = ctx["kids"].get("reflect")
            if c is None:
                return torch.zeros((N, 4), dtype=dt, device=dev)
            return torch.cat([c[:, :3], c[:, 3:] * m[1]], -1)
        if m[0] == "refract":
            if ctx["recurs"] > 1 and (m[1] > 0 or m[2] > 0):
                return ctx["kids"]["reflect"] * m[1] + ctx["kids"][id(m)] \
                    * m[2]
            return torch.zeros((N, 4), dtype=dt, device=dev)
        if m[0] == "warp":
            if ctx["recurs"] > 1:
                return ctx["kids"][id(m)]
            return torch.zeros((N, 4), dtype=dt, device=dev)
        raise TypeError(m[0])
