"""Acceleration structures: host-side cost-based BVH builds (numpy).

The reference builds a BIH with a 4-way candidate-split cost search
(Bih.hs:211-285: midpoint splits on x/y/z plus a big/small-object
split, surface-area x count costs weighted 1.1/1.2, leaves at <= 3
objects) and traverses it with recursive interval narrowing
(Bih.hs:332-368).  Two flat layouts are built here, both with the same
candidate-split cost heuristic and full AABBs per node (like the
reference's Mesh BVH, Mesh.hs:69-113):

  - build_bvh2: a strictly binary tree for the near-child-first
    per-ray stack walk of the megakernel's 'bvh2' phases;
  - build_bvh: DFS order with *skip links* (on a box miss jump to
    node.skip, on a hit fall through to node+1), used for the
    stackless point queries over big CSG member sets and as K5's group
    tree (compile.group_accel).

node_records lays a binary tree out as the child-pair records the CUDA
near-first walks read (K1, K2, K3, K5; csrc/bvh_walk.cuh): a build_bvh2
tree, or for K5 a build_bvh tree made binary by skip_link_pairs.

The builders are pure numpy; glome_tpu's C++ builder
(glome_tpu/native/bvh_builder.cpp) emits identical tables on the
scenes the tests cover (tests/test_torch_host.py compares the plans).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .config import DELTA, INFINITY

LEAF_MAX = 4
# floats per child-pair record (NODE_W in csrc/bvh_walk.cuh): both
# children's boxes, then their references
NODE_W = 16
# a leaf reference packs (first row << LEAF_BITS) | row count
LEAF_BITS = 5
COST_SPLIT = 1.1
COST_BIG = 1.2
BIG_SA_FRAC = 0.4


@dataclasses.dataclass
class BvhFlat:
    """Flattened skip-link BVH over one prim group."""
    bmin: np.ndarray        # (M, 3) float32
    bmax: np.ndarray        # (M, 3)
    leaf_start: np.ndarray  # (M,) int32 index into order, -1 for inner
    leaf_count: np.ndarray  # (M,) int32, 0 for inner nodes
    skip: np.ndarray        # (M,) int32 next-node-on-miss (M = end)
    order: np.ndarray       # (P,) int32 prim local indices in leaf order

    @property
    def n_nodes(self):
        return int(self.bmin.shape[0])


def group_bounds(g, delta=DELTA) -> Tuple[np.ndarray, np.ndarray]:
    """Per-prim world AABBs for a PrimGroup (host, float64).

    Mirrors the reference `bound` methods: sphere Sphere.hs:78-81, box
    Box.hs:70-71, triangle Triangle.hs:147-158 (delta padded), disc
    Cone.hs:93-95, cylinder/cone Cone.hs:145-147,253-255; transformed
    groups bound the 8 transformed corners (Solid.hs:477-484)."""
    p = {k: np.asarray(v, dtype=np.float64) for k, v in g.params.items()}
    t = g.ptype
    if t == "sphere":
        c, r = p["center"], p["radius"][:, None]
        bmin, bmax = c - r, c + r
    elif t == "box":
        bmin, bmax = p["bmin"], p["bmax"]
    elif t in ("triangle", "trianglenorm"):
        pts = np.stack([p["p1"], p["p2"], p["p3"]], axis=1)
        bmin = pts.min(axis=1) - delta
        bmax = pts.max(axis=1) + delta
    elif t == "disc":
        r = np.sqrt(p["rsqr"])[:, None]
        bmin, bmax = p["pos"] - r, p["pos"] + r
    elif t == "cylinder":
        r = p["radius"]
        bmin = np.stack([-r, -r, p["h1"]], axis=-1)
        bmax = np.stack([r, r, p["h2"]], axis=-1)
    elif t == "cone":
        r = p["radius"]
        bmin = np.stack([-r, -r, p["clip1"]], axis=-1)
        bmax = np.stack([r, r, p["clip2"]], axis=-1)
    elif t == "plane":
        n = p["norm"].shape[0]
        return (np.full((n, 3), -INFINITY), np.full((n, 3), INFINITY))
    else:
        raise ValueError(t)
    if g.m_fwd is not None:
        # bound the 8 transformed corners of the object-space box
        corners = np.stack([
            np.stack([bmin[:, 0] if i & 1 else bmax[:, 0],
                      bmin[:, 1] if i & 2 else bmax[:, 1],
                      bmin[:, 2] if i & 4 else bmax[:, 2]], axis=-1)
            for i in range(8)], axis=1)  # (P, 8, 3)
        fwd = np.asarray(g.m_fwd, dtype=np.float64)
        w = np.einsum('pij,pcj->pci', fwd[:, :, :3], corners) + fwd[:, None, :, 3]
        bmin = w.min(axis=1) - delta
        bmax = w.max(axis=1) + delta
    return bmin, bmax


def _bbsa(bmin, bmax):
    d = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2]
                  + d[..., 1] * d[..., 2])


@dataclasses.dataclass
class Bvh2:
    """Binary BVH for ORDERED (near-child-first) traversal: inner nodes
    store both children, leaves a contiguous [leaf_start, +count) range
    of `order`.  The reference's recursive interval narrowing
    (Bih.hs:332-368, Mesh.hs:172-196) visits the nearer child first and
    shrinks the far child's interval by the best hit; a skip-link walk
    cannot reorder, so per-tile stack traversal of this layout is the
    TPU analog."""
    bmin: np.ndarray        # (M, 3) float32
    bmax: np.ndarray        # (M, 3)
    left: np.ndarray        # (M,) int32, -1 for leaves
    right: np.ndarray       # (M,) int32
    leaf_start: np.ndarray  # (M,) int32 index into order
    leaf_count: np.ndarray  # (M,) int32, 0 for inner nodes
    order: np.ndarray       # (P,) int32 prim indices in leaf order
    depth: int              # max tree depth (stack bound)

    @property
    def n_nodes(self):
        return int(self.bmin.shape[0])


def build_bvh2(bmin: np.ndarray, bmax: np.ndarray,
               leaf_max: int = LEAF_MAX) -> Bvh2:
    """Strictly binary cost-based build (same candidate-split search as
    build_bvh, Bih.hs:211-285); oversized cost-leaves are forced apart
    by a median split so every leaf holds <= leaf_max prims."""
    P = bmin.shape[0]
    mids = (bmin + bmax) * 0.5
    sa = _bbsa(bmin, bmax)

    nb_min: List[np.ndarray] = []
    nb_max: List[np.ndarray] = []
    nleft: List[int] = []
    nright: List[int] = []
    nls: List[int] = []
    nlc: List[int] = []
    order: List[int] = []
    maxdepth = [0]

    def emit(idx: np.ndarray, depth: int) -> int:
        me = len(nleft)
        maxdepth[0] = max(maxdepth[0], depth)
        nb_min.append(bmin[idx].min(axis=0))
        nb_max.append(bmax[idx].max(axis=0))
        nleft.append(-1)
        nright.append(-1)
        nls.append(-1)
        nlc.append(0)
        n = len(idx)
        if n <= leaf_max:
            nls[me] = len(order)
            nlc[me] = n
            order.extend(idx.tolist())
            return me
        node_sa = max(_bbsa(nb_min[me][None], nb_max[me][None])[0], 1e-30)
        best_cost = node_sa * n if n <= 3 else np.inf
        l = r = None
        for axis in range(3):
            c = (nb_min[me][axis] + nb_max[me][axis]) * 0.5
            sel = mids[idx, axis] < c
            li, ri = idx[sel], idx[~sel]
            if len(li) == 0 or len(ri) == 0:
                continue
            cost = (_bbsa(bmin[li].min(0)[None], bmax[li].max(0)[None])[0]
                    * len(li)
                    + _bbsa(bmin[ri].min(0)[None], bmax[ri].max(0)[None])[0]
                    * len(ri)) * COST_SPLIT
            if cost < best_cost:
                best_cost, l, r = cost, li, ri
        sel = sa[idx] > node_sa * BIG_SA_FRAC
        li, ri = idx[sel], idx[~sel]
        if len(li) and len(ri):
            cost = (_bbsa(bmin[li].min(0)[None], bmax[li].max(0)[None])[0]
                    * len(li)
                    + _bbsa(bmin[ri].min(0)[None], bmax[ri].max(0)[None])[0]
                    * len(ri)) * COST_BIG
            if cost < best_cost:
                best_cost, l, r = cost, li, ri
        if l is None:
            # forced median split on the longest axis keeps the tree
            # binary when the cost search degenerates
            axis = int(np.argmax(nb_max[me] - nb_min[me]))
            ordax = np.argsort(mids[idx, axis], kind="stable")
            h = n // 2
            l, r = idx[ordax[:h]], idx[ordax[h:]]
        nleft[me] = emit(l, depth + 1)
        nright[me] = emit(r, depth + 1)
        return me

    if P:
        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 100000))
        emit(np.arange(P), 1)
        sys.setrecursionlimit(old)

    M = max(len(nleft), 1)
    if not nleft:  # empty group: one empty leaf
        return Bvh2(bmin=np.zeros((1, 3), np.float32),
                    bmax=np.zeros((1, 3), np.float32),
                    left=np.full(1, -1, np.int32),
                    right=np.full(1, -1, np.int32),
                    leaf_start=np.zeros(1, np.int32),
                    leaf_count=np.zeros(1, np.int32),
                    order=np.zeros(0, np.int32), depth=1)
    return Bvh2(
        bmin=np.asarray(nb_min, np.float32).reshape(M, 3),
        bmax=np.asarray(nb_max, np.float32).reshape(M, 3),
        left=np.asarray(nleft, np.int32),
        right=np.asarray(nright, np.int32),
        leaf_start=np.asarray(nls, np.int32),
        leaf_count=np.asarray(nlc, np.int32),
        order=np.asarray(order, np.int32),
        depth=maxdepth[0])


def build_bvh(bmin: np.ndarray, bmax: np.ndarray,
              leaf_max: int = LEAF_MAX) -> BvhFlat:
    """Cost-based build with the reference's candidate-split search
    (Bih.hs:211-285), emitted as a flattened skip-link array tree."""
    P = bmin.shape[0]
    mids = (bmin + bmax) * 0.5
    sa = _bbsa(bmin, bmax)

    nodes_bmin: List[np.ndarray] = []
    nodes_bmax: List[np.ndarray] = []
    nodes_ls: List[int] = []
    nodes_lc: List[int] = []
    nodes_skip: List[int] = []
    order: List[int] = []

    def emit(idx: np.ndarray):
        """Append the subtree over prim indices `idx`; returns nothing.
        Skip links are patched after each subtree completes."""
        me = len(nodes_ls)
        nb_min = bmin[idx].min(axis=0)
        nb_max = bmax[idx].max(axis=0)
        nodes_bmin.append(nb_min)
        nodes_bmax.append(nb_max)
        nodes_ls.append(-1)
        nodes_lc.append(0)
        nodes_skip.append(-1)

        n = len(idx)
        make_leaf = n <= 3
        l = r = None
        if not make_leaf:
            node_sa = max(_bbsa(nb_min[None], nb_max[None])[0], 1e-30)
            best_cost = node_sa * n  # cost of keeping a leaf
            for axis in range(3):
                c = (nb_min[axis] + nb_max[axis]) * 0.5
                sel = mids[idx, axis] < c
                li, ri = idx[sel], idx[~sel]
                if len(li) == 0 or len(ri) == 0:
                    continue
                cost = (_bbsa(bmin[li].min(0)[None], bmax[li].max(0)[None])[0] * len(li)
                        + _bbsa(bmin[ri].min(0)[None], bmax[ri].max(0)[None])[0] * len(ri)
                        ) * COST_SPLIT
                if cost < best_cost:
                    best_cost, l, r = cost, li, ri
            sel = sa[idx] > node_sa * BIG_SA_FRAC
            li, ri = idx[sel], idx[~sel]
            if len(li) and len(ri):
                cost = (_bbsa(bmin[li].min(0)[None], bmax[li].max(0)[None])[0] * len(li)
                        + _bbsa(bmin[ri].min(0)[None], bmax[ri].max(0)[None])[0] * len(ri)
                        ) * COST_BIG
                if cost < best_cost:
                    best_cost, l, r = cost, li, ri
            if l is None:
                make_leaf = True

        if make_leaf:
            # split oversized leaves into chains of <= leaf_max
            nodes_ls[me] = len(order)
            nodes_lc[me] = min(n, leaf_max)
            order.extend(idx[:leaf_max].tolist())
            rest = idx[leaf_max:]
            if len(rest):
                emit(rest)
        else:
            emit(l)
            emit(r)
        nodes_skip[me] = len(nodes_ls)  # patched to "next after subtree"

    if P:
        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 100000))
        emit(np.arange(P))
        sys.setrecursionlimit(old)

    M = len(nodes_ls)
    return BvhFlat(
        bmin=np.asarray(nodes_bmin, dtype=np.float32).reshape(M, 3),
        bmax=np.asarray(nodes_bmax, dtype=np.float32).reshape(M, 3),
        leaf_start=np.asarray(nodes_ls, dtype=np.int32),
        leaf_count=np.asarray(nodes_lc, dtype=np.int32),
        skip=np.asarray(nodes_skip, dtype=np.int32),
        order=np.asarray(order, dtype=np.int32),
    )


def skip_link_pairs(bvh: BvhFlat) -> Bvh2:
    """The skip-link tree `bvh` (build_bvh) as a strictly binary tree over
    the same rows in the same leaf order, for node_records (K5's
    child-pair records): an internal node n has the children n + 1 and
    skip[n + 1], each leaf keeps its box and its row range.

    A chain -- a leaf node that build_bvh could not split and that goes
    on at n + 1 with the rest of its rows, so it is both a leaf and a
    parent -- becomes a balanced subtree over its links: each link's own
    rows as a leaf with the link's box (a superset: it bounds the rest of
    the chain too), and the node that ends the chain.  Its depth grows
    with the log of the chain's length, where a node-by-node conversion
    would be as deep as the chain is long.  Node 0 is the root; `depth`
    counts the root as 1."""
    if bvh.n_nodes == 0:
        raise ValueError("an empty group has no tree to convert")
    lo = np.asarray(bvh.bmin, np.float32)
    hi = np.asarray(bvh.bmax, np.float32)
    skip = np.asarray(bvh.skip, np.int64)
    start = np.asarray(bvh.leaf_start, np.int64)
    count = np.asarray(bvh.leaf_count, np.int64)
    nb_min, nb_max, left, right, first, rows = [], [], [], [], [], []

    def new(items):
        """A node for the items, (link, n): the rows of the chain link n
        alone, or (node, n): the subtree at n; its box bounds them all."""
        ns = [n for _kind, n in items]
        nb_min.append(lo[ns].min(axis=0))
        nb_max.append(hi[ns].max(axis=0))
        for a in (left, right, first):
            a.append(-1)
        rows.append(0)
        return len(rows) - 1

    LINK, NODE = 0, 1
    work = [(new([(NODE, 0)]), [(NODE, 0)], 1)]
    depth = 1
    while work:
        me, items, level = work.pop()
        depth = max(depth, level)
        if len(items) == 1:
            kind, n = items[0]
            if kind == LINK or (count[n] > 0 and skip[n] == n + 1):
                first[me], rows[me] = int(start[n]), int(count[n])
                continue
            if count[n] == 0:
                items = [(NODE, n + 1), (NODE, int(skip[n + 1]))]
            else:
                # a chain: its links, then the node that ends it
                items, c = [], n
                while count[c] > 0 and skip[c] != c + 1:
                    items.append((LINK, c))
                    c += 1
                items.append((NODE, c))
        h = len(items) // 2
        left[me], right[me] = new(items[:h]), new(items[h:])
        work.append((right[me], items[h:], level + 1))
        work.append((left[me], items[:h], level + 1))
    n_out = len(rows)
    return Bvh2(bmin=np.asarray(nb_min, np.float32).reshape(n_out, 3),
                bmax=np.asarray(nb_max, np.float32).reshape(n_out, 3),
                left=np.asarray(left, np.int32),
                right=np.asarray(right, np.int32),
                leaf_start=np.asarray(first, np.int32),
                leaf_count=np.asarray(rows, np.int32),
                order=np.asarray(bvh.order, np.int32), depth=depth)


def node_records(bmin: np.ndarray, bmax: np.ndarray, left: np.ndarray,
                 right: np.ndarray, leaf_first: np.ndarray,
                 leaf_count: np.ndarray) -> np.ndarray:
    """A strictly binary tree (node 0 the root; per node its box, its
    children `left` / `right`, and for a leaf, leaf_count > 0, the rows
    [leaf_first, leaf_first + leaf_count) of the table the walk tests) as
    the (1 + n_inner, NODE_W) float32 child-pair records that the CUDA
    near-first walks read, one 64-byte record per step.  Record 0 holds
    the root's box in the left slot and the root's reference at float 12;
    then each internal node, in node order, gets one record: the left and
    the right child's boxes (bmin xyz, bmax xyz each, floats 0-11) and
    their references (floats 12 and 13, int32 bits).  A reference r > 0 is
    the record of an internal node, r < 0 a leaf with ~r = leaf_first <<
    LEAF_BITS | leaf_count."""
    box = np.concatenate([np.asarray(bmin, np.float32),
                          np.asarray(bmax, np.float32)], axis=1)
    left, right = np.asarray(left), np.asarray(right)
    first = np.asarray(leaf_first, np.int64)
    count = np.asarray(leaf_count, np.int64)
    leaf = count > 0
    if (np.any(count[leaf] >= 1 << LEAF_BITS)
            or np.any(first[leaf] >= 1 << (31 - LEAF_BITS))):
        raise ValueError("a leaf too big for a packed reference")
    inner = np.nonzero(~leaf)[0]
    rec_of = np.zeros(len(box), np.int64)
    rec_of[inner] = 1 + np.arange(len(inner))
    ref = np.where(leaf, ~((first << LEAF_BITS) | count),
                   rec_of).astype(np.int32)
    recs = np.zeros((1 + len(inner), NODE_W), np.float32)
    words = recs.view(np.int32)
    recs[0, 0:6] = box[0]
    words[0, 12] = ref[0]
    recs[1:, 0:6] = box[left[inner]]
    recs[1:, 6:12] = box[right[inner]]
    words[1:, 12] = ref[left[inner]]
    words[1:, 13] = ref[right[inner]]
    return recs
