"""Acceleration structures: host-side cost-based BVH builds.

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

build_bvh runs the C++ builder of native/ by default; its numpy builder
(native=False) is the plain version, and the two emit bit-equal tables
(tests/test_torch_native.py).  build_bvh2 is numpy.
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
              leaf_max: int = LEAF_MAX, native: bool = True) -> BvhFlat:
    """Cost-based build with the reference's candidate-split search
    (Bih.hs:211-285), emitted as a flattened skip-link array tree.

    native (the default): the C++ builder (native/bvh_builder.cpp), which
    raises RuntimeError where it cannot be built or run.  native=False:
    this numpy builder, its plain version; the two give bit-equal tables
    on float64 boxes (tests/test_torch_native.py)."""
    if native:
        from .native import build_bvh_native
        nb_min, nb_max, ls, lc, sk, order = build_bvh_native(bmin, bmax,
                                                             leaf_max)
        return BvhFlat(bmin=nb_min, bmax=nb_max, leaf_start=ls,
                       leaf_count=lc, skip=sk, order=order)
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
    counts the root as 1.

    Nodes are numbered as a near-first walk makes them: the root 0, then
    the two children of the k-th internal node in preorder 1 + 2k and
    2 + 2k.  The skip-link table lists its nodes in preorder, and a
    chain-free tree maps node for node, so the conversion is whole-array
    work; only the links of chains, rare and short, go through Python."""
    if bvh.n_nodes == 0:
        raise ValueError("an empty group has no tree to convert")
    lo = np.asarray(bvh.bmin, np.float32)
    hi = np.asarray(bvh.bmax, np.float32)
    skip = np.asarray(bvh.skip, np.int64)
    start = np.asarray(bvh.leaf_start, np.int64)
    count = np.asarray(bvh.leaf_count, np.int64)
    M = len(skip)
    link = (count > 0) & (skip != np.arange(M) + 1)
    # the output tree in preorder: elements (kind, first input node, last
    # input node): NODE n, an input node that is no link; LINK c, a
    # link's own rows; SPAN a..b, the subtree over the chain items a..b
    # (links, then the node that ends the chain), which for a whole chain
    # stands for its first link.  The links of each chain are replaced by
    # its subtree in preorder, less its last item, the chain's end node,
    # which keeps its own place.
    NODE, LINK, SPAN = 0, 1, 2
    heads = np.nonzero(link & ~np.concatenate([[False], link[:-1]]))[0]
    kind_parts, a_parts, b_parts = [], [], []
    edges = []        # (parent element, child element, side) in chains
    span_of = {}      # chain head -> the element of its whole-chain SPAN
    prev = n_elems = 0

    def nodes(lo_n, hi_n):
        nonlocal n_elems
        kind_parts.append(np.full(hi_n - lo_n, NODE))
        a_parts.append(np.arange(lo_n, hi_n))
        b_parts.append(np.arange(lo_n, hi_n))
        n_elems += hi_n - lo_n

    for c0 in heads.tolist():
        end = c0
        while link[end]:
            end += 1
        nodes(prev, c0)
        # the balanced subtree over items c0..end, in preorder; items[i]
        # is input node c0 + i, the last one the chain's end node
        toks, work = [], [(c0, end, None, 0)]
        while work:
            ia, ib, parent, side = work.pop()
            me = n_elems + len(toks)
            if ia == ib:
                toks.append((NODE if ia == end else LINK, ia, ia))
            else:
                toks.append((SPAN, ia, ib))
                h = (ib - ia + 1) // 2
                work.append((ia + h, ib, me, 1))
                work.append((ia, ia + h - 1, me, 0))
            if parent is not None:
                edges.append((parent, me, side))
        # the end node, last in preorder, keeps its place: the element
        # numbered for it is the first of the next run of nodes
        span_of[c0] = n_elems
        kind_parts.append(np.array([k for k, _a, _b in toks[:-1]]))
        a_parts.append(np.array([x for _k, x, _b in toks[:-1]]))
        b_parts.append(np.array([x for _k, _a, x in toks[:-1]]))
        n_elems += len(toks) - 1
        prev = end
    nodes(prev, M)
    kind = np.concatenate(kind_parts).astype(np.int64)
    ea = np.concatenate(a_parts).astype(np.int64)
    eb = np.concatenate(b_parts).astype(np.int64)
    n_out = len(kind)
    # each input node's element: its NODE element, for a chain head its
    # whole-chain SPAN
    is_node = kind == NODE
    rep = np.zeros(M, np.int64)
    rep[ea[is_node]] = np.nonzero(is_node)[0]
    for c0, e in span_of.items():
        rep[c0] = e
    inner_elem = (is_node & (count[ea] == 0)) | (kind == SPAN)
    k = np.cumsum(inner_elem) - inner_elem
    par, child, side = [], [], []
    inner_in = np.nonzero(~link & (count == 0))[0]
    par.append(rep[inner_in])
    child.append(rep[inner_in + 1])
    side.append(np.zeros(len(inner_in), np.int64))
    par.append(rep[inner_in])
    child.append(rep[skip[inner_in + 1]])
    side.append(np.ones(len(inner_in), np.int64))
    if edges:
        e = np.asarray(edges, np.int64)
        par.append(e[:, 0])
        child.append(e[:, 1])
        side.append(e[:, 2])
    par, child, side = (np.concatenate(x) for x in (par, child, side))
    out_id = np.zeros(n_out, np.int64)
    out_id[child] = 1 + 2 * k[par] + side
    left = np.full(n_out, -1, np.int64)
    right = np.full(n_out, -1, np.int64)
    left[out_id[par[side == 0]]] = out_id[child[side == 0]]
    right[out_id[par[side == 1]]] = out_id[child[side == 1]]
    # boxes: a node's or a link's own; a span's the least box over its
    # items (for a whole chain its first link's, which bounds the rest)
    nb_min = np.empty((n_out, 3), np.float32)
    nb_max = np.empty((n_out, 3), np.float32)
    nb_min[out_id] = lo[ea]
    nb_max[out_id] = hi[ea]
    for i in np.nonzero(kind == SPAN)[0]:
        nb_min[out_id[i]] = lo[ea[i]:eb[i] + 1].min(axis=0)
        nb_max[out_id[i]] = hi[ea[i]:eb[i] + 1].max(axis=0)
    leaf = ~inner_elem
    first = np.full(n_out, -1, np.int64)
    rows = np.zeros(n_out, np.int64)
    first[out_id[leaf]] = start[ea[leaf]]
    rows[out_id[leaf]] = count[ea[leaf]]
    # levels, root 1: one whole-array step per level
    level = np.ones(n_out, np.int64)
    frontier = np.zeros(1 if left[0] >= 0 else 0, np.int64)
    while len(frontier):
        kids = np.concatenate([left[frontier], right[frontier]])
        level[kids] = np.concatenate([level[frontier]] * 2) + 1
        frontier = kids[left[kids] >= 0]
    return Bvh2(bmin=nb_min, bmax=nb_max, left=left.astype(np.int32),
                right=right.astype(np.int32),
                leaf_start=first.astype(np.int32),
                leaf_count=rows.astype(np.int32),
                order=np.asarray(bvh.order, np.int32),
                depth=int(level.max()))


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
