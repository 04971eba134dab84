"""The pass-per-group route of the port (intersect.GROUPS) against
glome_tpu's, on the CPU.

  - the lazy group BVH (compile.group_accel) against the g.accel
    glome_tpu's compiler attaches, and the groups that get one;
  - K4 / K5's plain versions (group_kernels.dense_select_plain /
    bvh_select_plain, what CPU tensors run) against glome_tpu's Pallas
    dense_intersect / bvh_intersect in interpret mode;
  - K4's cull table (group_kernels.cull_aabbs) against the plain
    version's candidates: no box culls a candidate;
  - K2's block trees of block_scene as the child-pair records that K1,
    K2 and K3 share (accel.node_records);
  - K5's records: each group's skip-link tree converted to a binary tree
    (accel.skip_link_pairs) keeps its leaves, rows and boxes, a chain of
    unsplittable leaves becomes a shallow subtree, and the kernel's leaf
    rule (the least (t, row)) on a walk of the records, emulated here,
    gives bvh_select_plain's winner on exact ties;
  - TestScene 90x60 depth 3 through WavefrontTracer(route=GROUPS)
    against glome_tpu's CPU golden of the frame.

Tolerances (ROADMAP Queue 3): hit / blocked agree on >= 99.9% of lanes;
t within rtol 5e-5 / atol 1e-4 on >= 99.9% of lanes (see RTOL); a
winner may differ from glome_tpu's only where the two t tie to that
tolerance.  In shadow mode only "blocked" is compared: the TPU kernels
stop at some blocker, not the nearest.  tests/test_torch_group_route.py
holds the whole pipeline against glome_tpu's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu import pallas_kernels as PK
from glome_tpu.scenes import test_scene as jax_test_scene
from glome_tpu_torch import accel as A
from glome_tpu_torch import block_kernel as BK
from glome_tpu_torch import group_kernels as GK
from glome_tpu_torch.intersect import (GROUPS, bvh_args, dense_args,
                                       intersect_multi_table)
from glome_tpu_torch import kernels
from glome_tpu_torch import megakernel as TMK
from glome_tpu_torch.compile import group_accel, materialize_scene_params
from glome_tpu_torch.io import quantize, read_png
from glome_tpu_torch.megakernel import _field_width
from glome_tpu_torch.render import pixel_coords, primary_rays
from glome_tpu_torch.scenes import test_scene as torch_test_scene
from glome_tpu_torch.scenes.phasescene import (block_rays, block_scene,
                                               coincident_scene,
                                               phase_kinds_lights,
                                               phase_kinds_rays,
                                               phase_kinds_scene,
                                               sphere_cloud_scene,
                                               tie_grid_rays, tie_grid_scene)
from test_torch_mega import walk_pair_records
from test_torch_mesh import block_tree_rows

INF = T.INFINITY
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "testscene_90x60_cpu.png")
BVH_TABLES = ("bmin", "bmax", "skip", "leaf_start", "leaf_count", "order")
# t tolerance of the kernel comparisons.  Grazing hits are ill-conditioned
# in float32: on such lanes the Pallas interpreter's arithmetic (XLA's
# CPU code; rsqrt for transformed rows, pallas_kernels.py:470) and the
# port's land up to ~3e-5 of t apart (2 of 512 lanes on the thin cones
# and on the constrained spheres), with the same winner, so t is held at
# K1's rtol 5e-5 / atol 1e-4 (ROADMAP Queue 3) rather than 1e-5.
RTOL, ATOL = 5e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def testscene_pair():
    sj, lj, _ = jax_test_scene()
    st, lt, cam = torch_test_scene()
    return G.compile_scene(sj, lj), T.compile_scene(st, lt), cam


def _jnp(arrays):
    return jax.tree.map(jnp.asarray, arrays)


# --- the group BVH -----------------------------------------------------------

def test_group_bvh_matches_glome_tpu(testscene_pair):
    cj, ct, _cam = testscene_pair
    trees = 0
    for gj, gt in zip(cj.scenes[0].groups, ct.scenes[0].groups):
        assert gt.accel_eligible == (gj.accel is not None)
        if gj.accel is None:
            assert group_accel(gt) is None
            continue
        trees += 1
        bvh = group_accel(gt)
        assert group_accel(gt) is bvh                       # cached
        for k in BVH_TABLES:
            np.testing.assert_array_equal(getattr(bvh, k),
                                          getattr(gj.accel, k), err_msg=k)
    assert trees == 2          # the two lattice groups (2,786 and 2,816)


@pytest.mark.parametrize("accel_min_size", [16, 100])
def test_accel_min_size_picks_the_same_groups(accel_min_size):
    cj = G.compile_scene(phase_kinds_scene(G), phase_kinds_lights(G),
                         accel_min_size=accel_min_size)
    ct = T.compile_scene(phase_kinds_scene(T), phase_kinds_lights(T),
                         accel_min_size=accel_min_size)
    picked = [g.accel is not None for g in cj.scenes[0].groups]
    assert any(picked)
    assert [g.accel_eligible for g in ct.scenes[0].groups] == picked


def test_megakernel_route_builds_no_group_tree():
    st, lt, _cam = torch_test_scene()
    ct = T.compile_scene(st, lt)
    o, d = phase_kinds_rays(64)
    TMK.mega_intersect(ct, T.to_torch(ct.arrays(), "cpu"),
                       torch.as_tensor(o), torch.as_tensor(d))
    assert any(g.accel_eligible for g in ct.scenes[0].groups)
    assert not any("_accel" in g.__dict__ for sc in ct.scenes
                   for g in sc.groups)


@pytest.mark.parametrize("kind", ["spheres", "difference", "transformed"])
def test_block_scene_trees_as_child_pair_records(kind):
    """K2's binary block trees over phasescene.block_scene's groups (700
    spheres, their difference with a sphere, 300 rotated boxes), laid
    out as the child-pair records K1, K2 and K3 share: every child box
    and leaf range given back, each leaf the BP rows of its block of the
    unpermuted table, every node reached once."""
    ct = T.compile_scene(block_scene(kind), phase_kinds_lights())
    sc = ct.scenes[0]
    n_trees = 0
    for g in sc.groups:
        if g.size < 64 or g.ptype == "plane":
            continue
        plan = BK.get_block_plan(g, sc)
        reached, depth = walk_pair_records(
            plan.nodes.reshape(-1, TMK.NODE_W), *block_tree_rows(plan))
        assert (reached, depth) == (plan.n_nodes, plan.depth)
        assert plan.n_blocks > 1 and (plan.transformed
                                      == (kind == "transformed"))
        n_trees += 1
    assert n_trees >= 1


# --- K5's child-pair records of the skip-link trees -------------------------

def _k5_group(testscene_pair, case):
    """(compiled scene, group index in its scene 0) of a K5 case: TestScene's
    lattice groups ("lattice0", "lattice1"), block_scene's 700 spheres,
    the 20,000-sphere cloud, the 1,000 coincident spheres or the tie
    grid's 512 triangles."""
    if case.startswith("lattice"):
        ct = testscene_pair[1]
        groups = [gi for gi, g in enumerate(ct.scenes[0].groups)
                  if g.accel_eligible]
        assert len(groups) == 2
        return ct, groups[int(case[-1])]
    solid = {"block_scene": lambda: block_scene("spheres"),
             "sphere_cloud": sphere_cloud_scene,
             "coincident": coincident_scene,
             "tie_grid": tie_grid_scene}[case]()
    cc = T.compile_scene(solid, phase_kinds_lights(), accel_min_size=64)
    return cc, 0


def _chain_links(bvh):
    """Nodes of a skip-link tree that are both a leaf and a parent."""
    return int(((bvh.leaf_count > 0)
                & (bvh.skip != np.arange(bvh.n_nodes) + 1)).sum())


def _assert_pairs_keep_the_tree(bvh, pairs, bmin, bmax):
    """skip_link_pairs' tree against the skip-link tree it came from (and
    the group's prim bounds bmin / bmax in local order): its records
    walk back every node, box and leaf range; its leaves are the
    skip-link leaves, the same rows in leaf order; every leaf box holds
    its rows' bounds and every inner box its children's boxes."""
    recs = A.node_records(pairs.bmin, pairs.bmax, pairs.left, pairs.right,
                          pairs.leaf_start, pairs.leaf_count)
    box = np.concatenate([pairs.bmin, pairs.bmax], axis=1)
    reached, depth = walk_pair_records(recs, box, pairs.left, pairs.right,
                                       pairs.leaf_start, pairs.leaf_count)
    assert (reached, depth) == (pairs.n_nodes, pairs.depth)
    np.testing.assert_array_equal(pairs.order, bvh.order)
    leaf = pairs.leaf_count > 0
    got = sorted(zip(pairs.leaf_start[leaf].tolist(),
                     pairs.leaf_count[leaf].tolist()))
    sl = bvh.leaf_count > 0
    want = list(zip(bvh.leaf_start[sl].tolist(), bvh.leaf_count[sl].tolist()))
    assert got == want
    starts, counts = np.asarray(got).T
    np.testing.assert_array_equal(starts, np.cumsum(counts) - counts)
    assert counts.sum() == len(bvh.order)
    assert counts.max() <= A.LEAF_MAX
    order = np.asarray(bvh.order)
    lo = bmin[order].astype(np.float32)
    hi = bmax[order].astype(np.float32)
    for n in range(pairs.n_nodes):
        if leaf[n]:
            rows = slice(pairs.leaf_start[n],
                         pairs.leaf_start[n] + pairs.leaf_count[n])
            assert (pairs.bmin[n] <= lo[rows]).all()
            assert (pairs.bmax[n] >= hi[rows]).all()
        else:
            kids = [pairs.left[n], pairs.right[n]]
            assert (pairs.bmin[n] <= pairs.bmin[kids]).all()
            assert (pairs.bmax[n] >= pairs.bmax[kids]).all()


@pytest.mark.parametrize("case", ["lattice0", "lattice1", "block_scene",
                                  "sphere_cloud"])
def test_skip_link_trees_as_child_pair_records(testscene_pair, case):
    """Trees without a chain convert node for node (TestScene's lattice
    groups: 2,345 and 2,543 nodes, depth 13 and 19), keeping every leaf,
    row and box."""
    cc, gi = _k5_group(testscene_pair, case)
    g = cc.scenes[0].groups[gi]
    bvh = group_accel(g)
    pairs = A.skip_link_pairs(bvh)
    assert _chain_links(bvh) == 0
    assert pairs.n_nodes == bvh.n_nodes
    _assert_pairs_keep_the_tree(bvh, pairs, *A.group_bounds(g))
    if case.startswith("lattice"):
        assert (pairs.n_nodes, pairs.depth) in ((2345, 13), (2543, 19))
    kernels.walk_stack(pairs.depth)


def test_coincident_chain_converts_shallow(testscene_pair):
    """1,000 coincident spheres: build_bvh can split none of them, so its
    tree is a chain of 250 four-row leaves, 250 deep read as a binary
    tree, beyond the walk stack's 227 levels; converted, it is a
    balanced tree of the same 250 leaves at most 12 deep."""
    cc, gi = _k5_group(testscene_pair, "coincident")
    g = cc.scenes[0].groups[gi]
    bvh = group_accel(g)
    assert (bvh.n_nodes, _chain_links(bvh)) == (250, 249)
    with pytest.raises(ValueError):
        kernels.walk_stack(bvh.n_nodes)
    pairs = A.skip_link_pairs(bvh)
    _assert_pairs_keep_the_tree(bvh, pairs, *A.group_bounds(g))
    assert int((pairs.leaf_count > 0).sum()) == 250
    assert pairs.depth <= 12
    kernels.walk_stack(pairs.depth)


def test_chain_ending_in_a_subtree_converts():
    """A chain whose last link goes on into an inner node: node 0 holds
    rows 0-3 and its rest is node 1, an inner node over the leaves 2
    (rows 4-5) and 3 (rows 6-7).  The converted root's children are the
    link's own rows, under the link's box, and node 1's subtree."""
    box = np.float32([[0, 0, 0, 4, 4, 4], [1, 1, 1, 3, 3, 3],
                      [1, 1, 1, 2, 2, 2], [2, 2, 2, 3, 3, 3]])
    bvh = A.BvhFlat(bmin=box[:, :3], bmax=box[:, 3:],
                    leaf_start=np.int32([0, -1, 4, 6]),
                    leaf_count=np.int32([4, 0, 2, 2]),
                    skip=np.int32([4, 4, 3, 4]),
                    order=np.arange(8, dtype=np.int32))
    pairs = A.skip_link_pairs(bvh)
    assert (pairs.n_nodes, pairs.depth) == (5, 3)
    lo = np.float32([[0, 0, 0]] * 4 + [[1, 1, 1]] * 2 + [[2, 2, 2]] * 2)
    _assert_pairs_keep_the_tree(bvh, pairs, lo, lo + 1)
    left, right = pairs.left[0], pairs.right[0]
    assert (pairs.leaf_start[left], pairs.leaf_count[left]) == (0, 4)
    np.testing.assert_array_equal(pairs.bmax[left], [4, 4, 4])
    np.testing.assert_array_equal(pairs.bmin[right], [1, 1, 1])
    assert pairs.leaf_count[right] == 0


def _emulate_k5(recs, t0, t1, vis, seed, o, d, shadow, far_first=False):
    """csrc/bvh_select.cu's walk of one ray in numpy: the near-first walk
    of csrc/bvh_walk.cuh over child-pair records (far_first: the other
    child first) with the kernel's leaf rule -- a row's candidate beats
    the best (bt, best row) when it is nearer, or as near with a lower
    row -- on the row candidates t0 / t1 of this ray.  Returns (t, leaf
    row or -1)."""
    words = recs.view(np.int32)
    with np.errstate(divide="ignore"):
        inv = np.float32(1.0) / np.where(d == 0, np.float32(1e-20), d)

    def reach(b, lim):
        ta, tb = (b[0:3] - o) * inv, (b[3:6] - o) * inv
        near = np.max(np.minimum(ta, tb))
        far = np.min(np.maximum(ta, tb))
        return near <= far and far > 0 and near <= lim, near

    def beats(t, row, bt, best):
        return t < bt or (t == bt and best >= 0 and row < best)

    bt, best, stack = seed, -1, []
    if not seed > 0:
        return bt, -1
    node = int(words[0, 12]) if reach(recs[0, 0:6], bt)[0] else 0
    while node != 0:
        if node < 0:
            first, count = (~node) >> 5, (~node) & 31
            for row in range(first, first + count):
                if not vis[row] > 0.5:
                    continue
                v0 = t0[row] > 0 and beats(t0[row], row, bt, best)
                v1 = t1[row] > 0 and beats(t1[row], row, bt, best)
                if v0 or v1:
                    bt, best = (t0[row] if v0 else t1[row]), row
                    if shadow:
                        return bt, best
            node = 0
        else:
            hl, nl = reach(recs[node, 0:6], bt)
            hr, nr = reach(recs[node, 6:12], bt)
            kids = (int(words[node, 12]), int(words[node, 13]))
            if hl and hr:
                first_l = (nl <= nr) != far_first
                node = kids[0] if first_l else kids[1]
                stack.append((kids[1], nr) if first_l else (kids[0], nl))
            else:
                node = kids[0] if hl else (kids[1] if hr else 0)
        while node == 0 and stack:
            ref, near = stack.pop()
            if near <= bt:
                node = ref
    return bt, (best if bt < seed else -1)


@pytest.mark.parametrize("case", ["tie_grid", "coincident"])
@pytest.mark.parametrize("shadow", [False, True])
def test_record_walk_breaks_ties_as_the_plain_version(testscene_pair, case,
                                                      shadow):
    """On exact ties (the tie grid's vertical rays meet up to six rows at
    bit-exactly the same t, and a ray into the coincident spheres meets
    all 1,000), K5's leaf rule on its walk of the records, near child
    first or far child first, picks bvh_select_plain's winner on every
    lane: the lowest leaf-order row at the least t; in shadow mode the
    same rays are blocked."""
    cc, gi = _k5_group(testscene_pair, case)
    sc = cc.scenes[0]
    garrs = materialize_scene_params(
        sc, T.to_torch(cc.arrays(), "cpu")["scenes"][0])
    (ptype, bvh, rows, vis, cons), _order = bvh_args(sc, garrs, gi,
                                                        shadow, "cpu")
    n = 192
    if case == "tie_grid":
        o, d = tie_grid_rays(n, seed=2)
        seed_t = 5.0 if shadow else INF
    else:
        o, d = block_rays(n, 3)
        seed_t = 7.0 if shadow else INF
    o, d = o.astype(np.float32), d.astype(np.float32)
    seeds = np.full(n, seed_t, np.float32)
    seeds[::17] = 0.0
    tp, lp = GK.bvh_select_plain(ptype, bvh, rows, vis, cons,
                                 torch.as_tensor(np.concatenate(
                                     [o.T, d.T, seeds[None]])).contiguous(),
                                 torch.as_tensor(seeds), shadow)
    c0, c1 = TMK._candidates(ptype, rows, _field_width(ptype), False,
                             torch.as_tensor(o), torch.as_tensor(d))
    c0, c1 = c0.numpy(), c1.numpy()
    pairs = A.skip_link_pairs(bvh)
    recs = A.node_records(pairs.bmin, pairs.bmax, pairs.left, pairs.right,
                          pairs.leaf_start, pairs.leaf_count)
    vis = vis.numpy()
    ties = 0
    for far_first in (False, True):
        for i in range(n):
            t, leaf = _emulate_k5(recs, c0[i], c1[i], vis, seeds[i], o[i],
                                  d[i], shadow, far_first)
            assert (leaf >= 0) == (int(lp[i]) >= 0), i
            if not shadow:
                assert (t, leaf) == (float(tp[i]), int(lp[i])), i
                if not far_first and leaf >= 0:
                    at_t = (c0[i] == t) | (c1[i] == t)
                    ties += int((at_t & (vis > 0.5)).sum() > 1)
    assert 0 < int((lp >= 0).sum()) < n
    if not shadow:
        assert ties > n // 8


# --- K4 / K5 plain versions against the Pallas kernels ---------------------

def _kernel_rays(n, seed_t, rng_seed):
    o, d = block_rays(n, rng_seed)
    seeds = np.full(n, seed_t, np.float32)
    seeds[::17] = 0.0                             # dead lanes
    return o, d, seeds


def _port_rays(o, d):
    return torch.as_tensor(np.concatenate([o.T, d.T])).contiguous()


def _assert_select_close(got, want, shadow, rtol=RTOL):
    """(t, local) of a plain version against the Pallas kernel's."""
    (tg, lg), (tw, lw) = got, want
    hg, hw = lg >= 0, lw >= 0
    n = len(tg)
    print(f"{'blocked' if shadow else 'hit'}: {int(hw.sum())}/{n}, "
          f"disagree on {int((hg != hw).sum())}")
    assert 0 < hw.sum() < n
    assert (hg != hw).mean() <= 1e-3
    if shadow:
        return
    close = np.isclose(tg, tw, rtol=rtol, atol=ATOL)
    print(f"t outside rtol {rtol}/atol {ATOL}: {int((~close).sum())}")
    assert (~close).mean() <= 1e-3
    diff = hg & hw & (lg != lw)
    # a differing winner only where the two distances tie
    assert np.all(close[diff])
    assert diff.mean() <= 1e-3


def _dense_group(kind):
    """(compiled glome_tpu scene, group index) of a K4 check group."""
    rng = np.random.RandomState(0)

    def spheres(n):
        return [G.sphere(tuple(rng.uniform(-4, 4, 3)),
                         float(rng.uniform(0.2, 0.6))) for _ in range(n)]
    if kind == "spheres":
        solid = G.group(spheres(300))
    elif kind == "difference":
        solid = G.difference(G.group(spheres(900)),
                             G.sphere((0.0, 0.0, 0.0), 2.5))
    elif kind == "boxes":
        solid = block_scene("transformed", G)
    elif kind == "cones":
        cones = []
        for _ in range(300):
            p = rng.uniform(-4, 4, 3)
            q = p + rng.normal(size=3) * 0.6
            cones.append(G.cone(tuple(p), float(rng.uniform(0.1, 0.4)),
                                tuple(q), float(rng.uniform(0.0, 0.1))))
        solid = G.group(cones)
    else:
        solid = G.group([G.plane(tuple(rng.uniform(-5, 5, 3)),
                                 tuple(rng.normal(size=3)))
                         for _ in range(40)])
    compiled = G.compile_scene(solid, ())
    sc = compiled.scenes[0]
    gi = max((i for i, g in enumerate(sc.groups)
              if g.vclass in ("plain", "inline")
              and (kind != "difference" or g.constraints)),
             key=lambda i: sc.groups[i].size)
    return compiled, gi


@pytest.mark.parametrize("kind", ["spheres", "difference", "boxes", "cones",
                                  "planes"])
@pytest.mark.parametrize("shadow", [False, True])
def test_dense_select_plain_matches_pallas(kind, shadow):
    compiled, gi = _dense_group(kind)
    sc = compiled.scenes[0]
    g = sc.groups[gi]
    assert (g.m_inv is not None) == (kind in ("boxes", "cones"))
    assert bool(g.constraints) == (kind == "difference")
    garrs_j = _jnp(compiled.arrays())["scenes"][0]
    garrs_t = T.to_torch(compiled.arrays(), "cpu")["scenes"][0]
    pj = {k: v for k, v in garrs_j[gi].items() if k not in ("m_inv", "m_fwd")}
    pt = {k: v for k, v in garrs_t[gi].items() if k not in ("m_inv", "m_fwd")}
    pm_j = PK.pack_params_T(g.ptype, pj)
    pm_t = GK.pack_params_T(g.ptype, pt)
    np.testing.assert_array_equal(pm_t.numpy(), np.asarray(pm_j))
    bb_j = PK.block_aabbs(g.ptype, pj, garrs_j[gi].get("m_fwd"), g.size,
                          PK.BP)
    bb_t = GK.block_aabbs(g.ptype, pt, garrs_t[gi].get("m_fwd"), g.size)
    assert (bb_j is None) == (kind == "planes") == (bb_t is None)
    if bb_t is not None:
        np.testing.assert_allclose(bb_t.numpy(), np.asarray(bb_j),
                                   rtol=1e-6, atol=1e-6)
    vis = (~g.onlyshadow if not shadow else ~g.noshadow).astype(np.float32)
    o, d, seeds = _kernel_rays(512, 6.0 if shadow else INF,
                               3 if shadow else 2)
    tw, lw = PK.dense_intersect(
        g.ptype, pm_j, garrs_j[gi].get("m_inv"), jnp.asarray(vis),
        PK.pack_constraints(sc, garrs_j, g), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(seeds), interpret=True, block_bbox=bb_j, shadow=shadow)
    minv = garrs_t[gi].get("m_inv")
    cons = GK.encode_constraints(GK.pack_constraints(sc, garrs_t, g), "cpu")
    calls = GK.dense_select_plain.calls
    tg, lg = GK.dense_select(g.ptype, pm_t, minv, torch.as_tensor(vis),
                             cons, _port_rays(o, d), torch.as_tensor(seeds),
                             block_bbox=bb_t, shadow=shadow)
    assert GK.dense_select_plain.calls == calls + 1   # CPU -> plain version
    assert GK.dense_select.launches == 0
    _assert_select_close((tg.numpy(), lg.numpy()),
                         (np.asarray(tw), np.asarray(lw)), shadow)


# --- K4's cull table ---------------------------------------------------------

def _slab(boxes, o, d):
    """(near, far) (n, m) of csrc/walk.cuh box_live: n rays against the
    first six columns [bmin, bmax] of m boxes, in the kernel's float32
    operations."""
    iv = 1.0 / torch.where(d == 0.0, torch.full_like(d, 1e-20), d)
    t1 = (boxes[None, :, 0:3] - o[:, None, :]) * iv[:, None, :]
    t2 = (boxes[None, :, 3:6] - o[:, None, :]) * iv[:, None, :]
    return torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)


def _grazing_rays(ptype, rows, transformed, boxes, rng, k=384):
    """Rays that graze k random prims: from a random direction, the
    origin slides sideways off each prim by bisection (40 steps) until
    the ray barely hits it (the plain version's candidates); returns the
    barely-hitting and the barely-missing rays."""
    P = rows.shape[0]
    j = torch.as_tensor(rng.integers(0, P, k))
    d = torch.as_tensor(rng.normal(size=(k, 3)), dtype=torch.float32)
    d = d / d.norm(dim=1, keepdim=True)
    e = torch.as_tensor(rng.normal(size=(k, 3)), dtype=torch.float32)
    e = e - (e * d).sum(1, keepdim=True) * d
    e = e / e.norm(dim=1, keepdim=True)
    lo_b, hi_b = boxes[j, 0:3], boxes[j, 3:6]
    c = (lo_b + hi_b) * 0.5
    diag = (hi_b - lo_b).norm(dim=1, keepdim=True)

    def origin(s):
        return c + e * s - d * (3.0 * diag + 1.0)

    def hits(s):
        t0, t1 = TMK._candidates(ptype, rows[j], _field_width(ptype),
                                 transformed, origin(s), d)
        t0, t1 = t0.diagonal(), t1.diagonal()
        return ((t0 > 0) & (t0 < INF)) | ((t1 > 0) & (t1 < INF))
    s_lo = torch.zeros((k, 1))
    s_hi = diag.clone()                  # this far off the centre: a miss
    keep = hits(s_lo) & ~hits(s_hi)
    for _ in range(40):
        mid = (s_lo + s_hi) * 0.5
        h = hits(mid)[:, None]
        s_lo = torch.where(h, mid, s_lo)
        s_hi = torch.where(h, s_hi, mid)
    return (torch.cat([origin(s_lo)[keep], origin(s_hi)[keep]]),
            torch.cat([d[keep], d[keep]]))


def _assert_cull_contains_candidates(args, table, o, d):
    """Every candidate of the plain version's arithmetic (0 < t < INF,
    before visibility and constraints) lies inside its prim's padded
    box and its sub-block's box by box_live's slab test: near <= t <=
    far.  Returns the candidates checked."""
    ptype, params_T, m_inv, _vis, _cons = args
    rows = GK._dense_table(params_T, m_inv).t()
    P = rows.shape[0]
    n_sub = (P + GK.SUB - 1) // GK.SUB
    sub = torch.arange(P) // GK.SUB
    checked = 0
    for s in range(0, o.shape[0], 256):
        oc, dc = o[s:s + 256], d[s:s + 256]
        t0, t1 = TMK._candidates(ptype, rows, _field_width(ptype),
                                 m_inv is not None, oc, dc)
        for box in (table[n_sub:], table[:n_sub][sub]):
            near, far = _slab(box, oc, dc)
            for t in (t0, t1):
                cand = (t > 0.0) & (t < INF)
                bad = cand & ~((near <= t) & (t <= far))
                assert not bad.any(), (
                    f"{int(bad.sum())} candidates outside their box, "
                    f"e.g. t {t[bad][:4].tolist()}, near "
                    f"{near[bad][:4].tolist()}, far {far[bad][:4].tolist()}")
                checked += int(cand.sum())
    return checked


def _dense_groups_of(compiled):
    return [(si, gi) for si, sc in enumerate(compiled.scenes)
            for gi, g in enumerate(sc.groups)
            if g.vclass not in ("deferred", "convex") and g.size
            and not g.accel_eligible]


@pytest.mark.parametrize("scene", ["testscene", "rotated_boxes"])
def test_cull_boxes_contain_every_candidate(testscene_pair, scene):
    """K4's padded per-prim and per-sub-block boxes (cull_aabbs) hold
    every candidate hit of the plain version's arithmetic, on seeded
    rays (camera or block_rays, uniform, and rays grazing random prims),
    for TestScene's 7 dense groups and block_scene's rotated boxes; each
    sub-block box is the union of its prims' padded boxes."""
    rng = np.random.default_rng(11)
    if scene == "testscene":
        _cj, ct, cam = testscene_pair
        ys, xs = np.mgrid[0:40, 0:60]
        xc, yc = pixel_coords(60, 40, torch.as_tensor(xs.reshape(-1) + 0.5,
                                                      dtype=torch.float32),
                              torch.as_tensor(ys.reshape(-1) + 0.5,
                                              dtype=torch.float32))
        o_cam, d_cam = primary_rays(cam, xc, yc)
    else:
        ct = T.compile_scene(block_scene("transformed"), phase_kinds_lights(),
                             accel_min_size=1 << 30)
        o_np, d_np = block_rays(2400, seed=9)
        o_cam, d_cam = torch.as_tensor(o_np), torch.as_tensor(d_np)
    arrays = T.to_torch(ct.arrays(), "cpu")
    groups = _dense_groups_of(ct)
    assert len(groups) == (7 if scene == "testscene" else 1)
    for si, gi in groups:
        g = ct.scenes[si].groups[gi]
        args, table = dense_args(ct.scenes[si], arrays["scenes"][si], gi,
                                    False, "cpu")
        P = g.size
        n_sub = (P + GK.SUB - 1) // GK.SUB
        assert tuple(table.shape) == (n_sub + P, 8)
        prim = table[n_sub:]
        for s in range(n_sub):
            part = prim[s * GK.SUB:(s + 1) * GK.SUB]
            assert torch.equal(table[s, 0:3], part[:, 0:3].amin(0))
            assert torch.equal(table[s, 3:6], part[:, 3:6].amax(0))
        ga = arrays["scenes"][si][gi]
        bmin, bmax = TMK.prim_aabb(g.ptype, {k: v for k, v in ga.items()
                                             if k not in ("m_inv", "m_fwd")},
                                   ga.get("m_fwd"))
        assert (prim[:, 0:3] < bmin).all() and (prim[:, 3:6] > bmax).all()
        lo = prim[:, 0:3].amin(0) - 1.0
        hi = prim[:, 3:6].amax(0) + 1.0
        u = torch.as_tensor(rng.uniform(size=(512, 3)), dtype=torch.float32)
        o_uni = lo + (hi - lo) * u
        d_uni = torch.as_tensor(rng.normal(size=(512, 3)),
                                dtype=torch.float32)
        d_uni = d_uni / d_uni.norm(dim=1, keepdim=True)
        rows = GK._dense_table(args[1], args[2]).t()
        o_gr, d_gr = _grazing_rays(g.ptype, rows, args[2] is not None, prim,
                                   rng)
        assert o_gr.shape[0] >= 128
        checked = _assert_cull_contains_candidates(
            args, table, torch.cat([o_cam, o_uni, o_gr]),
            torch.cat([d_cam, d_uni, d_gr]))
        print(f"{si}.g{gi} ({P} {g.ptype}): {checked} candidates inside, "
              f"{o_gr.shape[0]} grazing rays")
        assert checked > 0


@pytest.mark.parametrize("constrained", [False, True])
@pytest.mark.parametrize("shadow", [False, True])
def test_bvh_select_plain_matches_pallas(constrained, shadow):
    rng = np.random.RandomState(5)
    solid = G.group([G.sphere(tuple(rng.uniform(-6, 6, 3)),
                              float(rng.uniform(0.1, 0.35)))
                     for _ in range(3000)])
    if constrained:
        solid = G.difference(solid, G.sphere((0.0, 0.0, 0.0), 3.0))
    compiled = G.compile_scene(solid, (), accel_min_size=64)
    sc = compiled.scenes[0]
    gi = max((i for i, g in enumerate(sc.groups) if g.accel is not None
              and bool(g.constraints) == constrained),
             key=lambda i: sc.groups[i].size)
    g = sc.groups[gi]
    order = np.asarray(g.accel.order)
    garrs_j = _jnp(compiled.arrays())["scenes"][0]
    garrs_t = T.to_torch(compiled.arrays(), "cpu")["scenes"][0]
    rows_j = PK.pack_params_rows(g.ptype, {k: v[order]
                                           for k, v in garrs_j[gi].items()})
    rows_t = GK.pack_params_rows(g.ptype, {k: v[torch.as_tensor(order)]
                                           for k, v in garrs_t[gi].items()})
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    vis = ((~g.noshadow if shadow else ~g.onlyshadow)[order]
           .astype(np.float32))
    o, d, seeds = _kernel_rays(512, 7.0 if shadow else INF,
                               5 if shadow else 4)
    seeds[::17] = 0.0
    tw, lw = PK.bvh_intersect(g.ptype, g.accel, rows_j, jnp.asarray(vis),
                              PK.pack_constraints(sc, garrs_j, g),
                              jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(seeds), shadow=shadow,
                              interpret=True)
    cons = GK.encode_constraints(GK.pack_constraints(sc, garrs_t, g), "cpu")
    assert bool(cons.spec) == constrained
    tg, lg = GK.bvh_select(g.ptype, g.accel, rows_t, torch.as_tensor(vis),
                           cons, _port_rays(o, d), torch.as_tensor(seeds),
                           shadow=shadow)

    def local(leaf):
        return np.where(leaf >= 0, order[np.maximum(leaf, 0)], -1)
    _assert_select_close((tg.numpy(), local(lg.numpy())),
                         (np.asarray(tw), local(np.asarray(lw))), shadow)


def test_unknown_route_is_refused(testscene_pair):
    _cj, ct, _cam = testscene_pair
    with pytest.raises(ValueError):
        T.WavefrontTracer(ct, route="pallas")
    with pytest.raises(ValueError):
        intersect_multi_table(ct, None, torch.zeros((8, 1)),
                                 route="pallas")


# --- the 90x60 frame on the group route ------------------------------------

@pytest.fixture(scope="module")
def group_frame(testscene_pair):
    _cj, ct, cam = testscene_pair
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = T.RenderConfig.tuned(xres=90, yres=60)
        tracer = T.WavefrontTracer(ct, cfg, route=GROUPS)
        renderer = T.Renderer(tracer, cam, cfg)
        before = (GK.dense_select.launches, GK.bvh_select.launches,
                  GK.dense_select_plain.calls, GK.bvh_select_plain.calls,
                  TMK.mega_select_plain.calls)
        rgb, _depth = renderer.render(T.to_torch(ct.arrays(), "cpu"))
        after = (GK.dense_select.launches, GK.bvh_select.launches,
                 GK.dense_select_plain.calls, GK.bvh_select_plain.calls,
                 TMK.mega_select_plain.calls)
        return dict(rgb=rgb, overflow=renderer.last_overflow,
                    batches=tracer.last_batches,
                    counts=[b - a for a, b in zip(before, after)])
    finally:
        torch.set_num_threads(n)


def test_group_route_frame_within_golden_canaries(group_frame):
    assert tuple(group_frame["rgb"].shape) == (60, 90, 3)
    assert torch.isfinite(group_frame["rgb"]).all()
    assert int(group_frame["overflow"].sum()) == 0
    got = quantize(group_frame["rgb"].numpy())
    want = read_png(GOLDEN)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    print(f"group route drift vs CPU golden: mean {diff.mean():.4f} levels, "
          f"{int((diff > 64).sum())}/{diff.size} pixels > 64, "
          f"{int((diff > 0).sum())}/{diff.size} pixels differ")
    assert diff.mean() <= 3.0
    assert (diff > 64).sum() <= 0.006 * diff.size


def test_group_route_frame_runs_the_plain_versions(group_frame):
    """On CPU tensors every K4 / K5 pass takes its plain version: seven
    dense and two BVH groups of TestScene per intersect or shadow batch,
    and no megakernel call."""
    k4, k5, p4, p5, p1 = group_frame["counts"]
    batches = group_frame["batches"]
    assert batches == 6            # intersect + shadow at each of 3 levels
    assert (k4, k5) == (0, 0)
    assert (p4, p5) == (7 * batches, 2 * batches)
    assert p1 == 0
