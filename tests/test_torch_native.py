"""The port's host tree builds on the CPU: the native BVH builder
(glome_tpu_torch/native, built here with g++) against the port's numpy
builder and glome_tpu's, its build key and its refusal to fall back;
and accel.skip_link_pairs (K5's binary tree) against the walk it
replaced.

Tolerance: none.  The tables must be bit-equal, dtypes included: the
native builder does numpy's double arithmetic in the same order (built
with -ffp-contract=off) and casts the node boxes to float32 at the end.
"""

import numpy as np
import pytest

import glome_tpu_torch as T
from glome_tpu import accel as JA
from glome_tpu import native as JN
from glome_tpu_torch import accel as A
from glome_tpu_torch import native as N
from glome_tpu_torch.scenes import mesh_scene
from glome_tpu_torch.scenes.phasescene import (coincident_scene,
                                               phase_kinds_lights,
                                               sphere_cloud_scene)

TABLES = ("bmin", "bmax", "leaf_start", "leaf_count", "skip", "order")
PAIR_TABLES = ("bmin", "bmax", "left", "right", "leaf_start", "leaf_count",
               "order")


def _mesh_bounds(n_tris):
    s, lt, _cam = mesh_scene(n_tris)
    cc = T.compile_scene(s, lt)
    g = max(cc.scenes[0].groups, key=lambda g: g.size)
    assert g.ptype == "trianglenorm" and g.mesh_src is not None
    return A.group_bounds(g)


def _case(name):
    """(bmin, bmax) float64 prim boxes of one test case."""
    rng = np.random.RandomState(3)
    if name == "random":
        c = rng.uniform(-20, 20, (3000, 3))
        h = rng.uniform(0.05, 2.0, (3000, 3))
        return c - h, c + h
    if name == "coincident":
        # build_bvh can split none of them: a chain of 250 leaves
        return np.full((1000, 3), -1.0), np.full((1000, 3), 1.0)
    if name == "one":
        return np.array([[0.0, 1.0, 2.0]]), np.array([[1.0, 2.0, 3.5]])
    if name == "duplicate_grid":
        g = np.stack(np.meshgrid(*[np.arange(6.0)] * 3), -1).reshape(-1, 3)
        c = np.repeat(g, 5, axis=0)
        return c - 0.3, c + 0.3
    if name == "flat":
        c = rng.uniform(-10, 10, (2000, 3))
        c[:, 1] = 0.0
        h = rng.uniform(0.1, 1.0, (2000, 3))
        h[:, 1] = 0.0
        return c - h, c + h
    if name == "mixed_sizes":
        c = rng.uniform(-30, 30, (2500, 3))
        h = np.exp(rng.uniform(np.log(1e-3), np.log(20.0), (2500, 1)))
        return c - h * rng.uniform(0.5, 1.0, (2500, 3)), c + h
    if name == "mesh20k":
        return _mesh_bounds(20_000)
    raise ValueError(name)


CASES = ["random", "coincident", "one", "duplicate_grid", "flat",
         "mixed_sizes", "mesh20k"]


def _glome_tpu_tree(bmin, bmax):
    """glome_tpu's tables: its native builder where its library loads,
    else its numpy builder."""
    native = JN.get_lib() is not None
    return JA.build_bvh(bmin, bmax, native=native), native


def _assert_same(a, b, fields, what):
    for k in fields:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("case", CASES)
def test_native_numpy_and_glome_tpu_tables_are_bit_equal(case):
    bmin, bmax = _case(case)
    nat = A.build_bvh(bmin, bmax)
    ref = A.build_bvh(bmin, bmax, native=False)
    jax_side, jax_native = _glome_tpu_tree(bmin, bmax)
    print(f"{case}: {len(bmin)} prims, {nat.n_nodes} nodes; glome_tpu's "
          f"{'native' if jax_native else 'numpy'} builder")
    assert nat.bmin.dtype == np.float32 and nat.order.dtype == np.int32
    _assert_same(nat, ref, TABLES, "native vs numpy")
    _assert_same(nat, jax_side, TABLES, "native vs glome_tpu")
    assert sorted(nat.order.tolist()) == list(range(len(bmin)))
    if case == "coincident":
        assert nat.n_nodes == 250 and (nat.leaf_count == 4).all()


def test_build_key_follows_source_flags_and_compiler(tmp_path):
    version = "g++ (Debian 12.2.0) 12.2.0\n"
    key = N.build_key(version)
    assert key == N.build_key(version)
    assert N.build_key("g++ (GCC) 13.1.0\n") != key
    assert N.build_key(version, flags=N.CXX_FLAGS + ["-g"]) != key
    assert N.build_key(version, flags=N.CXX_FLAGS[:-1]) != key
    src = tmp_path / "bvh_builder.cpp"
    with open(N.SOURCE, "rb") as f:
        text = f.read()
    src.write_bytes(text)
    assert N.build_key(version, source=str(src)) == key
    src.write_bytes(text + b"\n// an edit\n")
    assert N.build_key(version, source=str(src)) != key


def test_library_is_named_by_its_key():
    A.build_bvh(*_case("one"))
    path = N.BUILD_INFO["path"]
    assert path == N.build()
    assert path.endswith(f"_{N.build_key(N.cxx_version(N.cxx_path()))}.so")
    assert path.startswith(N.BUILD_DIR)


@pytest.mark.parametrize("fault", ["no_compiler", "failed_build"])
def test_build_failure_raises_instead_of_falling_back(monkeypatch, fault):
    monkeypatch.setattr(N, "_LIB", None)
    if fault == "no_compiler":
        monkeypatch.setattr(N, "CXX", "/nonexistent/bin/g++")
        match = "not found"
    else:
        # an option g++ refuses: a new key, so a build, which fails
        monkeypatch.setattr(N, "CXX_FLAGS",
                            N.CXX_FLAGS + ["--no-such-option"])
        match = "no-such-option"
    bmin, bmax = _case("random")
    with pytest.raises(RuntimeError, match=match):
        A.build_bvh(bmin, bmax)
    # the numpy builder only when the caller asks for it
    assert A.build_bvh(bmin, bmax, native=False).n_nodes > 1


def test_malformed_boxes_are_refused():
    bmin, bmax = _case("random")
    with pytest.raises(ValueError):
        A.build_bvh(bmin, bmax[:-1])
    with pytest.raises(ValueError):
        A.build_bvh(bmin[:, :2], bmax[:, :2])
    with pytest.raises(ValueError):
        A.build_bvh(bmin, bmax, leaf_max=0)


def test_failed_call_raises(monkeypatch):
    class Lib:
        @staticmethod
        def glome_build_bvh(*_args):
            return -1
    monkeypatch.setattr(N, "_LIB", Lib())
    with pytest.raises(RuntimeError, match="capacity"):
        A.build_bvh(*_case("random"))


# --- accel.skip_link_pairs against the per-node walk it replaced ----------

def _skip_link_pairs_walk(bvh):
    """skip_link_pairs as a walk over the tree, one node at a time (the
    port's version before its whole-array form): a work list of (node
    made, the items it covers, its level)."""
    lo = np.asarray(bvh.bmin, np.float32)
    hi = np.asarray(bvh.bmax, np.float32)
    skip = np.asarray(bvh.skip, np.int64)
    start = np.asarray(bvh.leaf_start, np.int64)
    count = np.asarray(bvh.leaf_count, np.int64)
    nb_min, nb_max, left, right, first, rows = [], [], [], [], [], []

    def new(items):
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
    return A.Bvh2(bmin=np.asarray(nb_min, np.float32).reshape(n_out, 3),
                  bmax=np.asarray(nb_max, np.float32).reshape(n_out, 3),
                  left=np.asarray(left, np.int32),
                  right=np.asarray(right, np.int32),
                  leaf_start=np.asarray(first, np.int32),
                  leaf_count=np.asarray(rows, np.int32),
                  order=np.asarray(bvh.order, np.int32), depth=depth)


def _tree(name):
    if name == "chain":
        cc = T.compile_scene(coincident_scene(), phase_kinds_lights(),
                             accel_min_size=64)
        return A.build_bvh(*A.group_bounds(cc.scenes[0].groups[0]))
    if name == "cloud":
        cc = T.compile_scene(sphere_cloud_scene(), phase_kinds_lights())
        return A.build_bvh(*A.group_bounds(cc.scenes[0].groups[0]))
    if name.startswith("mesh"):
        return A.build_bvh(*_mesh_bounds(int(name[4:])))
    return A.build_bvh(*_case(name))


@pytest.mark.parametrize("name", ["chain", "cloud", "mesh20000",
                                  "mesh100000", "duplicate_grid", "one"])
def test_skip_link_pairs_equals_the_walk(name):
    bvh = _tree(name)
    got, want = A.skip_link_pairs(bvh), _skip_link_pairs_walk(bvh)
    links = int(((bvh.leaf_count > 0)
                 & (bvh.skip != np.arange(bvh.n_nodes) + 1)).sum())
    print(f"{name}: {bvh.n_nodes} skip-link nodes ({links} chain links) "
          f"-> {got.n_nodes} nodes, depth {got.depth}")
    _assert_same(got, want, PAIR_TABLES, name)
    assert got.depth == want.depth
    if name == "cloud":
        assert links == 0 and got.n_nodes == bvh.n_nodes
    if name in ("chain", "mesh100000"):
        assert links > 0
