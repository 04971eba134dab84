"""Host-side parity of the port: the numpy modules copied into
glome_tpu_torch (scene DAG, compiler, BVH builders, megakernel plan)
must produce exactly glome_tpu's tables, so kernel winner ids and
finalize metadata mean the same thing in both packages."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu import megakernel as MK
from glome_tpu_torch import megakernel as TMK
from glome_tpu.scenes import test_scene as jax_test_scene
from glome_tpu_torch.scenes import test_scene as torch_test_scene
from glome_tpu_torch.scenes.phasescene import (phase_kinds_lights,
                                               phase_kinds_scene)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PLAN_ARRAYS = ("pi", "nf", "ni", "tex_all", "tag_all", "serial_all",
               "neg_all", "csg_all", "scene_of", "ltex_all", "ltag_all",
               "atex_all", "cid_all", "row_all")


def _testscene():
    sj, lj, _ = jax_test_scene()
    st, lt, _ = torch_test_scene()
    return G.compile_scene(sj, lj), T.compile_scene(st, lt)


def _phasescene():
    return (G.compile_scene(phase_kinds_scene(G), phase_kinds_lights(G)),
            T.compile_scene(phase_kinds_scene(T), phase_kinds_lights(T)))


@pytest.fixture(scope="module")
def testscene_pair():
    return _testscene()


@pytest.fixture(scope="module", params=["testscene", "phasekinds"])
def compiled_pair(request):
    if request.param == "testscene":
        return request.getfixturevalue("testscene_pair")
    return _phasescene()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_arrays_match_leaf_for_leaf(compiled_pair):
    cj, ct = compiled_pair
    lj = dict(_leaves(cj.arrays()))
    lt = dict(_leaves(ct.arrays()))
    assert lj.keys() == lt.keys()
    for k in lj:
        assert lj[k].dtype == lt[k].dtype, k
        np.testing.assert_array_equal(lj[k], lt[k], err_msg=k)


def test_plan_tables_match(compiled_pair):
    cj, ct = compiled_pair
    pj, pt = MK.get_plan(cj), TMK.get_plan(ct)
    assert [ph.kind for ph in pj.phases] == [ph.kind for ph in pt.phases]
    for a, b in zip(pj.phases, pt.phases):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert len(pj.pf_spec) == len(pt.pf_spec)
    for (s1, g1, i1, f1), (s2, g2, i2, f2) in zip(pj.pf_spec, pt.pf_spec):
        assert (s1, g1, f1) == (s2, g2, f2)
        assert (i1 is None) == (i2 is None)
        if i1 is not None:
            np.testing.assert_array_equal(i1, i2)
    assert pj.pf_size == pt.pf_size
    assert pj.bb_spec == pt.bb_spec
    assert pj.prim_base == pt.prim_base
    assert pj.combos == pt.combos
    assert (pj.blocks, pj.external) == (pt.blocks, pt.external) == ([], [])
    for name in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(pj, name), getattr(pt, name),
                                      err_msg=name)
    # the device tables the kernels read
    pfj, bbj = MK.pack_tables(pj, cj, cj.arrays())
    tabs = TMK.pack_tables(pt, ct, T.to_torch(ct.arrays(), "cpu"))
    np.testing.assert_array_equal(np.asarray(pfj), tabs.pf.numpy())
    np.testing.assert_allclose(np.asarray(bbj), tabs.bb.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tabs.pi.numpy(), pj.pi)


def test_testscene_plan_shape(testscene_pair):
    """The main path's plan: 2 scenes, the four phase kinds, nothing
    routed to K2/K3, and K1's walk stack sized from the deepest bvh2
    tree: depth 15, so 14 entries per thread."""
    _cj, ct = testscene_pair
    plan = TMK.get_plan(ct)
    assert plan.n_scenes == 2
    assert {ph.kind for ph in plan.phases} == {"dense", "bvh2", "convex",
                                               "deferred"}
    assert not plan.blocks and not plan.external
    tab = TMK.encode_phases(plan)
    assert tab.dtype == np.int32
    heads = tab[:len(plan.phases) * TMK.PH_W].reshape(-1, TMK.PH_W)
    assert [int(k) for k in heads[:, TMK.PH_KIND]] == [
        TMK.KIND_CODE[ph.kind] for ph in plan.phases]
    assert max(ph.depth for ph in plan.phases) == 15
    assert TMK.walk_stack(plan) == 14


def test_to_torch_round_trip():
    _cj, ct = _phasescene()
    arrays = ct.arrays()
    tt = T.to_torch(arrays, "cpu")
    back = dict(_leaves(tt))
    for k, v in _leaves(arrays):
        assert isinstance(back[k], torch.Tensor)
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    # jax arrays (a glome_tpu pytree on device) and tensors are accepted
    jtree = {"scenes": [[{k: jnp.asarray(v) for k, v in ga.items()}
                         for ga in sc] for sc in arrays["scenes"]],
             "lights": {k: jnp.asarray(v)
                        for k, v in arrays["lights"].items()}}
    again = T.to_torch(jtree, "cpu")
    twice = T.to_torch(tt, "cpu")
    for k, v in _leaves(arrays):
        np.testing.assert_array_equal(dict(_leaves(again))[k].numpy(), v)
        np.testing.assert_array_equal(dict(_leaves(twice))[k].numpy(), v)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import glome_tpu_torch, glome_tpu_torch.megakernel, "
            "glome_tpu_torch.kernels, glome_tpu_torch.scenes, "
            "glome_tpu_torch.scenes.phasescene, glome_tpu_torch.io\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'glome_tpu' "
            "or m.startswith('glome_tpu.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_port_sources_name_no_jax():
    pkg = os.path.join(ROOT, "glome_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                for line in fh:
                    words = line.split()
                    if words[:1] not in (["import"], ["from"]):
                        continue
                    mod = words[1].split(".")[0].rstrip(",")
                    assert mod not in ("jax", "glome_tpu"), (f, line)


def test_kernel_build_key_follows_nvcc_version():
    """A library's name hashes its sources, the nvcc flags and nvcc's
    --version text: another toolkit builds another library instead of
    loading one built by the first."""
    from glome_tpu_torch import kernels
    v1 = "Cuda compilation tools, release 12.4, V12.4.131"
    v2 = "Cuda compilation tools, release 12.8, V12.8.93"
    for sources in kernels.LIBRARIES.values():
        key = kernels.build_key(sources, v1)
        assert key == kernels.build_key(sources, v1)
        assert key != kernels.build_key(sources, v2)
    keys = {kernels.build_key(s, v1) for s in kernels.LIBRARIES.values()}
    assert len(keys) == len(kernels.LIBRARIES)
    assert "bvh_walk.cuh" in kernels.BVH_SOURCES
