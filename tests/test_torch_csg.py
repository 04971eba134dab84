"""K1 parity on phasescene.csg_scene: non-conjunctive CSG (DNF regions
with sibling exclusion), convex members under a non-uniform scale, and
an unbounded dense plane -- kernel paths the all-phase-kinds scene of
tests/test_torch_mega.py does not reach.  Same comparison and
tolerances as there: the port's plain mega_select against glome_tpu's
Pallas mega_select in interpret mode."""

import numpy as np
import pytest
import torch

import glome_tpu_torch as T
from glome_tpu import megakernel as MK
from glome_tpu_torch.scenes.phasescene import csg_rays, csg_scene

from test_torch_mega import (_assert_select_close, _compile_both,
                             _jax_select, _port_select)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shadow", [False, True])
def test_select_csg_matches_pallas(shadow):
    cj, ct = _compile_both(csg_scene)
    kinds = MK.get_plan(cj).phases
    assert any(ph.regions for ph in kinds)
    assert any(ph.kind == "convex" and any(m[3] for m in ph.members)
               for ph in kinds)
    n = 512
    o, d = csg_rays(n, seed=4 if shadow else 2)
    seed = np.full(n, 9.0 if shadow else 1e6, np.float32)
    want = _jax_select(cj, o, d, seed, shadow=shadow)
    got = _port_select(ct, T.to_torch(ct.arrays(), "cpu"), o, d, seed,
                       np.zeros(n, np.int32), shadow=shadow)
    assert 0 < (want[1] >= 0).sum() < n
    if shadow:
        np.testing.assert_array_equal(got[1] >= 0, want[1] >= 0)
    else:
        _assert_select_close(got, want)
