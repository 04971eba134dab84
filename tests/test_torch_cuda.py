"""K1 on the card: the CUDA kernel against its plain version, and the
wrapper's contract.  Every test needs a CUDA device and skips without
one.  The card's machine has no JAX, so run these without the suite's
conftest (which configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import glome_tpu_torch as T
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch.scenes.phasescene import (csg_rays, csg_scene,
                                               phase_kinds_lights,
                                               phase_kinds_rays,
                                               phase_kinds_scene)

SCENES = {"phase_kinds": (phase_kinds_scene, phase_kinds_rays),
          "csg": (csg_scene, csg_rays)}

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tables(dev, scene="phase_kinds"):
    compiled = T.compile_scene(SCENES[scene][0](), phase_kinds_lights())
    plan = MK.get_plan(compiled)
    return MK.pack_tables(plan, compiled, T.to_torch(compiled.arrays(), dev))


@pytest.fixture(scope="module")
def tables(dev):
    return _tables(dev)


def _rays(dev, n, seed_t, seed, scene="phase_kinds"):
    o, d = SCENES[scene][1](n, seed=seed)
    return torch.as_tensor(np.stack(
        [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
         np.full(n, seed_t, np.float32), np.zeros(n, np.float32)]),
        device=dev).contiguous()


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("shadow", [False, True])
def test_kernel_matches_plain(dev, scene, shadow):
    """Built without multiply-add contraction (kernels.NVCC_FLAGS), K1
    rounds every product as the plain version's eager ops do: on these
    scenes the two agree bit for bit."""
    tables = _tables(dev, scene)
    rays = _rays(dev, 8192, 20.0 if shadow else T.INFINITY, 3 if shadow
                 else 0, scene)
    tk, wk, ak = MK.mega_select(tables, rays, shadow)
    tp, wp, ap = MK.mega_select_plain(tables, rays, shadow)
    torch.cuda.synchronize()
    assert torch.equal(wk >= 0, wp >= 0)
    assert 0 < int((wk >= 0).sum()) < rays.shape[1]
    if not shadow:
        assert torch.equal(tk, tp)
        assert torch.equal(wk, wp)
        assert torch.equal(ak, ap)


def test_launch_count(dev, tables):
    rays = _rays(dev, 1024, T.INFINITY, 0)
    before = MK.mega_select.launches
    MK.mega_select(tables, rays, False)
    MK.mega_select(tables, rays[:, :0].contiguous(), False)   # no launch
    torch.cuda.synchronize()
    assert MK.mega_select.launches == before + 1


def test_wrapper_rejects_bad_inputs(dev, tables):
    rays = _rays(dev, 256, T.INFINITY, 0)
    with pytest.raises(ValueError):
        MK.mega_select(tables, rays[:7].contiguous(), False)
    with pytest.raises(TypeError):
        MK.mega_select(tables, rays.double(), False)
    with pytest.raises(ValueError):
        MK.mega_select(tables, rays.t().contiguous().t(), False)
    cpu = MK.PlanTables(tables.plan, tables.pf.cpu(), tables.pi, tables.nf,
                        tables.ni, tables.bb, tables.phases)
    with pytest.raises(ValueError):
        MK.mega_select(cpu, rays, False)
