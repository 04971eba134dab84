"""The port's soft-edge relaxation (glome_tpu_torch/soft.py) against
glome_tpu's SoftTracer on the CPU, on tests/test_soft.py's scenes: the
r = 1 sphere, the cylinder, cone and disc silhouettes, the three-prim
scene and a CSG cavity (a sphere bitten by a subtracted sphere, whose
soft edge is the clause margin).

Tolerances: tau = 0 gives the hard image bit for bit; soft colors
within atol 2e-5 of glome_tpu's; gradients of the summed soft image with
respect to every scene parameter within rtol 1e-3 of the largest |g|
(the same float32 formulas in another op order, summed over rays in
another order); AD against central FD at test_soft.py's probe points
with test_soft.py's tolerances (rtol 0.08 at the sphere; 0.2 at the
cylinder and the cone, 0.12 at the disc: central FD of a tau = 0.05
sigmoid carries O((eps/tau)^2) truncation near the silhouette, as
test_soft.py states).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu.soft import SoftTracer as JSoftTracer
from glome_tpu.trace import Tracer as JTracer
from glome_tpu_torch.soft import SoftTracer, soft_pixel_loss_fn

TAU = 0.05


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mat(P):
    return P.t_uniform(P.Surface(color=(0.9, 0.3, 0.1), alpha=1,
                                 ambient=0.3, kd=0.7))


SCENES = {
    "sphere": lambda P: P.tex(P.sphere((0.0, 0.0, 0.0), 1.0), _mat(P)),
    "cylinder": lambda P: P.tex(P.cylinder((-1.0, 0, 0), (1.0, 0, 0), 1.0),
                                _mat(P)),
    "cone": lambda P: P.tex(P.cone((-1.0, 0, 0), 1.0, (1.0, 0, 0), 0.01),
                            _mat(P)),
    "disc": lambda P: P.tex(P.disc((0, 0, 0), (0, 0, -1.0), 1.0), _mat(P)),
    "three": lambda P: P.tex(P.group([
        P.cylinder((-2.2, -1, 0), (-2.2, 1, 0), 0.6),
        P.cone((0.0, -1, 0), 0.8, (0.0, 1.2, 0), 0.05),
        P.disc((2.2, 0, 0), (0, 0.2, -1.0), 0.9)]), _mat(P)),
    "cavity": lambda P: P.tex(P.difference(
        P.sphere((0, 0, 0), 1.0), P.sphere((0.45, 0.9, 0.0), 0.55)),
        _mat(P)),
}
HALF = {"three": 3.4, "cavity": 1.8}


def _lights(P):
    return (P.light((3, 4, -6), (60, 60, 60)),)


def _ortho_rays(nx, ny, half=1.6):
    xs = np.linspace(-half, half, nx, dtype=np.float32)
    ys = np.linspace(-half * ny / nx, half * ny / nx, ny, dtype=np.float32)
    X, Y = np.meshgrid(xs, ys)
    o = np.stack([X.ravel(), Y.ravel(),
                  np.full(X.size, -5.0, np.float32)], axis=-1)
    d = np.zeros_like(o)
    d[:, 2] = 1.0
    return o, d


def _port(name, tau=TAU):
    compiled = T.compile_scene(SCENES[name](T), _lights(T))
    tracer = T.Tracer(compiled, T.RenderConfig(maxdepth=2))
    return compiled, tracer, SoftTracer(tracer, tau=tau)


@pytest.mark.parametrize("name", ["sphere", "three", "cavity"])
def test_tau_zero_is_hard_image(name):
    _compiled, tracer, _soft = _port(name)
    o, d = (torch.as_tensor(a) for a in _ortho_rays(32, 24,
                                                     HALF.get(name, 1.6)))
    arrays = T.to_torch(_compiled.arrays(), "cpu")
    hard = tracer.trace(arrays, o, d).color
    s0 = SoftTracer(tracer, tau=0.0).render(arrays, o, d)
    assert torch.equal(hard, s0)
    # tiny tau: every coverage sigmoid saturates except exact grazers
    s1 = SoftTracer(tracer, tau=1e-6).render(arrays, o, d)
    differ = np.nonzero((s1 != hard).any(dim=1).numpy())[0]
    print(f"{name}: tau 1e-6 differs from the hard image on "
          f"{len(differ)} of {len(o)} rays")
    if name != "cavity":
        assert len(differ) == 0
        return
    # the cavity's hard winners on its rim sit on the clause margin's
    # zero, where no tau saturates: glome_tpu's tau = 1e-6 image differs
    # from its hard image on exactly the same rays
    cj = G.compile_scene(SCENES[name](G), _lights(G))
    tj = JTracer(cj, G.RenderConfig(maxdepth=2))
    aj = jax.tree.map(jnp.asarray, cj.arrays())
    oj, dj = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    hj = np.asarray(jax.jit(lambda a: tj.trace(a, oj, dj).color)(aj))
    sj = np.asarray(jax.jit(lambda a: JSoftTracer(tj, tau=1e-6).render(
        a, oj, dj))(aj))
    np.testing.assert_array_equal(differ,
                                  np.nonzero((sj != hj).any(axis=1))[0])
    assert len(differ) <= 0.01 * len(o)


@pytest.mark.parametrize("name", list(SCENES))
def test_soft_colors_and_gradients_match_glome_tpu(name):
    o, d = _ortho_rays(32, 24, HALF.get(name, 1.6))
    cj = G.compile_scene(SCENES[name](G), _lights(G))
    sj = JSoftTracer(JTracer(cj, G.RenderConfig(maxdepth=2)), tau=TAU)

    def loss_j(a):
        col = sj.render(a, jnp.asarray(o), jnp.asarray(d))
        return jnp.sum(col[:, :3] * col[:, 3:4]), col

    (_l, col_j), grad_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        jax.tree.map(jnp.asarray, cj.arrays()))

    compiled, _tracer, soft = _port(name)
    assert soft.has_csg == (name == "cavity")
    arrays = T.to_torch(compiled.arrays(), "cpu")
    leaves = [v for sc in arrays["scenes"] for ga in sc for v in ga.values()]
    for v in leaves:
        v.requires_grad_(True)
    col = soft.render(arrays, torch.as_tensor(o), torch.as_tensor(d))
    (col[:, :3] * col[:, 3:4]).sum().backward()
    np.testing.assert_allclose(col.detach().numpy(), np.asarray(col_j),
                               atol=2e-5, rtol=0)
    scale = max(float(np.abs(np.asarray(g)).max())
                for g in jax.tree.leaves(grad_j["scenes"]))
    assert scale > 1.0
    g_err = max(float(np.abs(np.asarray(grad_j["scenes"][si][gi][k])
                             - v.grad.numpy()).max())
                for si, sc in enumerate(arrays["scenes"])
                for gi, ga in enumerate(sc) for k, v in ga.items()
                if v.grad is not None)
    print(f"{name}: max |color diff| "
          f"{np.abs(col.detach().numpy() - np.asarray(col_j)).max():.3g}, "
          f"max |grad diff| / max |g| {g_err / scale:.3g}")
    for si, sc in enumerate(arrays["scenes"]):
        for gi, ga in enumerate(sc):
            for k, v in ga.items():
                want = np.asarray(grad_j["scenes"][si][gi][k])
                got = (np.zeros_like(want) if v.grad is None
                       else v.grad.numpy())
                assert np.isfinite(got).all()
                np.testing.assert_allclose(got, want, rtol=1e-3,
                                           atol=1e-3 * scale,
                                           err_msg=f"{si}/{gi}/{k}")


def test_silhouette_fd_vs_ad_sphere():
    """d(loss)/d(center) on rays just inside and just outside the r = 1
    silhouette, where hard visibility has zero gradient."""
    compiled, _tracer, soft = _port("sphere")
    o = torch.tensor([[0.98, 0.0, -5.0], [1.02, 0.0, -5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])

    def loss(a):
        col = soft.render(a, o, d)
        return (col[:, :3] * col[:, 3:4]).sum()

    arrays = T.to_torch(compiled.arrays(), "cpu")
    arrays["scenes"][0][0]["center"].requires_grad_(True)
    loss(arrays).backward()
    gc = float(arrays["scenes"][0][0]["center"].grad[0, 0])
    assert abs(gc) > 1e-3, "no coverage gradient at the silhouette"

    def at(dx):
        a2 = T.to_torch(compiled.arrays(), "cpu")
        a2["scenes"][0][0]["center"][0, 0] += dx
        return float(loss(a2))

    eps = 1e-3   # << tau so FD resolves the sigmoid, not the step
    fd = (at(eps) - at(-eps)) / (2 * eps)
    np.testing.assert_allclose(gc, fd, rtol=0.08, atol=1e-4)


@pytest.mark.parametrize("name,probe,rtol", [
    ("cylinder", [[0.0, 0.97, -5.0], [0.0, 1.03, -5.0], [0.3, -0.96, -5.0]],
     0.2),
    ("cone", [[-0.5, 0.72, -5.0], [-0.5, 0.78, -5.0], [0.0, -0.48, -5.0]],
     0.2),
    ("disc", [[0.97, 0.0, -5.0], [1.03, 0.0, -5.0]], 0.12),
])
def test_silhouette_fd_vs_ad_translation(name, probe, rtol):
    """AD of a soft silhouette loss with respect to a translation of the
    whole group (applied by shifting the probe rays) against central
    FD."""
    compiled, _tracer, soft = _port(name)
    arrays = T.to_torch(compiled.arrays(), "cpu")
    o0 = torch.tensor(probe, dtype=torch.float32)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(len(probe), 3)

    def loss(o):
        col = soft.render(arrays, o, d)
        return (col[:, :3] * col[:, 3:4]).sum()

    o = o0.clone().requires_grad_(True)
    loss(o).backward()
    gx = float(o.grad[:, 0].sum())
    assert abs(gx) > 1e-4, "no coverage gradient at the silhouette"
    eps = 1e-3
    dx = torch.zeros_like(o0)
    dx[:, 0] = eps
    fd = (float(loss(o0 + dx)) - float(loss(o0 - dx))) / (2 * eps)
    np.testing.assert_allclose(gx, fd, rtol=rtol, atol=1e-4)


def test_soft_pixel_loss_matches_glome_tpu():
    """soft_pixel_loss_fn: the same mean squared error as glome_tpu's on
    the cavity scene against a shifted target."""
    from glome_tpu.soft import soft_pixel_loss_fn as j_loss_fn
    o, d = _ortho_rays(24, 18, 1.8)
    target = np.random.default_rng(0).uniform(
        0, 1, (len(o), 3)).astype(np.float32)
    cj = G.compile_scene(SCENES["cavity"](G), _lights(G))
    want = float(jax.jit(j_loss_fn(JSoftTracer(JTracer(
        cj, G.RenderConfig(maxdepth=2)), tau=TAU)))(
            jax.tree.map(jnp.asarray, cj.arrays()), jnp.asarray(o),
            jnp.asarray(d), jnp.asarray(target)))
    compiled, _tracer, soft = _port("cavity")
    got = float(soft_pixel_loss_fn(soft)(
        T.to_torch(compiled.arrays(), "cpu"), torch.as_tensor(o),
        torch.as_tensor(d), torch.as_tensor(target)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
