"""Math-layer parity: the port's vec, xfm, color, geom and noise against
glome_tpu's JAX functions on the same numpy inputs (made from seeds),
rtol 1e-6 / atol 1e-6; the gradient through vec.finite_grad against
jax.grad at the same points.

The inputs are well conditioned (rays aimed through the prims, unit
directions), so float32 op-order differences stay within the bound."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from glome_tpu import color as JC, geom as JG, noise as JN, vec as JV
from glome_tpu import xfm as JX
from glome_tpu_torch import color as TC, geom as TG, noise as TN, vec as TV
from glome_tpu_torch import xfm as TX

RTOL = ATOL = 1e-6
N = 512


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, rtol, atol)
        return
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype == bool:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def both(fn_t, fn_j, *args):
    """Apply the port and the JAX function to the same numpy args."""
    return (fn_t(*(torch.as_tensor(a) for a in args)),
            fn_j(*(jnp.asarray(a) for a in args)))


def unit(rng, n):
    v = rng.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_vec():
    rng = np.random.RandomState(0)
    a = rng.randn(N, 3).astype(np.float32)
    b = rng.randn(N, 3).astype(np.float32)
    s = rng.randn(N).astype(np.float32)
    a[0] = 0.0                       # vnorm's zero-vector guard
    for name in ("vdot", "vcross", "bisect", "reflect", "vdist"):
        close(*both(getattr(TV, name), getattr(JV, name), a, b))
    for name in ("vnorm", "vlen", "vlensqr", "vinvert"):
        close(*both(getattr(TV, name), getattr(JV, name), a))
    close(*both(TV.vscaleadd, JV.vscaleadd, a, b, s))
    close(*both(TV.vscale, JV.vscale, a, s))
    lo, hi = -np.abs(a), np.abs(b) + 0.5
    close(*both(lambda x, y, z: TV.bbinside((x, y), z),
                lambda x, y, z: JV.bbinside((x, y), z), lo, hi, 0.5 * b))
    close(*both(TV.bbclip, JV.bbclip, a, 1.0 / (b + 3.0), lo, hi))


def test_xfm():
    rng = np.random.RandomState(1)
    # the numpy constructors are copies: identical matrices
    for xf_t, xf_j in (
            (TX.compose([TX.rotate((0, 0, 1), 0.3), TX.scale((1, 2, 3)),
                         TX.translate((1, -2, 0.5))]),
             JX.compose([JX.rotate((0, 0, 1), 0.3), JX.scale((1, 2, 3)),
                         JX.translate((1, -2, 0.5))])),
            (TX.rotate((0.6, 0.8, 0.0), 1.1),
             JX.rotate((0.6, 0.8, 0.0), 1.1))):
        np.testing.assert_array_equal(xf_t.fwd, xf_j.fwd)
        np.testing.assert_array_equal(xf_t.inv, xf_j.inv)
    mats = rng.randn(N, 3, 4).astype(np.float32)
    pts = rng.randn(N, 3).astype(np.float32)
    for name in ("apply_point", "apply_vector", "apply_normal_T"):
        close(*both(getattr(TX, name), getattr(JX, name), mats, pts))


def test_color():
    rng = np.random.RandomState(2)
    c1 = rng.rand(N, 4).astype(np.float32)
    c2 = rng.rand(N, 4).astype(np.float32)
    w = rng.rand(N).astype(np.float32)
    close(*both(TC.cafold, JC.cafold, c1, c2))
    close(*both(TC.caweight, JC.caweight, c1, c2, w))
    close(*both(TC.cascale, JC.cascale, c1, w))
    close(*both(lambda x, y: TC.casum([x, y]),
                lambda x, y: JC.casum([x, y]), c1, c2))
    close(TC.ca_black((3,)), JC.ca_black((3,)))
    close(TC.ca_transparent((3,)), JC.ca_transparent((3,)))


def _rays_at(rng, centers, spread):
    """Rays from random origins aimed near `centers` (N, 3)."""
    o = centers + unit(rng, N) * 6.0
    tgt = centers + rng.randn(N, 3).astype(np.float32) * spread
    d = tgt - o
    return o.astype(np.float32), (d / np.linalg.norm(
        d, axis=-1, keepdims=True)).astype(np.float32)


def _geom_cases(rng):
    """(name, [params...], centers, spread) for each *_hits2."""
    c = rng.randn(N, 3).astype(np.float32)
    r = (rng.rand(N).astype(np.float32) + 0.5)
    p1 = rng.randn(N, 3).astype(np.float32)
    p2 = p1 + rng.randn(N, 3).astype(np.float32)
    p3 = p1 + rng.randn(N, 3).astype(np.float32)
    nrm = unit(rng, N)
    h = np.stack([-(rng.rand(N) + 0.2), rng.rand(N) + 0.2], 1).astype(
        np.float32)
    zero = np.zeros((N, 3), np.float32)
    return [
        ("sphere", [c, r], c, 0.6),
        ("plane", [nrm, rng.randn(N).astype(np.float32)],
         zero, 1.0),
        ("box", [c - r[:, None], c + r[:, None]], c, 0.8),
        ("triangle", [p1, p2, p3], (p1 + p2 + p3) / 3, 0.5),
        ("trianglenorm", [p1, p2, p3, unit(rng, N), unit(rng, N),
                          unit(rng, N)], (p1 + p2 + p3) / 3, 0.5),
        ("disc", [c, nrm, r * r], c, 0.8),
        ("cylinder", [r, h[:, 0], h[:, 1]], zero, 0.5),
        ("cone", [r, h[:, 0], h[:, 1], np.full(N, 1.5, np.float32)],
         zero, 0.5),
    ]


@pytest.mark.parametrize("case", range(8))
def test_geom_hits2(case):
    rng = np.random.RandomState(10 + case)
    name, params, centers, spread = _geom_cases(rng)[case]
    o, d = _rays_at(rng, centers, spread)
    f_t = getattr(TG, f"{name}_hits2")
    f_j = getattr(JG, f"{name}_hits2")
    got, want = both(f_t, f_j, *params, o, d)
    t0 = np.asarray(want[0])
    assert (t0 < 1e6).mean() > 0.1          # the rays do hit
    close(got, want)


def test_geom_inside():
    rng = np.random.RandomState(3)
    p = rng.randn(N, 3).astype(np.float32) * 1.2
    c = rng.randn(N, 3).astype(np.float32) * 0.3
    r = rng.rand(N).astype(np.float32) + 0.5
    nrm = unit(rng, N)
    h1 = -(rng.rand(N).astype(np.float32) + 0.2)
    h2 = rng.rand(N).astype(np.float32) + 0.2
    height = np.full(N, 1.5, np.float32)
    for name, params in (("sphere", [c, r]),
                         ("plane", [nrm, rng.randn(N).astype(np.float32)]),
                         ("box", [c - r[:, None], c + r[:, None]]),
                         ("cylinder", [r, h1, h2]),
                         ("cone", [r, h1, h2, height])):
        got, want = both(getattr(TG, f"{name}_inside"),
                         getattr(JG, f"{name}_inside"), *params, p)
        assert 0 < np.asarray(want).sum() < N
        close(got, want)


def test_noise():
    rng = np.random.RandomState(4)
    p = (rng.randn(N, 3) * 4.0).astype(np.float32)
    close(*both(TN.noise, JN.noise, p))
    close(*both(TN.perlin, JN.perlin, p))
    close(*both(lambda x: TN.turbulence(x, 3),
                lambda x: JN.turbulence(x, 3), p))
    for wave in ("square_wave", "triangle_wave", "sine_wave", "lump_wave"):
        close(*both(getattr(TN, wave), getattr(JN, wave), p[:, 0]))
    close(*both(lambda x: TN.stripe(x, (4.0, 8.0, 5.0), TN.triangle_wave),
                lambda x: JN.stripe(x, (4.0, 8.0, 5.0), JN.triangle_wave),
                p))


def test_finite_grad_matches_jax_grad():
    """The gradient of a loss with singular lanes (sqrt at 0, 1/x at
    0, a zero vector through vnorm) behind finite_grad: those lanes'
    non-finite gradients are zeroed, the rest pass unchanged."""
    rng = np.random.RandomState(5)
    x = rng.rand(64, 3).astype(np.float32)
    x[3] = 0.0
    x[7, 1] = 0.0

    def loss_t(v):
        y = TV.finite_grad(v)
        return (torch.sqrt(y).sum() + (1.0 / y).clamp(max=1e3).sum()
                + TV.vnorm(y).sum())

    def loss_j(v):
        y = JV.finite_grad(v)
        return (jnp.sqrt(y).sum() + jnp.minimum(1.0 / y, 1e3).sum()
                + JV.vnorm(y).sum())

    xt = torch.as_tensor(x).requires_grad_(True)
    loss_t(xt).backward()
    gj = jax.grad(loss_j)(jnp.asarray(x))
    gt = xt.grad.numpy()
    assert np.isfinite(gt).all()
    assert (gt[3] == 0).all()
    close(gt, gj)
    # identity forward
    close(TV.finite_grad(torch.as_tensor(x)), x)
