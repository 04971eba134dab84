"""Point queries in the port (glome_tpu_torch/query.py) against
glome_tpu's: `inside` and `metainfo` on the same compiled scenes and
the same numpy-seeded points must agree exactly -- inside, found, and
the texture and tag stacks, id for id (the compiled tables are equal,
test_torch_host.py, and every test is a float comparison of the same
expression in float32)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import glome_tpu as G
import glome_tpu_torch as T
from glome_tpu_torch.scenes.phasescene import csg_scene, phase_kinds_scene


def _scene_py(P):
    """test_scene.py:90-121's scene: a tagged textured sphere, a box
    minus a sphere, a two-sphere lens."""
    red = P.Uniform(P.Surface(color=(1, 0, 0)))
    return P.group([
        P.tex(P.tag(P.sphere((0, 0, 0), 1.0), "ball"), red),
        P.difference(P.box((2, -1, -1), (4, 1, 1)),
                     P.sphere((3, 0, 0), 0.9)),
        P.intersection([P.sphere((-3, 0, 0), 1.0),
                        P.sphere((-2.5, 0, 0), 1.0)]),
    ])


PTS = np.asarray([
    [0.0, 0.0, 0.0],      # in tagged sphere
    [3.0, 0.0, 0.0],      # in subtracted hollow -> NOT inside
    [2.05, 0.0, 0.0],     # in box, outside the subtracted sphere
    [-2.75, 0.0, 0.0],    # in the lens intersection
    [-3.9, 0.0, 0.0],     # in first sphere only -> NOT inside
    [9.0, 9.0, 9.0],      # nowhere
], np.float32)


def _both(scene):
    cj = G.compile_scene(scene(G), ())
    ct = T.compile_scene(scene(T), ())
    return cj, ct


def _queries(cj, ct, pts):
    aj = cj.arrays()
    at = T.to_torch(ct.arrays(), "cpu")
    jin = np.asarray(G.inside(cj, aj, jnp.asarray(pts)))
    tin = T.inside(ct, at, torch.as_tensor(pts))
    jf, jtex, jtag = (np.asarray(a) for a in G.metainfo(cj, aj,
                                                       jnp.asarray(pts)))
    tf, ttex, ttag = T.metainfo(ct, at, torch.as_tensor(pts))
    return (jin, jf, jtex, jtag), tuple(
        a.numpy() for a in (tin, tf, ttex, ttag))


def test_point_queries_inside_and_metainfo():
    """test_scene.py's point-query test on the port, and equal to
    glome_tpu's answers."""
    cj, ct = _both(_scene_py)
    j, t = _queries(cj, ct, PTS)
    np.testing.assert_array_equal(t[0], [True, False, True, True, False,
                                         False])
    np.testing.assert_array_equal(t[1], t[0])
    assert ct.tag_names[int(t[3][0, 0])] == "ball"
    for a, b, name in zip(j, t, ("inside", "found", "tex", "tag")):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _seeded_points(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("scene,lo,hi", [
    (csg_scene, (-1.6, -3.0, -1.6), (7.6, 3.5, 1.6)),
    (phase_kinds_scene, (-4.5, -2.0, -1.5), (6.0, 4.5, 13.0)),
], ids=["csg_scene", "phase_kinds_scene"])
def test_seeded_points_match_glome_tpu(scene, lo, hi):
    """4,096 seeded points: inside, found, tex and tag equal; the
    points reach both answers."""
    cj, ct = _both(scene)
    pts = _seeded_points(4096, lo, hi, seed=11)
    j, t = _queries(cj, ct, pts)
    for a, b, name in zip(j, t, ("inside", "found", "tex", "tag")):
        np.testing.assert_array_equal(a, b, err_msg=name)
    frac = t[0].mean()
    print(f"{scene.__name__}: {frac:.4f} of the points inside")
    assert 0.01 < frac < 0.99
    assert (t[1] == t[0]).all()


def test_points_keep_batch_shape_and_device():
    cj, ct = _both(_scene_py)
    at = T.to_torch(ct.arrays(), "cpu")
    pts = torch.as_tensor(np.stack([PTS, PTS[::-1]]))
    ins = T.inside(ct, at, pts)
    found, tex, tag = T.metainfo(ct, at, pts)
    assert ins.shape == found.shape == (2, 6)
    assert tex.shape[:2] == tag.shape[:2] == (2, 6)
    assert ins.device == tex.device == at["lights"]["pos"].device
    np.testing.assert_array_equal(ins[1].numpy(), ins[0].numpy()[::-1])
