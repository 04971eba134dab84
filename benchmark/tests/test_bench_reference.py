"""The plain reference on cases worked out by hand: its primitives, CSG,
shading and AA stencil."""

import numpy as np
import pytest
import torch

from benchmark.reference import aa as AA
from benchmark.reference import scene as S
from benchmark.reference.tracer import INF, Scene, Tracer

F64 = torch.float64


def hit(root, o, d, tmax=INF):
    sc = Scene(root, {}, "cpu", F64)
    o = torch.tensor([o], dtype=F64)
    d = torch.tensor([d], dtype=F64)
    h = sc.hit(o, d, torch.full((1,), tmax, dtype=F64))
    return float(h["t"][0]), h["norm"][0].tolist()


def test_a_sphere_is_hit_at_its_entry_and_from_inside_at_its_exit():
    ball = S.sphere((0, 0, 0), 1)
    assert hit(ball, (0, 0, -5), (0, 0, 1)) == (pytest.approx(4.0),
                                                pytest.approx([0, 0, -1]))
    t, n = hit(ball, (0, 0, 0), (0, 0, 1))
    assert t == pytest.approx(1.0) and n == pytest.approx([0, 0, 1])
    assert hit(ball, (0, 0, -5), (0, 0, 1), tmax=3.0)[0] == INF


def test_a_transform_keeps_world_distances_and_turns_normals():
    squashed = S.xform(S.sphere((0, 0, 0), 1), [S.scale((1, 0.5, 1)),
                                                S.translate((0, 0, 3))])
    t, n = hit(squashed, (0, -5, 3), (0, 1, 0))
    assert t == pytest.approx(4.5) and n == pytest.approx([0, -1, 0])


def test_a_box_and_a_capped_cone():
    assert hit(S.box((-1, -1, -1), (1, 1, 1)), (-4, 0.5, 0), (1, 0, 0)) == (
        pytest.approx(3.0), pytest.approx([-1, 0, 0]))
    cone = S.cone((0, 0, 0), 1.0, (0, 0, 2), 0.5)      # radius 0.75 at z=1
    t, n = hit(cone, (-3, 0, 1), (1, 0, 0))
    assert t == pytest.approx(3 - 0.75)
    assert n[2] > 0 and n[0] < 0                       # the side leans in
    assert hit(cone, (0, 0, -3), (0, 0, 1)) == (pytest.approx(3.0),
                                                pytest.approx([0, 0, -1]))


def test_difference_shows_b_inside_a_with_its_normal_flipped():
    carved = S.Diff(S.box((-2, -2, -2), (2, 2, 2)), S.sphere((0, 0, -2), 1))
    # through the carved dimple: B's far side, facing out of the box
    t, n = hit(carved, (0, 0, -5), (0, 0, 1))
    assert t == pytest.approx(4.0) and n == pytest.approx([0, 0, -1])
    # beside it: the box's own face
    assert hit(carved, (1.5, 1.5, -5), (0, 0, 1))[0] == pytest.approx(3.0)


def test_a_convex_intersection_is_cut_by_its_half_spaces():
    cut = S.Inter([S.sphere((0, 0, 0), 2), S.half_space((0, 0, -1), 0.5)])
    # the half-space z > -0.5: the ray enters it at its plane
    t, n = hit(cut, (0, 0, -5), (0, 0, 1))
    assert t == pytest.approx(4.5) and n == pytest.approx([0, 0, -1])
    assert hit(cut, (1.9, 0, 5), (0, 0, -1))[0] < INF
    assert hit(cut, (0, 3, -5), (0, 0, 1))[0] == INF


def test_a_lit_matte_surface_and_its_shadow():
    floor = S.Tex(S.box((-10, -1, -10), (10, 0, 10)),
                  S.matte((1.0, 0.5, 0.25)))
    light = S.Light((0.0, 4.0, 0.0), (16.0, 16.0, 16.0))
    tr = Tracer(floor, [light], 3, "cpu", F64)
    o = torch.tensor([[0.0, 1.0, 0.0]], dtype=F64)
    d = torch.tensor([[0.0, -1.0, 0.0]], dtype=F64)
    c, t = tr.trace(o, d)
    # ambient 0.2 of the colour plus light 16 / 4^2 at normal incidence
    assert t.tolist() == pytest.approx([1.0])
    assert c[0].tolist() == pytest.approx([0.2 + 1, 0.1 + 1, 0.05 + 1, 1])
    blocker = S.Group([floor, S.sphere((0, 2, 0), 0.5)])
    c, _ = Tracer(blocker, [light], 3, "cpu", F64).trace(o, d)
    assert c[0].tolist() == pytest.approx([0.2, 0.1, 0.05, 1])


def test_aa_traces_an_even_field_once_in_eight_and_fills_the_rest():
    calls = []

    def trace(xf, yf):
        calls.append(len(xf))
        out = torch.zeros((len(xf), 5), dtype=F64)
        out[:, :4] = 0.5
        out[:, 4] = 10.0
        return out
    img = AA.tiles(trace, [(0, 0), (8, 0)], 8, (0.14, 0.15, 0.16, 0.18),
                   F64, "cpu")
    # pass 1 traces x, y even with x + y = 0 mod 4; the tiles' last row and
    # column read outside neighbours, so only they are traced again
    assert calls[0] == 2 * 8
    inner = img[:, :, :7, :7]
    assert torch.allclose(inner[:, :4], torch.full_like(inner[:, :4], 0.5))
    assert torch.allclose(inner[:, 4], torch.full_like(inner[:, 4], 10.0))
    assert np.isfinite(img.numpy()).all()
