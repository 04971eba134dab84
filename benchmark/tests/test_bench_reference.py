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


# --- triangles (Triangle.hs) ------------------------------------------------

FLAT = S.triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))     # normal +z
EPS = 1e-9


def test_a_triangle_is_hit_inside_and_missed_just_past_each_edge():
    assert hit(FLAT, (0.25, 0.25, -2), (0, 0, 1)) == (
        pytest.approx(2.0), pytest.approx([0, 0, 1]))
    assert hit(FLAT, (0.5 - EPS, 0.5 - EPS, -2), (0, 0, 1))[0] < INF
    for past in ((0.5, -EPS), (-EPS, 0.5), (0.5 + EPS, 0.5 + EPS)):
        assert hit(FLAT, (*past, -2), (0, 0, 1))[0] == INF


def test_a_triangle_is_hit_from_its_back_with_its_own_normal():
    # two-sided: the flat normal is (p2 - p1) x (p3 - p1) from either side
    assert hit(FLAT, (0.25, 0.25, 2), (0, 0, -1)) == (
        pytest.approx(2.0), pytest.approx([0, 0, 1]))
    assert hit(FLAT, (0.25, 0.25, 2), (0, 0, 1))[0] == INF     # behind


def test_a_ray_in_the_triangles_plane_misses_it():
    assert hit(FLAT, (-1, 0.25, 0), (1, 0, 0))[0] == INF


def test_the_smooth_normal_blends_the_vertex_normals():
    n1, n2, n3 = (0, 0, 1), (1, 0, 1), (0, 1, 1)
    smooth = S.trianglenorm((0, 0, 0), (1, 0, 0), (0, 1, 0), n1, n2, n3)
    unit = lambda v: (np.asarray(v, float) / np.linalg.norm(v)).tolist()
    # at a vertex its own normal, halfway along an edge the normalised mean
    assert hit(smooth, (1, 0, -2), (0, 0, 1)) == (pytest.approx(2.0),
                                                  pytest.approx(unit(n2)))
    half = np.add(unit(n1), unit(n2)) / 2
    assert hit(smooth, (0.5, 0, -2), (0, 0, 1))[1] == pytest.approx(
        unit(half))


def test_a_triangle_has_no_inside():
    from benchmark.reference.tracer import inside
    p = torch.tensor([FLAT.p], dtype=F64)
    x = torch.tensor([[[0.25, 0.25, 0.0]], [[0.1, 0.1, 1e-12]]], dtype=F64)
    assert not inside("triangle", p, x).any()


def test_a_triangle_under_a_transform_is_baked_as_triangle_hs_bakes_it():
    # turned onto the plane y = 0 and moved: world distances, turned normal
    moved = S.xform(FLAT, [S.rotate((1, 0, 0), np.pi / 2),
                           S.translate((0, 0, 5))])
    assert hit(moved, (0.25, 3, 5.25), (0, -1, 0)) == (
        pytest.approx(3.0), pytest.approx([0, -1, 0], abs=1e-12))
    # a mirror reverses the world vertices' order, so the flat normal
    # turns with them (an inverse-transposed normal would not)
    mirrored = S.xform(FLAT, [S.scale((-1, 1, 1))])
    assert hit(mirrored, (-0.25, 0.25, -2), (0, 0, 1)) == (
        pytest.approx(2.0), pytest.approx([0, 0, -1]))
    # the vertex normals go by the forward matrix (Triangle.hs:170-177)
    n = (1, 0, 1)
    stretched = S.xform(S.trianglenorm((0, 0, 0), (1, 0, 0), (0, 1, 0),
                                       n, n, n), [S.scale((2, 1, 1))])
    assert hit(stretched, (0.5, 0.25, -2), (0, 0, 1))[1] == pytest.approx(
        (np.array([2, 0, 1]) / np.sqrt(5)).tolist())


def test_fans_of_a_polygon_and_of_a_patch():
    quad = S.triangles([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)])
    assert [t.p for t in quad] == [
        (0, 0, 0, 1, 0, 0, 1, 1, 0), (0, 0, 0, 1, 1, 0, 0, 1, 0)]
    patch = S.trianglesnorms([((0, 0, 0), (0, 0, 2)), ((1, 0, 0), (0, 0, 1)),
                              ((1, 1, 0), (0, 0, 1)), ((0, 1, 0), (0, 0, 1))])
    assert [t.p[:9] for t in patch] == [t.p for t in quad]
    assert patch[1].p[9:] == (0, 0, 1, 0, 0, 1, 0, 0, 1)


# --- the background (NFF's b, missshade) ------------------------------------

SKY = (0.1, 0.2, 0.3)
MIRROR_FLOOR = S.Tex(S.box((-10, -1, -10), (10, 0, 10)),
                     ("uniform", ("reflect", 0.5)))


def trace_one(root, o, d, maxdepth, background, recurs=None):
    tr = Tracer(root, [], maxdepth, "cpu", F64, background=background)
    o = torch.tensor([o], dtype=F64)
    d = torch.tensor([d], dtype=F64)
    return tr.trace(o, d, recurs=recurs)[0][0].tolist()


def test_the_background_on_a_primary_miss_and_a_reflected_miss():
    up, down = ((0, 1, 0), (0, 1, 0)), ((0, 1, 0), (0, -1, 0))
    assert trace_one(MIRROR_FLOOR, *up, 2, SKY) == pytest.approx([*SKY, 1])
    # the mirror's child misses: the sky, opaque, at half the mirror's
    # weight, folded over a transparent start
    assert trace_one(MIRROR_FLOOR, *down, 2, SKY) == pytest.approx(
        [0.05, 0.1, 0.15, 0.5])
    # without one a miss is transparent
    assert trace_one(MIRROR_FLOOR, *up, 2, None) == [0, 0, 0, 0]
    assert trace_one(MIRROR_FLOOR, *down, 2, None) == [0, 0, 0, 0]


def test_no_background_at_the_recursion_floor():
    up, down = ((0, 1, 0), (0, 1, 0)), ((0, 1, 0), (0, -1, 0))
    assert trace_one(MIRROR_FLOOR, *up, 2, SKY, recurs=0) == [0, 0, 0, 0]
    # depth 1: the mirror's child would be the floor, so it is not traced
    assert trace_one(MIRROR_FLOOR, *down, 1, SKY) == [0, 0, 0, 0]
