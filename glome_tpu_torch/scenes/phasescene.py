"""A small scene that exercises every megakernel phase kind.

The scene of glome_tpu's tests/test_mega.py:build_scene: dense groups,
bvh2 groups (plain and transformed, > DENSE_MAX prims), convex CSG,
deferred difference-B prims with restricted member scans (one large
enough for a point-query BVH), inline constraints, retexture, shadow
flags, and a transformed dense sphere.  `P` is the package whose
constructors build it (default: this one), so tests can build the same
scene with glome_tpu for a side-by-side comparison.
"""

from __future__ import annotations

import numpy as np


def _package(P):
    if P is None:
        import glome_tpu_torch as P
    return P


def phase_kinds_scene(P=None, tagged=False):
    """The all-phase-kinds solid, built with package P; with `tagged`,
    each of its items is wrapped in a tag of its own ("item0", ...), so
    a pick names the item it hit."""
    P = _package(P)

    def mat(c):
        return P.t_uniform(P.Surface(color=c, ambient=0.3, kd=0.7))

    rng = np.random.RandomState(7)
    items = []
    # dense boxes
    for i in range(6):
        items.append(P.tex(P.box((i, -1, -1), (i + 0.5, 1, 1)),
                           mat((1, 0, 0))))
    # bvh2 sphere grid minus a sphere: A inline with a 1-member
    # constraint, B deferred with a restricted ~150-member scan
    lat = [P.sphere((0.4 * a, 0.4 * b, 4.0 + 0.4 * c), 0.18)
           for a in range(6) for b in range(5) for c in range(5)]
    items.append(P.tex(P.difference(P.group(lat),
                                    P.sphere((1.0, 0.8, 4.8), 0.9)),
                       mat((0, 1, 0))))
    # transformed cones (bvh2, transformed leaf tests)
    cones = []
    for _ in range(100):
        p = rng.randn(3) * 2 + np.array([0, 0, 8.0])
        q = p + rng.randn(3) * 0.3
        cones.append(P.cone(tuple(p), 0.2, tuple(q), 0.05))
    items.append(P.tex(P.group(cones), mat((0, 0, 1))))
    # convex csg: intersection of planes
    items.append(P.tex(P.intersection([
        P.plane((0, 0, 12), (0, 0, 1)),
        P.plane((0, 0, 10), (0, 0, -1)),
        P.plane((1, 0, 11), (1, 0.2, 0)),
        P.plane((-1, 0, 11), (-1, 0.1, 0)),
        P.plane((0, 1, 11), (0.05, 1, 0)),
        P.plane((0, -1, 11), (0, -1, 0.02))]), mat((1, 1, 0))))
    # retexture difference (useatex): box minus sphere
    items.append(P.difference(
        P.tex(P.box((-4, -1, 2), (-2, 1, 4)), mat((1, 0, 1))),
        P.tex(P.sphere((-2, 0, 3), 0.8), mat((0, 1, 1)))))
    # nested CSG (conjunctive normalization): (lens & lens) - bite
    items.append(P.tex(P.difference(
        P.intersection([P.sphere((4.5, 0, 5.0), 1.0),
                        P.sphere((5.5, 0, 5.0), 1.0)]),
        P.sphere((5.0, 0.45, 5.0), 0.5)), mat((0.2, 0.8, 0.6))))
    # shadow-control wrappers
    items.append(P.noshadow(P.tex(P.sphere((3, 3, 3), 0.5),
                                  mat((0.5, 0.5, 0.5)))))
    items.append(P.onlyshadow(P.sphere((-3, 3, 3), 0.5)))
    # transformed squashed sphere (dense transformed)
    xf = P.compose([P.scale((1.0, 0.5, 1.0)), P.rotate((0, 0, 1), 0.4),
                    P.translate((2, -2, 6))])
    items.append(P.tex(P.transform(P.sphere((0, 0, 0), 1.0), [xf]),
                       mat((0.9, 0.3, 0.1))))
    if tagged:
        items = [P.tag(it, f"item{i}") for i, it in enumerate(items)]
    return P.group(items)


def phase_kinds_lights(P=None):
    P = _package(P)
    return (P.light((0, 8, 0), (50, 50, 50)),)


def phase_kinds_rays(n, seed=0):
    """(o, d) float32 (n, 3) rays from behind the scene into it
    (tests/test_mega.py:rays)."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32) * 0.5 + np.array(
        [0.5, 0.2, -4.0], np.float32)
    at = rng.randn(n, 3).astype(np.float32) * 3.0 + np.array(
        [0.0, 0.0, 6.0], np.float32)
    d = at - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def csg_scene(P=None):
    """CSG the all-phase-kinds scene leaves out, built with package P:
    non-conjunctive nesting (DNF regions with sibling exclusion, after
    glome_tpu's tests/test_csg.py), a convex intersection under a
    non-uniform scale (transformed convex members) and a ground plane
    (a dense phase without an AABB)."""
    P = _package(P)

    def mat(c):
        return P.t_uniform(P.Surface(color=c, ambient=0.3, kd=0.7))

    def at(x, s):
        return P.transform(s, [P.translate((x, 0.0, 0.0))])

    s = P.sphere
    return P.group([
        # a - (b & c)  ==  (a-b) | (a-c)
        at(0.0, P.tex(P.difference(
            s((0, 0, 0), 1.2),
            P.intersection([s((0.45, 0, 0), 0.9), s((-0.45, 0, 0), 0.9)])),
            mat((1, 0, 0)))),
        # a - (b - c)  ==  (a-b) | (a & c)
        at(3.0, P.tex(P.difference(
            s((0, 0, 0), 1.2),
            P.difference(s((0.5, 0, 0), 0.9), s((0.3, 0.3, 0), 0.6))),
            mat((0, 1, 0)))),
        # (a | (b & c)) - e
        at(6.0, P.tex(P.difference(
            P.group([s((-0.6, 0, 0), 0.8),
                     P.intersection([s((0.5, 0, 0), 0.9),
                                     s((0.9, 0, 0), 0.9)])]),
            s((0, 0.5, 0), 0.5)), mat((0, 0, 1)))),
        # convex lens under a non-uniform scale and a rotation
        P.tex(P.transform(
            P.intersection([s((-0.4, 0, 0), 1.0), s((0.4, 0, 0), 1.0)]),
            [P.scale((1.0, 0.5, 1.5)), P.rotate((0, 0, 1), 0.5),
             P.translate((3.0, 2.5, 0.0))]), mat((1, 1, 0))),
        P.tex(P.plane((0, -2.5, 0), (0, 1, 0)), mat((0.5, 0.5, 0.5))),
    ])


def csg_rays(n, seed=0):
    """(o, d) float32 (n, 3) rays from in front of csg_scene into it."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32) * 0.5 + np.array(
        [3.0, 0.5, -7.0], np.float32)
    at = rng.randn(n, 3).astype(np.float32) * np.array(
        [3.0, 1.5, 0.8], np.float32) + np.array([3.0, 0.3, 0.0], np.float32)
    d = at - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def block_scene(kind, P=None):
    """Groups for the block kernel (K2) beyond meshes, built with package
    P: "spheres" is glome_tpu's tests/test_block.py scene (700 spheres);
    "difference" subtracts a sphere from it, which leaves the spheres
    overlapping that sphere as a group with an inline "not inside"
    constraint; "transformed" is 300 boxes under random rotations (a
    group with per-prim inverse matrices)."""
    P = _package(P)
    if kind == "transformed":
        rng = np.random.default_rng(8)
        objs = []
        for _ in range(300):
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            box = P.box((-0.3, -0.2, -0.1), (0.3, 0.2, 0.1))
            objs.append(P.transform(box, [
                P.rotate(axis, float(rng.uniform(0, np.pi))),
                P.translate(tuple(rng.uniform(-4, 4, 3)))]))
        return P.group(objs)
    rng = np.random.default_rng(3)
    solid = P.group([P.sphere(tuple(rng.uniform(-4, 4, 3)), 0.3)
                     for _ in range(700)])
    if kind == "difference":
        solid = P.difference(solid, P.sphere((0.0, 0.0, 0.0), 2.0))
    return solid


def block_rays(n, seed=0, span=6.0):
    """(o, d) float32 (n, 3) rays from a cube of half-width `span`
    toward the middle of block_scene (or of a mesh_scene)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    at = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = at - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def chain_scene(n=200, ratio=2.0 ** -0.25, P=None):
    """A plain group of n spheres whose centres (ratio^k, 0, 0) and radii
    0.1 ratio^k shrink geometrically, built with package P.  The BVH
    builders split at spatial midpoints, so each level peels off the few
    largest spheres and the tree's depth grows with n instead of log2 n:
    the default 200 spheres give K1's bvh2 tree depth 47, and 320 spheres
    at ratio 2^(-1/6) give K2's block tree (4-sphere blocks) depth 80,
    the smallest sphere still 1e-16 across, which float32 tells apart.
    Spheres are listed smallest first, so the compiler's Morton order
    (which ties the tiny ones) keeps every block a run of neighbours."""
    P = _package(P)
    return P.group([P.sphere((ratio ** k, 0.0, 0.0), 0.1 * ratio ** k)
                    for k in range(n - 1, -1, -1)])


def chain_rays(n, seed=0, n_spheres=200, ratio=2.0 ** -0.25):
    """(o, d) float32 (n, 3) rays falling onto chain_scene from y = 2x
    over points x log-uniformly spread along the chain, within about a
    radius of its axis: the walks reach its deepest nodes, and the
    height, in scale with the sphere below, keeps even the smallest
    spheres' hits resolved in float32."""
    rng = np.random.default_rng(seed)
    x = ratio ** rng.uniform(-1.0, n_spheres, n)
    o = np.stack([x, 2.0 * x, rng.uniform(-0.12, 0.12, n) * x], axis=1)
    d = np.stack([rng.uniform(-0.01, 0.01, n) * x, -np.ones(n),
                  np.zeros(n)], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def tie_grid_scene(n=16, P=None):
    """A flat n x n grid of unit quads in the y = 0 plane (x, z in
    [-n/2, n/2]), two flat triangles each, as one shared-vertex mesh
    built with package P.  Every coordinate is a small integer, so a
    vertical ray through a shared edge or vertex (tie_grid_rays) meets
    each triangle around it at bit-exactly the same t: exact ties between
    table rows, in one block and across blocks."""
    P = _package(P)
    h = n // 2
    xs = np.arange(-h, n - h + 1, dtype=np.float64)
    V = np.stack(np.meshgrid(xs, [0.0], xs, indexing="ij"),
                 axis=-1).reshape(-1, 3)

    def vid(i, j):
        return i * (n + 1) + j
    tris = []
    for i in range(n):
        for j in range(n):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            tris += [[a, b, c, -1, -1, -1, -1, -1],
                     [a, c, d, -1, -1, -1, -1, -1]]
    return P.mesh(V, None, np.asarray(tris, np.int32), cast_shadows=True)


def tie_grid_rays(n, seed=0, grid=16):
    """(o, d) float32 (n, 3) rays onto tie_grid_scene: a quarter straight
    down through grid vertices, a quarter through points of the grid
    lines, a quarter through points of the quads' diagonals (each such
    ray ties the triangles that share the point), and a quarter tilted at
    random points (no ties)."""
    rng = np.random.default_rng(seed)
    h = grid // 2
    k = n // 4
    vert = rng.integers(-h, h + 1, (k, 2)).astype(np.float64)
    line = rng.integers(-h, h + 1, (k, 2)).astype(np.float64)
    line[:, 1] += rng.integers(0, 4, k) / 4.0 * (line[:, 1] < h)
    line = np.where(rng.random((k, 1)) < 0.5, line, line[:, ::-1])
    diag = rng.integers(-h, h, (k, 2)) + (rng.integers(1, 4, k) / 4.0)[:, None]
    pts = np.concatenate([vert, line, diag])
    down = np.tile([0.0, -1.0, 0.0], (len(pts), 1))
    m = n - len(pts)
    rnd = rng.uniform(-h, h, (m, 2))
    tilt = np.stack([rng.uniform(-0.3, 0.3, m), -np.ones(m),
                     rng.uniform(-0.3, 0.3, m)], axis=1)
    tilt /= np.linalg.norm(tilt, axis=1, keepdims=True)
    at = np.concatenate([pts, rnd])
    at = np.stack([at[:, 0], np.zeros(n), at[:, 1]], axis=1)
    d = np.concatenate([down, tilt])
    # from y = 3 (exactly 3 above the target for the vertical rays)
    o = at - d * (3.0 / -d[:, 1:2])
    return o.astype(np.float32), d.astype(np.float32)


def sphere_cloud_scene(n=20_000, P=None):
    """One plain group of n spheres at random in a cube of half-width 10,
    radii 0.05-0.25 (seed 12), built with package P: a deeper tree for
    the pass-per-group route's BVH (K5) than TestScene's lattice groups.
    Rays: block_rays(n, seed, span=14.0)."""
    P = _package(P)
    rng = np.random.default_rng(12)
    return P.group([P.sphere(tuple(rng.uniform(-10, 10, 3)),
                             float(rng.uniform(0.05, 0.25)))
                    for _ in range(n)])


def coincident_scene(n=1000, P=None):
    """One plain group of n spheres of radius 1 all at the origin, built
    with package P.  No split separates them, so the skip-link tree
    (accel.build_bvh) is a chain of leaves n / 4 long, and every ray
    that hits one sphere meets all n at bit-exactly the same t: exact
    ties between all rows.  The group gets that tree on the
    pass-per-group route once compiled with accel_min_size below n.
    Rays: block_rays."""
    P = _package(P)
    return P.group([P.sphere((0.0, 0.0, 0.0), 1.0) for _ in range(n)])


def warp_lights_scene(P=None):
    """A portal whose target scene has a light set of its own, built with
    package P: the root (a floor, a mirror sphere, a glass sphere and a
    door frame, one light) and, through the door, a target scene of two
    spheres on a floor under two other lights -- a scene the wavefront
    tracer refuses and the recursive Tracer renders (Shader.hs:157-175).
    Returns (solid, lights, camera); rays: the camera's."""
    P = _package(P)

    def mat(c, ks=0.0):
        return P.t_uniform(P.Surface(color=c, ambient=0.2, kd=0.7, ks=ks,
                                     shine=12.0))

    target = P.group([
        P.tex(P.sphere((0.0, 1.0, 0.0), 1.0), mat((0.2, 0.9, 0.3), 0.4)),
        P.tex(P.sphere((1.6, 0.6, -0.8), 0.6), mat((0.9, 0.8, 0.1))),
        P.tex(P.plane((0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
              mat((0.8, 0.8, 0.8))),
    ])
    warp_lights = (P.light((2.0, 6.0, -3.0), (30.0, 12.0, 12.0)),
                   P.light((-4.0, 3.0, 2.0), (6.0, 6.0, 40.0)))
    d = P.DELTA
    frame = P.tex(P.difference(P.box((-1.2, 0.0, -0.2), (1.2, 2.6, 0.2)),
                               P.box((-1.0, 0.2, -0.2 - d),
                                     (1.0, 2.4, 0.2 + d))),
                  mat((0.4, 0.4, 0.8)))
    surface = P.box((-1.2, 0.0, -d), (1.2, 2.6 - d, d))
    wx = P.compose([P.rotate((1, 0, 0), P.deg(-15)),
                    P.translate((0.0, 1.0, 5.0))])
    warp = P.Warp(frame=frame, scene=target, lights=warp_lights, xfm=wx)
    solid = P.group([
        P.transform(P.group([frame, P.tex(surface, P.t_uniform(warp))]),
                    [P.rotate((0, 1, 0), P.deg(10)),
                     P.translate((-0.8, 0.0, 0.0))]),
        P.tex(P.sphere((2.0, 0.9, 0.5), 0.9),
              P.t_uniform(P.AdditiveLayers((
                  P.Surface(color=(0.3, 0.3, 0.3), ambient=0.1, kd=0.3),
                  P.Reflect(0.7))))),
        P.tex(P.sphere((-2.4, 0.7, 1.2), 0.7),
              P.t_uniform(P.Refract(0.2, 0.8, 1.4))),
        P.tex(P.plane((0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
              mat((0.6, 0.5, 0.4))),
    ])
    lights = (P.light((3.0, 7.0, 5.0), (60.0, 60.0, 60.0)),)
    cam = P.camera((0.0, 2.2, 8.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0), 50.0)
    return solid, lights, cam


def two_prim_scene(P=None):
    """glome_tpu's tests/test_sharding.py scene, built with package P: a
    red sphere on a grey ground plane under one light.  Returns (solid,
    lights, camera); its tests render it at 32x16, depth 2."""
    P = _package(P)
    solid = P.group([
        P.tex(P.sphere((0, 1, 0), 1.0),
              P.t_uniform(P.Surface(color=(1, 0, 0), ambient=0.2, kd=0.8))),
        P.tex(P.plane((0, 0, 0), (0, 1, 0)),
              P.t_uniform(P.Surface(color=(0.6, 0.6, 0.6), ambient=0.1,
                                    kd=1.0))),
    ])
    lights = (P.light((-3, 6, 4), (60, 60, 60)),)
    return solid, lights, P.camera((0, 2, 6), (0, 1, 0), (0, 1, 0), 45)


def ptypes_scene(P=None):
    """Every primitive type of the megakernel's FIELDS (sphere, plane,
    box, triangle, trianglenorm, disc, cylinder, cone), each once plain
    and once under a scale and a rotation, a shared-vertex mesh (a
    triangle group and a trianglenorm group) and a retexture difference
    (a box minus a sphere: the difference-B retexture and the flipped
    normals of its B surface), built with package P: the scene of the
    fused finalize's checks.  Returns (solid, lights, camera)."""
    from importlib import import_module
    P = _package(P)
    S = import_module(P.__name__ + ".solids")

    def mat(c):
        return P.t_uniform(P.Surface(color=c, ambient=0.3, kd=0.7))

    def prims():
        return [
            P.sphere((0, 0, 0), 0.8),
            P.box((-0.7, -0.6, -0.5), (0.7, 0.6, 0.5)),
            P.triangle((-0.9, -0.8, 0), (0.9, -0.7, 0.2), (0, 0.9, -0.1)),
            P.trianglenorm((-0.9, -0.8, 0), (0.9, -0.7, 0.2),
                           (0, 0.9, -0.1), (0, 0.3, -1), (0.4, 0, -1),
                           (-0.3, -0.2, -1)),
            P.disc((0, 0, 0), (0.2, 0.3, -1), 0.8),
            S.CylinderZ(0.5, -0.6, 0.6),
            S.ConeZ(0.6, -0.5, 0.5, 0.9),
        ]

    items = []
    for k, s in enumerate(prims()):
        c = (0.2 + 0.1 * k, 0.9 - 0.1 * k, 0.5)
        items.append(P.tex(P.transform(s, [P.translate((2.0 * k - 6, 1.2,
                                                        0))]), mat(c)))
        items.append(P.tex(P.transform(s, [
            P.scale((1.0, 0.6, 1.2)), P.rotate((0.6, 0.8, 0.0), 0.7),
            P.translate((2.0 * k - 6, -1.2, 0))]), mat(c[::-1])))
    # plain (untransformed) prims of every type
    items += [P.tex(P.sphere((-5, 3.4, 1), 0.7), mat((1, 0, 0))),
              P.tex(P.box((-3.6, 2.8, 0.5), (-2.6, 3.9, 1.4)),
                    mat((0, 1, 0))),
              P.tex(P.triangle((-2, 2.8, 1), (-0.6, 2.9, 1.2),
                               (-1.3, 4.0, 0.9)), mat((0, 0, 1))),
              P.tex(P.trianglenorm((-0.2, 2.8, 1), (1.2, 2.9, 1.2),
                                   (0.5, 4.0, 0.9), (0, 0.3, -1),
                                   (0.4, 0, -1), (-0.3, -0.2, -1)),
                    mat((1, 1, 0))),
              P.tex(P.disc((2.2, 3.4, 1), (0.1, -0.2, -1), 0.6),
                    mat((0, 1, 1))),
              # on the z axis: the cone in front of the cylinder, which
              # shows as a ring around it
              P.tex(S.CylinderZ(0.5, 1.5, 2.5), mat((1, 0, 1))),
              P.tex(S.ConeZ(0.3, -0.5, 0.5, 0.9), mat((0.5, 0.5, 1))),
              P.tex(P.plane((0, -3.2, 0), (0, 1, 0)), mat((0.7, 0.7, 0.7)))]
    # a shared-vertex mesh: rows with vertex normals (trianglenorm) and
    # rows without (triangle)
    rng = np.random.default_rng(11)
    verts = rng.uniform(-0.8, 0.8, (24, 3)) + np.array([5.0, 3.4, 1.5])
    norms = rng.normal(size=(24, 3)) + np.array([0.0, 0.0, -3.0])
    norms /= np.linalg.norm(norms, axis=1, keepdims=True)
    vi = rng.integers(0, 24, (16, 3))
    ni = np.where(np.arange(16)[:, None] % 2 == 0, vi, -1)
    tris = np.concatenate([vi, ni, np.full((16, 2), -1)], axis=1)
    items.append(P.tex(P.mesh(verts, norms, tris), mat((0.9, 0.6, 0.3))))
    # a retexture difference, B surfaces flipped and retextured
    items.append(P.difference(
        P.tex(P.box((3.2, -3.0, -0.5), (4.8, -1.8, 0.5)), mat((1, 0, 1))),
        P.tex(P.sphere((3.4, -2.4, -0.4), 0.7), mat((0, 1, 1)))))
    lights = (P.light((0, 6, -8), (80, 80, 80)),)
    cam = P.camera((0.3, 0.4, -11.0), (0, 0.2, 0), (0, 1, 0), 55.0)
    return P.group(items), lights, cam
