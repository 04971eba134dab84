"""The one generator of every traffic mix: a mix is data
(benchmark/traffic/<name>.json) and this module turns it and a seed into
the inputs a run hands the program and the reference.

A frame of a still mix is the entry's frame at the configuration's camera
moved by a sub-pixel offset (dx, dy), drawn uniformly from the mix's
`jitter_px` interval: a viewer refining a still view.  The offset moves
the camera's forward vector by (dx, dy) pixels of the camera plane, so
every primary ray of the frame moves by the same amount (a pixel is
2 / yres of the plane, render.pixel_coords).

Streams: every use draws from its own numpy Generator seeded with
(seed, stream), so the window's frames do not depend on how many warm-up
frames or checks a run makes.
"""

from __future__ import annotations

import numpy as np

WARMUP, WINDOW, CHECK, TILES = 0, 1, 2, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    return np.random.default_rng([int(seed), stream])


class Offsets:
    """The frames' sub-pixel offsets of one stream, in order: offsets[i]
    is frame i's (dx, dy), the same for the same seed whatever is asked
    first.  A mix with "jitter": "per_run" holds one offset, drawn from
    the window's stream, for every frame of the run, warm-up included: a
    still view at a seeded sub-pixel position."""

    BLOCK = 256

    def __init__(self, traffic: dict, seed: int, stream: int):
        self.lo, self.hi = (float(v) for v in traffic["jitter_px"])
        self.per_run = traffic.get("jitter", "per_frame") == "per_run"
        self._rng = rng(seed, WINDOW if self.per_run else stream)
        self._have = np.zeros((0, 2))

    def __getitem__(self, i: int):
        if self.per_run:
            i = 0
        while i >= len(self._have):
            more = self._rng.uniform(self.lo, self.hi, size=(self.BLOCK, 2))
            self._have = np.concatenate([self._have, more])
        return tuple(float(v) for v in self._have[i])


def shifted_fwd(fwd, right, up, yres: int, dx: float, dy: float):
    """The forward vector that moves every primary ray by (dx, dy) pixels:
    the ray of pixel (x, y) is norm(fwd - xc * right + yc * up) with
    xc growing by 2 / yres per pixel in x and yc falling by 2 / yres per
    pixel in y (render.pixel_coords)."""
    step = 2.0 / yres
    return (np.asarray(fwd, np.float64)
            - step * dx * np.asarray(right, np.float64)
            - step * dy * np.asarray(up, np.float64))


def check_plan(traffic: dict, seed: int, frames_done: int, n_pixels: int):
    """The checked frames (indices into the window's frames, drawn from
    the first `check_from_first` frames and capped by the frames done) and
    each one's sampled pixel indices (flat, row-major; all of them when
    the mix checks whole frames)."""
    g = rng(seed, CHECK)
    pool = max(1, min(int(traffic["check_from_first"]), frames_done))
    k = min(int(traffic["check_frames"]), pool)
    idx = sorted(int(i) for i in g.choice(pool, size=k, replace=False))
    want = traffic.get("check_pixels")
    out = []
    for i in idx:
        if want is None or int(want) >= n_pixels:
            px = np.arange(n_pixels)
        else:
            px = np.sort(g.choice(n_pixels, size=int(want), replace=False))
        out.append((i, px))
    return out


def check_tiles(traffic: dict, seed: int, xres: int, yres: int, size: int):
    """The origins (x0, y0) of the AA tiles a mix with `check_tiles`
    checks, drawn from the seed among the frame's size x size tiles (the
    last row and column of tiles pad the frame), in raster order."""
    ntx, nty = -(-xres // size), -(-yres // size)
    k = min(int(traffic["check_tiles"]), ntx * nty)
    pick = sorted(int(i) for i in rng(seed, TILES).choice(ntx * nty, size=k,
                                                          replace=False))
    return [((i % ntx) * size, (i // ntx) * size) for i in pick]


def tile_pixels(tiles, xres: int, yres: int, size: int):
    """The flat row-major indices of the frame's pixels in the tiles, tile
    by tile, each tile's in raster order."""
    out = []
    for x0, y0 in tiles:
        ys, xs = np.mgrid[y0:min(y0 + size, yres), x0:min(x0 + size, xres)]
        out.append((ys * xres + xs).reshape(-1))
    return np.concatenate(out)
