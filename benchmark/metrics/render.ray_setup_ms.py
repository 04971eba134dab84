"""render.Renderer.render: the program's span render.ray_setup (np.mgrid,
tile_order, the offsets, rays_for_pixels with its upload: everything up
to the first trace call), ms per frame over the traced window."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "render.ray_setup", "render")
