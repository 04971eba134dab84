"""render.Renderer.render: the program's span render.scatter (the
inverse permutation and its upload, cat, the gather, reshape, clamp:
everything after the last trace call), ms per frame over the traced
window."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "render.scatter", "render")
