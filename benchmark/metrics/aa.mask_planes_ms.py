"""aa.AARenderer.render: the program's spans aa.mask_planes (the static
mask planes, built in numpy and uploaded every frame), ms per frame over
the traced window."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "aa.mask_planes", "aa")
