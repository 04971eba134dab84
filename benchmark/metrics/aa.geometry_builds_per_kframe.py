"""aa.AARenderer.render: the program's counter aa.geometry_builds (1 in a
frame that built the AA stencil's static geometry, 0 in a frame that
found it built), summed over the traced window, per 1,000 window
frames; None where no frame counts it."""

from benchmark.metrics._spans import count_sum, window


def read(run):
    builds = count_sum(run, "aa.geometry_builds")
    if builds is None:
        return None
    return 1e3 * builds / len(window(run))
