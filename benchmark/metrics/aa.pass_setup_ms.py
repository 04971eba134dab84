"""aa.AARenderer.render: the program's spans aa.pass_setup (each pass's
compact_indices, whose torch.nonzero waits for the device, its pixel
coordinates and primary rays, and the index_copy of its results back:
all but the trace call), ms per frame over the traced window."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "aa.pass_setup", "aa")
