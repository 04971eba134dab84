"""aa.AARenderer.render: the self time of the program's spans
aa.variance (passes 2-4's decisions, pass 5's corner variance, the final
combine; the mask planes built inside them are left out), ms per frame
over the traced window."""

from benchmark.metrics._spans import mean_ms


def read(run):
    return mean_ms(run, "aa.variance", "aa", self_time=True)
