"""aa.AARenderer.render: each frame's wall less the walls of its five
calls into Tracer.trace (the harness's spans, synced at both edges),
averaged over the traced window: the variance planes, the per-pass ray
set-up and the copy to the host."""


def read(run):
    if run.entry != "aa" or not run.outside_s:
        return None
    return 1e3 * sum(run.outside_s) / len(run.outside_s)
