"""render.Renderer.render: each frame's wall less the wall of its call
into Tracer.trace (the harness's spans, synced at both edges), averaged
over the traced window: the numpy ray set-up, the scatter back and the
copy to the host."""


def read(run):
    if run.entry != "render" or not run.outside_s:
        return None
    return 1e3 * sum(run.outside_s) / len(run.outside_s)
