"""graphs (the compiled frame): segments captured during the window
(GraphCache.totals["captures"]), per 1,000 frames.  A capture is a
stall: the segment is warmed up and recorded instead of replayed."""


def read(run):
    if run.frames == 0:
        return None
    return 1e3 * run.captures / run.frames
