"""aa: the rays the AA frame asked for (the sum of last_ray_counts over
its five passes) over the frame's pixels, averaged over the window."""


def read(run):
    if run.entry != "aa" or not run.rays:
        return None
    return sum(sum(r.values()) for r in run.rays) / (len(run.rays)
                                                     * run.pixels)
