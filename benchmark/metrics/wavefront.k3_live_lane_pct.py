"""trace_wavefront.WavefrontTracer: the share of K3's lanes that K3
tests, the program's counters k3.live_lanes over k3.lanes summed over
the traced window's launches, in %.  A K3 launch runs its batch's lanes
(the static width in the compiled frame); a lane is live to K3 where
its seed is above 0: a live ray of the group's scene, in a shadow batch
one that K1 and K2 left unblocked.  A program that records no K3 launch
reads as nothing."""

from benchmark.metrics._spans import count_sum


def read(run):
    lanes = count_sum(run, "k3.lanes")
    live = count_sum(run, "k3.live_lanes")
    if not lanes or live is None:
        return None
    return 100.0 * live / lanes
