"""megakernel (pack, finalize, shading): the program's counter
megakernel.table_packs (the builds of the select tables a trace call
made: one a batch in the eager frame, one a call in the compiled
frame), summed over the traced window, per window frame; None where no
frame counts it."""

from benchmark.metrics._spans import count_sum, window


def read(run):
    packs = count_sum(run, "megakernel.table_packs")
    if packs is None:
        return None
    return packs / len(window(run))
