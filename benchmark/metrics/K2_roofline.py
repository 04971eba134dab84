"""K2 (csrc/block_select.cu): the roofline share of each profiled
frame's first K2 launch, the level-0 intersect of every primary ray
against the block group; its bytes bound it (_roofline.py)."""

from benchmark.metrics._roofline import share_pct


def read(run):
    return share_pct(run, r"(?<![A-Za-z0-9_])block_select_kernel")
