"""K1 (csrc/mega_select.cu): the roofline share of each profiled
frame's level-0 intersect launch; its bytes bound it (_roofline.py)."""

from benchmark.metrics._roofline import share_pct


def read(run):
    return share_pct(run, r"(?<![A-Za-z0-9_])mega_select_kernel")
