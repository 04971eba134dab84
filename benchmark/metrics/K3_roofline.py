"""K3 (csrc/mesh_block_select.cu): the roofline share of each profiled
frame's first K3 launch, the level-0 intersect of every primary ray
against the external triangle group; its bytes bound it (_roofline.py:
262,144 rays x 36 B + 262,144 triangles x 36 B in the tetra cell)."""

from benchmark.metrics._roofline import share_pct


def read(run):
    return share_pct(run, r"(?<![A-Za-z0-9_])mesh_block_select_kernel")
