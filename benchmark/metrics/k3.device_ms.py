"""K3 (csrc/mesh_block_select.cu): the device ms of its launches per
profiled frame (every level's intersect and shadow batch), from the
profiler's kernel events; None where the profile holds no K3 launch."""

from benchmark.harness.profile import kernel_launches


def read(run):
    if run.prof is None:
        return None
    per_frame = kernel_launches(run.prof,
                                r"(?<![A-Za-z0-9_])mesh_block_select_kernel")
    if not any(per_frame):
        return None
    ns = sum(b - a for frame in per_frame for a, b in frame)
    return ns / 1e6 / len(per_frame)
