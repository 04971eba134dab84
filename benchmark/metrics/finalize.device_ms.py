"""The fused finalize (csrc/finalize_hit.cu): the device ms of its
launches per profiled frame (one a level's intersect batch), from the
profiler's kernel events; None where the profile holds no launch of it
(a program without the kernel, or a frame that ran the torch ops)."""

from benchmark.harness.profile import kernel_launches


def read(run):
    if run.prof is None:
        return None
    per_frame = kernel_launches(run.prof,
                                r"(?<![A-Za-z0-9_])finalize_hit_kernel")
    if not any(per_frame):
        return None
    ns = sum(b - a for frame in per_frame for a, b in frame)
    return ns / 1e6 / len(per_frame)
