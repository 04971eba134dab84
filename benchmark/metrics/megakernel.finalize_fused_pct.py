"""megakernel (pack, finalize, shading): the share of the finalize calls
that ran the fused kernel (csrc/finalize_hit.cu): the program's counter
megakernel.finalize_fused (the kernel's launches) over it plus
megakernel.finalize_torch (the calls that ran the differentiable torch
ops), each summed over the traced window, times 100; None where no frame
counts them (a program without the fused kernel) or no finalize ran."""

from benchmark.metrics._spans import count_sum


def read(run):
    fused = count_sum(run, "megakernel.finalize_fused")
    unfused = count_sum(run, "megakernel.finalize_torch")
    if fused is None or unfused is None or fused + unfused == 0:
        return None
    return 100.0 * fused / (fused + unfused)
