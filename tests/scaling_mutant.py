"""A rank of glome_tpu_torch.tools.scaling_bench with one fault, named by
the SCALING_MUTANT environment variable.  tests/test_torch_scaling.py
runs it as the harness's rank module (scaling_bench.RANK_MODULE):

  zero_shard   rank 1 returns its shard zeroed (rgb and t);
  extra_plain  every rank makes one more plain K1 call per trace;
  raises       rank 1 raises in its first trace.

It imports torch and the port only, as the harness's own ranks do.
"""

import os
import sys

import torch

import glome_tpu_torch as T
from glome_tpu_torch import megakernel as MK
from glome_tpu_torch.config import INFINITY
from glome_tpu_torch.tools import scaling_bench as SB


def _rank(argv):
    return int(argv[argv.index("--rank") + 1])


def mutant_tracer(kind, rank):
    class Mutant(T.WavefrontTracer):
        def trace(self, arrays, o, d, *a, **k):
            if kind == "raises" and rank == 1:
                raise RuntimeError("mutant: rank 1 raises")
            if kind == "extra_plain":
                tables = MK.pack_tables(MK.get_plan(self.compiled),
                                        self.compiled, arrays)
                ray = torch.cat([o[:1], d[:1]], dim=1).t()
                MK.mega_select_plain(tables, torch.cat(
                    [ray, torch.tensor([[INFINITY], [0.0]])]).contiguous())
            res = super().trace(arrays, o, d, *a, **k)
            if kind == "zero_shard" and rank == 1:
                res = res._replace(color=torch.zeros_like(res.color),
                                   t=torch.zeros_like(res.t))
            return res
    return Mutant


if __name__ == "__main__":
    T.WavefrontTracer = mutant_tracer(os.environ["SCALING_MUTANT"],
                                      _rank(sys.argv))
    sys.exit(SB.main())
