"""No run loads JAX or the JAX package, compared by whole top-level
names, and the plain reference loads nothing of the program."""

import json
import os
import subprocess
import sys

from benchmark.harness import guard
from benchmark.harness import manifest as M


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_loaded({"glome_tpu_torch", "glome_tpu_torch.aa",
                                   "numpy", "jaxtyping", "flaxen"}) == []
    assert guard.forbidden_loaded({"glome_tpu.render", "numpy"}) == [
        "glome_tpu"]
    assert guard.forbidden_loaded({"jax", "jaxlib.xla_client", "flax.nn",
                                   "glome_tpu"}) == ["flax", "glome_tpu",
                                                     "jax", "jaxlib"]


def _python(code: str, timeout=600):
    env = dict(os.environ, PYTHONPATH=M.ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=M.ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


RUN = """
import json, sys, time, torch
from benchmark.harness import core
args = core.parse(["--workload", "testscene-still", "--seed", "3",
                   "--seconds", "0.5", "--trace", "0"])
out = core.run(args, time.perf_counter(), device=torch.device("cpu"),
               sizes={"xres": 24, "yres": 16, "warmup_frames": 1,
                      "check_from_first": 1, "check_frames": 1,
                      "check_pixels": 64})
print(json.dumps({"correct": out["correct"],
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""

REFERENCE = """
import json, sys, numpy as np, torch
from benchmark.harness import manifest as M
from benchmark.reference import Reference
man = M.load()
ref = Reference(M.config(man, "testscene"), 24, 16, "cpu")
rgb, t = ref.pixels(ref.cam.fwd, np.arange(0, 24 * 16, 7))
print(json.dumps({"finite": bool(np.isfinite(rgb).all()),
                  "modules": sorted(sys.modules)}))
"""


def test_a_run_loads_no_jax_and_no_glome_tpu():
    out = _python(RUN)
    assert out["correct"] is True
    assert "glome_tpu_torch" in out["modules"]
    assert guard.forbidden_loaded(out["modules"]) == []


def test_the_reference_loads_nothing_of_the_program():
    out = _python(REFERENCE)
    assert out["finite"]
    assert not [m for m in out["modules"]
                if m.split(".")[0] in ("glome_tpu_torch", "glome_tpu")]
    assert guard.forbidden_loaded(out["modules"]) == []
    # nor anything of the harness's program side
    assert "benchmark.harness.program" not in out["modules"]
