"""The command as the benchmark runs it: no result without a card or
without the program, and one correct result line on the card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import manifest as M


def run(cwd, *extra, timeout=900):
    cmd = [sys.executable, "benchmark/run.py", "--workload",
           "testscene-still", "--seed", str(2 ** 31 + 5), "--seconds", "2",
           "--trace", "0", *extra]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = run(M.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    # a directory that holds only BENCHMARK.json and the benchmark's files
    shutil.copytree(os.path.join(M.ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(M.ROOT, "BENCHMARK.json"), tmp_path)
    proc = run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = run(M.ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) >= {"frame_ms", "setup_s"}
    assert list(out)[-1] == "checks"
