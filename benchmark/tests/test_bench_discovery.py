"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and manifest entries in a copy of the benchmark are found by
name and run, with no file that was there edited."""

import hashlib
import json
import os
import shutil
import time

import torch

from benchmark.harness import core
from benchmark.harness import manifest as M


def digest(root):
    out = {}
    for d, _dirs, files in os.walk(os.path.join(root, "benchmark")):
        if "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def write(path, obj):
    with open(path, "w") as f:
        if isinstance(obj, str):
            f.write(obj)
        else:
            json.dump(obj, f)


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(M.ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(M.ROOT, "BENCHMARK.json"), root)
    before = digest(root)

    conf = M.config(M.load(root), "testscene", root)
    conf.update(name="testscene_small", xres=24, yres=16,
                reduced=["xres", "yres"])
    write(os.path.join(root, "benchmark/configs/testscene_small.json"), conf)
    mix = dict(M.traffic("still", root), warmup_frames=1, check_from_first=1,
               check_frames=1, check_pixels=32)
    write(os.path.join(root, "benchmark/traffic/still_short.json"), mix)
    write(os.path.join(root, "benchmark/limits/small-still.json"),
          M.limits("testscene-still", root))
    write(os.path.join(root, "benchmark/metrics/harness.frames_seen.py"),
          "def read(run):\n    return float(run.frames)\n")

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"].append({"name": "testscene_small", "source":
                           conf["source"], "file":
                           "benchmark/configs/testscene_small.json",
                           "reduced": ["xres", "yres"], "why": "a test"})
    man["workloads"].append({"name": "small-still",
                             "config": "testscene_small",
                             "traffic": "still_short", "chips": 1,
                             "why": "a test"})
    man["per_layer"].append({"name": "harness.frames_seen", "unit": "frames",
                             "better": "higher", "source": "host_clock",
                             "layer": "harness", "moves": "setup_s",
                             "workloads": ["small-still"]})
    write(os.path.join(root, "BENCHMARK.json"), man)

    args = core.parse(["--workload", "small-still", "--seed", "9",
                       "--seconds", "0.2", "--trace", "1"])
    out = core.run(args, time.perf_counter(), device=torch.device("cpu"),
                   root=root)
    assert out["correct"] is True
    assert out["metrics"]["harness.frames_seen"]["value"] >= 1
    after = digest(root)
    assert all(after[k] == v for k, v in before.items())
