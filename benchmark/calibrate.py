"""The readings a cell's limits are set from (not run by the benchmark).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out build/cal.json]

In one process, at the cell's own sizes: the program's entry is set up
once, and for each seed the first frames of that seed's window run
through the same entry as a run's window does, and are compared with the
plain reference on that seed's check plan (the lower readings), and, where every frame has
its own offset, each checked frame's predecessor is compared in its place
(the fault of a frame that hands back the one before it).  For each
control seed the control (the reference with its scene's numbers and
rays in bfloat16, computed in float32) is compared with the reference on
the same plan (the upper readings).  Prints one JSON line per seed and a summary: the largest
program reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark.harness import check as CK  # noqa: E402
from benchmark.harness import core  # noqa: E402
from benchmark.harness import manifest as M  # noqa: E402
from benchmark.harness import traffic as TR  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def readings(workload, prog_seeds, control_seeds, device=None, sizes=None):
    manifest = M.load()
    cell = M.cell(manifest, workload)
    conf = M.config(manifest, cell["config"])
    mix = dict(M.traffic(cell["traffic"]))
    sizes = dict(sizes or {})
    xres = sizes.pop("xres", conf["xres"])
    yres = sizes.pop("yres", conf["yres"])
    mix.update(sizes)
    if device is None:
        if not core.cuda_ready(cell["chips"]):
            raise SystemExit(3)
        device = torch.device("cuda", 0)
    core.cache_dirs()
    from benchmark.harness.program import Entry
    from benchmark.reference import Reference
    entry = Entry(conf, mix["entry"], device, xres, yres)
    warm = TR.Offsets(mix, prog_seeds[0], TR.WARMUP)
    for i in range(int(mix["warmup_frames"])):
        entry.frame(warm[i])
    ref = Reference(conf, xres, yres, device)
    n = int(mix["check_from_first"])
    rows = []
    for seed in prog_seeds:
        t0 = time.perf_counter()
        offsets = TR.Offsets(mix, seed, TR.WINDOW)
        kept = [entry.frame(offsets[i]) for i in range(n)]
        answers = core.reference_frames(ref, mix, seed, n)
        parts = core.compare_kept(kept, answers, mix)
        rows.append({"side": "program", "seed": seed, **CK.merge(parts),
                     "seconds": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
        if mix.get("jitter", "per_frame") == "per_frame":
            # the fault of a frame that hands back the one before it
            stale = [kept[i - 1] if i else kept[1] for i in range(n)]
            parts = core.compare_kept(stale, answers, mix)
            rows.append({"side": "fault_stale", "seed": seed,
                         **CK.merge(parts)})
            print(json.dumps(rows[-1]), flush=True)
    entry.free()
    if control_seeds:
        ctl = Reference(conf, xres, yres, device, control=True)
        tol = core.tolerances(mix)
        for seed in control_seeds:
            t0 = time.perf_counter()
            want = core.reference_frames(ref, mix, seed, n)
            got = core.reference_frames(ctl, mix, seed, n)
            parts = [CK.compare(g[2], g[3], w[2], w[3], tol)
                     for g, w in zip(got, want)]
            rows.append({"side": "control", "seed": seed, **CK.merge(parts),
                         "seconds": time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
    return rows, summarize(rows, CK.NUMBERS)


def summarize(rows, names):
    """Each number's largest program reading and smallest reading of
    every other side."""
    out = {}
    for k in names:
        out[k] = {"program_max": max((r[k] for r in rows
                                      if r["side"] == "program"),
                                     default=None)}
        for side in sorted({r["side"] for r in rows} - {"program"}):
            out[k][f"{side}_min"] = min(r[k] for r in rows
                                        if r["side"] == side)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--out")
    a = p.parse_args(argv)
    rows, summary = readings(a.workload, a.seeds, a.control_seeds)
    print(json.dumps({"workload": a.workload, "summary": summary}),
          flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
