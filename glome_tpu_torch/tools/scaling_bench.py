"""Sharding overhead of the port's ray-sharded frame: the repository's
tools/scaling_bench.py with its ranks sharing one card.

    python -m glome_tpu_torch.tools.scaling_bench [--device cuda|cpu]
        [--counts 1,2,4,8] [--rays 262144] [--reps 7] [--out PATH]
        [--timeout S]

The reference runs N virtual XLA devices pinned to one core and traces
a fixed global batch on each mesh, so the total work is constant, the
ideal N-device time is the one-device time, and efficiency t(1) / t(N)
isolates what the mesh adds (tools/scaling_bench.py:1-18).  Here each
count N is N rank processes (gloo, one card, every rank on cuda:0):
every rank joins the group (parallel.init_distributed), builds
make_mesh(N) and times parallel.sharded_render_fn on the reference's
workload (tools/scaling_bench.py:43-72):

- simple_scene() with its lights() and cust_cam(), compile_scene, a
  WavefrontTracer at maxdepth 3 on the megakernel route (K1 on every
  level's intersect and shadow batch);
- a fixed global batch of --rays rays from Renderer.rays_for_pixels at
  pixel coordinates drawn by np.random.default_rng(0), uniform over
  720 x 480;
- one warm-up frame, then --reps timed frames, frame r with the
  origins shifted by 1e-5 * (r + 1); the median, minimum and maximum.

The one-rank case goes through the same function on a one-rank mesh.
A frame's time is taken alike on every rank: dist.barrier() and a
synchronize, then the host clock around the call and a synchronize (the
call ends in the all-gather, so every rank ends with the whole frame);
the frame's time is the largest over the ranks (an all-reduce MAX).
Every rank also times its two all-gathers per frame, between
synchronizes: rank 0's time, and the least over the ranks, which is
the last rank in's and so the collective's own cost without the wait
for the others.

Two series, both from one launch of each count:

- "1core" (the headline, the reference's mode): after its set-up every
  rank pins all its threads to one core, the same for every rank, as
  the reference's `taskset -c 0` does, so the ranks' host work also
  runs one rank after another;
- "core_per_rank": rank r on its own core r (counts above the host's
  cores are skipped and read null), so a reader can tell the per-rank
  host floor from the collective's cost.

A rank runs on one core in both, so its intra-op thread pool is one
thread.  Set-up is not timed and runs on every core.

Gates, on every count and series; any failure exits 1 and prints no
payload:

- each rank's gathered (rgb, t) of the warm-up and the last timed frame
  equals the one-rank frame on every ray (max |diff| 0);
- every rank selected K1 exactly K1_PER_FRAME times a frame and
  nothing else: 2 * maxdepth, an intersect and a shadow batch per
  level, empty or not (the tracer's compiled frame runs every level, an
  empty one as a batch of dead lanes): on the card kernel launches and
  no plain call, on the CPU plain calls and no launch (tools/bench.py's
  launch counters), so every rank selected the same number;
- zero overflow;
- no rank imported jax, glome_tpu or the root tools/.

Output: one stderr line per count and series in the reference's form,
"# N ranks: X ms [lo..hi] (R rays, 1 core)", with the all-gather's ms
and the K1 launches per rank per frame; the last stdout line is one JSON
payload with every key of the repository's SCALING.json (mode, n_rays,
reps, devices, ms, ms_spread, efficiency_vs_1dev, note; efficiency
t(1) / t(N), unrounded), the second series' ms_core_per_rank,
ms_spread_core_per_rank and efficiency_core_per_rank_vs_1, the
all-gather's ms by series, each rank's K1 launches, and backend, device
and power_limit_w as tools/bench.py prints them.  The payload also goes
to --out (default build/scaling.json), the ranks' frames and reports
beside it in <out stem>_ranks/.  SCALING.json is the reference's run
and is never written.

On the card unless --device cpu (for the tests: CPU tensors through
K1's plain version, the host clock; not a device number).  --device
cuda without a card raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from . import bench
from .sharded import ROOT, launch

N_RAYS = 262144         # the global batch, fixed across rank counts
REPS = 7
COUNTS = (1, 2, 4, 8)
XRES, YRES = 720, 480   # the pixel range the rays are drawn from
MAXDEPTH = 3
SHIFT = 1e-5            # frame r's origins move by SHIFT * (r + 1)
MODE = "shared-card-gloo-fixed-global-batch-1core"
SERIES = ("1core", "core_per_rank")
# K1 selections a frame: an intersect and a shadow batch per level.
# simple_scene reflects and refracts nothing, so levels 1 and 2 hold no
# ray; the compiled frame still runs them, as batches of dead lanes, and
# on the CPU the plain version is called for every batch
K1_PER_FRAME = {"cuda": 2 * MAXDEPTH, "cpu": 2 * MAXDEPTH}
RANK_MODULE = "glome_tpu_torch.tools.scaling_bench"
# the repository's SCALING.json keys, then the port's own
SCALING_KEYS = ("mode", "n_rays", "reps", "devices", "ms", "ms_spread",
                "efficiency_vs_1dev", "note")
ADDED_KEYS = ("ms_core_per_rank", "ms_spread_core_per_rank",
              "efficiency_core_per_rank_vs_1", "allgather_ms",
              "allgather_last_rank_ms", "k1_launches") + bench.DEVICE_KEYS
NOTE = ("every rank count on one card, each rank a process joined over "
        "gloo (CUDA tensors cross the all-gather through host copies), "
        "all ranks pinned to ONE host core after set-up, with a fixed "
        "global batch: ideal efficiency is exactly 1.0; the shortfall is "
        "the sharded path's overhead (each rank's per-batch host floor, "
        "the host-staged all-gather, imbalance). ms_core_per_rank gives "
        "rank r its own core r. Not multi-card scaling: that needs NCCL "
        "with one rank per card.")


def log(msg: str):
    print(f"# {msg}", file=sys.stderr, flush=True)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--counts", default=",".join(map(str, COUNTS)))
    ap.add_argument("--rays", type=int, default=N_RAYS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "scaling.json"))
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for each rank count's processes")
    # a rank's own (launch appends --rank and --port)
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    return ap


def rank_dir(out):
    """Where the ranks leave their frames and reports: <out stem>_ranks."""
    return os.path.splitext(out)[0] + "_ranks"


def rank_file(out, n, rank):
    return os.path.join(rank_dir(out), f"n{n}_rank{rank}.pt")


# -- a rank ---------------------------------------------------------------------

def setup(device, n_rays):
    """The reference's workload (tools/scaling_bench.py:43-72): (tracer,
    arrays, o, d) of simple_scene at maxdepth 3 and n_rays rays at
    default_rng(0) pixel coordinates over 720 x 480."""
    import glome_tpu_torch as T
    from ..scenes.testscene import cust_cam, lights, simple_scene
    compiled = T.compile_scene(simple_scene(), lights())
    tracer = T.WavefrontTracer(compiled, T.RenderConfig(maxdepth=MAXDEPTH))
    renderer = T.Renderer(tracer, cust_cam(), T.RenderConfig())
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, XRES, n_rays).astype(np.float32)
    ys = rng.uniform(0, YRES, n_rays).astype(np.float32)
    o, d = renderer.rays_for_pixels(xs, ys, device)
    return tracer, T.to_torch(compiled.arrays(), device), o, d


class Overflow:
    """The tracer as sharded_render_fn calls it, summing every trace's
    overflow counters on the device (read once the frames are done)."""

    def __init__(self, tracer):
        self.tracer, self.total = tracer, 0

    def trace(self, arrays, o, d):
        res = self.tracer.trace(arrays, o, d)
        self.total = self.total + res.overflow.sum()
        return res


def pin(core):
    """Every thread of this process onto `core`, and torch's intra-op
    pool to one thread (threads started later inherit the affinity)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), {core})
        except ProcessLookupError:      # the thread has ended
            pass
    torch.set_num_threads(1)


def time_series(render, arrays, o, d, reps, device, ag_s):
    """One series: a warm-up frame, then `reps` timed frames.  Returns
    (frame ms, the largest over the ranks; rank 0's all-gather ms; the
    least all-gather ms over the ranks; the warm-up and last frames as
    (n, 4) rgb | t)."""
    import torch.distributed as dist

    def frame(shift):
        rgb, t = render(arrays, o + shift, d)
        return torch.cat([rgb, t[:, None]], dim=1)
    warm = frame(0.0)
    bench.sync(device)
    ms, ag0, ag_min = [], [], []
    for r in range(reps):
        shift = float(np.float32(SHIFT * (r + 1)))
        dist.barrier()
        bench.sync(device)
        ag_s.clear()
        t0 = time.perf_counter()
        last = frame(shift)
        bench.sync(device)
        dt = time.perf_counter() - t0
        # the frame's time on the slowest rank, the all-gathers' on the
        # rank that waited least (MAX of the negated time)
        stat = torch.tensor([dt, -sum(ag_s)], dtype=torch.float64)
        dist.all_reduce(stat, op=dist.ReduceOp.MAX)
        ms.append(float(stat[0]) * 1e3)
        ag0.append(sum(ag_s) * 1e3)
        ag_min.append(-float(stat[1]) * 1e3)
    return ms, ag0, ag_min, warm.cpu(), last.cpu()


def worker(args):
    """One rank: set up, then each series (pinned), then save its report
    and frames to rank_file(out, nprocs, rank)."""
    import torch.distributed as dist
    from ..parallel import init_distributed, make_mesh, sharded_render_fn
    from ..parallel import mesh as PM
    device = torch.device("cuda", 0) if args.device == "cuda" else \
        torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_distributed(f"localhost:{args.port}", args.nprocs, args.rank,
                     backend="gloo")
    try:
        mesh = make_mesh(args.nprocs)
        tracer, arrays, o, d = setup(device, args.rays)
        counted = Overflow(tracer)
        render = sharded_render_fn(counted, mesh)
        ag_s = []
        all_gather = PM._all_gather

        def timed_all_gather(x, m):
            bench.sync(device)
            t0 = time.perf_counter()
            out = all_gather(x, m)
            bench.sync(device)
            ag_s.append(time.perf_counter() - t0)
            return out
        # sharded_render_fn looks _all_gather up at each call
        PM._all_gather = timed_all_gather
        cores = sorted(os.sched_getaffinity(0))
        report = {"rank": args.rank, "world": args.nprocs, "cores": cores,
                  "series": {}}
        frames = {}
        for series in SERIES:
            if series == "core_per_rank" and args.nprocs > len(cores):
                continue          # the same answer on every rank
            pin(cores[0] if series == "1core" else cores[args.rank])
            before = bench.snapshot()
            ms, ag0, ag_min, frames[f"{series}_warm"], \
                frames[f"{series}_last"] = time_series(
                    render, arrays, o, d, args.reps, device, ag_s)
            launches, plain = bench.snapshot()
            report["series"][series] = {
                "ms": ms, "allgather_ms": ag0, "allgather_min_ms": ag_min,
                "launches": {k: launches[k] - before[0][k]
                             for k in bench.KERNELS},
                "plain": {k: plain[k] - before[1][k] for k in bench.KERNELS}}
        report["overflow"] = int(counted.total)
        # JAX or the reference package, had this rank imported them
        report["foreign_modules"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "glome_tpu", "tools"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save({"report": report, "frames": frames},
               rank_file(args.out, args.nprocs, args.rank))
    return 0


# -- the launcher -----------------------------------------------------------------

class GateError(RuntimeError):
    """A count failed its gates."""


def gate(n, ranks, one, device, reps):
    """Raise GateError unless every rank of count n holds the one-rank
    frames, selected K1 exactly K1_PER_FRAME times a frame and nothing
    else, and overflowed nowhere."""
    want = (reps + 1) * K1_PER_FRAME[device.type]
    errors = []
    for rep in ranks:
        r = rep["report"]
        if r["overflow"]:
            errors.append(f"rank {r['rank']}: overflow {r['overflow']}")
        if r["foreign_modules"]:
            errors.append(f"rank {r['rank']} imported "
                          f"{r['foreign_modules']}")
        for series, s in r["series"].items():
            ran, other = ((s["launches"], s["plain"]) if device.type == "cuda"
                          else (s["plain"], s["launches"]))
            if ran != {**dict.fromkeys(bench.KERNELS, 0), "K1": want} or any(
                    other.values()):
                errors.append(f"rank {r['rank']} {series}: selections {ran}, "
                              f"other {other}, want K1 {want} alone")
            for which in ("warm", "last"):
                got = rep["frames"][f"{series}_{which}"]
                ref = one["frames"][f"{series}_{which}"]
                if not torch.equal(got, ref):
                    diff = (got - ref).abs().nan_to_num(float("inf"))
                    errors.append(
                        f"rank {r['rank']} {series} {which} frame: max "
                        f"|diff| {float(diff.max()):.6g} on "
                        f"{int((got != ref).any(dim=1).sum())} rays")
    if errors:
        raise GateError(f"{n} ranks: " + "; ".join(errors))


def spread(ms):
    """(median, min, max) of a series' frame ms, as the reference reads
    them."""
    s = sorted(ms)
    return s[len(s) // 2], s[0], s[-1]


def main(argv=None):
    """Run every count, gate it, print the lines and the payload; 0, or 1
    when a count's ranks or gates failed."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("scaling_bench: no CUDA device (--device cpu "
                           "runs the plain K1 on the CPU)")
    if args.rank is not None:
        return worker(args)
    counts = [int(c) for c in args.counts.split(",")]
    if counts[0] != 1 or counts != sorted(set(counts)):
        raise ValueError(f"--counts {args.counts}: increasing, from 1")
    if any(args.rays % n for n in counts):
        raise ValueError(f"--rays {args.rays} does not split over {counts}")
    device = torch.device("cuda", 0) if args.device == "cuda" else \
        torch.device("cpu")
    name, limit = bench.device_info(device)
    if device.type == "cuda":
        # K1's library once here, not by every rank at once
        from .. import kernels
        kernels.build(kernels.MEGA_SOURCES, "glome_mega")
    shutil.rmtree(rank_dir(args.out), ignore_errors=True)
    os.makedirs(rank_dir(args.out))
    rank_argv = ["--device", args.device, "--rays", str(args.rays),
                 "--reps", str(args.reps), "--out", args.out]
    res = {s: {} for s in SERIES}
    k1, one = {}, None
    for n in counts:
        t0 = time.perf_counter()
        rc = launch(rank_argv + ["--nprocs", str(n)], n, args.timeout,
                    module=RANK_MODULE)
        log(f"{n} ranks: exit {rc} after {time.perf_counter() - t0:.1f} s "
            f"with process start")
        if rc:
            log(f"SCALING FAILED: {n} ranks exited {rc}")
            return 1
        ranks = [torch.load(rank_file(args.out, n, r)) for r in range(n)]
        if one is None:
            one = ranks[0]
        try:
            gate(n, ranks, one, device, args.reps)
        except GateError as e:
            log(f"SCALING FAILED: {e}")
            return 1
        k1[str(n)] = [sum(s["launches"]["K1"] for s in
                          r["report"]["series"].values()) for r in ranks]
        for series, s in ranks[0]["report"]["series"].items():
            med, lo, hi = spread(s["ms"])
            ag, ag_last = (spread(s[k])[0] for k in ("allgather_ms",
                                                     "allgather_min_ms"))
            res[series][n] = {"ms": med, "spread": [lo, hi], "ag": ag,
                              "ag_last": ag_last}
            sel = (s["launches"] if device.type == "cuda" else s["plain"])
            log(f"{n} ranks: {med:.3f} ms [{lo:.3f}..{hi:.3f}] "
                f"({args.rays} rays, "
                f"{'1 core' if series == '1core' else '1 core per rank'}); "
                f"all-gather {ag:.3f} ms at rank 0, {ag_last:.3f} ms at the "
                f"last rank in ({100 * ag / med:.1f}% / "
                f"{100 * ag_last / med:.1f}% of the frame); "
                f"K1 {sel['K1'] / (args.reps + 1):g} "
                f"{'launches' if device.type == 'cuda' else 'plain calls'} "
                f"per rank per frame")

    def col(series, key):
        """Each count's `key` in a series, None where it did not run."""
        return [res[series][n][key] if n in res[series] else None
                for n in counts]

    def eff(series):
        ms = col(series, "ms")
        return {str(n): None if m is None else ms[0] / m
                for n, m in zip(counts, ms)}
    payload = {
        "mode": MODE, "n_rays": args.rays, "reps": args.reps,
        "devices": counts, "ms": col("1core", "ms"),
        "ms_spread": dict(zip(map(str, counts), col("1core", "spread"))),
        "efficiency_vs_1dev": eff("1core"), "note": NOTE,
        "ms_core_per_rank": col("core_per_rank", "ms"),
        "ms_spread_core_per_rank": dict(zip(map(str, counts),
                                            col("core_per_rank", "spread"))),
        "efficiency_core_per_rank_vs_1": eff("core_per_rank"),
        "allgather_ms": {s: col(s, "ag") for s in SERIES},
        "allgather_last_rank_ms": {s: col(s, "ag_last") for s in SERIES},
        "k1_launches": k1,
        "backend": device.type, "device": name, "power_limit_w": limit}
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
