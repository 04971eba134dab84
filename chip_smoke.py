#!/usr/bin/env python3
"""Smoke test of glome_tpu_torch on one CUDA GPU.

Drives the port's main paths through the entry points a user calls
(compile_scene -> to_torch -> WavefrontTracer or Tracer ->
Renderer.render or AARenderer.render; SoftTracer + optimize for
BASELINE config 5; the CLI, python -m glome_tpu_torch.app, and ray
sharding over torch.distributed) with
the hand-written CUDA kernels K1 (csrc/mega_select.cu), K2
(csrc/block_select.cu) and K3 (csrc/mesh_block_select.cu) on the
megakernel route, and K4 (csrc/dense_select.cu) and K5
(csrc/bvh_select.cu) on the pass-per-group route
(WavefrontTracer(route=intersect.GROUPS), on TestScene and on the 100k
mesh), the fused finalize (csrc/finalize_hit.cu: megakernel.finalize's
Hit in one launch per intersect batch on the megakernel route, a port
kernel with no Pallas counterpart), and the card microbenchmarks
M1 (csrc/micro_prims.cu) and M2 (csrc/micro_kwide.cu) through their
tools' entry points (python -m glome_tpu_torch.tools.micro_prims /
micro_kwide), and checks them in phases:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: all eight libraries (K1-K5, M1, M2, the fused finalize)
     from the sources in this
     checkout, one nvcc each, all started together (build seconds, ptxas
     register and spill counts), and the native BVH builder
     (glome_tpu_torch/native/bvh_builder.cpp, g++; its version and build
     seconds);
  3. K1 against mega_select_plain on the card, on the all-phase-kinds
     scene, the CSG scene, TestScene's 345,600 primary rays (L0) and the
     200-sphere chain (phasescene.chain_scene: a bvh2 tree of depth 47,
     walked with a plan-sized stack), intersect and shadow; and the
     TestScene compiled frame's own six K1 batches (each level's
     intersect and fused shadow table at its static width, recorded from
     its capture frame's warm-ups) on every lane, the dead lanes exactly;
  4. TestScene frame: 720x480, depth 3, through the kernels: 6 K1
     launches and 3 finalize_hit launches, no K2-K5 launch, no plain call
     and no torch finalize, zero overflow, and within the drift canaries
     of out/testscene_tpu.png;
  5. TestScene plain-path frame: 180x120 through the plain set
     (megakernel.PLAIN) on the card, against the kernel frame and
     tests/golden/testscene_180x120_cpu.png under the same canaries;
  6. TestScene timing with CUDA events: the frame and one K1 launch
     against one plain launch on the L0 batch; then K1's cost per phase
     on the L0 batch and the first shadow batch
     (glome_tpu_torch.tools.kernel_ab.attribution: the launch timed with
     phases >= k switched off in a copy of the descriptor table, for
     every k, by tools.device_time);
  7. K2 against block_select_plain on the card, equal on every checked
     lane, winners included: K2 launched on all 1920x1080 L0 rays of
     mesh_scene(100_000) (intersect) and on all its shadow rays with
     cast_shadows=True, as the frame launches it, and held against the
     plain version on a 65,536-lane subset; the 700-sphere scene of
     glome_tpu's tests/test_block.py (plain, with a difference
     constraint, and 300 rotated boxes) with BLOCK_MIN lowered to 256;
     a 320-sphere chain whose block tree is 80 deep; and the flat quad
     grid of phasescene.tie_grid_scene, whose rays tie rows exactly;
  8. K3 against mesh_block_select_plain likewise, on the L0 and shadow
     rays of mesh_scene(250_000) and on the tie grid;
  9. mesh frames: mesh_scene(100_000) at 1920x1080, depth 1, with and
     without cast_shadows (K1 + K2), and mesh_scene(250_000) with
     cast_shadows (K1 + K3): launch counts, no plain call, zero
     overflow, a finite image, and every 8th pixel against the same
     scene rendered through the plain set at 240x135 (the same rays)
     under the canaries; each frame is a compiled tracer's capture
     frame, and every K1, K2 and K3 call it made is held against the
     plain version on its own static-width inputs: a 65,536-lane subset
     spread over the batch, and every dead lane exactly (the plain
     version on 4,096 of them, whose inputs are all the same);
 10. mesh timing with CUDA events: the 100k frames (ms, primary
     Mrays/s), one K2 and one K3 launch on their L0 batches against one
     plain launch on the 65,536-ray subset, each mesh through both
     kernels interleaved (K2, K3, K3, K2), the SM clock sampled around
     each timing, and one profiled 100k frame (device busy share, K2's
     share);
 11. bounds: each kernel's least time on the card for its measured
     launch -- the larger of its bytes (inputs read once, outputs written
     once) over 3.35 TB/s and the float32 work of the box and prim tests
     its rays actually made (counted by a tallying build of the kernel;
     K1 also counts its clause work, point-in-node tests and member
     inside tests) over 67 TFLOP/s; and the tallies of each mesh through
     the other kernel: K3's box + triangle tests per ray are at most 1.1x
     K2's on the same rays; K4 is also timed and bounded on one of
     TestScene's one-prim groups ("one_prim_*" in its entry);
 12. K4 against dense_select_plain on the card: K4 launched on every
     dense group of TestScene with all 345,600 L0 rays and all their
     shadow rays, held against the plain version on the whole batch; and
     on every dense group of the all-phase-kinds and CSG scenes and of
     block_scene's difference and rotated-box scenes (65,536 rays);
 13. K5 against bvh_select_plain, equal on every lane, winners
     included: on TestScene's two lattice groups (one with an inline
     constraint; all L0 rays and all their shadow rays), on the
     20,000-sphere group of phasescene.sphere_cloud_scene, on the
     1,000-sphere chain of phasescene.coincident_scene (a skip-link chain
     250 leaves long, whose converted tree is reported: every hit ties
     all 1,000 rows) and on the tie grid as a K5 group; then the
     coincident chain rendered at 96x64 on the group route through the
     kernels against the plain set, under the canaries;
 14. TestScene frame 720x480 depth 3 on the group route through K4/K5:
     per intersect or shadow batch one K4 launch per dense group and one
     K5 launch per BVH group of the compiled scene (7 and 2), no K1-K3
     launch, no plain call, zero overflow, and within the canaries of
     out/testscene_tpu.png and of phase 4's megakernel-route frame;
 15. TestScene 180x120 on the group route through the plain set
     (megakernel.PLAIN) on the card, against
     tests/golden/testscene_180x120_cpu.png (glome_tpu's CPU group
     route made it);
 16. group-route timing with CUDA events and the SM clock sampled: the
     720x480 frame, one K4 launch on the cone group's L0 batch and one K5
     launch on the 2,816-sphere group's, each against one plain launch,
     and one profiled frame (device busy share, K4's and K5's shares);
 17. M1 on the card: micro_prims.main() at the tool's size (256 tiles,
     262,144 rays) launches every variant's kernel (each > 0 times, no
     plain call) and times it (tools.device_time, the SM clock sampled);
     then every variant against its plain version on the same inputs,
     bit-equal except f_mxu128 (rtol / atol 1e-4 on >= 99.9% of rays, its
     3xTF32 tensor-core product), the plain version's time, each
     variant's bound from the sphere tests its tiles made, its issue
     floor (the SASS instructions of its hot loop per test, from
     cuobjdump -sass of the built library, times the tests, over the
     SMs x 128 lanes x the sampled SM clock), its grid and ptxas figures,
     its launch floor (tools.device_time of a kernel of the same grid
     that only stores its output; near the time of e, f and vread), and
     a's step against b's test (the share of a's block-wide vote);
 18. M2 likewise through micro_kwide.main(): the K-wide walk at K = 1, 2,
     4, 8, 16 (visited nodes per tile, exactly the plain version's) and
     the scratch reads at NREAD = 16, 64;
 19. TestScene 720x480 depth 3 through the recursive Tracer
     (glome_tpu_torch/trace.py) on K1: one K1 launch per intersect or
     shadow batch (Tracer.last_batches), no other kernel, no plain call,
     within the canaries of out/testscene_tpu.png and of phase 4's
     wavefront frame; frame ms (CUDA events, mean of 3 after a warm-up);
 20. phasescene.warp_lights_scene, a portal whose target scene has its
     own two lights (the wavefront tracer refuses it), 320x240 depth 3
     through Tracer on the kernels against the plain set, under the
     canaries;
 21. the adaptive-AA frame of TestScene at 720x480 (AARenderer over the
     WavefrontTracer): per-pass ray counts, pass 1 exactly 1/8 of the
     tile-padded frame, at most 2 rays/px, zero overflow, a finite image,
     K1 launches and no plain call, ms per frame (CUDA events, mean of 3
     after a warm-up); and a 180x120 AA frame through the kernels against
     the plain set under the canaries;
 22. BASELINE config 5 at 180x120 through
     glome_tpu_torch/tools/config5_e2e.py's functions: the AA target,
     three Adam steps of the 8x-pooled soft loss with a checkpoint at
     step 2 and at the end, then a resumed run that continues from step
     3 (K1 launches of that one step; no plain call); finite losses, ms
     per step and peak memory; the perturbed row's gradient after
     only_group finite and nonzero on its center and radius and zero on
     every other leaf, and within 1e-3 of the largest |g| of the same
     gradient through the plain set; the forward + backward with and
     without the soft pass and K1's device time in a profiled step; the
     first loss printed beside the TPU reference's losses[0]
     (out/config5/config5_result.json), not gated;
 23. the CLI, glome_tpu_torch.app.main(argv) in-process as
     `python -m glome_tpu_torch.app` runs it on the card (its default
     device), writing into a temporary directory: --scene test at
     720x480, depth 3, --iters 3: 6 K1 launches per frame, no plain
     call, zero overflow, the PNG within the canaries of
     out/testscene_tpu.png; its set-up seconds (compile_scene, to_torch,
     the tracer) and each render's seconds;
 24. the app's --aa frame at 720x480: 30 K1 launches, pass 1 = 50,700
     rays, at most 2 rays/px (printed);
 25. picks: --pick 360 240, and a PickSession over the card's tensors
     run on a hit (the dodecahedron at 136 204), a miss, an invalid line
     and 'q'; tags, prim serials and the session's replies equal those of
     the same picks through the plain set (megakernel.PLAIN);
 26. the work maps --debug (torch only, no kernel) and --debug-full
     (K1) at 720x480: seconds, the mean and max of prims and nodes; at
     180x120 the --debug-full counts through the kernels equal those
     through the plain set, and the --debug counts on the card those on
     CPU tensors;
 27. tests/fixtures/{miniflake,gears}.nff through the app at their own
     96x64, depth 2, against tests/golden/*_rgb.npy under the canaries
     (max |diff| printed);
 28. ray sharding (glome_tpu_torch.parallel) through
     python -m glome_tpu_torch.tools.sharded: two gloo ranks sharing the
     card, each its own process importing only torch and
     glome_tpu_torch: the TestScene 720x480 depth-3 frame through
     sharded_render_fn against phase 23's single-process frame (max
     |diff| <= 1e-5, every 8-bit value equal; 6 K1 launches per rank),
     and one sharded_train_step_fn step of the two-prim scene of
     glome_tpu's tests/test_sharding.py against the single-process
     full-batch step (rtol 1e-5; the loss equal on both ranks);
 29. mesh_scene(100_000) at 1920x1080, depth 1, on the pass-per-group
     route (WavefrontTracer(route=GROUPS)): the ground plane through K4,
     the 99,904 smooth triangles through K5 over the native builder's
     skip-link tree.  The set-up apart on the host clock (compile_scene,
     the group's bounds, the native build_bvh, the numpy builder once on
     the same bounds with its tables bit-equal to the native ones,
     skip_link_pairs + node_records, the records' upload); the frames
     with and without cast_shadows (K4 1 and K5 1 per batch, no K1-K3
     launch, no plain call, zero overflow, within the canaries of phase
     9's megakernel-route frame of the same scene), ms per frame by CUDA
     events, mean of 3 after a warm-up; K5 launched on all L0 rays and
     all their shadow rays and equal to its plain version on every lane
     of a 65,536-lane subset of each, winners included; K5's ms per
     launch on the L0 batch and its bound from the tally;
 30. the frame-profiling tool (glome_tpu_torch/tools/profile_frame.py,
     python -m glome_tpu_torch.tools.profile_frame) on nine workloads:
     the eager frame of the TestScene 720x480 depth-3 frame on each
     route, of the mesh100k 1080p self-shadowing frame on each route,
     of the 720x480 AA frame and of one config 5 step at 180x120; and
     the compiled frame of the TestScene frame and the mesh100k
     self-shadowing frame (as bench's frames: the trace of rays built
     once) and of the AA frame.  Each gets the tool's one report: ms by
     CUDA events (mean of 3 after a warm-up), then one run profiled, its
     device busy time, kernels' ms, launches and the program's spans
     with the device busy ms while each is open.  Gates: the K1-K5
     launches of the profiled run, by the wrappers' counters, are the
     path's (6 K1 per TestScene frame; 7 K4 + 2 K5 per batch of the
     group-route frame; 2 K1 + 2 K2 per mesh frame on the megakernel
     route; 1 K4 + 1 K5 per batch on the group route; 30 K1 per AA
     frame; 6 K1 per config 5 step), no plain call; the run opened
     wavefront.trace and every span row's device ms, "(outside any
     span)" too, is within the profiler's device busy time; a compiled
     frame equals the eager frame and a replay frame captures nothing;
 31. the benchmark report, run right after phase 2 (the libraries
     built): python -m glome_tpu_torch.tools.bench as a subprocess, the
     port of the repository's bench.py (the TestScene headline, the
     mesh100k 1080p frames without and with self-shadowing and the
     720x480 AA frame, each gated on its warm-up frame as phases 4, 9
     and 21 gate theirs).  It must exit 0 and print one JSON line with
     every key of bench.py's line plus backend ("cuda"), device and
     power_limit_w, every timing positive; the line is printed here,
     and each section's K1-K5 launches (which the bench gates) go into
     the kernels line's launches_by_path as "bench_<section>";
 32. the scaling harness, run last:
     python -m glome_tpu_torch.tools.scaling_bench as a subprocess, the
     port of the repository's tools/scaling_bench.py (simple_scene,
     262,144 rays, depth 3, through parallel.sharded_render_fn on 1, 2,
     4 and 8 gloo ranks sharing the card; every rank pinned to one core,
     then rank r on core r).  It must exit 0, its gates held (each
     rank's gathered frame equal to the one-rank frame on every ray, 6
     K1 launches per rank per frame (simple_scene's deeper levels are
     empty, and the compiled frame runs them as batches of dead lanes)
     and no plain call, zero overflow),
     and print one JSON payload with every key of SCALING.json plus the
     port's own, every reading positive; each count's line (with the
     all-gather's share) and the payload are printed here, and each
     rank's K1 launches go into the kernels line's launches_by_path as
     "scaling_n<N>_rank<r>".  Then K1 at the harness's shapes:
     simple_scene's first-level batch of 262,144 rays, one rank's
     32,768 of 8 and the first shadow batch against the plain version
     (as phase 3 holds K1), its ms and plain ms on the 262,144 rays, and
     its bound from the tally, as the kernels line's "scaling_*" keys.
 33. the compiled frame (graphs.py; WavefrontTracer(frame=COMPILED), the
     tracers' default, which phases 4, 9, 21 and 23-32 already run;
     phases 3 and 9 hold K1, K2 and K3 against their plain versions on
     the compiled frame's own inputs, recorded from its capture frame's
     warm-ups: the static-width tables with their dead lanes; phase 30
     profiles one replay frame of TestScene, mesh100k and AA):
     compiled and eager frames in turns on the same inputs -- TestScene
     720x480 depth 3 through Renderer.render and as bench's frame
     (tracer.trace on rays built once), the 1080p mesh frames as bench's
     (100k without and with self-shadowing, 250k) and the 720x480 AA
     frame.  Gates: every compiled frame equal to the eager frame,
     zero captures after the first frame, and the capture frame's and a
     replay frame's launches as the eager frame's (6 K1; 2 K1 + 1 / 2
     K2; 2 K1 + 2 K3; 30 K1; and one finalize_hit an intersect batch:
     3, 1, 1, 15), no plain call and no torch finalize, each under
     "compiled_<frame>[_capture]" in launches_by_path.
     Prints each frame's replay and eager ms (medians in turns), the
     capture frame's seconds, captures and host reads per frame, the
     level widths and the graph pools' bytes beside
     torch.cuda.max_memory_allocated.
 34. SPD balls at size factor 5 (scenes/spd_balls.balls: 66,430 spheres
     in one group, which the plan routes to K2, the floor fan in K1),
     512x512 depth 3 through Renderer.render on the compiled frame:
     every K1 and K2 call of its capture frame held against its plain
     version on that call's own static-width inputs, on every lane
     (intersect: hit, t and winner; shadow: the blocked mask), and the
     frame's launches (6 K1 + 6 K2: each level's intersect and shadow
     batch; 3 finalize_hit), counts reset just before it, under
     "spd_balls5_512" in launches_by_path; then phase 33's gates on the
     same frame (compiled = eager on every lane, zero captures after the
     first).
 35. the fused finalize (csrc/finalize_hit.cu) against the torch
     finalize (megakernel._finalize_torch) on the compiled frame's own
     finalize inputs: each level's (o, d, t, wid, aux) of the TestScene
     720x480 depth-3 frame and of the SPD balls size-5 512x512 frame,
     recorded from the capture frame's warm-ups (static widths, dead
     lanes included).  Every field of the Hit bit for bit on every lane,
     and its layouts; the capture frame's and a replay frame's launches,
     counts reset just before each (3 finalize_hit, no torch finalize),
     under "finalize_<scene>[_capture]" in launches_by_path; then the
     kernel's ms on TestScene's level-0 call (CUDA events) against the
     torch ops' on the same inputs, and its bound: the lanes' bytes (rays,
     t, wid and aux read once, the Hit written once) over 3.35 TB/s.
 36. SPD tetra at tetra.c's SizeFactor 9 (scenes/spd_tetra.tetra(8):
     262,144 flat triangles in one group, which the plan routes to K3,
     K1 left with no primitive), 512x512 depth 3 through Renderer.render
     on the compiled frame, the benchmark's spd-tetra-262k-still frame:
     plan.external == [(0, 0)] and no K2 group; every K1 and K3 call of
     its capture frame held against its plain version on that call's own
     static-width inputs, on every lane, and every finalize call's fused
     Hit against megakernel._finalize_torch on the same inputs, bit for
     bit (the flat-triangle rows of an external group read in place);
     the capture frame's and a replay frame's launches, counts reset
     just before each (6 K1 + 6 K3: each level's intersect and shadow
     batch; 3 finalize_hit, no plain call, no torch finalize), under
     "spd_tetra8_512[_capture]" in launches_by_path; K3's level-0 ms by
     CUDA events against its bytes bound (36 B a ray and a triangle over
     3.35 TB/s); then phase 33's gates on the same frame (compiled =
     eager on every lane, zero captures after the first).

Phases 10, 16 and 22 take their profiled frame and per-launch
host/device split from the same tool (profile_kernels, launch_split).

Kernel against plain: K2, K3 and K5 equal their plain versions on
every lane (hit or blocked, t bit for bit, and the winner: each takes
the lowest row of an exact tie).  K1 and K4: hit/blocked agree on >=
99.9% of lanes, t within rtol 5e-5 / atol 1e-4 on >= 99.9% of the
agreeing lanes, and the winner differs beyond a distance tie on <= 0.1%
of lanes.

Each kernel's entry in the kernels line also carries "ptxas": the
registers, stack frame and spills ptxas gave its normal (non-counting)
build; K1-K3 and K5 also "smem_bytes", the dynamic shared memory of
their plan-sized walk stacks at the main path's launch (K5's: the
biggest lattice group's).

In the kernels line each M1 and M2 variant is an entry of its own, named
"micro_prims.<variant>" or "micro_kwide.<variant>": it has its own C
entry, launch count, time and bound.

The finalize_hit entry counts launches in megakernel.finalize.fused_calls
(the torch finalize's calls in .torch_calls); it has no plain version
beside it but the torch ops, whose ms is its "torch_ms".

Prints a JSON line of the kernels, then the nvidia-smi name/power-limit
line, then last {"ok": true, "device": {...}}.  Any failed phase, a
missing CUDA device or a missing package exits non-zero and prints no
result.

    python3 chip_smoke.py
"""

import ast
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 5e-5, 1e-4       # tests/test_mega.py:123-124
AGREE_MIN = 0.999
CANARY_MEAN, CANARY_FRAC = 3.0, 0.006   # tests/test_golden.py:129-131
SUBSET = 65536
PLAIN_CHUNK = 262144          # lanes per plain K1 call over a whole batch
DEAD_SAMPLE = 4096            # dead lanes the plain version runs on
DEVICE = ("cuda", 0)
MESH_RES = (1920, 1080)
PLAIN_RES = (240, 135)        # every 8th pixel of MESH_RES: the same rays
SCALING_COUNTS = (1, 2, 4, 8)  # phase 32's rank counts
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, float32 FLOP/s
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
TF32_FLOPS = 495e12           # dense tensor-core TF32 (the same data sheet)
# float32 operations of one test (csrc/walk.cuh box_live; prims.cuh
# triangle_t and sphere_t, the cheapest prim: a lower bound for K1's mix)
BOX_FLOPS, TRI_FLOPS, MIN_PRIM_FLOPS = 25, 60, 21
# K1's clause work: a point-in-node test (csrc/mega_select.cu
# point_in_node, six compares) and a member inside test (prims.cuh
# inside_comp; the cheapest, a box's or a plane's, six operations)
POINT_FLOPS, MIN_MEMBER_FLOPS = 6, 6


def canaries(got, want):
    """(mean per-pixel max-channel |diff| in levels, fraction of pixels
    off by more than 64 levels)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    return float(diff.mean()), float((diff > 64).mean())


def canaries_ok(name, got, want):
    mean, frac = canaries(got, want)
    ok = mean <= CANARY_MEAN and frac <= CANARY_FRAC
    print(f"  canaries {name}: mean {mean:.4f} levels (<= {CANARY_MEAN}), "
          f"{100 * frac:.4f}% pixels > 64 (<= {100 * CANARY_FRAC}%) "
          f"-> {'ok' if ok else 'FAIL'}")
    return ok


def compare(name, kern, plain, shadow, exact=False):
    """A kernel's (t, winner, ...) against its plain version's, as numpy.
    exact: every lane must agree -- hit or blocked, and in intersect
    mode t bit for bit and the winner (no near-tie difference)."""
    tk, wk = kern[0], kern[1]
    tp, wp = plain[0], plain[1]
    n = len(tk)
    hk, hp = wk >= 0, wp >= 0
    agree = hk == hp
    frac = float(agree.mean()) if n else 1.0
    word = "blocked" if shadow else "hit"
    print(f"  {name}: {n} rays, {int(hp.sum())} {word} (plain), "
          f"{word} disagree on {int((~agree).sum())} lanes "
          f"({100 * (1 - frac):.4f}%)")
    ok = frac >= AGREE_MIN
    if exact:
        ok = bool(agree.all())
    if shadow:
        return ok, 0.0
    close = np.isclose(tk, tp, rtol=RTOL, atol=ATOL)
    n_agree = max(int(agree.sum()), 1)
    t_out = int((agree & ~close).sum())
    wid_bad = int((agree & (wk != wp) & ~close).sum())
    wid_tie = int((agree & (wk != wp) & close).sum())
    both = hk & hp
    max_err = float(np.abs(tk[both] - tp[both]).max()) if both.any() else 0.0
    print(f"    t outside rtol {RTOL}/atol {ATOL}: {t_out} of {n_agree} "
          f"agreeing lanes; max |dt| on common hits {max_err:.6g}; "
          f"winner differs at near-ties {wid_tie}, beyond ties {wid_bad}")
    if exact:
        same_t = bool(np.array_equal(tk, tp))
        print(f"    exact: t bit-equal on every lane {same_t}, winners "
              f"differ on {wid_tie + wid_bad} lanes")
        return ok and same_t and wid_tie + wid_bad == 0, max_err
    ok = ok and t_out <= (1 - AGREE_MIN) * n_agree \
        and wid_bad <= (1 - AGREE_MIN) * n
    return ok, max_err


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "glome_tpu_torch")):
        print("chip_smoke: glome_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import glome_tpu_torch as T
    from glome_tpu_torch import block_kernel as BK
    from glome_tpu_torch import group_kernels as GK
    from glome_tpu_torch.intersect import GROUPS, MEGA, bvh_args, dense_args
    from glome_tpu_torch import kernels
    from glome_tpu_torch import megakernel as MK
    from glome_tpu_torch import mesh_kernel as MSH
    from glome_tpu_torch import native as NAT
    from glome_tpu_torch.compile import (group_accel,
                                         materialize_scene_params)
    from glome_tpu_torch.io import quantize, read_png, write_png
    from glome_tpu_torch.scenes import mesh_scene, test_scene
    from glome_tpu_torch.tools import bench as BENCH
    from glome_tpu_torch.tools import config5_e2e as C5
    from glome_tpu_torch.tools import kernel_ab as KAB
    from glome_tpu_torch.tools import micro_kwide as MKW
    from glome_tpu_torch.tools import micro_prims as MPR
    from glome_tpu_torch.tools import profile_frame as PF
    from glome_tpu_torch.tools import scaling_bench as SB
    from glome_tpu_torch.tools.device_time import device_time
    from glome_tpu_torch.render import camera
    from glome_tpu_torch.scenes.phasescene import (block_rays, block_scene,
                                                   chain_rays, chain_scene,
                                                   coincident_scene,
                                                   csg_rays, csg_scene,
                                                   phase_kinds_lights,
                                                   phase_kinds_rays,
                                                   phase_kinds_scene,
                                                   sphere_cloud_scene,
                                                   tie_grid_rays,
                                                   tie_grid_scene,
                                                   warp_lights_scene)
    from glome_tpu_torch.graphs import COMPILED, EAGER
    from glome_tpu_torch.trace import _light_arrays
    from glome_tpu_torch.trace_wavefront import shadow_rays

    dev = torch.device(*DEVICE)
    failed = []
    entries = {
        "mega_select": {"name": "mega_select", "route": "cuda",
                        "source": "glome_tpu_torch/csrc/mega_select.cu",
                        "replaces": "glome_tpu/megakernel.py:686"},
        "block_select": {"name": "block_select", "route": "cuda",
                         "source": "glome_tpu_torch/csrc/block_select.cu",
                         "replaces": "glome_tpu/block_kernel.py:225"},
        "mesh_block_select": {
            "name": "mesh_block_select", "route": "cuda",
            "source": "glome_tpu_torch/csrc/mesh_block_select.cu",
            "replaces": "glome_tpu/mesh_kernel.py:105"},
        "dense_select": {"name": "dense_select", "route": "cuda",
                         "source": "glome_tpu_torch/csrc/dense_select.cu",
                         "replaces": "glome_tpu/pallas_kernels.py:363"},
        "bvh_select": {"name": "bvh_select", "route": "cuda",
                       "source": "glome_tpu_torch/csrc/bvh_select.cu",
                       "replaces": "glome_tpu/pallas_kernels.py:558"},
        # no Pallas counterpart: it replaces the XLA ops of finalize
        "finalize_hit": {"name": "finalize_hit", "route": "cuda",
                         "source": "glome_tpu_torch/csrc/finalize_hit.cu",
                         "replaces": "glome_tpu/megakernel.py:1542"}}
    # the microbenchmarks: each variant is a kernel of its own (its own C
    # entry, wrapper and launch count), replacing one Pallas body of the
    # tool's (tools/micro_prims.py:65 mk, tools/micro_kwide.py:47 / :138)
    micro_tools = {"micro_prims": MPR, "micro_kwide": MKW}
    micro_libs = {"micro_prims": "glome_micro_prims",
                  "micro_kwide": "glome_micro_kwide"}
    micro_bodies = {"a_vote_while": 82, "b_dense_fori": 99, "c_gate8": 111,
                    "c_gate16": 111, "c_gate32": 111, "d_bits168": 130,
                    "e_lane8x128": 168, "f_mxu128": 196}
    micro_kernels = {}
    for key, tool in micro_tools.items():
        for v in tool.VARIANTS:
            name = f"{key}.{v.name}"
            line = (micro_bodies[v.name] if key == "micro_prims"
                    else 47 if v.name.startswith("walk") else 138)
            micro_kernels[name] = v
            entries[name] = {"name": name, "route": "cuda",
                             "source": f"glome_tpu_torch/csrc/{key}.cu",
                             "replaces": f"tools/{key}.py:{line}"}
    for e in entries.values():
        e["library_ms"] = None        # no single PyTorch call computes it
        e["launches_by_path"] = {}
    kernel_fns = {"mega_select": MK.mega_select,
                  "block_select": BK.block_select,
                  "mesh_block_select": MSH.mesh_block_select,
                  "dense_select": GK.dense_select,
                  "bvh_select": GK.bvh_select}
    plain_fns = (MK.mega_select_plain, BK.block_select_plain,
                 MSH.mesh_block_select_plain, GK.dense_select_plain,
                 GK.bvh_select_plain) + MPR.PLAIN + MKW.PLAIN

    def phase(title, fn):
        print(f"== {title}", flush=True)
        t0 = time.perf_counter()
        try:
            ok = fn()
        except Exception:
            traceback.print_exc(file=sys.stdout)
            ok = False
        print(f"  -> {'ok' if ok else 'FAILED'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if not ok:
            failed.append(title)
        return ok

    def reset_counts():
        torch.cuda.synchronize()
        for fn in kernel_fns.values():
            fn.launches = 0
        for v in micro_kernels.values():
            v.kernel.launches = 0
        for fn in plain_fns:
            fn.calls = 0
        MK.finalize.fused_calls = MK.finalize.torch_calls = 0

    def read_counts(path):
        """Launch counts since reset_counts, recorded under `path`."""
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in kernel_fns.items()}
        counts.update((k, v.kernel.launches) for k, v in micro_kernels.items())
        counts["finalize_hit"] = MK.finalize.fused_calls
        for k, c in counts.items():
            entries[k]["launches_by_path"][path] = c
        m1, m2 = (sum(c for k, c in counts.items() if k.startswith(t + "."))
                  for t in micro_tools)
        counts["plain"] = sum(fn.calls for fn in plain_fns)
        counts["finalize_torch"] = MK.finalize.torch_calls
        print(f"  launches: K1 {counts['mega_select']}, K2 "
              f"{counts['block_select']}, K3 {counts['mesh_block_select']}, "
              f"K4 {counts['dense_select']}, K5 {counts['bvh_select']}, "
              f"M1 {m1}, M2 {m2}, finalize_hit {counts['finalize_hit']}, "
              f"plain calls {counts['plain']}, torch finalize calls "
              f"{counts['finalize_torch']}")
        return counts

    def cuda_ms(fn, reps, warm=1):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    def clocks():
        """The card's SM clock, its maximum, power draw and temperature
        now, as nvidia-smi reads them."""
        try:
            return subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                 "power.draw,temperature.gpu", "--format=csv,noheader"],
                capture_output=True, text=True,
                timeout=60).stdout.strip()
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"not read ({e})"

    def l0_batch(cam, xres, yres):
        """Primary rays of an xres x yres frame in tile order, as the
        (8, N) table the tracer's first level intersects."""
        return KAB.l0_batch(cam, xres, yres, dev)

    def subset(n):
        """SUBSET lane indices spread evenly over n lanes."""
        return torch.linspace(0, n - 1, min(n, SUBSET),
                              device=dev).to(torch.int64)

    def as_np(out):
        return [None if a is None else a.cpu().numpy() for a in out]

    # -- 1. device ---------------------------------------------------------
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = []
        print(f"nvidia-smi: {e}")
    smi_line = smi[0] if smi else ""
    kind = torch.cuda.get_device_name(0)

    def p_device():
        print(f"  {smi_line}")
        print(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
              f"{torch.cuda.device_count()} device(s), device 0: {kind}")
        return bool(smi_line)
    phase("1 device", p_device)

    # -- 2. build ----------------------------------------------------------
    def p_build():
        t0 = time.perf_counter()
        # the native BVH builder (g++, no fallback) beside the nvcc runs
        with ThreadPoolExecutor(1) as pool:
            native = pool.submit(NAT.get_lib)
            paths = kernels.load_all()
            native.result()
        print(f"  {len(paths)} nvcc runs and one g++ run in parallel: "
              f"{time.perf_counter() - t0:.2f} s wall")
        info = NAT.BUILD_INFO
        print(f"  {os.path.relpath(info['path'], ROOT)}: "
              f"{NAT.cxx_path()} {' '.join(NAT.CXX_FLAGS)}, "
              f"{info['seconds']:.2f} s; "
              f"{info['version'].splitlines()[0]}")
        for name, path in zip(kernel_fns, paths):
            # K1-K5 come first, in kernel_fns order (kernels.LIBRARIES);
            # the normal build (kTally = false, ILb0E) of each
            figs = kernels.ptxas_figures(kernels.BUILD_INFO[path]["log"])
            entries[name]["ptxas"] = next(
                f for fn, f in figs.items()
                if name + "_kernel" in fn and "ILb0E" in fn)
        figs = kernels.ptxas_figures(kernels.BUILD_INFO[kernels.library_path(
            "glome_finalize")]["log"])
        entries["finalize_hit"]["ptxas"] = next(
            f for fn, f in figs.items() if "finalize_hit_kernel" in fn)
        for path in paths:
            info = kernels.BUILD_INFO[path]
            print(f"  {os.path.relpath(path, ROOT)}: nvcc "
                  f"{info['seconds']:.2f} s")
            for line in info["log"].splitlines():
                # each kernel's two builds (_Z...ILb0E: normal, ILb1E:
                # counting), then their registers and spills
                if ("entry function" in line or "registers" in line
                        or "spill" in line):
                    print(f"    ptxas: {line.strip()}")
        return True
    if not phase("2 build", p_build):
        return 1

    # -- 31. the benchmark report (a subprocess, on the built libraries) ----
    def p_bench():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "glome_tpu_torch.tools.bench"], cwd=ROOT,
            capture_output=True, text=True, timeout=900)
        for line in proc.stderr.splitlines():
            print(f"  {line}")
            # each section's launches of its warm-up frame, which the
            # bench gates, go into the kernels line under "bench_<section>"
            m = re.match(r"# (\S+): launches (\{.*?\}), plain calls", line)
            if m:
                counts = ast.literal_eval(m.group(2))
                for name, k in zip(kernel_fns, BENCH.KERNELS):
                    entries[name]["launches_by_path"][
                        f"bench_{m.group(1)}"] = counts[k]
        lines = proc.stdout.splitlines()
        print(f"  exit {proc.returncode} after "
              f"{time.perf_counter() - t0:.1f} s, {len(lines)} stdout lines")
        if len(lines) != 1:
            return False
        print(f"  [{smi_line}] bench: {lines[0]}")
        line = json.loads(lines[0])
        missing = [k for k in BENCH.KEYS + BENCH.DEVICE_KEYS
                   if k not in line]
        timed = [k for k in BENCH.KEYS
                 if k.endswith(("_ms_per_frame", "_Mrays_per_s",
                                "compile_s")) or k == "value"]
        bad = [k for k in timed if k in line and not line[k] > 0]
        print(f"  missing keys {missing}, readings <= 0 {bad}")
        return (proc.returncode == 0 and not missing and not bad
                and line["backend"] == "cuda" and bool(line["device"]))
    phase("31 bench: python -m glome_tpu_torch.tools.bench", p_bench)

    # -- TestScene -----------------------------------------------------------
    solid, lights, cam = test_scene()
    t0 = time.perf_counter()
    compiled = T.compile_scene(solid, lights)
    plan = MK.get_plan(compiled)
    print(f"TestScene: {plan.n_prims} prims, {len(plan.phases)} phases, "
          f"{plan.n_scenes} scenes, host compile+plan "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    arrays = T.to_torch(compiled.arrays(), dev)
    cfg = T.RenderConfig.tuned()
    n_px = cfg.xres * cfg.yres
    Q0 = l0_batch(cam, cfg.xres, cfg.yres)
    tables = MK.pack_tables(plan, compiled, arrays)

    def both(tabs, rays, shadow):
        k = MK.mega_select(tabs, rays, shadow)
        p = MK.mega_select_plain(tabs, rays, shadow)
        torch.cuda.synchronize()
        return as_np(k), as_np(p)

    # -- the compiled frame's own kernel inputs ----------------------------
    class Tap:
        """A select wrapper standing in for K1, K2 or K3 where the path
        looks it up: it records the inputs of each call made outside a
        CUDA graph capture (a compiled segment's eager warm-up makes
        them; its capture only records them) and calls the wrapper.  Its
        counters are the wrapper's."""

        def __init__(self, name, fn, log):
            self.__dict__.update(name=name, fn=fn, log=log)

        def __call__(self, *args):
            if not torch.cuda.is_current_stream_capturing():
                self.log.append((self.name, [
                    a.clone() if torch.is_tensor(a) else a for a in args]))
            return self.fn(*args)

        def __getattr__(self, k):
            return getattr(self.__dict__["fn"], k)

        def __setattr__(self, k, v):
            setattr(self.fn, k, v)

    tapped = ((MK, "mega_select"), (BK, "block_select"),
              (MSH, "mesh_block_select"))
    plain_of = {"mega_select": MK.mega_select_plain,
                "block_select": BK.block_select_plain,
                "mesh_block_select": MSH.mesh_block_select_plain}
    # where the rays (and the seed) stand in each kernel's arguments
    rays_at = {"mega_select": 1, "block_select": 3, "mesh_block_select": 2}
    seed_at = {"block_select": 4, "mesh_block_select": 3}

    def record_inputs(run):
        """(run()'s result, [(kernel, arguments)] of every K1-K3 call run
        made outside a capture): run on a fresh compiled tracer is its
        capture frame, whose warm-ups launch each segment's kernels
        eagerly on the segment's own inputs at their static widths."""
        log = []
        saved = [getattr(m, n) for m, n in tapped]
        for m, n in tapped:
            setattr(m, n, Tap(n, getattr(m, n), log))
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            for (m, n), f in zip(tapped, saved):
                setattr(m, n, f)
        return out, log

    def lanes_args(name, args, ix):
        """A kernel's arguments with the rays (and seed) cut to lanes ix."""
        a = list(args)
        a[rays_at[name]] = a[rays_at[name]][:, ix].contiguous()
        if name in seed_at:
            a[seed_at[name]] = a[seed_at[name]][ix].contiguous()
        return a

    def check_recorded(label, log, every_lane):
        """Each recorded call's kernel against its plain version on the
        same arguments, as phases 3, 7 and 8 hold them (K1 within its
        agreement and tolerance, K2 and K3 exactly), on every lane
        (every_lane: plain in chunks of PLAIN_CHUNK lanes) or on SUBSET
        lanes spread over the whole batch.  The dead lanes (tmax 0, sid
        -1) are held exactly: every_lane compares each one; otherwise
        the plain version runs on DEAD_SAMPLE of them, whose inputs are
        all the same (o 0, d the guard's unit z, seed 0), must give one
        output, and every dead lane's kernel output must be it."""
        ok = True
        for i, (name, args) in enumerate(log):
            rays, shadow = args[rays_at[name]], args[-1]
            n = rays.shape[1]
            dead = ((rays[6] == 0) & (rays[7] == -1)).cpu().numpy()
            k = as_np(kernel_fns[name](*args))
            if every_lane:
                parts = [as_np(plain_of[name](*lanes_args(
                    name, args, torch.arange(s0, min(s0 + PLAIN_CHUNK, n),
                                             device=dev))))
                         for s0 in range(0, n, PLAIN_CHUNK)]
                p = [None if parts[0][j] is None else
                     np.concatenate([q[j] for q in parts])
                     for j in range(len(parts[0]))]
                kk = k
            else:
                ix = subset(n)
                p = as_np(plain_of[name](*lanes_args(name, args, ix)))
                kk = [None if a is None else a[ix.cpu().numpy()] for a in k]
            mode = "shadow" if shadow else "intersect"
            good, _err = compare(
                f"{label} call {i}: {name} {mode}, {n} lanes "
                f"({int(dead.sum())} dead), "
                f"{'every lane' if every_lane else f'{len(p[0])} lanes'} "
                f"checked", kk, p, shadow, exact=name != "mega_select")
            if every_lane:
                dead_ok = all(a is None or np.array_equal(a[dead], b[dead])
                              for a, b in zip(k, p))
            elif dead.any():
                di = np.flatnonzero(dead)
                di = di[np.linspace(0, len(di) - 1,
                                    min(len(di), DEAD_SAMPLE)).astype(int)]
                pd = as_np(plain_of[name](*lanes_args(
                    name, args, torch.as_tensor(di, device=dev))))
                dead_ok = all(a is None or (len(np.unique(b)) == 1
                                            and bool((a[dead] == b[0]).all()))
                              for a, b in zip(k, pd))
            else:
                dead_ok = True
            print(f"    dead lanes: every output the plain version's "
                  f"{dead_ok}")
            ok &= good and dead_ok
        return ok

    # -- 3. K1 against the plain version ------------------------------------
    def p_compare():
        ok = True
        for name, scene, make_rays, sh_t in (
                ("phase-kinds", phase_kinds_scene, phase_kinds_rays, 20.0),
                ("csg", csg_scene, csg_rays, 9.0)):
            pc = T.compile_scene(scene(), phase_kinds_lights())
            pplan = MK.get_plan(pc)
            ptabs = MK.pack_tables(pplan, pc, T.to_torch(pc.arrays(), dev))
            print(f"  {name}: {len(pplan.phases)} phases, kinds "
                  f"{sorted({ph.kind for ph in pplan.phases})}")
            for shadow, n, seed_t, rseed in ((False, 65536, T.INFINITY, 0),
                                             (True, 65536, sh_t, 3)):
                o, d = make_rays(n, seed=rseed)
                rays = torch.as_tensor(np.stack(
                    [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                     np.full(n, seed_t, np.float32),
                     np.zeros(n, np.float32)]), device=dev).contiguous()
                k, p = both(ptabs, rays, shadow)
                mode = "shadow" if shadow else "intersect"
                ok &= compare(f"{name} {mode}", k, p, shadow)[0]
        k, p = both(tables, Q0, False)
        good, entries["mega_select"]["max_abs_err"] = compare(
            "TestScene L0 intersect", k, p, False)
        ok &= good
        hit = MK.finalize(compiled, plan, arrays, Q0[0:3].t(), Q0[3:6].t(),
                          *(torch.as_tensor(a, device=dev) for a in k))
        lpos, _lcol, lrad = _light_arrays(compiled, arrays, compiled.lights)
        _pre, _segs, sh = shadow_rays(hit, Q0[7], compiled.lights, lpos,
                                      lrad)
        k, p = both(tables, sh.contiguous(), True)
        ok &= compare("TestScene L0 shadow", k, p, True)[0]
        # a bvh2 tree deeper than the fixed 32-entry stack K1 had
        cc = T.compile_scene(chain_scene(), phase_kinds_lights())
        cplan = MK.get_plan(cc)
        ctabs = MK.pack_tables(cplan, cc, T.to_torch(cc.arrays(), dev))
        depth = max(ph.depth for ph in cplan.phases if ph.kind == "bvh2")
        print(f"  200-sphere chain: bvh2 depth {depth}, walk stack "
              f"{MK.walk_stack(cplan)} entries per thread")
        ok &= depth > 32
        o, d = chain_rays(SUBSET)
        for shadow, seed_t in ((False, T.INFINITY), (True, 1.0)):
            rays = torch.as_tensor(np.stack(
                [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                 np.full(SUBSET, seed_t, np.float32),
                 np.zeros(SUBSET, np.float32)]), device=dev).contiguous()
            k, p = both(ctabs, rays, shadow)
            ok &= compare(f"chain {'shadow' if shadow else 'intersect'}", k,
                          p, shadow)[0]
        # the compiled frame's own K1 batches: every level's intersect and
        # fused shadow table at its static width (level 0 at whole rows,
        # the deeper levels on the ladder, the shadow batch L x B with its
        # dead tail), as its capture frame's warm-ups launch them
        _out, log = record_inputs(lambda: T.Renderer(
            T.WavefrontTracer(compiled, cfg, frame=COMPILED), cam,
            cfg).render(arrays))
        print(f"  TestScene compiled frame: {len(log)} K1 batches, widths "
              f"{[a[rays_at[n]].shape[1] for n, a in log]}")
        ok &= (len(log) == 2 * cfg.maxdepth
               and all(n == "mega_select" for n, _a in log)
               and check_recorded("TestScene compiled frame", log, True))
        return ok
    phase("3 K1 vs plain", p_compare)

    # -- 4. the TestScene frame through the kernels -------------------------
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)

    frame_imgs = {}

    def p_frame():
        renderer = T.Renderer(T.WavefrontTracer(compiled, cfg), cam, cfg)
        reset_counts()
        rgb, depth = renderer.render(arrays)
        counts = read_counts("testscene_720x480_depth3")
        ov = int(renderer.last_overflow.sum())
        img = rgb.cpu().numpy()
        finite = bool(np.isfinite(img).all()
                      and torch.isfinite(depth).all().item())
        print(f"  rgb {tuple(img.shape)} finite {finite}, overflow {ov} "
              f"(expected K1 launches {2 * cfg.maxdepth})")
        write_png(os.path.join(out_dir, "testscene_720x480_gpu.png"), img)
        frame_imgs["mega"] = quantize(img)
        ok = canaries_ok("vs out/testscene_tpu.png", quantize(img),
                         read_png(os.path.join(ROOT, "out",
                                               "testscene_tpu.png")))
        return (ok and finite and img.shape == (cfg.yres, cfg.xres, 3)
                and counts["mega_select"] == 2 * cfg.maxdepth
                and all(counts[k] == 0 for k in kernel_fns
                        if k != "mega_select")
                and counts["finalize_hit"] == cfg.maxdepth
                and counts["plain"] == counts["finalize_torch"] == 0
                and ov == 0)
    phase("4 TestScene frame 720x480 depth 3 through the kernels", p_frame)

    # -- 5. the TestScene plain path ----------------------------------------
    def p_plain_frame():
        small = T.RenderConfig.tuned(xres=180, yres=120)
        rk, _ = T.Renderer(T.WavefrontTracer(compiled, small), cam,
                           small).render(arrays)
        rplain = T.Renderer(T.WavefrontTracer(compiled, small,
                                              select=MK.PLAIN), cam, small)
        reset_counts()
        rp, _ = rplain.render(arrays)
        counts = read_counts("testscene_180x120_plain")
        gk, gp = quantize(rk.cpu().numpy()), quantize(rp.cpu().numpy())
        golden = read_png(os.path.join(ROOT, "tests", "golden",
                                       "testscene_180x120_cpu.png"))
        ok = canaries_ok("plain vs kernel 180x120", gp, gk)
        ok &= canaries_ok("plain vs CPU golden", gp, golden)
        ok &= canaries_ok("kernel vs CPU golden", gk, golden)
        no_kernel = sum(counts[k] for k in kernel_fns) == 0
        return ok and no_kernel and int(rplain.last_overflow.sum()) == 0
    phase("5 TestScene plain-path frame 180x120", p_plain_frame)

    l0_shadow_cache = []

    def l0_shadow():
        """The shadow rays of TestScene's L0 hits (megakernel route), as
        the tracer's first shadow batch."""
        if not l0_shadow_cache:
            l0_shadow_cache.append(KAB.l0_shadow(compiled, arrays, Q0))
        return l0_shadow_cache[0]

    # -- 6. TestScene timing -----------------------------------------------
    def p_timing():
        renderer = T.Renderer(T.WavefrontTracer(compiled, cfg), cam, cfg)
        t0 = time.perf_counter()
        frame_ms = cuda_ms(lambda: renderer.render(arrays), 3)
        print(f"  [{smi_line}] 720x480 depth-3 frame: {frame_ms:.3f} ms "
              f"(CUDA events, mean of 3 after warm-up), "
              f"{n_px / frame_ms / 1e3:.4f} primary Mrays/s "
              f"(host wall incl. warm-up {time.perf_counter() - t0:.2f} s)")
        kms = cuda_ms(lambda: MK.mega_select(tables, Q0, False), 20)
        pms = cuda_ms(lambda: MK.mega_select_plain(tables, Q0, False), 3)
        print(f"  [{smi_line}] L0 intersect batch ({Q0.shape[1]} rays): "
              f"K1 {kms:.4f} ms/launch, plain {pms:.4f} ms/launch "
              f"({pms / kms:.2f}x)")
        entries["mega_select"].update(ms=kms, plain_ms=pms,
                                      rays=Q0.shape[1],
                                      plain_rays=Q0.shape[1])
        # K1's cost per phase inside the full launch
        for label, rays, shadow in (("L0 intersect", Q0, False),
                                    ("first shadow", l0_shadow(), True)):
            before = clocks()
            rows, full = KAB.attribution(
                lambda tabs: device_time(
                    lambda: MK.mega_select(tabs, rays, shadow)) * 1e3,
                tables)
            KAB.print_attribution(
                f"[{smi_line}] K1 per phase, TestScene {label} batch "
                f"({rays.shape[1]} rays; tools.device_time; clocks before "
                f"{before}, after {clocks()})", rows, full)
        return True
    phase("6 TestScene timing", p_timing)

    # -- mesh scenes ---------------------------------------------------------
    meshes = {}

    def mesh(n_tris, cast_shadows):
        """(compiled, arrays, plan, cam, (si, gi) of the mesh group) of
        mesh_scene(n_tris), built once."""
        key = (n_tris, cast_shadows)
        if key not in meshes:
            t0 = time.perf_counter()
            s, lt, c = mesh_scene(n_tris, cast_shadows=cast_shadows)
            cc = T.compile_scene(s, lt)
            mp = MK.get_plan(cc)
            grp = (mp.blocks + mp.external)[0]
            g = cc.scenes[grp[0]].groups[grp[1]]
            if mp.blocks:
                BK.get_block_plan(g, cc.scenes[grp[0]])
            else:
                MSH.get_block_plan(g)
            meshes[key] = (cc, T.to_torch(cc.arrays(), dev), mp, c, grp)
            print(f"  mesh_scene({n_tris}, cast_shadows={cast_shadows}): "
                  f"{g.size} triangles, blocks {mp.blocks}, external "
                  f"{mp.external}, host compile+plans "
                  f"{time.perf_counter() - t0:.1f} s")
        return meshes[key]

    def k2_inputs(cc, garrs, grp):
        return KAB.block_inputs(cc, garrs, grp, dev)

    def k3_inputs(cc, garrs, grp):
        return KAB.mesh_inputs(cc, garrs, grp)

    mesh_batches = {}

    def mesh_l0(n_tris):
        """The 1920x1080 L0 rays of mesh_scene(n_tris, cast_shadows=True),
        the seed K1 (the ground plane) leaves for the mesh group, and the
        shadow rays of the L0 hits after the whole chain."""
        if n_tris not in mesh_batches:
            cc, garrs, _mp, c, _grp = mesh(n_tris, True)
            mesh_batches[n_tris] = KAB.mesh_batches(cc, garrs, c, dev,
                                                    MESH_RES)
        return mesh_batches[n_tris]

    def check_group_kernel(label, fn, plain, args, make_rays, seeds,
                           tri_rows=None):
        """K2 or K3 (fn, on the group inputs args) against its plain
        version, exactly, on rays from make_rays(n, seed=...) with seed t
        seeds = (intersect, shadow).  With tri_rows, the group's (P, F)
        triangle rows, the intersect lanes whose winning t more than one
        row meets (exact ties) are counted, and there must be some."""
        ok = True
        o, d = make_rays(SUBSET, seed=4)
        for shadow, seed_t in zip((False, True), seeds):
            rays = torch.as_tensor(np.stack(
                [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                 np.full(SUBSET, seed_t, np.float32),
                 np.zeros(SUBSET, np.float32)]), device=dev).contiguous()
            rays[6, ::17] = 0.0                       # dead lanes
            seed = rays[6].contiguous()
            k = fn(*args, rays, seed, shadow)
            p = plain(*args, rays, seed, shadow)
            torch.cuda.synchronize()
            ok &= compare(f"{label} {'shadow' if shadow else 'intersect'}",
                          as_np(k), as_np(p), shadow, exact=True)[0]
            if tri_rows is not None and not shadow:
                n_tie = tie_lanes(tri_rows, rays, p[0])
                print(f"    {n_tie} lanes with more than one row at the "
                      f"winning t")
                ok &= n_tie > 0
        return ok

    def tie_grid_inputs():
        """(compiled, device arrays, (0, 0)) of the tie grid: one mesh
        group of 512 flat triangles."""
        tc = T.compile_scene(tie_grid_scene(), phase_kinds_lights())
        return tc, T.to_torch(tc.arrays(), dev), (0, 0)

    def tie_lanes(rows, rays, t_win):
        """Lanes of rays whose winning t (t_win, on the card) more than
        one of the (P, F) triangle rows meets: real exact ties."""
        n_tie = 0
        for s0 in range(0, rays.shape[1], 4096):
            sl = slice(s0, s0 + 4096)
            t0, _t1 = MK._candidates("triangle", rows, 9, False,
                                     rays[0:3, sl].t(), rays[3:6, sl].t())
            n_tie += int((((t0 == t_win[sl, None]) & (t0 > 0)).sum(1)
                          > 1).sum())
        return n_tie

    def sub_rays(rays, seed):
        ix = subset(rays.shape[1])
        return rays[:, ix].contiguous(), seed[ix].contiguous()

    # -- 7. K2 against the plain version ------------------------------------
    def p_k2():
        ok = True
        cc, garrs, _mp, _c, grp = mesh(100_000, True)
        bplan, tab, cf = k2_inputs(cc, garrs, grp)
        Q, t1, sh = mesh_l0(100_000)
        print(f"  block plan: {bplan.n_blocks} blocks of {BK.BP}, "
              f"{bplan.n_nodes} nodes, depth {bplan.depth}; L0 "
              f"{Q.shape[1]} rays, shadow batch {sh.shape[1]} rays")
        for shadow, rays, seed in ((False, Q, t1), (True, sh, sh[6])):
            # the kernel on the whole batch, as the frame launches it;
            # the plain version on SUBSET of its lanes
            ix = subset(rays.shape[1])
            rs, ss = sub_rays(rays, seed)
            k = BK.block_select(bplan, tab, cf, rays, seed, shadow)
            p = BK.block_select_plain(bplan, tab, cf, rs, ss, shadow)
            torch.cuda.synchronize()
            mode = "shadow" if shadow else "intersect"
            good, err = compare(f"mesh100k 1080p L0 {mode} (full launch, "
                                f"{SUBSET}-lane subset checked)",
                                as_np([a[ix] for a in k]), as_np(p), shadow,
                                exact=True)
            ok &= good
            if not shadow:
                entries["block_select"]["max_abs_err"] = err
        saved = MK.BLOCK_MIN
        MK.BLOCK_MIN = 256
        try:
            for kind_ in ("spheres", "difference", "transformed"):
                bc = T.compile_scene(block_scene(kind_), phase_kinds_lights())
                bplan_all = MK.get_plan(bc)
                bg = T.to_torch(bc.arrays(), dev)
                sc = bc.scenes[0]
                print(f"  {kind_}: plan.blocks {bplan_all.blocks}")
                ok &= bool(bplan_all.blocks)
                o, d = block_rays(SUBSET, seed=4)
                for gi, g in enumerate(sc.groups):
                    if g.size < 64:
                        continue
                    bp_, tab_, cf_ = k2_inputs(bc, bg, (0, gi))
                    for shadow, seed_t in ((False, T.INFINITY), (True, 7.0)):
                        rays = torch.as_tensor(np.stack(
                            [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                             d[:, 2], np.full(SUBSET, seed_t, np.float32),
                             np.zeros(SUBSET, np.float32)]),
                            device=dev).contiguous()
                        k = BK.block_select(bp_, tab_, cf_, rays, rays[6],
                                            shadow)
                        p = BK.block_select_plain(bp_, tab_, cf_, rays,
                                                  rays[6], shadow)
                        torch.cuda.synchronize()
                        mode = "shadow" if shadow else "intersect"
                        label = (f"{kind_} group {gi} ({g.size} {g.ptype}"
                                 f"{', transformed' if bp_.transformed else ''}"
                                 f"{', constrained' if bp_.cons else ''}) "
                                 f"{mode}")
                        ok &= compare(label, as_np(k), as_np(p), shadow,
                                      exact=True)[0]
        finally:
            MK.BLOCK_MIN = saved
        # a block tree deeper than the fixed 64-entry stack K2 had: the
        # 320-sphere chain in 4-sphere blocks, called directly
        ratio = 2.0 ** (-1 / 6)
        cc = T.compile_scene(chain_scene(320, ratio), phase_kinds_lights())
        cplan, ctab, ccf = k2_inputs(cc, T.to_torch(cc.arrays(), dev), (0, 0))
        print(f"  320-sphere chain: {cplan.n_blocks} blocks, block tree depth "
              f"{cplan.depth}, walk stack {kernels.walk_stack(cplan.depth)} "
              f"entries per thread")
        ok &= cplan.depth > 64
        ok &= check_group_kernel(
            "320-sphere chain", BK.block_select, BK.block_select_plain,
            (cplan, ctab, ccf),
            lambda n, seed: chain_rays(n, seed, n_spheres=320, ratio=ratio),
            (T.INFINITY, 1.0))
        # exact ties between rows: the winner is the lowest row
        tc, tg, grp = tie_grid_inputs()
        targs = k2_inputs(tc, tg, grp)
        ok &= check_group_kernel("tie grid", BK.block_select,
                                 BK.block_select_plain, targs, tie_grid_rays,
                                 (T.INFINITY, 5.0),
                                 targs[1].reshape(-1, targs[0].F))
        return ok
    phase("7 K2 vs plain", p_k2)

    # -- 8. K3 against the plain version ------------------------------------
    def p_k3():
        ok = True
        cc, garrs, _mp, _c, grp = mesh(250_000, True)
        mplan, tri = k3_inputs(cc, garrs, grp)
        Q, t1, sh = mesh_l0(250_000)
        print(f"  mesh plan: {mplan.n_blocks} blocks of {MSH.BP}, at most "
              f"{MSH.BLOCK_LEAF_MAX} per leaf, {mplan.n_nodes} nodes, depth "
              f"{mplan.depth}; L0 {Q.shape[1]} rays, shadow batch "
              f"{sh.shape[1]} rays")
        for shadow, rays, seed in ((False, Q, t1), (True, sh, sh[6])):
            ix = subset(rays.shape[1])
            rs, ss = sub_rays(rays, seed)
            k = MSH.mesh_block_select(mplan, tri, rays, seed, shadow)
            p = MSH.mesh_block_select_plain(mplan, tri, rs, ss, shadow)
            torch.cuda.synchronize()
            mode = "shadow" if shadow else "intersect"
            good, err = compare(f"mesh250k 1080p L0 {mode} (full launch, "
                                f"{SUBSET}-lane subset checked)",
                                as_np([a[ix] for a in k]), as_np(p), shadow,
                                exact=True)
            ok &= good
            if not shadow:
                entries["mesh_block_select"]["max_abs_err"] = err
        tc, tg, grp = tie_grid_inputs()
        targs = k3_inputs(tc, tg, grp)
        ok &= check_group_kernel("tie grid", MSH.mesh_block_select,
                                 MSH.mesh_block_select_plain, targs,
                                 tie_grid_rays, (T.INFINITY, 5.0), targs[1])
        return ok
    phase("8 K3 vs plain", p_k3)

    # -- 9. the mesh frames --------------------------------------------------
    mcfg = T.RenderConfig(xres=MESH_RES[0], yres=MESH_RES[1], maxdepth=1)
    pcfg = T.RenderConfig(xres=PLAIN_RES[0], yres=PLAIN_RES[1], maxdepth=1)
    step = MESH_RES[0] // PLAIN_RES[0]

    mesh_imgs = {}

    def mesh_frame(n_tris, cast_shadows, want):
        cc, garrs, _mp, c, _grp = mesh(n_tris, cast_shadows)
        path = f"mesh{n_tris // 1000}k_1080p_cast{int(cast_shadows)}"
        renderer = T.Renderer(T.WavefrontTracer(cc, mcfg), c, mcfg)
        reset_counts()
        # the compiled frame's capture frame: its warm-ups' kernel inputs
        # are recorded and held against the plain versions below
        (rgb, depth), log = record_inputs(lambda: renderer.render(garrs))
        counts = read_counts(path)
        ov = int(renderer.last_overflow.sum())
        img = rgb.cpu().numpy()
        finite = bool(np.isfinite(img).all()
                      and torch.isfinite(depth).all().item())
        print(f"  {path}: rgb {tuple(img.shape)} finite {finite}, "
              f"overflow {ov}, expected launches {want}")
        write_png(os.path.join(out_dir, f"{path}_gpu.png"), img)
        mesh_imgs[path] = quantize(img)
        rplain = T.Renderer(T.WavefrontTracer(cc, pcfg, select=MK.PLAIN), c,
                            pcfg)
        reset_counts()
        rp, _ = rplain.render(garrs)
        pcounts = read_counts(f"{path}_plain_{PLAIN_RES[0]}x{PLAIN_RES[1]}")
        ok = canaries_ok(f"every {step}th pixel vs the plain set at "
                         f"{PLAIN_RES[0]}x{PLAIN_RES[1]}",
                         quantize(img[::step, ::step]),
                         quantize(rp.cpu().numpy()))
        print(f"  {path} compiled frame: calls "
              f"{[(n, a[rays_at[n]].shape[1]) for n, a in log]}")
        ok &= (sorted(n for n, _a in log)
               == sorted(k for k, v in want.items() for _ in range(v))
               and check_recorded(f"{path} compiled frame", log, False))
        return (ok and finite and ov == 0 and counts["plain"] == 0
                and img.shape == (MESH_RES[1], MESH_RES[0], 3)
                and all(counts[k] == want.get(k, 0) for k in kernel_fns)
                and pcounts["plain"] > 0
                and sum(pcounts[k] for k in kernel_fns) == 0
                and int(rplain.last_overflow.sum()) == 0)

    def p_mesh_frames():
        ok = True
        # one intersect and one fused shadow batch per level; the mesh's
        # K2/K3 pass is skipped in the shadow batch when it casts none
        ok &= mesh_frame(100_000, False, {"mega_select": 2,
                                          "block_select": 1,
                                          "mesh_block_select": 0})
        ok &= mesh_frame(100_000, True, {"mega_select": 2,
                                         "block_select": 2,
                                         "mesh_block_select": 0})
        ok &= mesh_frame(250_000, True, {"mega_select": 2,
                                         "block_select": 0,
                                         "mesh_block_select": 2})
        return ok
    phase("9 mesh frames 1920x1080 depth 1 through the kernels",
          p_mesh_frames)

    # -- 10. mesh timing ----------------------------------------------------
    frames = {}
    device_share = {}

    def p_mesh_timing():
        n_rays = MESH_RES[0] * MESH_RES[1]
        print(f"  clocks at the start: {clocks()}")
        for cast_shadows in (False, True):
            cc, garrs, _mp, c, _grp = mesh(100_000, cast_shadows)
            renderer = T.Renderer(T.WavefrontTracer(cc, mcfg), c, mcfg)
            ms = cuda_ms(lambda: renderer.render(garrs), 3)
            frames[cast_shadows] = ms
            print(f"  [{smi_line}] mesh_scene(100_000) 1920x1080 depth 1 "
                  f"cast_shadows={cast_shadows}: {ms:.3f} ms (CUDA events, "
                  f"mean of 3 after warm-up), {n_rays / ms / 1e3:.4f} "
                  f"primary Mrays/s")
            if cast_shadows:
                wall, busy, per = PF.profile_kernels(
                    lambda: renderer.render(garrs), ("block_select_kernel",))
                if busy is None:
                    print("  profiler: no device time (device busy share "
                          "not measured)")
                else:
                    k2 = per["block_select_kernel"]
                    device_share.update(wall=wall, busy=busy, k2=k2)
                    print(f"  [{smi_line}] one profiled frame: host wall "
                          f"{wall:.3f} ms, device busy {busy:.3f} ms "
                          f"({100 * busy / wall:.1f}%), K2 "
                          f"{k2:.3f} ms ({100 * k2 / wall:.1f}% of the "
                          f"frame, {100 * k2 / busy:.1f}% of device busy)")
        for name, n_tris, inputs, fn, fn_plain in (
                ("block_select", 100_000, k2_inputs, BK.block_select,
                 BK.block_select_plain),
                ("mesh_block_select", 250_000, k3_inputs,
                 MSH.mesh_block_select, MSH.mesh_block_select_plain)):
            cc, garrs, _mp, _c, grp = mesh(n_tris, True)
            args = inputs(cc, garrs, grp)
            Q, t1, _sh = mesh_l0(n_tris)
            rs, ss = sub_rays(Q, t1)
            before = clocks()
            kms = cuda_ms(lambda: fn(*args, Q, t1, False), 10)
            ksub = cuda_ms(lambda: fn(*args, rs, ss, False), 10)
            pms = cuda_ms(lambda: fn_plain(*args, rs, ss, False), 1)
            print(f"  [{smi_line}] {name} on mesh_scene({n_tris}) L0: "
                  f"{kms:.4f} ms/launch ({Q.shape[1]} rays); on the "
                  f"{SUBSET}-ray subset {ksub:.4f} ms vs plain {pms:.4f} ms "
                  f"({pms / ksub:.1f}x) (clocks before the kernel: "
                  f"{before})")
            entries[name].update(ms=kms, plain_ms=pms, rays=Q.shape[1],
                                 plain_rays=SUBSET, subset_ms=ksub)
        # each mesh through both kernels, interleaved K2, K3, K3, K2 with
        # the clocks sampled around them: whether one kernel could serve
        # both routes on this card
        for n_tris in (100_000, 250_000):
            cc, garrs, _mp, _c, grp = mesh(n_tris, True)
            k2a, k3a = k2_inputs(cc, garrs, grp), k3_inputs(cc, garrs, grp)
            Q, t1, _sh = mesh_l0(n_tris)
            before = clocks()
            times = [cuda_ms(lambda: fn(*args, Q, t1, False), 10)
                     for fn, args in ((BK.block_select, k2a),
                                      (MSH.mesh_block_select, k3a),
                                      (MSH.mesh_block_select, k3a),
                                      (BK.block_select, k2a))]
            print(f"  [{smi_line}] mesh_scene({n_tris}) L0, K2 / K3 / K3 / "
                  f"K2: {' / '.join(f'{x:.4f}' for x in times)} ms/launch "
                  f"(clocks before: {before}; after: {clocks()})")
        return True
    phase("10 mesh timing", p_mesh_timing)

    # -- TestScene's groups on the pass-per-group route -------------------
    def route_groups(cc):
        """[(si, gi, "dense" | "bvh")] of every group of cc the group
        route sends to K4 or K5, in route order."""
        return [(si, gi, "bvh" if g.accel_eligible else "dense")
                for si, sc in enumerate(cc.scenes)
                for gi, g in enumerate(sc.groups)
                if g.vclass not in ("deferred", "convex") and g.size]

    def group_args(cc, garrs, si, gi, kind, shadow):
        """(select function, plain version, positional inputs, keywords)
        of one group's K4 or K5 launch, packed as the group route packs
        them (`garrs` the to_torch arrays of cc)."""
        sc = cc.scenes[si]
        ga = garrs["scenes"][si]
        if kind == "dense":
            args, bbox = dense_args(sc, ga, gi, shadow, dev)
            return (GK.dense_select, GK.dense_select_plain, args,
                    {"block_bbox": bbox})
        args, _order = bvh_args(sc, ga, gi, shadow, dev)
        return GK.bvh_select, GK.bvh_select_plain, args, {}

    def group_label(cc, si, gi):
        g = cc.scenes[si].groups[gi]
        return (f"{si}.g{gi} ({g.size} {g.ptype}"
                f"{', transformed' if g.m_inv is not None else ''}"
                f"{', constrained' if g.constraints else ''})")

    groups_ts = route_groups(compiled)
    cone_gi = next(gi for si, gi, _k in groups_ts
                   if si == 0
                   and compiled.scenes[0].groups[gi].ptype == "cone")
    big_bvh_gi = max((gi for si, gi, kind in groups_ts
                      if si == 0 and kind == "bvh"),
                     key=lambda gi: compiled.scenes[0].groups[gi].size)

    # -- 11. bounds ----------------------------------------------------------
    def bound(name, rays_bytes, out_bytes, table_bytes, tally, prim_flops,
              prefix=""):
        """The kernel's bound from its tally: box and prim tests, and for
        K1 (four rows) its point-in-node and member inside tests; stored
        as the entry's `prefix`bound_ms / `prefix`bound_by."""
        n_box = int(tally[0].sum())
        n_prim = int(tally[1].sum())
        nbytes = rays_bytes + out_bytes + table_bytes
        flops = n_box * BOX_FLOPS + n_prim * prim_flops
        n = tally.shape[1]
        clause = ""
        if tally.shape[0] == 4:
            n_point, n_member = int(tally[2].sum()), int(tally[3].sum())
            flops += n_point * POINT_FLOPS + n_member * MIN_MEMBER_FLOPS
            clause = (f", {n_point} point-in-node tests "
                      f"({n_point / n:.2f}/ray), {n_member} member tests "
                      f"({n_member / n:.2f}/ray)")
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        e = entries[name]
        e[prefix + "bound_ms"] = max(t_bytes, t_ops)
        e[prefix + "bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"  {name}{' ' + prefix[:-1] if prefix else ''}: {n} rays, "
              f"{n_box} box tests "
              f"({n_box / n:.2f}/ray), {n_prim} prim tests "
              f"({n_prim / n:.2f}/ray){clause}; {nbytes / 1e6:.3f} MB -> "
              f"{1e3 * t_bytes:.2f} us, {flops / 1e9:.3f} GFLOP -> "
              f"{1e3 * t_ops:.2f} us; bound "
              f"{1e3 * e[prefix + 'bound_ms']:.2f} us "
              f"({e[prefix + 'bound_by']})"
              + (f", measured {1e3 * e[prefix + 'ms']:.2f} us"
                 if prefix + "ms" in e else ""))

    def p_bounds():
        def tally_for(n, rows=2):
            return torch.zeros((rows, n), dtype=torch.int32, device=dev)
        n = Q0.shape[1]
        tally = tally_for(n, MK.TALLY_ROWS)
        MK.mega_select(tables, Q0, False, tally=tally)
        tbytes = sum(t.numel() * t.element_size() for t in
                     (tables.pf, tables.pi, tables.nf, tables.ni,
                      tables.nodes, tables.bb, tables.pbox, tables.phases))
        # rays [o, d, seed, sid] in; t, wid, aux out
        bound("mega_select", 32 * n, 12 * n, tbytes, tally.cpu(),
              MIN_PRIM_FLOPS)
        n_meta = tables.phases.numel()
        entries["mega_select"]["smem_bytes"] = (
            MK.walk_stack(plan) * kernels.WALK_THREADS
            * kernels.STACK_ENTRY_BYTES
            + (4 * n_meta if n_meta <= MK.META_MAX else 0))
        for name, n_tris, inputs, fn in (
                ("block_select", 100_000, k2_inputs, BK.block_select),
                ("mesh_block_select", 250_000, k3_inputs,
                 MSH.mesh_block_select)):
            cc, garrs, _mp, _c, grp = mesh(n_tris, True)
            args = inputs(cc, garrs, grp)
            Q, t1, _sh = mesh_l0(n_tris)
            n = Q.shape[1]
            tally = tally_for(n)
            fn(*args, Q, t1, False, tally=tally)
            p = args[0]
            table = sum(a.numel() * a.element_size() for a in args[1:])
            # o, d and the seed in; t and the winner out
            bound(name, 28 * n, 8 * n, p.nodes.nbytes + table, tally.cpu(),
                  TRI_FLOPS)
            entries[name]["smem_bytes"] = (
                kernels.walk_stack(p.depth) * kernels.WALK_THREADS
                * kernels.STACK_ENTRY_BYTES)
        # each mesh's rays through both kernels' walks: K3, redesigned on
        # K2's walk, makes at most 1.1x K2's box + triangle tests
        ok = True
        for n_tris in (100_000, 250_000):
            cc, garrs, _mp, _c, grp = mesh(n_tris, True)
            Q, t1, _sh = mesh_l0(n_tris)
            per = {}
            for label, inputs, fn in (("K2", k2_inputs, BK.block_select),
                                      ("K3", k3_inputs,
                                       MSH.mesh_block_select)):
                tally = tally_for(Q.shape[1])
                fn(*inputs(cc, garrs, grp), Q, t1, False, tally=tally)
                per[label] = (tally.sum(dim=1) / Q.shape[1]).tolist()
            ratio = sum(per["K3"]) / sum(per["K2"])
            print(f"  mesh{n_tris // 1000}k L0: K2 {per['K2'][0]:.2f} box + "
                  f"{per['K2'][1]:.2f} triangle tests per ray, K3 "
                  f"{per['K3'][0]:.2f} + {per['K3'][1]:.2f}: K3 / K2 "
                  f"{ratio:.3f} (<= 1.1)")
            ok &= ratio <= 1.1
        # K4 on the cone group's L0 batch, K5 on the biggest lattice
        # group's, each as the route launches it
        for name, gi, kind in (("dense_select", cone_gi, "dense"),
                               ("bvh_select", big_bvh_gi, "bvh")):
            fn, _plain, args, kw = group_args(compiled, arrays, 0, gi, kind,
                                              False)
            n = Q0.shape[1]
            tally = tally_for(n)
            fn(*args, Q0, Q0[6].contiguous(), tally=tally, **kw)
            tabs = [a for a in list(args) + list(kw.values())
                    if torch.is_tensor(a)] + [args[-1].cf, args[-1].desc]
            if kind == "bvh":
                recs = GK.bvh_records(args[1], dev)
                tabs.append(recs.nodes)
                entries[name]["smem_bytes"] = (
                    kernels.walk_stack(recs.depth) * kernels.WALK_THREADS
                    * kernels.STACK_ENTRY_BYTES)
            # o, d and the seed in; t and the winner out
            bound(name, 28 * n, 8 * n,
                  sum(t.numel() * t.element_size() for t in tabs),
                  tally.cpu(), MIN_PRIM_FLOPS)
        # K4 on a one-prim group (TestScene has four), timed and bounded
        # on the same L0 batch
        one_gi = next(gi for si, gi, kind in groups_ts
                      if si == 0 and kind == "dense"
                      and compiled.scenes[0].groups[gi].size == 1)
        fn, _plain, args, kw = group_args(compiled, arrays, 0, one_gi,
                                          "dense", False)
        seed = Q0[6].contiguous()
        e = entries["dense_select"]
        e["one_prim_group"] = group_label(compiled, 0, one_gi)
        # tools.device_time: a wrapper call issues slower than this
        # launch runs, so CUDA events would time the host
        e["one_prim_ms"] = device_time(
            lambda: fn(*args, Q0, seed, **kw)) * 1e3
        tally = tally_for(Q0.shape[1])
        fn(*args, Q0, seed, tally=tally, **kw)
        tabs = [a for a in list(args) + list(kw.values())
                if torch.is_tensor(a)] + [args[-1].cf, args[-1].desc]
        bound("dense_select", 28 * Q0.shape[1], 8 * Q0.shape[1],
              sum(t.numel() * t.element_size() for t in tabs), tally.cpu(),
              MIN_PRIM_FLOPS, prefix="one_prim_")
        print(f"  [{smi_line}] dense_select on {e['one_prim_group']}: "
              f"{e['one_prim_ms']:.4f} ms/launch (tools.device_time), "
              f"bound {e['one_prim_bound_ms']:.5f} ms "
              f"({e['one_prim_bound_by']})")
        return ok
    phase("11 bounds", p_bounds)

    # -- 12. K4 against the plain version -----------------------------------
    def check_group(label, fn, plain, args, kw, rays, seed, shadow):
        """K4 or K5 against its plain version; K5 exactly."""
        k = fn(*args, rays, seed, shadow=shadow, **kw)
        p = plain(*args, rays, seed, shadow=shadow, **kw)
        torch.cuda.synchronize()
        return compare(label, as_np(k), as_np(p), shadow,
                       exact=fn is GK.bvh_select)

    def check_scene_groups(cc, make_rays, sh_t, kinds):
        """Every K4/K5 group of cc (of the given kinds) on SUBSET of the
        scene's own rays, intersect and shadow."""
        ok = True
        garrs = T.to_torch(cc.arrays(), dev)
        garrs["scenes"] = [materialize_scene_params(sc, ga) for sc, ga in
                           zip(cc.scenes, garrs["scenes"])]
        o, d = make_rays(SUBSET, seed=4)
        for shadow, seed_t in ((False, T.INFINITY), (True, sh_t)):
            rays = torch.as_tensor(np.stack(
                [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                 np.full(SUBSET, seed_t, np.float32),
                 np.zeros(SUBSET, np.float32)]), device=dev).contiguous()
            rays[6, ::17] = 0.0                       # dead lanes
            for si, gi, kind in route_groups(cc):
                if kind not in kinds:
                    continue
                fn, plain, args, kw = group_args(cc, garrs, si, gi, kind,
                                                 shadow)
                ok &= check_group(
                    f"  {group_label(cc, si, gi)} "
                    f"{'shadow' if shadow else 'intersect'}", fn, plain,
                    args, kw, rays, rays[6].contiguous(), shadow)[0]
        return ok

    def check_testscene_groups(kind):
        """Every TestScene group of `kind` with all L0 rays and all their
        shadow rays; returns (ok, max |dt| on common intersect hits)."""
        ok, errs = True, []
        for shadow, rays in ((False, Q0), (True, l0_shadow())):
            for si, gi, k_ in groups_ts:
                if k_ != kind:
                    continue
                fn, plain, args, kw = group_args(compiled, arrays, si, gi,
                                                 kind, shadow)
                good, err = check_group(
                    f"TestScene {group_label(compiled, si, gi)} L0 "
                    f"{'shadow' if shadow else 'intersect'}", fn, plain,
                    args, kw, rays, rays[6].contiguous(), shadow)
                ok &= good
                if not shadow:
                    errs.append(err)
        return ok, max(errs)

    def p_k4():
        ok, err = check_testscene_groups("dense")
        entries["dense_select"]["max_abs_err"] = err
        for name, scene, make_rays, sh_t in (
                ("phase-kinds", phase_kinds_scene, phase_kinds_rays, 20.0),
                ("csg", csg_scene, csg_rays, 9.0)):
            print(f"  {name}:")
            ok &= check_scene_groups(
                T.compile_scene(scene(), phase_kinds_lights()), make_rays,
                sh_t, ("dense",))
        for kind_ in ("difference", "transformed"):
            print(f"  block_scene({kind_!r}), every group dense:")
            ok &= check_scene_groups(
                T.compile_scene(block_scene(kind_), phase_kinds_lights(),
                                accel_min_size=1 << 30),
                lambda n, seed: block_rays(n, seed), 7.0, ("dense",))
        return ok
    phase("12 K4 vs plain", p_k4)

    # -- 13. K5 against the plain version -----------------------------------
    def k5_tree(label, g):
        """Print a K5 group's skip-link tree and its converted records."""
        bvh = group_accel(g)
        recs = GK.bvh_records(bvh, dev)
        print(f"  {label}: skip-link tree {bvh.n_nodes} nodes, records of "
              f"{recs.n_nodes} nodes, depth {recs.depth}, walk stack "
              f"{kernels.walk_stack(recs.depth)} entries per thread")
        return recs

    def p_k5():
        for si, gi, k_ in groups_ts:
            if k_ == "bvh":
                k5_tree(f"TestScene {group_label(compiled, si, gi)}",
                        compiled.scenes[si].groups[gi])
        ok, err = check_testscene_groups("bvh")
        entries["bvh_select"]["max_abs_err"] = err
        # a deeper tree than TestScene's: 20,000 spheres in one group
        t0 = time.perf_counter()
        big = T.compile_scene(sphere_cloud_scene(), phase_kinds_lights())
        group_accel(big.scenes[0].groups[0])
        print(f"  20,000-sphere group: compiled and tree built in "
              f"{time.perf_counter() - t0:.2f} s")
        k5_tree("20,000-sphere group", big.scenes[0].groups[0])
        ok &= check_scene_groups(
            big, lambda n, seed: block_rays(n, seed, span=14.0), 7.0,
            ("bvh",))
        # a chain of unsplittable leaves: 1,000 coincident spheres, every
        # hit an exact tie of all rows (the winner is leaf row 0)
        co = T.compile_scene(coincident_scene(), phase_kinds_lights(),
                             accel_min_size=64)
        recs = k5_tree("1,000 coincident spheres",
                       co.scenes[0].groups[0])
        ok &= recs.depth <= 12
        ok &= check_scene_groups(co, block_rays, 7.0, ("bvh",))
        # the tie grid's 512 flat triangles as one K5 group
        tg = T.compile_scene(tie_grid_scene(), phase_kinds_lights(),
                             accel_min_size=64)
        k5_tree("tie grid", tg.scenes[0].groups[0])
        ok &= check_scene_groups(tg, tie_grid_rays, 5.0, ("bvh",))
        # the coincident chain rendered through K5 and through the plain set
        ccfg = T.RenderConfig.tuned(xres=96, yres=64)
        ccam = camera((0.0, 1.0, -6.0), (0, 0, 0), (0, 1, 0), 45)
        carrs = T.to_torch(co.arrays(), dev)
        imgs = {}
        for sel in (MK.KERNELS, MK.PLAIN):
            r = T.Renderer(T.WavefrontTracer(co, ccfg, select=sel,
                                             route=GROUPS), ccam, ccfg)
            reset_counts()
            rgb, _depth = r.render(carrs)
            counts = read_counts(f"coincident_96x64_groups_{sel}")
            imgs[sel] = rgb.cpu().numpy()
            launched = (counts["bvh_select"] > 0 and counts["plain"] == 0
                        if sel == MK.KERNELS else counts["bvh_select"] == 0)
            ok &= (launched and int(r.last_overflow.sum()) == 0
                   and bool(np.isfinite(imgs[sel]).all()))
        ok &= canaries_ok("coincident chain 96x64, kernels vs plain",
                          quantize(imgs[MK.KERNELS]), quantize(imgs[MK.PLAIN]))
        return ok
    phase("13 K5 vs plain", p_k5)

    # -- 14. the TestScene frame on the group route --------------------------
    n_dense = sum(k == "dense" for _s, _g, k in groups_ts)
    n_bvh = sum(k == "bvh" for _s, _g, k in groups_ts)

    def p_group_frame():
        tracer = T.WavefrontTracer(compiled, cfg, route=GROUPS)
        renderer = T.Renderer(tracer, cam, cfg)
        reset_counts()
        t0 = time.perf_counter()
        rgb, depth = renderer.render(arrays)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts("testscene_720x480_groups")
        batches = tracer.last_batches
        ov = int(renderer.last_overflow.sum())
        img = rgb.cpu().numpy()
        finite = bool(np.isfinite(img).all()
                      and torch.isfinite(depth).all().item())
        print(f"  rgb {tuple(img.shape)} finite {finite}, overflow {ov}, "
              f"{batches} batches, expected K4 {n_dense} x {batches}, K5 "
              f"{n_bvh} x {batches} (first frame, host wall {wall:.2f} s)")
        write_png(os.path.join(out_dir, "testscene_720x480_groups_gpu.png"),
                  img)
        ok = canaries_ok("vs out/testscene_tpu.png", quantize(img),
                         read_png(os.path.join(ROOT, "out",
                                               "testscene_tpu.png")))
        if "mega" in frame_imgs:
            ok &= canaries_ok("vs phase 4's megakernel-route frame",
                              quantize(img), frame_imgs["mega"])
        else:
            print("  no megakernel-route frame to compare (phase 4 failed)")
            ok = False
        return (ok and finite and ov == 0 and batches > 0
                and img.shape == (cfg.yres, cfg.xres, 3)
                and counts["dense_select"] == n_dense * batches
                and counts["bvh_select"] == n_bvh * batches
                and counts["mega_select"] == 0
                and counts["block_select"] == 0
                and counts["mesh_block_select"] == 0
                and counts["plain"] == 0)
    phase("14 TestScene frame 720x480 depth 3 on the group route",
          p_group_frame)

    # -- 15. the group route's plain path ------------------------------------
    def p_group_plain():
        small = T.RenderConfig.tuned(xres=180, yres=120)
        rplain = T.Renderer(T.WavefrontTracer(compiled, small,
                                              select=MK.PLAIN,
                                              route=GROUPS), cam, small)
        reset_counts()
        rp, _ = rplain.render(arrays)
        counts = read_counts("testscene_180x120_groups_plain")
        golden = read_png(os.path.join(ROOT, "tests", "golden",
                                       "testscene_180x120_cpu.png"))
        ok = canaries_ok("group-route plain vs CPU golden",
                         quantize(rp.cpu().numpy()), golden)
        return (ok and counts["plain"] > 0
                and sum(counts[k] for k in kernel_fns) == 0
                and int(rplain.last_overflow.sum()) == 0)
    phase("15 TestScene group-route plain frame 180x120", p_group_plain)

    # -- 16. group-route timing ----------------------------------------------
    def p_group_timing():
        renderer = T.Renderer(T.WavefrontTracer(compiled, cfg,
                                                route=GROUPS), cam, cfg)
        print(f"  clocks at the start: {clocks()}")
        frame_ms = cuda_ms(lambda: renderer.render(arrays), 3)
        print(f"  [{smi_line}] group-route 720x480 depth-3 frame: "
              f"{frame_ms:.3f} ms (CUDA events, mean of 3 after warm-up), "
              f"{n_px / frame_ms / 1e3:.4f} primary Mrays/s")
        for name, gi, kind in (("dense_select", cone_gi, "dense"),
                               ("bvh_select", big_bvh_gi, "bvh")):
            fn, plain, args, kw = group_args(compiled, arrays, 0, gi, kind,
                                             False)
            seed = Q0[6].contiguous()
            before = clocks()
            kms = cuda_ms(lambda: fn(*args, Q0, seed, **kw), 10)
            pms = cuda_ms(lambda: plain(*args, Q0, seed, **kw), 1)
            host, dev_ms, rec = PF.launch_split(
                lambda: fn(*args, Q0, seed, **kw), f"{name}_kernel")
            print(f"  [{smi_line}] {name} on TestScene "
                  f"{group_label(compiled, 0, gi)} L0 ({Q0.shape[1]} rays): "
                  f"{kms:.4f} ms/launch (CUDA events), {dev_ms:.4f} ms "
                  f"device time per launch (profiler, {rec} of 10 launches "
                  f"recorded), {host:.4f} ms host per wrapper call; plain "
                  f"{pms:.4f} ms ({pms / kms:.1f}x) (clocks before: "
                  f"{before})")
            entries[name].update(ms=kms, plain_ms=pms, rays=Q0.shape[1],
                                 plain_rays=Q0.shape[1], device_ms=dev_ms,
                                 host_ms=host)
        # the same split for K1 on TestScene L0 and K2 on the mesh100k
        # subset (their CUDA-event times come from phases 6 and 10)
        cc, garrs, _mp, _c, grp = mesh(100_000, True)
        k2a = k2_inputs(cc, garrs, grp)
        Q, t1, _sh = mesh_l0(100_000)
        rs, ss = sub_rays(Q, t1)
        for label, fn, kname in (
                ("mega_select on TestScene L0",
                 lambda: MK.mega_select(tables, Q0, False),
                 "mega_select_kernel"),
                (f"block_select on the mesh100k {SUBSET}-ray subset",
                 lambda: BK.block_select(*k2a, rs, ss, False),
                 "block_select_kernel")):
            host, dev_ms, rec = PF.launch_split(fn, kname)
            print(f"  [{smi_line}] {label}: {dev_ms:.4f} ms device time per "
                  f"launch (profiler, {rec} of 10 launches recorded), "
                  f"{host:.4f} ms host per wrapper call")
        wall, busy, per = PF.profile_kernels(
            lambda: renderer.render(arrays),
            ("dense_select_kernel", "bvh_select_kernel"), top=8)
        if busy is None:
            print("  profiler: no device time (device busy share not "
                  "measured)")
        else:
            k4, k5 = per["dense_select_kernel"], per["bvh_select_kernel"]
            print(f"  [{smi_line}] one profiled group-route frame: host wall "
                  f"{wall:.3f} ms, device busy {busy:.3f} ms "
                  f"({100 * busy / wall:.1f}%), K4 {k4:.3f} ms "
                  f"({100 * k4 / wall:.1f}% of the frame, "
                  f"{100 * k4 / busy:.1f}% of device busy), K5 {k5:.3f} ms "
                  f"({100 * k5 / wall:.1f}%, {100 * k5 / busy:.1f}%)")
        return True
    phase("16 group-route timing", p_group_timing)

    # -- 17/18. the card microbenchmarks M1 and M2 -------------------------
    def micro_bound(v, inp, tally):
        """(bound ms, "bytes" | "operations", detail) of one variant's
        launch: what it reads of the rays (vread: only the sectors of its
        N elements), its tables and its output once over HBM_BPS
        (MPR.moved_bytes), against the float32 work of the tests its
        tiles made (tally) over F32_FLOPS and, for f, its 3xTF32 product
        over TF32_FLOPS."""
        n_t = inp["rays"].shape[1]
        nbytes = MPR.moved_bytes(v, inp)
        tests = int(tally.sum())
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = tests * v.tile_ops / F32_FLOPS * 1e3
        if v.name == "f_mxu128":
            t_ops = max(t_ops, tests * MPR.TILE * MPR.MXU_TF32_OPS
                        / TF32_FLOPS * 1e3)
        detail = (f"{nbytes / 1e6:.3f} MB -> {1e3 * t_bytes:.3f} us, "
                  f"{tests / n_t:.2f} tests per tile -> "
                  f"{1e3 * t_ops:.3f} us")
        if t_bytes >= t_ops:
            return t_bytes, "bytes", detail
        return t_ops, "operations", detail

    def sm_clock_mhz(reading):
        """The SM clock (MHz) of a clocks() reading."""
        m = re.match(r"\s*(\d+) MHz", reading)
        if m is None:
            raise RuntimeError(f"no SM clock in {reading!r}")
        return float(m.group(1))

    def p_micro(key, path):
        tool = micro_tools[key]
        print(f"  [{smi_line}] clocks at the start: {clocks()}")
        reset_counts()
        rows = tool.main([])          # the tool's entry point, its size
        counts = read_counts(path)
        launched = {v.name: v.kernel.launches for v in tool.VARIANTS}
        after = clocks()
        print(f"  clocks after the timed rows: {after}")
        ok = (counts["plain"] == 0 and all(launched.values())
              and all(counts[k] == 0 for k in counts
                      if k != "plain" and not k.startswith(key + ".")))
        # the build as the card runs it: ptxas figures and SASS; the issue
        # floor at the SM clock read after the timed rows
        lib = kernels.library_path(micro_libs[key])
        figs = kernels.ptxas_figures(kernels.BUILD_INFO[lib]["log"])
        funcs = MPR.sass_functions(kernels.sass(lib))
        clk = sm_clock_mhz(after)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        inp = tool.device_inputs(dev)
        for v, sec, _out in rows:
            args = (inp["rays"], *(inp[t] for t in v.tables))
            k = v.kernel(*args)
            tally = torch.zeros(tool.T, dtype=torch.int64, device=dev)
            p = v.plain(*args, tally=tally)
            torch.cuda.synchronize()
            err = float((k - p).abs().max())
            if v.name == "f_mxu128":
                frac = float(torch.isclose(k, p, rtol=MPR.MXU_RTOL,
                                           atol=MPR.MXU_ATOL).float().mean())
                good = frac >= MPR.MXU_AGREE
                check = (f"within rtol {MPR.MXU_RTOL} / atol {MPR.MXU_ATOL} "
                         f"on {100 * frac:.4f}% of rays (>= "
                         f"{100 * MPR.MXU_AGREE}%)")
            else:
                good = torch.equal(k, p)
                check = "bit-equal" if good else "NOT bit-equal"
            pms = cuda_ms(lambda: v.plain(*args), 1, warm=0)
            bound, by, detail = micro_bound(v, inp, tally)
            floor, per = MPR.issue_floor(v, funcs, int(tally.sum()), tool.T,
                                         sms, clk)
            fig = figs[MPR.find_function(figs, v.symbol)]
            row = {"ms": sec * 1e3, "plain_ms": pms, "bound_ms": bound,
                   "bound_by": by, "max_abs_err": err,
                   "tests_per_tile": int(tally.sum()) / tool.T,
                   "issue_floor_ms": floor, "instructions_per_test": per,
                   "sm_clock_mhz": clk, "ptxas": fig,
                   "grid": [tool.T * v.grid[0], v.grid[1]],
                   "launch_floor_ms": device_time(
                       lambda: MPR.store_tile(inp["rays"], v.grid)) * 1e3}
            if v.units is None:       # a walk: the nodes it visited
                per_tile = k[:, 0, 0]
                row.update(visited_tile0=float(per_tile[0]),
                           visited_mean=float(per_tile.mean()))
                extra = (f", visited/tile {float(per_tile[0]):.0f} (tile "
                         f"0), {float(per_tile.mean()):.2f} (mean)")
            else:
                extra = ""
            unit = "thread" if v.per_pass == 0 else "test"
            print(f"  [{smi_line}] {v.name}: {launched[v.name]} launches, "
                  f"{sec * 1e3:.5f} ms/launch, plain {pms:.4f} ms, bound "
                  f"{bound * 1e3:.3f} us ({by}: {detail}); issue floor "
                  f"{floor * 1e3:.3f} us ({per:.2f} SASS instructions per "
                  f"{unit}, {sms} SMs x {MPR.LANES_PER_SM} lanes at "
                  f"{clk:.0f} MHz); launch floor "
                  f"{row['launch_floor_ms'] * 1e3:.3f} us; grid "
                  f"{row['grid'][0]} x {row['grid'][1]}; ptxas "
                  f"{fig}; kernel vs plain {check}, max |diff| "
                  f"{err:.3g}{extra}")
            ok &= good
            entries[f"{key}.{v.name}"].update(row)
        if key == "micro_prims":
            # a's step is b's test plus a block-wide vote (a barrier)
            a, b = (entries[f"micro_prims.{n}"]
                    for n in ("a_vote_while", "b_dense_fori"))
            a_ns, b_ns = (e["ms"] * 1e6 / (e["tests_per_tile"] * tool.T)
                          for e in (a, b))
            print(f"  [{smi_line}] a's step {a_ns:.4f} ns per tile against "
                  f"b's test {b_ns:.4f} ns: the vote's barrier "
                  f"{a_ns - b_ns:.4f} ns, {100 * (a_ns - b_ns) / a_ns:.1f}% "
                  f"of a's step")
        return ok
    phase("17 M1 micro_prims on the card",
          lambda: p_micro("micro_prims", "micro_prims_T256"))
    phase("18 M2 micro_kwide on the card",
          lambda: p_micro("micro_kwide", "micro_kwide_T256"))

    # -- 19. TestScene through the recursive Tracer ------------------------
    def p_tracer_frame():
        tracer = T.Tracer(compiled, cfg)
        renderer = T.Renderer(tracer, cam, cfg)
        reset_counts()
        rgb, depth = renderer.render(arrays)
        counts = read_counts("testscene_720x480_tracer")
        img = rgb.cpu().numpy()
        finite = bool(np.isfinite(img).all()
                      and torch.isfinite(depth).all().item())
        print(f"  rgb {tuple(img.shape)} finite {finite}, "
              f"{tracer.last_batches} intersect and shadow batches "
              f"(expected K1 launches)")
        write_png(os.path.join(out_dir, "testscene_720x480_tracer_gpu.png"),
                  img)
        ok = canaries_ok("vs out/testscene_tpu.png", quantize(img),
                         read_png(os.path.join(ROOT, "out",
                                               "testscene_tpu.png")))
        if "mega" in frame_imgs:
            ok &= canaries_ok("vs phase 4's wavefront frame", quantize(img),
                              frame_imgs["mega"])
        else:
            ok = False
        frame_ms = cuda_ms(lambda: renderer.render(arrays), 3)
        entries["mega_select"]["tracer_frame_ms"] = frame_ms
        print(f"  [{smi_line}] 720x480 depth-3 frame through Tracer: "
              f"{frame_ms:.3f} ms (CUDA events, mean of 3 after warm-up), "
              f"{n_px / frame_ms / 1e3:.4f} primary Mrays/s")
        return (ok and finite and img.shape == (cfg.yres, cfg.xres, 3)
                and counts["mega_select"] == tracer.last_batches
                and all(counts[k] == 0 for k in kernel_fns
                        if k != "mega_select")
                and counts["plain"] == 0)
    phase("19 TestScene frame 720x480 depth 3 through the recursive Tracer",
          p_tracer_frame)

    # -- 20. a portal with its own light set --------------------------------
    def p_warp_lights():
        ws, wl, wcam = warp_lights_scene()
        wc = T.compile_scene(ws, wl)
        wa = T.to_torch(wc.arrays(), dev)
        wcfg = T.RenderConfig(xres=320, yres=240, maxdepth=3)
        own_lights = tuple(wc.warp_mats[0].lights) != tuple(wc.lights)
        tracer = T.Tracer(wc, wcfg)
        reset_counts()
        rk, _ = T.Renderer(tracer, wcam, wcfg).render(wa)
        counts = read_counts("warp_lights_320x240_tracer")
        rp, _ = T.Renderer(T.Tracer(wc, wcfg, select=MK.PLAIN), wcam,
                           wcfg).render(wa)
        gk, gp = quantize(rk.cpu().numpy()), quantize(rp.cpu().numpy())
        same = float((gk == gp).all(axis=-1).mean())
        print(f"  {tracer.last_batches} batches; kernel and plain frames "
              f"equal on {100 * same:.4f}% of pixels")
        ok = canaries_ok("kernels vs plain set 320x240", gk, gp)
        return (ok and own_lights
                and counts["mega_select"] == tracer.last_batches > 2
                and counts["plain"] == 0)
    phase("20 portal with its own light set through the recursive Tracer",
          p_warp_lights)

    # -- 21. adaptive AA ----------------------------------------------------
    def p_aa():
        aa = T.AARenderer(T.WavefrontTracer(compiled, cfg), cam, cfg)
        reset_counts()
        rgb, depth = aa.render(arrays)
        counts = read_counts("aa_testscene_720x480")
        rc = aa.last_ray_counts
        S = cfg.blocksize
        yy, xx = np.mgrid[0:-(-cfg.yres // S) * S, 0:-(-cfg.xres // S) * S]
        n_pad = xx.size
        # pass 1's pixels: every 4th of the even grid, 1/8 of a frame whose
        # sides are multiples of 4 (720x480 pads to 780x520)
        pass1 = int(((xx % 2 == 0) & (yy % 2 == 0)
                     & ((xx + yy) % 4 == 0)).sum())
        total = sum(rc.values())
        rays_px = total / n_px
        img = rgb.cpu().numpy()
        finite = bool(np.isfinite(img).all())
        overflow = sum(aa.last_overflow.values())
        print(f"  ray counts {rc}: {total} rays, {rays_px:.4f} rays/px "
              f"(padded frame {n_pad} px, pass 1 = {pass1} expected, "
              f"{pass1 / n_pad:.4f} of it), "
              f"overflow {overflow}, finite {finite}")
        write_png(os.path.join(out_dir, "aa_720x480_gpu.png"), img)
        frame_ms = cuda_ms(lambda: aa.render(arrays), 3)
        entries["mega_select"]["aa_frame_ms"] = frame_ms
        entries["mega_select"]["aa_rays_per_px"] = rays_px
        print(f"  [{smi_line}] AA 720x480 frame: {frame_ms:.3f} ms (CUDA "
              f"events, mean of 3 after warm-up), {rays_px:.4f} rays/px, "
              f"{total / frame_ms / 1e3:.4f} Mrays/s")
        ok = (rc["pass1"] == pass1 and rays_px <= 2.0 and finite
              and overflow == 0 and counts["mega_select"] > 0
              and counts["plain"] == 0
              and all(counts[k] == 0 for k in kernel_fns
                      if k != "mega_select"))
        small = T.RenderConfig.tuned(xres=180, yres=120)
        ak = T.AARenderer(T.WavefrontTracer(compiled, small), cam, small)
        ap = T.AARenderer(T.WavefrontTracer(compiled, small,
                                            select=MK.PLAIN), cam, small)
        rk, _ = ak.render(arrays)
        rp, _ = ap.render(arrays)
        print(f"  180x120 ray counts: kernels {ak.last_ray_counts}, plain "
              f"set {ap.last_ray_counts}")
        ok &= canaries_ok("AA 180x120 kernels vs plain set",
                          quantize(rk.cpu().numpy()),
                          quantize(rp.cpu().numpy()))
        return ok
    phase("21 adaptive AA 720x480 through the kernels", p_aa)

    # -- 22. BASELINE config 5 ----------------------------------------------
    def p_config5():
        from glome_tpu_torch.soft import SoftTracer
        from glome_tpu_torch.optimize import optimize, tree_leaves, tree_map
        c5, c5cfg, c5cam, c5tracer, c5true = C5.setup(180, 120, dev)
        target, aa5 = C5.aa_target(c5tracer, c5cam, c5cfg, c5true)
        o5, d5 = C5.pixel_rays(c5tracer, c5cam, c5cfg, dev)
        pert = C5.perturb(c5true)
        H, W = c5cfg.yres, c5cfg.xres
        loss_fn = C5.coarse_to_fine_loss(SoftTracer(c5tracer), H, W)
        ckpt = os.path.join(out_dir, "chip_smoke_config5")
        if os.path.isdir(ckpt):
            for name in os.listdir(ckpt):
                os.remove(os.path.join(ckpt, name))
        stamps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)

        def on_step(i, loss):
            stamps.append(time.perf_counter())
            print(f"  step {i}: loss {loss:.6f}")
        t0 = time.perf_counter()
        run1 = optimize(c5tracer, pert, o5, d5, target, steps=3, lr=5e-3,
                        checkpoint_dir=ckpt, checkpoint_every=2,
                        loss_fn=loss_fn, grad_filter=C5.only_group(),
                        on_step=on_step)
        peak = torch.cuda.max_memory_allocated(dev)
        steps_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps, stamps)]
        saved = sorted(os.listdir(ckpt))
        reset_counts()
        run2 = optimize(c5tracer, pert, o5, d5, target, steps=4, lr=5e-3,
                        checkpoint_dir=ckpt, checkpoint_every=2,
                        loss_fn=loss_fn, grad_filter=C5.only_group(),
                        on_step=on_step)
        counts = read_counts("config5_180x120_step")
        losses = run1.losses + run2.losses
        ms_step = float(np.mean(steps_ms[1:]))
        ref_path = os.path.join(ROOT, "out", "config5", "config5_result.json")
        with open(ref_path) as f:
            ref0 = json.load(f)["losses"][0]
        print(f"  AA target: {sum(aa5.last_ray_counts.values()) / (H * W):.3f}"
              f" rays/px; checkpoints {saved}; resumed run: "
              f"{run2.steps_run} step(s) from step 3")
        print(f"  [{smi_line}] config 5 180x120: {ms_step:.1f} ms per step "
              f"(host wall between steps, each ending with the loss read "
              f"back; mean of steps 2-3), first step {steps_ms[0]:.1f} ms, "
              f"peak memory {peak / 2**30:.3f} GiB "
              f"(torch.cuda.max_memory_allocated)")
        print(f"  first loss {losses[0]:.10f}; the TPU reference's "
              f"losses[0] (out/config5/config5_result.json): {ref0:.10f}")
        entries["mega_select"].update(config5_ms_per_step=ms_step,
                                      config5_peak_bytes=peak,
                                      config5_first_loss=losses[0])
        ok = (run1.steps_run == 3 and run2.steps_run == 1
              and "step_00000002.pt" in saved and "step_00000003.pt" in saved
              and all(np.isfinite(losses)) and counts["mega_select"] > 0
              and counts["plain"] == 0
              and all(counts[k] == 0 for k in kernel_fns
                      if k != "mega_select"))

        # the gradient of one loss at the perturbed scene, through the
        # kernels and through the plain set, after only_group
        def grads(tracer):
            params = tree_map(lambda p: p.clone().requires_grad_(True), pert)
            loss = C5.coarse_to_fine_loss(SoftTracer(tracer), H, W)(
                params, o5, d5, target)
            loss.backward()
            return C5.only_group()(tree_map(
                lambda p: (torch.zeros_like(p) if p.grad is None
                           else p.grad), params))
        gk = grads(c5tracer)
        gp = grads(T.WavefrontTracer(c5, c5cfg, select=MK.PLAIN))
        row = gk["scenes"][0][C5.GROUP]
        kept = [row["center"][C5.ROW], row["radius"][C5.ROW:C5.ROW + 1]]
        prow = gp["scenes"][0][C5.GROUP]
        pkept = [prow["center"][C5.ROW], prow["radius"][C5.ROW:C5.ROW + 1]]
        finite = all(bool(torch.isfinite(g).all()) for g in kept)
        nonzero = all(bool((g != 0).any()) for g in kept)
        others = sum(int((g != 0).sum()) for g in tree_leaves(gk)) - sum(
            int((g != 0).sum()) for g in kept)
        scale = max(float(g.abs().max()) for g in pkept)
        diff = max(float((a - b).abs().max()) for a, b in zip(kept, pkept))
        print(f"  gradient (kernels): center {kept[0].tolist()}, radius "
              f"{kept[1].tolist()}; plain set: center {pkept[0].tolist()}, "
              f"radius {pkept[1].tolist()}; max |diff| {diff:.3g} "
              f"(<= 1e-3 x {scale:.4g}); finite {finite}, nonzero {nonzero}"
              f", nonzero entries elsewhere {others}")
        ok &= (finite and nonzero and others == 0
               and diff <= 1e-3 * scale)

        # where a step's time goes: the same forward + backward with the
        # soft pass (tau 0.01) and without it (tau 0: the hard render),
        # and K1's device time in one profiled soft step
        def fwd_bwd(tau):
            params = tree_map(lambda p: p.clone().requires_grad_(True), pert)
            C5.coarse_to_fine_loss(SoftTracer(c5tracer, tau=tau), H, W)(
                params, o5, d5, target).backward()
        soft_ms = cuda_ms(lambda: fwd_bwd(1e-2), 3)
        hard_ms = cuda_ms(lambda: fwd_bwd(0.0), 3)
        wall, busy, per = PF.profile_kernels(lambda: fwd_bwd(1e-2),
                                             ("mega_select_kernel",), top=8)
        k1 = per["mega_select_kernel"] if per else float("nan")
        print(f"  [{smi_line}] forward + backward: {soft_ms:.3f} ms with the "
              f"soft pass, {hard_ms:.3f} ms without it (the soft pass "
              f"{soft_ms - hard_ms:.3f} ms, "
              f"{100 * (soft_ms - hard_ms) / soft_ms:.1f}% of the step); "
              f"profiled: host wall {wall:.3f} ms, device busy "
              + (f"{busy:.3f} ms, K1 {k1:.3f} ms ({100 * k1 / wall:.2f}% "
                 f"of the step)" if busy is not None else "not measured"))
        entries["mega_select"].update(config5_soft_pass_ms=soft_ms - hard_ms,
                                      config5_fwd_bwd_ms=soft_ms,
                                      config5_k1_device_ms=k1)
        return ok
    phase("22 BASELINE config 5 at 180x120 through the kernels", p_config5)

    # -- 23-28: the CLI (python -m glome_tpu_torch.app) and ray sharding --
    from glome_tpu_torch import app as APP
    from glome_tpu_torch import debug as DBG
    from glome_tpu_torch.pick import PickSession
    from glome_tpu_torch.tools import sharded as SH
    app_dir = tempfile.mkdtemp(prefix="chip_smoke_app_")
    app_frames = {}

    def run_app(argv, name):
        """app.main(argv) in-process, its PNG written into app_dir;
        returns (result dict, PNG path)."""
        path = os.path.join(app_dir, name + ".png")
        return APP.main(argv + ["--out", path]), path

    def only_k1(counts):
        return (counts["plain"] == 0
                and all(counts[k] == 0 for k in kernel_fns
                        if k != "mega_select"))

    # -- 23. the app's TestScene frame --------------------------------------
    def p_app_frame():
        iters = 3
        reset_counts()
        res, path = run_app(["--scene", "test", "--iters", str(iters)],
                            "app_testscene")
        counts = read_counts("app_testscene_720x480_3_frames")
        entries["mega_select"]["launches_by_path"][
            "app_testscene_720x480"] = counts["mega_select"] / iters
        img = read_png(path)
        app_frames["test"] = res["rgb"]
        finite = bool(np.isfinite(res["rgb"]).all())
        ms = [1e3 * s for s in res["render_s"]]
        entries["mega_select"].update(app_setup_s=res["setup_s"],
                                      app_frame_ms=ms)
        print(f"  [{smi_line}] app set-up (compile_scene + to_torch + "
              f"tracer) {res['setup_s']:.3f} s; render "
              + ", ".join(f"{m:.3f}" for m in ms)
              + f" ms (host clock to torch.cuda.synchronize); K1 "
              f"{counts['mega_select'] / iters:g} per frame (expected 6), "
              f"overflow {res['overflow']}")
        ok = canaries_ok("app PNG vs out/testscene_tpu.png", img,
                         read_png(os.path.join(ROOT, "out",
                                               "testscene_tpu.png")))
        # the set-up apart, on the host clock: compile_scene, to_torch,
        # the tracer, and the megakernel plan that the first frame builds,
        # with every BVH build of these steps timed on its own
        from glome_tpu_torch import accel as A
        builders = {k: getattr(A, k) for k in ("build_bvh", "build_bvh2")}
        bvh = {"s": 0.0, "n": 0}

        def timed(fn):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    bvh["s"] += time.perf_counter() - t
                    bvh["n"] += 1
            return run
        split = {}
        for k, fn in builders.items():
            setattr(A, k, timed(fn))
        try:
            solid, lights, _cam = test_scene()
            t0 = time.perf_counter()
            comp = T.compile_scene(solid, lights)
            split["compile_scene_s"] = time.perf_counter() - t0
            split["compile_scene_bvh_s"] = bvh["s"]
            t0 = time.perf_counter()
            T.to_torch(comp.arrays(), dev)
            torch.cuda.synchronize()
            split["to_torch_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            T.WavefrontTracer(comp, T.RenderConfig.tuned())
            split["tracer_s"] = time.perf_counter() - t0
            b0 = bvh["s"]
            t0 = time.perf_counter()
            MK.build_plan(comp)
            split["plan_s"] = time.perf_counter() - t0
            split["plan_bvh_s"] = bvh["s"] - b0
            split["bvh_builds"] = bvh["n"]
        finally:
            for k, fn in builders.items():
                setattr(A, k, fn)
        entries["mega_select"]["app_setup_split"] = split
        print(f"  [{smi_line}] set-up apart (host clock): compile_scene "
              f"{split['compile_scene_s']:.3f} s (BVH builds "
              f"{split['compile_scene_bvh_s']:.3f} s), to_torch "
              f"{split['to_torch_s']:.3f} s, WavefrontTracer "
              f"{split['tracer_s']:.3f} s; the megakernel plan (built by "
              f"the first frame) {split['plan_s']:.3f} s, of which its BVH "
              f"builds {split['plan_bvh_s']:.3f} s ({split['bvh_builds']} "
              f"builds in all)")
        return (ok and finite and img.shape == (480, 720, 3)
                and counts["mega_select"] == 6 * iters and only_k1(counts)
                and res["overflow"] == {})
    phase("23 app: TestScene 720x480 depth 3, python -m glome_tpu_torch.app",
          p_app_frame)

    # -- 24. the app's AA frame ---------------------------------------------
    def p_app_aa():
        reset_counts()
        res, _path = run_app(["--scene", "test", "--aa"], "app_aa")
        counts = read_counts("app_aa_720x480")
        rc = res["ray_counts"]
        rays_px = sum(rc.values()) / (720 * 480)
        entries["mega_select"]["app_aa_rays_per_px"] = rays_px
        print(f"  [{smi_line}] app --aa render {1e3 * res['render_s'][0]:.3f}"
              f" ms; ray counts {rc}, {rays_px:.4f} rays/px, K1 "
              f"{counts['mega_select']}")
        return (rc["pass1"] == 50_700 and rays_px <= 2.0
                and counts["mega_select"] == 30 and only_k1(counts)
                and res["overflow"] == {}
                and bool(np.isfinite(res["rgb"]).all()))
    phase("24 app: adaptive AA 720x480", p_app_aa)

    # -- 25. picks ------------------------------------------------------------
    def p_picks():
        reset_counts()
        res, _ = run_app(["--scene", "test", "--pick", "360", "240"], "pick")
        counts = read_counts("app_pick")
        ok = counts["mega_select"] > 0 and only_k1(counts)
        # a hit on the dodecahedron, a miss, an invalid line and 'q'
        script = "136 204\n0 0\nnot a pick\nq\n488 268\n"
        replies, picks = {}, {}
        for select in (MK.KERNELS, MK.PLAIN):
            sess = PickSession(T.WavefrontTracer(compiled, cfg,
                                                 select=select), cam, arrays)
            out = io.StringIO()
            sess.run(inp=io.StringIO(script), out=out)
            replies[select] = out.getvalue().splitlines()
            picks[select] = [sess.pick(x, y) for x, y in
                             ((360, 240), (136, 204), (0, 0), (488, 268))]
        print(f"  --pick 360 240: {res['tags']}; session (kernels): "
              f"{replies[MK.KERNELS]}")
        same = all(a["tags"] == b["tags"]
                   and a["prim_serial"] == b["prim_serial"]
                   for a, b in zip(picks[MK.KERNELS], picks[MK.PLAIN]))
        lines = replies[MK.KERNELS]
        ok &= (same and res["tags"] == picks[MK.PLAIN][0]["tags"]
               and replies[MK.KERNELS] == replies[MK.PLAIN]
               and len(lines) == 4 and lines[1].endswith(" dodecahedron")
               and lines[2].endswith("(no tags)") and lines[3].startswith("?"))
        print(f"  kernels vs plain set: tags and prim_serial equal on "
              f"{len(picks[MK.PLAIN])} picks {same}; session replies equal "
              f"{replies[MK.KERNELS] == replies[MK.PLAIN]}")
        return ok
    phase("25 app: picks (--pick, PickSession)", p_picks)

    # -- 26. work maps --------------------------------------------------------
    def p_work_maps():
        ok = True
        for flag in ("--debug", "--debug-full"):
            reset_counts()
            res, _ = run_app(["--scene", "test", flag], flag[2:])
            counts = read_counts(f"app_{flag[2:]}_720x480")
            p, n = res["prims"], res["nodes"]
            print(f"  [{smi_line}] {flag} 720x480: {res['debug_s']:.3f} s; "
                  f"prims mean {p.mean():.4f} max {p.max():.0f}, nodes mean "
                  f"{n.mean():.4f} max {n.max():.0f}; K1 "
                  f"{counts['mega_select']}")
            entries["mega_select"][f"app_{flag[2:]}_s"] = res["debug_s"]
            ok &= only_k1(counts) and p.max() > 0 and n.max() > 0
            ok &= (counts["mega_select"] == 0 if flag == "--debug"
                   else counts["mega_select"] > 0)
        cpu = T.to_torch(compiled.arrays(), "cpu")
        maps = {}
        for key, a, full, select in (("cpu", cpu, False, MK.KERNELS),
                                     ("card", arrays, False, MK.KERNELS),
                                     ("kernels", arrays, True, MK.KERNELS),
                                     ("plain", arrays, True, MK.PLAIN)):
            maps[key] = DBG.debug_image(compiled, a, cam, 180, 120,
                                        full=full, select=select)[1:]
        for a, b in (("card", "cpu"), ("kernels", "plain")):
            same = [float((x == y).mean()) for x, y in zip(maps[a], maps[b])]
            print(f"  180x120 {'--debug' if a == 'card' else '--debug-full'}"
                  f": {a} vs {b}: prims equal on {100 * same[0]:.4f}%, "
                  f"nodes on {100 * same[1]:.4f}% of pixels")
            ok &= same == [1.0, 1.0]
        return ok
    phase("26 app: work maps (--debug, --debug-full)", p_work_maps)

    # -- 27. the NFF fixtures -------------------------------------------------
    def p_nff():
        ok = True
        for name in ("miniflake", "gears"):
            reset_counts()
            res, path = run_app(
                ["--scene", os.path.join(ROOT, "tests", "fixtures",
                                         name + ".nff"), "--depth", "2"],
                "nff_" + name)
            counts = read_counts(f"app_nff_{name}")
            gold = np.load(os.path.join(ROOT, "tests", "golden",
                                        name + "_rgb.npy"))
            diff = np.abs(res["rgb"] - gold)
            print(f"  {name}.nff {res['xres']}x{res['yres']}: max |diff| vs "
                  f"tests/golden/{name}_rgb.npy {diff.max():.6g}, "
                  f"{int((diff.max(axis=-1) > 1e-5).sum())} pixels beyond "
                  f"1e-5; K1 {counts['mega_select']}")
            ok &= canaries_ok(f"{name} vs golden", read_png(path),
                              quantize(gold))
            ok &= counts["mega_select"] > 0 and only_k1(counts)
        return ok
    phase("27 app: NFF fixtures", p_nff)

    # -- 28. ray sharding over torch.distributed ------------------------------
    def p_sharded():
        ok = True
        outs = {}
        for scene, jobs in (("test", "render"), ("two_prim", "train")):
            d = os.path.join(app_dir, "sharded_" + scene)
            t0 = time.perf_counter()
            rc = SH.main(["--scene", scene, "--jobs", jobs, "--nprocs", "2",
                          "--timeout", "600", "--out", d])
            print(f"  {scene} {jobs}: 2 gloo ranks on one card, exit {rc}, "
                  f"{time.perf_counter() - t0:.1f} s with process start")
            if rc != 0:
                return False
            outs[scene] = [torch.load(os.path.join(d, f"rank{r}.pt"))
                           for r in (0, 1)]
        for r in outs["test"] + outs["two_prim"]:
            ok &= not r["foreign_modules"]
        ranks = outs["test"]
        for r in ranks:
            entries["mega_select"]["launches_by_path"][
                f"sharded_testscene_rank{r['rank']}"] = r["render_launches"]
        want = app_frames.get("test")
        if want is None:
            print("  phase 23's frame is missing")
            return False
        for r in ranks:
            got = torch.clamp(r["rgb"], 0.0, 1.0).numpy()
            diff = np.abs(got - want)
            n_px = int((diff.max(axis=-1) > 0).sum())
            lv = int((quantize(got) != quantize(want)).any(axis=-1).sum())
            print(f"  [{smi_line}] rank {r['rank']}: TestScene 720x480 "
                  f"sharded frame {1e3 * r['render_s']:.3f} ms warm, "
                  f"{1e3 * r['render_cold_s']:.3f} ms cold (half the rays, "
                  f"with the all-gather; host clock to synchronize), K1 "
                  f"{r['render_launches']} in the warm one; "
                  f"vs phase 23's single-process frame: max |diff| "
                  f"{diff.max():.6g}, {n_px} pixels differ, {lv} in their "
                  f"8-bit value")
            ok &= (diff.max() <= 1e-5 and lv == 0
                   and r["render_launches"] == 6)
        _c, c2, cam2, tr2, a2 = SH.scene_setup("two_prim", dev)
        o2, d2, _inv = SH.frame_rays(tr2, cam2, c2, dev)
        new, loss = SH.full_batch_step(tr2, a2, o2, d2, torch.zeros_like(o2),
                                       SH.LR)
        from glome_tpu_torch.optimize import tree_leaves
        tr = outs["two_prim"]
        rel = max(float(((a - b.cpu()).abs() / (b.cpu().abs() + 1e-7)).max())
                  for r in tr for a, b in zip(tree_leaves(r["new_arrays"]),
                                              tree_leaves(new)))
        l0, l1 = (float(r["loss"]) for r in tr)
        print(f"  two-prim train step: loss rank 0 {l0:.9g}, rank 1 "
              f"{l1:.9g}, single process {float(loss):.9g}; new arrays vs "
              f"the full-batch step: max rel diff {rel:.3g}; K1 per rank "
              f"{[r['train_launches'] for r in tr]}")
        ok &= (l0 == l1 and abs(l0 - float(loss)) <= 1e-6 * abs(float(loss))
               and rel <= 1e-5 and all(r["train_launches"] > 0 for r in tr))
        return ok
    phase("28 ray sharding: 2 gloo ranks on one card", p_sharded)
    shutil.rmtree(app_dir, ignore_errors=True)

    # -- 29. mesh100k on the pass-per-group route ----------------------------
    def p_mesh_groups():
        from glome_tpu_torch import accel as A
        e = entries["bvh_select"]
        ok = True
        # the set-up apart, on the host clock
        split = {}
        t0 = time.perf_counter()
        s, lt, c = mesh_scene(100_000, cast_shadows=True)
        cc = T.compile_scene(s, lt)
        split["compile_scene_s"] = time.perf_counter() - t0
        sc = cc.scenes[0]
        gi = next(i for i, g in enumerate(sc.groups) if g.accel_eligible)
        g = sc.groups[gi]
        t0 = time.perf_counter()
        bounds = A.group_bounds(g)
        split["group_bounds_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bvh = group_accel(g)          # the native builder, cached on g
        split["native_build_bvh_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = A.build_bvh(*bounds, native=False)
        split["numpy_build_bvh_s"] = time.perf_counter() - t0
        same = all(np.array_equal(getattr(bvh, k), getattr(ref, k))
                   and getattr(bvh, k).dtype == getattr(ref, k).dtype
                   for k in ("bmin", "bmax", "leaf_start", "leaf_count",
                             "skip", "order"))
        t0 = time.perf_counter()
        pairs = A.skip_link_pairs(bvh)
        A.node_records(pairs.bmin, pairs.bmax, pairs.left, pairs.right,
                       pairs.leaf_start, pairs.leaf_count)
        split["skip_link_pairs_node_records_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        recs = GK.bvh_records(bvh, dev)
        torch.cuda.synchronize()
        split["bvh_records_upload_s"] = time.perf_counter() - t0
        e["mesh100k_setup"] = split
        print(f"  [{smi_line}] set-up apart (host clock): "
              + ", ".join(f"{k[:-2]} {v:.3f} s" for k, v in split.items()))
        print(f"  mesh group: {g.size} {g.ptype} rows; skip-link tree "
              f"{bvh.n_nodes} nodes; native tables bit-equal to the numpy "
              f"builder's on this host: {same}; records of {recs.n_nodes} "
              f"nodes, depth {recs.depth}, walk stack "
              f"{kernels.walk_stack(recs.depth)} entries per thread")
        ok &= same and g.size == 99_904
        # the frames, with and without the mesh's shadows
        garrs = T.to_torch(cc.arrays(), dev)
        for cast_shadows in (False, True):
            if cast_shadows:
                fc, fa = cc, garrs
            else:
                fc, fa, _mp, _c, _grp = mesh(100_000, False)
            path = f"mesh100k_1080p_groups_cast{int(cast_shadows)}"
            tracer = T.WavefrontTracer(fc, mcfg, route=GROUPS)
            renderer = T.Renderer(tracer, c, mcfg)
            reset_counts()
            t0 = time.perf_counter()
            rgb, depth = renderer.render(fa)
            torch.cuda.synchronize()
            first = time.perf_counter() - t0
            counts = read_counts(path)
            batches = tracer.last_batches
            ov = int(renderer.last_overflow.sum())
            img = rgb.cpu().numpy()
            finite = bool(np.isfinite(img).all()
                          and torch.isfinite(depth).all().item())
            write_png(os.path.join(out_dir, f"{path}_gpu.png"), img)
            ms = cuda_ms(lambda: renderer.render(fa), 3)
            e[f"{path}_ms"] = ms
            print(f"  [{smi_line}] {path}: rgb {tuple(img.shape)} finite "
                  f"{finite}, overflow {ov}, {batches} batches (expected "
                  f"K4 1 and K5 1 per batch); first frame {first:.3f} s "
                  f"host wall; {ms:.3f} ms per frame (CUDA events, mean of "
                  f"3 after warm-up), "
                  f"{MESH_RES[0] * MESH_RES[1] / ms / 1e3:.4f} primary "
                  f"Mrays/s")
            mega_path = f"mesh100k_1080p_cast{int(cast_shadows)}"
            if mega_path in mesh_imgs:
                ok &= canaries_ok(f"vs phase 9's {mega_path} (K1 + K2)",
                                  quantize(img), mesh_imgs[mega_path])
            else:
                print(f"  no phase 9 frame {mega_path} to compare")
                ok = False
            ok &= (finite and ov == 0 and batches == 2
                   and img.shape == (MESH_RES[1], MESH_RES[0], 3)
                   and counts["dense_select"] == batches
                   and counts["bvh_select"] == batches
                   and counts["mega_select"] == 0
                   and counts["block_select"] == 0
                   and counts["mesh_block_select"] == 0
                   and counts["plain"] == 0)
        # K5 on all L0 rays and all their shadow rays, as the frame
        # launches it; the plain version, brute force over every row, on
        # an evenly spread subset of each (one call, timed by CUDA events)
        mg = dict(garrs)
        mg["scenes"] = [materialize_scene_params(sc, garrs["scenes"][0])]
        Q, t1, sh = mesh_l0(100_000)
        sub = {}
        for shadow, rays, seed in ((False, Q, t1), (True, sh, sh[6])):
            fn, plain, args, _kw = group_args(cc, mg, 0, gi, "bvh", shadow)
            ix = subset(rays.shape[1])
            rs, ss = sub_rays(rays, seed)
            k = fn(*args, rays, seed, shadow=shadow)
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            p = plain(*args, rs, ss, shadow=shadow)
            ev1.record()
            torch.cuda.synchronize()
            sub[shadow] = (rs, ss, ev0.elapsed_time(ev1))
            mode = "shadow" if shadow else "intersect"
            good, err = compare(f"mesh100k 1080p L0 {mode} on the group "
                                f"route (full launch, {SUBSET}-lane subset "
                                f"checked; plain {sub[shadow][2]:.1f} ms)",
                                as_np([a[ix] for a in k]), as_np(p), shadow,
                                exact=True)
            ok &= good
            if not shadow:
                e["mesh100k_max_abs_err"] = err
        # K5's time and bound on the L0 batch; on the L0 subset beside the
        # plain version's time there
        fn, plain, args, _kw = group_args(cc, mg, 0, gi, "bvh", False)
        rs, ss, pms = sub[False]
        before = clocks()
        kms = cuda_ms(lambda: fn(*args, Q, t1), 10)
        ksub = cuda_ms(lambda: fn(*args, rs, ss), 10)
        e.update(mesh100k_ms=kms, mesh100k_plain_ms=pms,
                 mesh100k_rays=Q.shape[1], mesh100k_plain_rays=SUBSET,
                 mesh100k_subset_ms=ksub,
                 mesh100k_smem_bytes=kernels.walk_stack(recs.depth)
                 * kernels.WALK_THREADS * kernels.STACK_ENTRY_BYTES)
        print(f"  [{smi_line}] bvh_select on mesh100k L0: {kms:.4f} "
              f"ms/launch ({Q.shape[1]} rays, CUDA events); on the "
              f"{SUBSET}-ray subset {ksub:.4f} ms vs plain {pms:.4f} ms "
              f"({pms / ksub:.1f}x) (clocks before: {before})")
        tally = torch.zeros((2, Q.shape[1]), dtype=torch.int32, device=dev)
        fn(*args, Q, t1, tally=tally)
        tabs = [a for a in args if torch.is_tensor(a)] + [
            args[-1].cf, args[-1].desc, recs.nodes]
        bound("bvh_select", 28 * Q.shape[1], 8 * Q.shape[1],
              sum(t.numel() * t.element_size() for t in tabs), tally.cpu(),
              TRI_FLOPS, prefix="mesh100k_")
        return ok
    phase("29 mesh100k 1920x1080 depth 1 on the group route",
          p_mesh_groups)

    # -- 30. the frame-profiling tool on every path ---------------------------
    def p_profile():
        mc, ma, _mp, mcam, _grp = mesh(100_000, True)
        # (key, workload, K1-K5 launches the path makes per run, from the
        # tracer's batch count where that is per batch)
        work = (
            ("testscene_mega", PF.frame_workload(
                "TestScene 720x480 depth 3, megakernel route", compiled,
                arrays, cam, cfg, MEGA),
             lambda b: {"K1": 2 * cfg.maxdepth}),
            ("testscene_groups", PF.frame_workload(
                "TestScene 720x480 depth 3, group route", compiled, arrays,
                cam, cfg, GROUPS),
             lambda b: {"K4": n_dense * b, "K5": n_bvh * b}),
            ("mesh100k_shadows_mega", PF.frame_workload(
                "mesh100k 1920x1080 depth 1 self-shadowing, megakernel "
                "route", mc, ma, mcam, mcfg, MEGA),
             lambda b: {"K1": 2, "K2": 2}),
            ("mesh100k_shadows_groups", PF.frame_workload(
                "mesh100k 1920x1080 depth 1 self-shadowing, group route", mc,
                ma, mcam, mcfg, GROUPS),
             lambda b: {"K4": b, "K5": b}),
            ("aa_testscene", PF.aa_workload(
                "AA TestScene 720x480 depth 3, megakernel route", compiled,
                arrays, cam, cfg, MEGA),
             lambda b: {"K1": 30}),
            ("config5_step", PF.config5_workload(compiled, arrays, cam, 180,
                                                 120),
             lambda b: {"K1": 6}),
            # the compiled frame's replay (--frame compiled)
            ("compiled_testscene", PF.compiled_workload(
                "TestScene 720x480 depth 3, bench's frame", compiled, arrays,
                cam, cfg),
             lambda b: {"K1": 2 * cfg.maxdepth}),
            ("compiled_mesh100k_shadows", PF.compiled_workload(
                "mesh100k 1920x1080 depth 1 self-shadowing, bench's frame",
                mc, ma, mcam, mcfg),
             lambda b: {"K1": 2, "K2": 2}),
            ("compiled_aa_testscene", PF.compiled_workload(
                "AA TestScene 720x480 depth 3", compiled, arrays, cam, cfg,
                aa=True),
             lambda b: {"K1": 30}))
        ok = True
        for key, w, want_fn in work:
            reset_counts()
            rep = PF.profile(w, dev, smi_line)
            read_counts(f"profile_{key}")
            want = want_fn(w.tracer.last_batches)
            kernels = {f"K{i}": rep.counts[f"K{i}"] for i in range(1, 6)}
            plain = sum(v for k, v in rep.counts.items() if "plain" in k)
            launches_ok = (kernels == {k: want.get(k, 0) for k in kernels}
                           and plain == 0)
            # every span's device time lies within the profiler's
            busy = rep.busy_ms or 0.0
            spans_ok = (busy > 0 and rep.row("wavefront.trace") is not None
                        and all(r.busy_ms is not None
                                and r.busy_ms <= busy + 1e-6
                                for r in rep.spans))
            good = launches_ok and spans_ok
            text = (f"K1-K5 launches {kernels}, expected {want} "
                    f"({w.tracer.last_batches} batches in the last trace), "
                    f"plain calls {plain}; span rows' device ms within the "
                    f"profiler's {busy:.3f}: {spans_ok}")
            if w.eager is not None:
                good &= rep.same and rep.per_frame["captures"] == 0
                text += (f"; equal to the eager frame {rep.same}, captures "
                         f"{rep.per_frame['captures']}")
            print(f"  [{smi_line}] {w.name}: {text} -> "
                  f"{'ok' if good else 'FAIL'}")
            ok &= good
            torch.cuda.empty_cache()
        return ok
    phase("30 the frame-profiling tool (python -m "
          "glome_tpu_torch.tools.profile_frame) on every path", p_profile)

    # -- 32. the scaling harness (rank subprocesses sharing the card) -------
    def p_scaling():
        t0 = time.perf_counter()
        out = os.path.join(ROOT, "build", "smoke_scaling.json")
        proc = subprocess.run(
            [sys.executable, "-m", "glome_tpu_torch.tools.scaling_bench",
             "--counts", ",".join(map(str, SCALING_COUNTS)),
             "--timeout", "300", "--out", out], cwd=ROOT,
            capture_output=True, text=True, timeout=900)
        shutil.rmtree(SB.rank_dir(out), ignore_errors=True)  # the frames
        for line in proc.stderr.splitlines():
            print(f"  {'[' + smi_line + '] ' if ' ms [' in line else ''}"
                  f"{line}")
        lines = proc.stdout.splitlines()
        print(f"  exit {proc.returncode} after "
              f"{time.perf_counter() - t0:.1f} s, {len(lines)} stdout lines")
        if proc.returncode != 0 or len(lines) != 1:
            return False
        print(f"  [{smi_line}] scaling: {lines[0]}")
        p = json.loads(lines[0])
        missing = [k for k in SB.SCALING_KEYS + SB.ADDED_KEYS if k not in p]
        # one launch of each count runs both series: a warm-up and the
        # timed frames each, K1_PER_FRAME K1 launches a frame
        per_series = (p["reps"] + 1) * SB.K1_PER_FRAME["cuda"]
        want = {str(n): [per_series * (1 + (m is not None))] * n
                for n, m in zip(p["devices"], p["ms_core_per_rank"])}
        for n, ks in p["k1_launches"].items():
            for r, k in enumerate(ks):
                entries["mega_select"]["launches_by_path"][
                    f"scaling_n{n}_rank{r}"] = k
        bad = [m for m in p["ms"] + p["ms_core_per_rank"]
               if m is not None and not m > 0]
        print(f"  missing keys {missing}, readings <= 0 {bad}; K1 launches "
              f"per rank {p['k1_launches']}, want {want}")
        ok = (not missing and not bad and None not in p["ms"]
              and p["k1_launches"] == want and p["backend"] == "cuda"
              and p["devices"] == list(SCALING_COUNTS))
        # K1 at the harness's shapes: simple_scene's first-level batches
        # of the one-rank frame and of one of eight ranks, against the
        # plain version; timed, and bounded from its tally
        stracer, sarrays, so, sd = SB.setup(dev, SB.N_RAYS)
        sc = stracer.compiled
        stabs = MK.pack_tables(MK.get_plan(sc), sc, sarrays)
        n = so.shape[0]
        q = torch.cat([so.t(), sd.t(), torch.full((1, n), T.INFINITY,
                                                  device=dev),
                       torch.zeros((1, n), device=dev)]).contiguous()
        sh = KAB.l0_shadow(sc, sarrays, q)
        shard = q[:, :n // SCALING_COUNTS[-1]].contiguous()
        for label, rays, shadow in (("L0", q, False),
                                    (f"L0 of one of {SCALING_COUNTS[-1]} "
                                     "ranks", shard, False),
                                    ("first shadow", sh, True)):
            good, err = compare(f"K1 vs plain, simple_scene {label}",
                                *both(stabs, rays, shadow), shadow)
            ok &= good
            if label == "L0":
                entries["mega_select"]["scaling_max_abs_err"] = err
        kms = cuda_ms(lambda: MK.mega_select(stabs, q, False), 20)
        pms = cuda_ms(lambda: MK.mega_select_plain(stabs, q, False), 3)
        entries["mega_select"].update(scaling_ms=kms, scaling_plain_ms=pms,
                                      scaling_rays=n)
        tally = torch.zeros((MK.TALLY_ROWS, n), dtype=torch.int32,
                            device=dev)
        MK.mega_select(stabs, q, False, tally=tally)
        tbytes = sum(t.numel() * t.element_size() for t in
                     (stabs.pf, stabs.pi, stabs.nf, stabs.ni, stabs.nodes,
                      stabs.bb, stabs.pbox, stabs.phases))
        bound("mega_select", 32 * n, 12 * n, tbytes, tally.cpu(),
              MIN_PRIM_FLOPS, prefix="scaling_")
        print(f"  [{smi_line}] simple_scene L0 batch ({n} rays): K1 "
              f"{kms:.4f} ms/launch, plain {pms:.4f} ms/launch "
              f"({pms / kms:.2f}x)")
        return ok
    phase("32 scaling: python -m glome_tpu_torch.tools.scaling_bench",
          p_scaling)

    # -- 33. the compiled frame ----------------------------------------------
    def frame_ms(fn):
        """(output, ms) of one frame timed alone by CUDA events (the end
        event waits for the host's last launch)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def compiled_case(name, make, want, fin, reps=3):
        """make(frame) -> (tracer, frame function returning a tuple of
        tensors).  The compiled and the eager frame in turns on the same
        inputs: the capture frame, then compiled, eager, eager, compiled
        ... (reps of each, timed); every compiled frame equal to the eager
        frame on every lane, zero captures after the first, and the
        launches of the capture frame and of one replay frame (counts
        reset just before each) as `want` and `fin` finalize_hit
        launches, no plain call and no torch finalize.  Captures,
        replays and host reads per frame are the tracer's GraphCache
        totals over the frame (the AA frame traces five times)."""
        ctracer, cframe = make(COMPILED)
        etracer, eframe = make(EAGER)
        totals = ctracer.graphs.totals

        def per_frame(fn):
            before = dict(totals)
            out = fn()
            return out, {k: totals[k] - before[k] for k in totals}
        reset_counts()
        t0 = time.perf_counter()
        first, first_stats = per_frame(cframe)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        ccounts = read_counts(f"compiled_{name}_capture")
        widths = ctracer.last_frame.get("widths")
        eager = eframe()
        torch.cuda.synchronize()
        same = [all(torch.equal(a, b) for a, b in zip(first, eager))]
        worst = 0.0
        reset_counts()
        out, st = per_frame(cframe)
        counts = read_counts(f"compiled_{name}")
        stats = [st]
        same.append(all(torch.equal(a, b) for a, b in zip(out, eager)))
        cms, ems = [], []
        for i in range(2 * reps):
            for frame in (("c", "e") if i % 2 == 0 else ("e", "c")):
                if frame == "c":
                    (res, ms), st = per_frame(lambda: frame_ms(cframe))
                    cms.append(ms)
                    stats.append(st)
                    same.append(all(torch.equal(a, b)
                                    for a, b in zip(res, eager)))
                else:
                    _res, ms = frame_ms(eframe)
                    ems.append(ms)
        for a, b in zip(out, eager):
            if a.is_floating_point():
                worst = max(worst, float((a - b).abs().max()))
        captures = [st["captures"] for st in stats]
        reads = sorted({st["host_reads"] for st in stats})
        pool = ctracer.graphs.pool_bytes()
        cmed = sorted(cms)[len(cms) // 2]
        emed = sorted(ems)[len(ems) // 2]
        print(f"  [{smi_line}] {name}: replay {cmed:.3f} ms, eager "
              f"{emed:.3f} ms (medians of {len(cms)}; replay "
              f"{', '.join(f'{m:.3f}' for m in cms)}; eager "
              f"{', '.join(f'{m:.3f}' for m in ems)}), {emed / cmed:.2f}x; "
              f"capture frame {capture_s:.3f} s ({first_stats['captures']} "
              f"segments captured); captures per later frame {captures}; "
              f"host reads per frame {reads}; widths {widths}; pool {pool} "
              f"bytes, {len(ctracer.graphs)} segments cached, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated()}")
        print(f"    every compiled frame equal to the eager frame on every "
              f"lane: {all(same)} ({same.count(False)} of {len(same)} "
              f"differ; max |diff| of the replay {worst})")
        compiled_frames[name] = dict(
            replay_ms=cmed, eager_ms=emed, capture_s=capture_s,
            captures=captures, host_reads=reads, pool_bytes=pool,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            equal=all(same), max_abs_diff=worst)
        ok = (all(same) and not any(captures)
              and all(c[k] == want.get(k, 0) for k in kernel_fns
                      for c in (ccounts, counts))
              and ccounts["finalize_hit"] == counts["finalize_hit"] == fin
              and ccounts["plain"] == counts["plain"] == 0
              and ccounts["finalize_torch"] == counts["finalize_torch"] == 0)
        del ctracer, etracer
        torch.cuda.empty_cache()
        return ok

    compiled_frames = {}

    def p_compiled():
        ok = True

        def render_case(cc, garrs, c, rcfg):
            def make(frame):
                r = T.Renderer(T.WavefrontTracer(cc, rcfg, frame=frame), c,
                               rcfg)
                return r.tracer, lambda: r.render(garrs)
            return make

        # bench's frame: tracer.trace on bench.py's rays (built once, in
        # tile order), origins jittered by a fixed mean colour
        def bench_case(cc, garrs, c, rcfg):
            def make(frame):
                tr = T.WavefrontTracer(cc, rcfg, frame=frame)
                o, d, _perm = BENCH.frame_rays(T.Renderer(tr, c, rcfg), dev)
                oj = o + torch.tensor([0.21, 0.17, 0.13], device=dev) * 1e-4
                return tr, lambda: tuple(tr.trace(garrs, oj, d))[:4]
            return make

        ok &= compiled_case("testscene_720x480_render",
                            render_case(compiled, arrays, cam, cfg),
                            {"mega_select": 2 * cfg.maxdepth}, cfg.maxdepth)
        ok &= compiled_case("testscene_720x480_bench",
                            bench_case(compiled, arrays, cam, cfg),
                            {"mega_select": 2 * cfg.maxdepth}, cfg.maxdepth)
        for n_tris, cast, want in (
                (100_000, False, {"mega_select": 2, "block_select": 1}),
                (100_000, True, {"mega_select": 2, "block_select": 2}),
                (250_000, True, {"mega_select": 2, "mesh_block_select": 2})):
            cc, garrs, _mp, c, _grp = mesh(n_tris, cast)
            ok &= compiled_case(
                f"mesh{n_tris // 1000}k_1080p_cast{int(cast)}_bench",
                bench_case(cc, garrs, c, mcfg), want, mcfg.maxdepth)

        def aa_case(frame):
            a = T.AARenderer(T.WavefrontTracer(compiled, cfg, frame=frame),
                             cam, cfg)
            return a.tracer, lambda: a.render(arrays)
        ok &= compiled_case("aa_testscene_720x480", aa_case,
                            {"mega_select": 5 * 2 * cfg.maxdepth},
                            5 * cfg.maxdepth)
        return ok
    phase("33 compiled frame: the wavefront frame captured as CUDA graphs "
          "and replayed, against the eager frame", p_compiled)

    # -- 34. SPD balls at size factor 5 -------------------------------------
    def p_balls():
        from glome_tpu_torch.scenes.spd_balls import balls
        t0 = time.perf_counter()
        solid, lights, c = balls(5)
        bc = T.compile_scene(solid, lights)
        bplan = MK.get_plan(bc)
        barrs = T.to_torch(bc.arrays(), dev)
        print(f"  SPD balls size 5: {bplan.n_prims} prims, K2 groups "
              f"{bplan.blocks}, host parse+compile+plan "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        bcfg = T.RenderConfig(xres=512, yres=512, maxdepth=3,
                              background=(0.078, 0.361, 0.753))
        want = {"mega_select": 2 * bcfg.maxdepth,
                "block_select": 2 * bcfg.maxdepth}
        renderer = T.Renderer(T.WavefrontTracer(bc, bcfg), c, bcfg)
        reset_counts()
        # the capture frame: its warm-ups' kernel inputs are recorded and
        # held against the plain versions
        (rgb, _depth), log = record_inputs(lambda: renderer.render(barrs))
        ccounts = read_counts("spd_balls5_512_capture")
        reset_counts()
        renderer.render(barrs)
        counts = read_counts("spd_balls5_512")
        print(f"  compiled frame: calls "
              f"{[(n, a[rays_at[n]].shape[1]) for n, a in log]}")
        ok = (bplan.blocks == [(0, 0)]
              and sorted(n for n, _a in log)
              == sorted(k for k, v in want.items() for _ in range(v))
              and bool(torch.isfinite(rgb).all()))
        ok &= check_recorded("spd_balls5 compiled frame", log, True)
        ok &= all(cn[k] == want.get(k, 0) for k in kernel_fns
                  for cn in (ccounts, counts))
        ok &= (ccounts["finalize_hit"] == counts["finalize_hit"]
               == bcfg.maxdepth)
        ok &= ccounts["plain"] == counts["plain"] == 0
        ok &= ccounts["finalize_torch"] == counts["finalize_torch"] == 0
        del renderer, log

        def make(frame):
            r = T.Renderer(T.WavefrontTracer(bc, bcfg, frame=frame), c, bcfg)
            return r.tracer, lambda: r.render(barrs, 0.25)
        return compiled_case("spd_balls5_512x512_render", make, want,
                             bcfg.maxdepth) and ok
    phase("34 SPD balls size 5 512x512 depth 3: K1 and K2 on the compiled "
          "frame", p_balls)

    # -- 35. the fused finalize against the torch finalize -------------------
    class FinalizeTap:
        """megakernel.finalize where the path looks it up: records the
        inputs of each call made outside a capture (the capture frame's
        warm-ups) and calls finalize; its counters are finalize's."""

        def __init__(self, fn, log):
            self.__dict__.update(fn=fn, log=log)

        def __call__(self, compiled, plan, arrays, o, d, t, wid, aux=None,
                     want_meta=True, select=MK.KERNELS):
            if not torch.cuda.is_current_stream_capturing():
                self.log.append((compiled, plan, arrays) + tuple(
                    None if a is None else a.clone()
                    for a in (o, d, t, wid, aux)) + (want_meta,))
            return self.fn(compiled, plan, arrays, o, d, t, wid, aux=aux,
                           want_meta=want_meta, select=select)

        def __getattr__(self, k):
            return getattr(self.__dict__["fn"], k)

        def __setattr__(self, k, v):
            setattr(self.fn, k, v)

    def hit_diff(a, b):
        """{field: lanes that differ, or its layouts} of two Hits, floats
        compared as their bits."""
        bad = {}
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            if (x.shape, x.dtype, x.stride()) != (y.shape, y.dtype,
                                                  y.stride()):
                bad[name] = (f"{tuple(x.shape)} {x.dtype} {x.stride()} "
                             f"against {tuple(y.shape)} {y.dtype} "
                             f"{y.stride()}")
                continue
            if not x.numel():
                continue
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            ne = (x != y).reshape(x.shape[0], -1).any(dim=1)
            if bool(ne.any()):
                bad[name] = int(ne.sum())
        return bad

    def p_finalize():
        from glome_tpu_torch.scenes.spd_balls import balls
        ok = True
        bsolid, blights, bcam = balls(5)
        bc = T.compile_scene(bsolid, blights)
        bcfg = T.RenderConfig(xres=512, yres=512, maxdepth=3,
                              background=(0.078, 0.361, 0.753))
        cases = (("testscene", compiled, arrays, cam, cfg),
                 ("spd_balls5", bc, T.to_torch(bc.arrays(), dev), bcam,
                  bcfg))
        l0 = None
        for name, cc, garrs, c, rcfg in cases:
            renderer = T.Renderer(T.WavefrontTracer(cc, rcfg), c, rcfg)
            log = []
            real = MK.finalize
            MK.finalize = FinalizeTap(real, log)
            try:
                reset_counts()
                renderer.render(garrs)
                ccounts = read_counts(f"finalize_{name}_capture")
            finally:
                MK.finalize = real
            reset_counts()
            renderer.render(garrs)
            counts = read_counts(f"finalize_{name}")
            ok &= all(cn["finalize_hit"] == rcfg.maxdepth
                      and cn["finalize_torch"] == 0
                      for cn in (ccounts, counts))
            ok &= len(log) == rcfg.maxdepth
            for i, args in enumerate(log):
                o, wid = args[3], args[6]
                fused = MK._finalize_fused(*args)
                ref = MK._finalize_torch(*args)
                torch.cuda.synchronize()
                bad = hit_diff(fused, ref)
                hits = int((wid >= 0).sum())
                print(f"  {name} level {i}: {o.shape[0]} lanes, {hits} hits, "
                      f"rays "
                      f"{'row-major' if MK._fused_layout(o) else 'table rows'}"
                      f"; fused Hit = torch Hit bit for bit on every lane "
                      f"and field: {not bad} {bad or ''}")
                ok &= not bad and (i > 0 or hits > 0)
            if name == "testscene":
                l0 = log[0]
            del renderer, log
        # the kernel's time and bound on TestScene's level-0 call
        o = l0[3]
        n = o.shape[0]
        kms = cuda_ms(lambda: MK._finalize_fused(*l0), 20)
        tms = cuda_ms(lambda: MK._finalize_torch(*l0), 5)
        plan = l0[1]
        warp = any(tr and w for _p, tr, _g, w in plan.combos)
        retex = l0[7] is not None and bool(plan.atex_all.any())
        # read once: o, d, t, wid (and aux); written once: t, hit, pos,
        # norm, tex, tag, serial (and the object rays)
        lane_bytes = (24 + 4 + 4 + 4 * retex
                      + 4 + 1 + 12 + 12 + 16 + 16 + 4 + 24 * warp)
        bound = n * lane_bytes / HBM_BPS * 1e3
        entries["finalize_hit"].update(
            ms=kms, torch_ms=tms, rays=n, bytes_per_lane=lane_bytes,
            bound_ms=bound, bound_by="bytes")
        print(f"  [{smi_line}] TestScene level 0, {n} lanes: finalize_hit "
              f"{kms:.4f} ms, torch ops {tms:.4f} ms ({tms / kms:.1f}x); "
              f"bound {1e3 * bound:.2f} us ({lane_bytes} B a lane over "
              f"3.35 TB/s), {100 * bound / kms:.1f}% of it")
        return ok
    phase("35 fused finalize against the torch finalize on the compiled "
          "frame's own inputs", p_finalize)

    # -- 36. SPD tetra at SizeFactor 9: K3 on the compiled frame -------------
    def p_tetra():
        from glome_tpu_torch.scenes.spd_tetra import tetra
        t0 = time.perf_counter()
        solid, lights, c = tetra(8)
        tc = T.compile_scene(solid, lights)
        tplan = MK.get_plan(tc)
        tarrs = T.to_torch(tc.arrays(), dev)
        print(f"  SPD tetra, 8 subdivisions: {tplan.n_prims} prims, K3 "
              f"groups {tplan.external}, K2 groups {tplan.blocks}, host "
              f"parse+compile+plan {time.perf_counter() - t0:.1f} s",
              flush=True)
        tcfg = T.RenderConfig(xres=512, yres=512, maxdepth=3,
                              background=(0.078, 0.361, 0.753))
        want = {"mega_select": 2 * tcfg.maxdepth,
                "mesh_block_select": 2 * tcfg.maxdepth}
        renderer = T.Renderer(T.WavefrontTracer(tc, tcfg), c, tcfg)
        fin_log = []
        real = MK.finalize

        def capture_frame():
            MK.finalize = FinalizeTap(real, fin_log)
            try:
                return renderer.render(tarrs)
            finally:
                MK.finalize = real
        reset_counts()
        # the capture frame: its warm-ups' K1, K3 and finalize inputs are
        # recorded and held against the plain versions and the torch
        # finalize
        (rgb, _depth), log = record_inputs(capture_frame)
        ccounts = read_counts("spd_tetra8_512_capture")
        reset_counts()
        renderer.render(tarrs)
        counts = read_counts("spd_tetra8_512")
        print(f"  compiled frame: calls "
              f"{[(n, a[rays_at[n]].shape[1]) for n, a in log]}")
        ok = (tplan.external == [(0, 0)] and tplan.blocks == []
              and sorted(n for n, _a in log)
              == sorted(k for k, v in want.items() for _ in range(v))
              and bool(torch.isfinite(rgb).all()))
        ok &= check_recorded("spd_tetra8 compiled frame", log, True)
        ok &= all(cn[k] == want.get(k, 0) for k in kernel_fns
                  for cn in (ccounts, counts))
        ok &= (ccounts["finalize_hit"] == counts["finalize_hit"]
               == tcfg.maxdepth)
        ok &= ccounts["plain"] == counts["plain"] == 0
        ok &= ccounts["finalize_torch"] == counts["finalize_torch"] == 0
        ok &= len(fin_log) == tcfg.maxdepth
        for i, args in enumerate(fin_log):
            wid = args[6]
            fused = MK._finalize_fused(*args)
            ref = MK._finalize_torch(*args)
            torch.cuda.synchronize()
            bad = hit_diff(fused, ref)
            hits = int((wid >= 0).sum())
            print(f"  finalize level {i}: {args[3].shape[0]} lanes, {hits} "
                  f"hits; fused Hit = torch Hit bit for bit on every lane "
                  f"and field: {not bad} {bad or ''}")
            ok &= not bad and (i > 0 or hits > 0)
        # K3's level-0 intersect call by CUDA events against its bound,
        # the benchmark's K3_roofline's: 36 B a ray (its table column and
        # seed) and 36 B a triangle (three vertices), each read once
        k3_calls = [a for n, a in log if n == "mesh_block_select"]
        if k3_calls:
            args = k3_calls[0]
            n = args[2].shape[1]
            kms = cuda_ms(lambda: MSH.mesh_block_select(*args), 20)
            bound = (n + tplan.n_prims) * 36 / HBM_BPS * 1e3
            print(f"  [{smi_line}] K3 level-0 intersect, {n} rays against "
                  f"{tplan.n_prims} triangles: {kms:.4f} ms, bound "
                  f"{1e3 * bound:.2f} us ({100 * bound / kms:.2f}% of it)")
        del renderer, log, fin_log

        def make(frame):
            r = T.Renderer(T.WavefrontTracer(tc, tcfg, frame=frame), c, tcfg)
            return r.tracer, lambda: r.render(tarrs, 0.25)
        return compiled_case("spd_tetra8_512x512_render", make, want,
                             tcfg.maxdepth) and ok
    phase("36 SPD tetra at SizeFactor 9 512x512 depth 3: K1 and K3 on the "
          "compiled frame", p_tetra)

    if any(m.split(".")[0] in ("jax", "glome_tpu", "tools")
           for m in sys.modules):
        print("jax, glome_tpu or tools was imported")
        failed.append("no-jax")
    if failed:
        print(f"chip_smoke FAILED: {failed}")
        return 1
    # each kernel's launches on the main path it serves
    for name, path in (("mega_select", "testscene_720x480_depth3"),
                       ("block_select", "mesh100k_1080p_cast1"),
                       ("mesh_block_select", "mesh250k_1080p_cast1"),
                       ("dense_select", "testscene_720x480_groups"),
                       ("bvh_select", "testscene_720x480_groups"),
                       ("finalize_hit", "testscene_720x480_depth3"),
                       *((k, k.split(".")[0] + "_T256")
                         for k in micro_kernels)):
        entries[name]["launches"] = entries[name]["launches_by_path"][path]
    entries["bvh_select"]["mesh100k_launches"] = entries["bvh_select"][
        "launches_by_path"]["mesh100k_1080p_groups_cast1"]
    print(json.dumps({"kernels": list(entries.values())}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
