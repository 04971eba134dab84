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
mesh), and the card microbenchmarks
M1 (csrc/micro_prims.cu) and M2 (csrc/micro_kwide.cu) through their
tools' entry points (python -m glome_tpu_torch.tools.micro_prims /
micro_kwide), and checks them in phases:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: all seven libraries (K1-K5, M1, M2) from the sources in this
     checkout, one nvcc each, all started together (build seconds, ptxas
     register and spill counts), and the native BVH builder
     (glome_tpu_torch/native/bvh_builder.cpp, g++; its version and build
     seconds);
  3. K1 against mega_select_plain on the card, on the all-phase-kinds
     scene, the CSG scene, TestScene's 345,600 primary rays (L0) and the
     200-sphere chain (phasescene.chain_scene: a bvh2 tree of depth 47,
     walked with a plan-sized stack), intersect and shadow;
  4. TestScene frame: 720x480, depth 3, through the kernels: 6 K1
     launches, no K2-K5 launch, no plain call, zero overflow, and within
     the drift canaries of out/testscene_tpu.png;
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
     under the canaries;
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
     3xTF32 tensor-core product), the plain version's time, and each
     variant's bound from the sphere tests its tiles made;
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
     python -m glome_tpu_torch.tools.profile_frame) on six workloads:
     the TestScene 720x480 depth-3 frame on each route, the mesh100k
     1080p self-shadowing frame on each route, the 720x480 AA frame and
     one config 5 step at 180x120.  Each is timed unprofiled (CUDA
     events, mean of 3 after a warm-up), then run once with every stage
     wrapped and profiled, and its stage table printed.  Gates: every
     stage the path reaches fired; the result equals the warm-up's
     without the wrappers (frames bit for bit; the config 5 step's loss
     equal and its updated row within 1e-6 relative); the K1-K5
     launches summed over the stages equal the wrappers' counters and
     the path's counts (6 K1 per TestScene frame; 7 K4 + 2 K5 per batch
     of the group-route frame; 2 K1 + 2 K2 per mesh frame on the
     megakernel route; 1 K4 + 1 K5 per batch on the group route; 30 K1
     per AA frame; 6 K1 per config 5 step), no plain call; the rows'
     device ms, with "(outside any stage)", sum to the profiler's
     device time within 1%.

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

Prints a JSON line of the kernels, then the nvidia-smi name/power-limit
line, then last {"ok": true, "device": {...}}.  Any failed phase, a
missing CUDA device or a missing package exits non-zero and prints no
result.

    python3 chip_smoke.py
"""

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
DEVICE = ("cuda", 0)
MESH_RES = (1920, 1080)
PLAIN_RES = (240, 135)        # every 8th pixel of MESH_RES: the same rays
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


def ptxas_figures(log, kernel):
    """{registers, stack_frame, spill_stores, spill_loads} ptxas -v gave
    the normal (kTally = false) build of `kernel` in a build log."""
    fig, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\S+?)'?"
                      r"(?: for|$)", line.strip())
        if m:
            cur = m.group(1)
            continue
        if cur is None or kernel not in cur or "ILb0E" not in cur:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            fig.update(stack_frame=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            fig["registers"] = int(m.group(1))
    return fig


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
    from glome_tpu_torch.tools import config5_e2e as C5
    from glome_tpu_torch.tools import kernel_ab as KAB
    from glome_tpu_torch.tools import micro_kwide as MKW
    from glome_tpu_torch.tools import micro_prims as MPR
    from glome_tpu_torch.tools import profile_frame as PF
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
                       "replaces": "glome_tpu/pallas_kernels.py:558"}}
    # the microbenchmarks: each variant is a kernel of its own (its own C
    # entry, wrapper and launch count), replacing one Pallas body of the
    # tool's (tools/micro_prims.py:65 mk, tools/micro_kwide.py:47 / :138)
    micro_tools = {"micro_prims": MPR, "micro_kwide": MKW}
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

    def read_counts(path):
        """Launch counts since reset_counts, recorded under `path`."""
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in kernel_fns.items()}
        counts.update((k, v.kernel.launches) for k, v in micro_kernels.items())
        for k, c in counts.items():
            entries[k]["launches_by_path"][path] = c
        m1, m2 = (sum(c for k, c in counts.items() if k.startswith(t + "."))
                  for t in micro_tools)
        counts["plain"] = sum(fn.calls for fn in plain_fns)
        print(f"  launches: K1 {counts['mega_select']}, K2 "
              f"{counts['block_select']}, K3 {counts['mesh_block_select']}, "
              f"K4 {counts['dense_select']}, K5 {counts['bvh_select']}, "
              f"M1 {m1}, M2 {m2}, plain calls {counts['plain']}")
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
            # K1-K5 come first, in kernel_fns order (kernels.LIBRARIES)
            entries[name]["ptxas"] = ptxas_figures(
                kernels.BUILD_INFO[path]["log"], name + "_kernel")
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
                and counts["plain"] == 0 and ov == 0)
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
        rgb, depth = renderer.render(garrs)
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
        launch: the ray components it reads, its tables and its output
        once over HBM_BPS, against the float32 work of the tests its
        tiles made (tally) over F32_FLOPS and, for f, its 3xTF32 product
        over TF32_FLOPS."""
        n_t = inp["rays"].shape[1]
        n_rays = n_t * MPR.TILE
        nbytes = (4 * (v.ray_comps + 1) * n_rays
                  + sum(4 * inp[t].numel() for t in v.tables))
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

    def p_micro(key, path):
        tool = micro_tools[key]
        print(f"  [{smi_line}] clocks at the start: {clocks()}")
        reset_counts()
        rows = tool.main([])          # the tool's entry point, its size
        counts = read_counts(path)
        launched = {v.name: v.kernel.launches for v in tool.VARIANTS}
        print(f"  clocks after the timed rows: {clocks()}")
        ok = (counts["plain"] == 0 and all(launched.values())
              and all(counts[k] == 0 for k in counts
                      if k != "plain" and not k.startswith(key + ".")))
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
            row = {"ms": sec * 1e3, "plain_ms": pms, "bound_ms": bound,
                   "bound_by": by, "max_abs_err": err,
                   "tests_per_tile": int(tally.sum()) / tool.T}
            if v.units is None:       # a walk: the nodes it visited
                per_tile = k[:, 0, 0]
                row.update(visited_tile0=float(per_tile[0]),
                           visited_mean=float(per_tile.mean()))
                extra = (f", visited/tile {float(per_tile[0]):.0f} (tile "
                         f"0), {float(per_tile.mean()):.2f} (mean)")
            else:
                extra = ""
            print(f"  [{smi_line}] {v.name}: {launched[v.name]} launches, "
                  f"{sec * 1e3:.5f} ms/launch, plain {pms:.4f} ms, bound "
                  f"{bound * 1e3:.3f} us ({by}: {detail}); kernel vs plain "
                  f"{check}, max |diff| {err:.3g}{extra}")
            ok &= good
            entries[f"{key}.{v.name}"].update(row)
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
        mk = ("mega_select", "block_select", "mesh_block_select",
              "dense_select", "bvh_select")
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
             lambda b: {"K1": 6}))
        ok = True
        for key, w, want_fn in work:
            reset_counts()
            rep = PF.profile(w, dev, smi_line)
            read_counts(f"profile_{key}")
            sp = rep.split
            want = want_fn(w.tracer.last_batches)
            stage_sum = {f"K{i + 1}": sum(r.counts[f"K{i + 1}"]
                                          for r in sp.stage_rows())
                         for i in range(len(mk))}
            prof_sum = {k: sum(r.profiled_launches().get(k, 0)
                               for r in sp.rows) for k in stage_sum}
            plain = sum(v for k, v in sp.counts.items() if "plain" in k)
            launches_ok = all(stage_sum[k] == sp.counts[k] == want.get(k, 0)
                              for k in stage_sum) and plain == 0
            rows_dev = sum(r.device_ms for r in sp.rows)
            part_ok = (sp.device_ms is not None and sp.device_ms > 0
                       and abs(rows_dev - sp.device_ms)
                       <= 0.01 * sp.device_ms)
            print(f"  [{smi_line}] {w.name}: K1-K5 launches summed over the "
                  f"stages {stage_sum}, the wrappers' counters "
                  f"{ {k: sp.counts[k] for k in stage_sum} }, expected "
                  f"{want} ({w.tracer.last_batches} batches in the last "
                  f"trace), the profiler recorded {prof_sum}, plain calls "
                  f"{plain} -> {'ok' if launches_ok else 'FAIL'}; rows' "
                  f"device ms {rows_dev:.3f} of the profiler's "
                  f"{sp.device_ms or 0.0:.3f} -> "
                  f"{'ok' if part_ok else 'FAIL'}; stages fired: every "
                  f"stage of the path {not rep.missing}; the same result "
                  f"as without the wrappers: {rep.same}")
            ok &= (launches_ok and part_ok and rep.same and not rep.missing)
        return ok
    phase("30 the frame-profiling tool (python -m "
          "glome_tpu_torch.tools.profile_frame) on every path", p_profile)

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
