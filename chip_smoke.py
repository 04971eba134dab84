#!/usr/bin/env python3
"""Smoke test of glome_tpu_torch on one CUDA GPU.

Drives the port's two main paths through the entry points a user calls
(compile_scene -> to_torch -> WavefrontTracer -> Renderer.render) with
the hand-written CUDA kernels K1 (csrc/mega_select.cu), K2
(csrc/block_select.cu) and K3 (csrc/mesh_block_select.cu), and checks
them in phases:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: K1, K2 and K3 from the sources in this checkout, one nvcc
     each, all started together (build seconds, ptxas register and
     spill counts);
  3. K1 against mega_select_plain on the card, on the all-phase-kinds
     scene, the CSG scene and TestScene's 345,600 primary rays (L0),
     intersect and shadow;
  4. TestScene frame: 720x480, depth 3, through the kernels: 6 K1
     launches, no K2/K3 launch, no plain call, zero overflow, and within
     the drift canaries of out/testscene_tpu.png;
  5. TestScene plain-path frame: 180x120 through the plain set
     (megakernel.PLAIN) on the card, against the kernel frame and
     tests/golden/testscene_180x120_cpu.png under the same canaries;
  6. TestScene timing with CUDA events: the frame and one K1 launch
     against one plain launch on the L0 batch;
  7. K2 against block_select_plain on the card: K2 launched on all
     1920x1080 L0 rays of mesh_scene(100_000) (intersect) and on all its
     shadow rays with cast_shadows=True, as the frame launches it, and
     held against the plain version on a 65,536-lane subset; and the
     700-sphere scene of glome_tpu's tests/test_block.py (plain, with a
     difference constraint, and 300 rotated boxes) with BLOCK_MIN
     lowered to 256;
  8. K3 against mesh_block_select_plain likewise, on the L0 and shadow
     rays of mesh_scene(250_000);
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
     its rays actually made (counted by a tallying build of the kernel)
     over 67 TFLOP/s; and the tallies of each mesh through the other
     kernel.

Kernel against plain: hit/blocked agree on >= 99.9% of lanes, t within
rtol 5e-5 / atol 1e-4 on >= 99.9% of the agreeing lanes, and the winner
differs beyond a distance tie on <= 0.1% of lanes.

Prints a JSON line of the kernels, then the nvidia-smi name/power-limit
line, then last {"ok": true, "device": {...}}.  Any failed phase, a
missing CUDA device or a missing package exits non-zero and prints no
result.

    python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import time
import traceback

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
# float32 operations of one test (csrc/walk.cuh box_live; prims.cuh
# triangle_t and sphere_t, the cheapest prim: a lower bound for K1's mix)
BOX_FLOPS, TRI_FLOPS, MIN_PRIM_FLOPS = 25, 60, 21


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


def compare(name, kern, plain, shadow):
    """A kernel's (t, winner, ...) against its plain version's, as
    numpy."""
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
    from glome_tpu_torch import kernels
    from glome_tpu_torch import megakernel as MK
    from glome_tpu_torch import mesh_kernel as MSH
    from glome_tpu_torch.compile import group_device_params
    from glome_tpu_torch.io import quantize, read_png, write_png
    from glome_tpu_torch.render import pixel_coords, primary_rays, tile_order
    from glome_tpu_torch.scenes import mesh_scene, test_scene
    from glome_tpu_torch.scenes.phasescene import (block_rays, block_scene,
                                                   csg_rays, csg_scene,
                                                   phase_kinds_lights,
                                                   phase_kinds_rays,
                                                   phase_kinds_scene)
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
            "replaces": "glome_tpu/mesh_kernel.py:105"}}
    for e in entries.values():
        e["library_ms"] = None        # no single PyTorch call computes it
        e["launches_by_path"] = {}
    kernel_fns = {"mega_select": MK.mega_select,
                  "block_select": BK.block_select,
                  "mesh_block_select": MSH.mesh_block_select}
    plain_fns = (MK.mega_select_plain, BK.block_select_plain,
                 MSH.mesh_block_select_plain)

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
        for fn in plain_fns:
            fn.calls = 0

    def read_counts(path):
        """Launch counts since reset_counts, recorded under `path`."""
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in kernel_fns.items()}
        for k, c in counts.items():
            entries[k]["launches_by_path"][path] = c
        counts["plain"] = sum(fn.calls for fn in plain_fns)
        print(f"  launches: K1 {counts['mega_select']}, K2 "
              f"{counts['block_select']}, K3 {counts['mesh_block_select']}, "
              f"plain calls {counts['plain']}")
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

    def l0_batch(cam, xres, yres):
        """Primary rays of an xres x yres frame in tile order, as the
        (8, N) table the tracer's first level intersects."""
        ys, xs = np.mgrid[0:yres, 0:xres]
        perm = tile_order(xres, yres)
        xc, yc = pixel_coords(
            xres, yres,
            torch.as_tensor(xs.reshape(-1)[perm], dtype=torch.float32,
                            device=dev),
            torch.as_tensor(ys.reshape(-1)[perm], dtype=torch.float32,
                            device=dev))
        o, d = primary_rays(cam, xc, yc)
        n = o.shape[0]
        return torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                            d[:, 2],
                            torch.full((n,), T.INFINITY, device=dev),
                            torch.zeros(n, device=dev)]).contiguous()

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
        paths = kernels.load_all()
        print(f"  three nvcc runs in parallel: {time.perf_counter() - t0:.2f}"
              f" s wall")
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
        return ok
    phase("3 K1 vs plain", p_compare)

    # -- 4. the TestScene frame through the kernels -------------------------
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)

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
        ok = canaries_ok("vs out/testscene_tpu.png", quantize(img),
                         read_png(os.path.join(ROOT, "out",
                                               "testscene_tpu.png")))
        return (ok and finite and img.shape == (cfg.yres, cfg.xres, 3)
                and counts["mega_select"] == 2 * cfg.maxdepth
                and counts["block_select"] == 0
                and counts["mesh_block_select"] == 0
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
        sc = cc.scenes[grp[0]]
        g = sc.groups[grp[1]]
        bplan = BK.get_block_plan(g, sc)
        ga = {k: v.detach() for k, v in
              group_device_params(g, garrs["scenes"][grp[0]][grp[1]]).items()
              if k != "m_fwd"}
        return (bplan, BK.pack_blocks(bplan, ga),
                BK.pack_cons(bplan, sc, garrs["scenes"][grp[0]], dev))

    def k3_inputs(cc, garrs, grp):
        g = cc.scenes[grp[0]].groups[grp[1]]
        mplan = MSH.get_block_plan(g)
        ga = group_device_params(g, garrs["scenes"][grp[0]][grp[1]])
        return mplan, MSH.pack_tri_blocks(
            mplan, {k: ga[k].detach() for k in ("p1", "p2", "p3")})

    mesh_batches = {}

    def mesh_l0(n_tris):
        """The 1920x1080 L0 rays of mesh_scene(n_tris, cast_shadows=True),
        the seed K1 (the ground plane) leaves for the mesh group, and the
        shadow rays of the L0 hits after the whole chain."""
        if n_tris not in mesh_batches:
            cc, garrs, mp, c, _grp = mesh(n_tris, True)
            Q = l0_batch(c, *MESH_RES)
            t1, _w, _a = MK.mega_select(MK.pack_tables(mp, cc, garrs), Q,
                                        False)
            hit = MK.mega_intersect_table(cc, garrs, Q)
            lpos, _lcol, lrad = _light_arrays(cc, garrs, cc.lights)
            _pre, _segs, sh = shadow_rays(hit, Q[7], cc.lights, lpos, lrad)
            mesh_batches[n_tris] = (Q, t1.contiguous(), sh.contiguous())
        return mesh_batches[n_tris]

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
                                as_np([a[ix] for a in k]), as_np(p), shadow)
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
                        ok &= compare(label, as_np(k), as_np(p), shadow)[0]
        finally:
            MK.BLOCK_MIN = saved
        return ok
    phase("7 K2 vs plain", p_k2)

    # -- 8. K3 against the plain version ------------------------------------
    def p_k3():
        ok = True
        cc, garrs, _mp, _c, grp = mesh(250_000, True)
        mplan, tri = k3_inputs(cc, garrs, grp)
        Q, t1, sh = mesh_l0(250_000)
        print(f"  mesh plan: {mplan.n_blocks} blocks of {MSH.BP}, "
              f"{mplan.n_nodes} nodes; L0 {Q.shape[1]} rays, shadow batch "
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
                                as_np([a[ix] for a in k]), as_np(p), shadow)
            ok &= good
            if not shadow:
                entries["mesh_block_select"]["max_abs_err"] = err
        return ok
    phase("8 K3 vs plain", p_k3)

    # -- 9. the mesh frames --------------------------------------------------
    mcfg = T.RenderConfig(xres=MESH_RES[0], yres=MESH_RES[1], maxdepth=1)
    pcfg = T.RenderConfig(xres=PLAIN_RES[0], yres=PLAIN_RES[1], maxdepth=1)
    step = MESH_RES[0] // PLAIN_RES[0]

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
                and all(counts[k] == v for k, v in want.items())
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

    def profile_frame(render):
        """(host wall ms, device busy ms, K2 kernel ms) of one
        frame under torch.profiler (None where it saw no device time)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            render()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        spans, k2 = [], 0.0
        for ev in prof.events():
            if getattr(ev, "device_type", None) != \
                    torch.autograd.DeviceType.CUDA:
                continue
            a, b = ev.time_range.start, ev.time_range.end
            spans.append((a, b))
            # "void block_select_kernel<false>(float const*, ...)"
            if ev.name.split("<")[0].split("(")[0].split()[-1] == \
                    "block_select_kernel":
                k2 += (b - a) / 1e3
        if not spans:
            return wall, None, None
        spans.sort()
        busy, cur_a, cur_b = 0.0, spans[0][0], spans[0][1]
        for a, b in spans[1:]:
            if a > cur_b:
                busy += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        busy += cur_b - cur_a
        return wall, busy / 1e3, k2

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
                wall, busy, k2 = profile_frame(lambda: renderer.render(garrs))
                if busy is None:
                    print("  profiler: no device time (device busy share "
                          "not measured)")
                else:
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

    # -- 11. bounds ----------------------------------------------------------
    def bound(name, rays_bytes, out_bytes, table_bytes, tally, prim_flops):
        n_box = int(tally[0].sum())
        n_prim = int(tally[1].sum())
        nbytes = rays_bytes + out_bytes + table_bytes
        flops = n_box * BOX_FLOPS + n_prim * prim_flops
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        e = entries[name]
        e["bound_ms"] = max(t_bytes, t_ops)
        e["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        n = tally.shape[1]
        print(f"  {name}: {n} rays, {n_box} box tests "
              f"({n_box / n:.2f}/ray), {n_prim} prim tests "
              f"({n_prim / n:.2f}/ray); {nbytes / 1e6:.3f} MB -> "
              f"{1e3 * t_bytes:.2f} us, {flops / 1e9:.3f} GFLOP -> "
              f"{1e3 * t_ops:.2f} us; bound {1e3 * e['bound_ms']:.2f} us "
              f"({e['bound_by']}), measured {1e3 * e.get('ms', 0):.2f} us")

    def p_bounds():
        def tally_for(n):
            return torch.zeros((2, n), dtype=torch.int32, device=dev)
        n = Q0.shape[1]
        tally = tally_for(n)
        MK.mega_select(tables, Q0, False, tally=tally)
        tbytes = sum(t.numel() * t.element_size() for t in
                     (tables.pf, tables.pi, tables.nf, tables.ni, tables.bb,
                      tables.phases))
        # rays [o, d, seed, sid] in; t, wid, aux out
        bound("mega_select", 32 * n, 12 * n, tbytes, tally.cpu(),
              MIN_PRIM_FLOPS)
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
            nodes = p.nf.nbytes + p.ni.nbytes
            table = sum(a.numel() * a.element_size() for a in args[1:])
            # o, d and the seed in; t and the winner out
            bound(name, 28 * n, 8 * n, nodes + table, tally.cpu(),
                  TRI_FLOPS)
        # each mesh's rays through the other kernel's walk too
        for label, n_tris, inputs, fn in (
                ("K3 on mesh100k", 100_000, k3_inputs, MSH.mesh_block_select),
                ("K2 on mesh250k", 250_000, k2_inputs, BK.block_select)):
            cc, garrs, _mp, _c, grp = mesh(n_tris, True)
            Q, t1, _sh = mesh_l0(n_tris)
            tally = tally_for(Q.shape[1])
            fn(*inputs(cc, garrs, grp), Q, t1, False, tally=tally)
            per_ray = (tally.sum(dim=1) / Q.shape[1]).tolist()
            print(f"  {label}: {per_ray[0]:.2f} box + {per_ray[1]:.2f} "
                  f"triangle tests per ray")
        return True
    phase("11 bounds", p_bounds)

    if "jax" in sys.modules or "glome_tpu" in sys.modules:
        print("jax or glome_tpu was imported")
        failed.append("no-jax")
    if failed:
        print(f"chip_smoke FAILED: {failed}")
        return 1
    # each kernel's launches on the main path it serves
    for name, path in (("mega_select", "testscene_720x480_depth3"),
                       ("block_select", "mesh100k_1080p_cast1"),
                       ("mesh_block_select", "mesh250k_1080p_cast1")):
        entries[name]["launches"] = entries[name]["launches_by_path"][path]
    print(json.dumps({"kernels": list(entries.values())}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
