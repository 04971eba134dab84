#!/usr/bin/env python3
"""Smoke test of glome_tpu_torch on one CUDA GPU.

Drives the port's main path -- TestScene at 720x480, depth 3, 1 ray/px,
through compile_scene -> WavefrontTracer -> Renderer -- with the K1 CUDA
kernel (glome_tpu_torch/csrc/mega_select.cu), and checks it in phases:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: K1 from the sources in this checkout (build seconds, ptxas
     register and spill counts);
  3. K1 against mega_select_plain on the card, on the all-phase-kinds
     scene, the CSG scene (DNF regions, transformed convex members) and
     TestScene's 345,600 primary rays (L0), intersect and shadow:
     hit/blocked agree on >= 99.9% of lanes, t within rtol 5e-5 / atol
     1e-4 on >= 99.9% of the agreeing lanes, and wid differs beyond a
     distance tie on <= 0.1% of lanes;
  4. frame: the 720x480 depth-3 frame through the kernel: 6 K1
     launches, no call of the plain version, zero overflow, and within
     the drift canaries of out/testscene_tpu.png (mean |diff| <= 3
     levels, <= 0.6% of pixels off by more than 64);
  5. plain-path frame: 180x120 through mega_select_plain on the card,
     against the kernel frame and tests/golden/testscene_180x120_cpu.png
     under the same canaries;
  6. timing with CUDA events after warm-up: the 720x480 frame (ms,
     primary Mrays/s) and one K1 launch against one plain launch on the
     L0 intersect batch.

Prints a JSON summary of K1, then the nvidia-smi name/power-limit line,
then last {"ok": true, "device": {...}}.  Any failed phase, a missing
CUDA device or a missing package exits non-zero and prints no result.

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
    """K1 (t, wid, aux) against the plain version's, as numpy."""
    tk, wk, _ak = kern
    tp, wp, _ap = plain
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
          f"wid differs at near-ties {wid_tie}, beyond ties {wid_bad}")
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
    from glome_tpu_torch import kernels
    from glome_tpu_torch import megakernel as MK
    from glome_tpu_torch.io import quantize, read_png, write_png
    from glome_tpu_torch.render import pixel_coords, primary_rays, tile_order
    from glome_tpu_torch.scenes import test_scene
    from glome_tpu_torch.scenes.phasescene import (csg_rays, csg_scene,
                                                   phase_kinds_lights,
                                                   phase_kinds_rays,
                                                   phase_kinds_scene)
    from glome_tpu_torch.trace import _light_arrays
    from glome_tpu_torch.trace_wavefront import shadow_rays

    dev = torch.device("cuda", 0)
    failed = []
    summary = {"name": "mega_select", "route": "cuda",
               "source": "glome_tpu_torch/csrc/mega_select.cu",
               "replaces": "glome_tpu/megakernel.py:686"}

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
        path = kernels.build(kernels.MEGA_SOURCES, "glome_mega")
        kernels.mega_select_lib()
        info = kernels.BUILD_INFO[path]
        print(f"  {os.path.relpath(path, ROOT)}: nvcc {info['seconds']:.2f} s"
              f" (load {time.perf_counter() - t0:.2f} s)")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
        return True
    if not phase("2 build", p_build):
        return 1

    # -- scenes --------------------------------------------------------------
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

    def l0_batch():
        """TestScene's primary rays at 720x480 in tile order, as the
        (8, N) table the tracer's first level intersects."""
        ys, xs = np.mgrid[0:cfg.yres, 0:cfg.xres]
        perm = tile_order(cfg.xres, cfg.yres)
        xc, yc = pixel_coords(
            cfg.xres, cfg.yres,
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

    Q0 = l0_batch()
    tables = MK.pack_tables(plan, compiled, arrays)

    def both(tabs, rays, shadow):
        k = MK.mega_select(tabs, rays, shadow)
        p = MK.mega_select_plain(tabs, rays, shadow)
        torch.cuda.synchronize()
        return ([a.cpu().numpy() for a in k], [a.cpu().numpy() for a in p])

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
        good, summary["max_abs_err"] = compare("TestScene L0 intersect", k,
                                               p, False)
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

    # -- 4. the frame through the kernel ------------------------------------
    frame = {}
    out_dir = os.path.join(ROOT, "build")

    def p_frame():
        renderer = T.Renderer(T.WavefrontTracer(compiled, cfg), cam, cfg)
        torch.cuda.synchronize()
        MK.mega_select.launches = 0
        MK.mega_select_plain.calls = 0
        rgb, depth = renderer.render(arrays)
        torch.cuda.synchronize()
        launches = MK.mega_select.launches
        plain_calls = MK.mega_select_plain.calls
        summary["launches"] = launches
        ov = int(renderer.last_overflow.sum())
        img = rgb.cpu().numpy()
        frame["img"] = img
        finite = bool(np.isfinite(img).all()
                      and torch.isfinite(depth).all().item())
        print(f"  rgb {tuple(img.shape)} finite {finite}, K1 launches "
              f"{launches} (expected {2 * cfg.maxdepth}), plain calls "
              f"{plain_calls}, overflow {ov}")
        os.makedirs(out_dir, exist_ok=True)
        write_png(os.path.join(out_dir, "testscene_720x480_gpu.png"), img)
        ok = canaries_ok("vs out/testscene_tpu.png", quantize(img),
                         read_png(os.path.join(ROOT, "out",
                                               "testscene_tpu.png")))
        return (ok and finite and img.shape == (cfg.yres, cfg.xres, 3)
                and launches == 2 * cfg.maxdepth and plain_calls == 0
                and ov == 0)
    phase("4 frame 720x480 depth 3 through K1", p_frame)

    # -- 5. the plain path ------------------------------------------------
    def p_plain_frame():
        small = T.RenderConfig.tuned(xres=180, yres=120)
        rk, _ = T.Renderer(T.WavefrontTracer(compiled, small), cam,
                           small).render(arrays)
        rplain = T.Renderer(T.WavefrontTracer(compiled, small,
                                              select=MK.mega_select_plain),
                            cam, small)
        rp, _ = rplain.render(arrays)
        gk, gp = quantize(rk.cpu().numpy()), quantize(rp.cpu().numpy())
        golden = read_png(os.path.join(ROOT, "tests", "golden",
                                       "testscene_180x120_cpu.png"))
        ok = canaries_ok("plain vs kernel 180x120", gp, gk)
        ok &= canaries_ok("plain vs CPU golden", gp, golden)
        ok &= canaries_ok("kernel vs CPU golden", gk, golden)
        return ok and int(rplain.last_overflow.sum()) == 0
    phase("5 plain-path frame 180x120", p_plain_frame)

    # -- 6. timing ---------------------------------------------------------
    def cuda_ms(fn, reps):
        fn()                                    # warm-up
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

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
        summary["ms"] = kms
        summary["plain_ms"] = pms
        frame["ms"] = frame_ms
        return True
    phase("6 timing", p_timing)

    if "jax" in sys.modules or "glome_tpu" in sys.modules:
        print("jax or glome_tpu was imported")
        failed.append("no-jax")
    if failed:
        print(f"chip_smoke FAILED: {failed}")
        return 1
    print(json.dumps({"kernels": [summary]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
