"""Command-line renderer: the reference GlomeView executable, headless.

Port of glome_tpu/app.py.  Replicates the reference executable's behavior
(GlomeView/Glome.hs:440-469): print primcount, time scene setup /
render / output separately, render the TestScene (or an NFF file) and
write a PNG.  The interactive window becomes --pick x y: trace a pick
ray and print the tag stack of the hit object (the reference's mouse
handler, Glome.hs:416-438).

It runs on the CUDA device unless --device cpu is given, and stops
when CUDA is missing.  The wavefront tracer runs its compiled frame
(each level captured once as CUDA graphs and replayed, graphs.py, the
counterpart of glome_tpu's jitted frame and cache.py; its static-width
levels run eagerly on the CPU).  Nothing persists across processes: the
graphs are captured by the first frame of each width, and the kernels'
own build cache (kernels.build_key) is the set-up cache.

Usage:
  python -m glome_tpu_torch.app [--scene test|simple|path.nff]
      [--out out.png] [--xres 720 --yres 480] [--depth 3] [--aa]
      [--pick X Y] [--interactive] [--debug | --debug-full]
      [--iters 1] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time


def _parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="test",
                   help="'test', 'simple', or a .nff file path")
    p.add_argument("--out", default="out.png")
    p.add_argument("--xres", type=int, default=720)
    p.add_argument("--yres", type=int, default=480)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--aa", action="store_true",
                   help="adaptive subsample/supersample antialiasing")
    p.add_argument("--pick", type=int, nargs=2, metavar=("X", "Y"),
                   help="print the tag stack for the object at pixel X,Y")
    p.add_argument("--interactive", action="store_true",
                   help="persistent pick session: read 'X Y' lines from "
                        "stdin and print tag stacks (the reference's "
                        "event loop, Glome.hs:416-438, headless)")
    p.add_argument("--debug-full", action="store_true",
                   help="like --debug but through the FULL trace: "
                        "shadow + child-ray work per level ascends to "
                        "the primary pixel (trace_debug parity, "
                        "Trace.hs:86-109)")
    p.add_argument("--debug", action="store_true",
                   help="render the rayint_debug work map instead of "
                        "color: prims tested -> red, BVH nodes -> green "
                        "(reference get_color_debug, Glome.hs:57-62)")
    p.add_argument("--iters", type=int, default=1,
                   help="repeat the render (timing consistency)")
    p.add_argument("--lattice-n", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the scene tensors live and the kernels run")
    return p


def _load_scene(args):
    """(solid, lights, camera, background); an NFF file's resolution
    overrides --xres/--yres."""
    from .render import camera
    if args.scene == "test":
        from .scenes import test_scene
        return (*test_scene(lattice_n=args.lattice_n), None)
    if args.scene == "simple":
        from .scenes import simple_scene
        from .scenes.testscene import cust_cam, lights
        return simple_scene(), lights(), cust_cam(), None
    from . import spd
    s = spd.load(args.scene)
    cam = s.cam or camera((0, 0, -5), (0, 0, 0), (0, 1, 0), 45)
    if s.resolution:
        args.xres, args.yres = s.resolution
    # NFF `b` feeds missshade (Spd.hs:118-122)
    return s.geom, s.lights, cam, s.background


def _overflow(ov) -> dict:
    """{label or index: dropped rays} of a renderer's last_overflow (a
    tensor for Renderer, a dict for AARenderer)."""
    if ov is None:
        return {}
    if isinstance(ov, dict):
        return {k: int(v) for k, v in ov.items() if int(v)}
    return {i: int(n) for i, n in enumerate(ov.cpu().numpy()) if n}


def main(argv=None):
    """Run the CLI; returns a dict of what it did (set-up and per-render
    seconds, the overflow, the picked tags or the work maps) for
    callers that drive it in-process."""
    args = _parser().parse_args(argv)

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("glome_tpu_torch.app: no CUDA device "
                         "(--device cpu runs on the CPU)")
    device = torch.device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    import glome_tpu_torch as G
    from .config import RenderConfig
    from .io import write_png
    from .render import Renderer

    t0 = time.time()
    solid, lights, cam, background = _load_scene(args)
    print(f"(primitives,transforms,bounding objects): {G.primcount(solid)}")
    compiled = G.compile_scene(solid, lights)
    arrays = G.to_torch(compiled.arrays(), device)
    # RenderConfig's capacity knobs are accepted and ignored: the
    # port's queues are exact (trace_wavefront.py), so nothing overflows
    cfg = RenderConfig.tuned(xres=args.xres, yres=args.yres,
                             maxdepth=args.depth, background=background)
    try:
        tracer = G.WavefrontTracer(compiled, cfg)
    except NotImplementedError:
        # a portal with a light set of its own
        tracer = G.Tracer(compiled, cfg)
    sync()
    setup_s = time.time() - t0
    print(f"scene setup: {setup_s:.3f}s")
    result = {"setup_s": setup_s, "xres": args.xres, "yres": args.yres}

    if args.debug or args.debug_full:
        from .debug import debug_image
        t0 = time.time()
        img, prims, nodes = debug_image(compiled, arrays, cam,
                                        args.xres, args.yres,
                                        full=args.debug_full,
                                        recurs=cfg.maxdepth)
        debug_s = time.time() - t0
        print(f"debug render: {debug_s:.3f}s; per-ray prims "
              f"mean {prims.mean():.1f} max {prims.max():.0f}, nodes "
              f"mean {nodes.mean():.1f} max {nodes.max():.0f}")
        write_png(args.out, img)
        print(f"-> {args.out}")
        result.update(debug_s=debug_s, prims=prims, nodes=nodes)
        return result

    if args.pick:
        from .pick import pick
        tags = pick(tracer, cam, arrays, args.pick[0], args.pick[1])
        print(f"{args.pick[0]} {args.pick[1]}:")
        for t in tags:
            print(t)
        result["tags"] = tags
        return result

    if args.interactive:
        from .pick import PickSession
        PickSession(tracer, cam, arrays).run()
        return result

    if args.aa:
        from .aa import AARenderer
        r = AARenderer(tracer, cam, cfg)
    else:
        r = Renderer(tracer, cam, cfg)

    render_s = []
    for _ in range(args.iters):
        t0 = time.time()
        rgb, depth = r.render(arrays)
        sync()
        render_s.append(time.time() - t0)
        print(f"render: {render_s[-1]:.3f}s")

    bad = _overflow(r.last_overflow)
    if bad:
        print(f"WARNING: queue overflow (under-traced rays): {bad}; "
              f"widen the RenderConfig *_capacity schedule",
              file=sys.stderr)

    t0 = time.time()
    img = rgb.cpu().numpy()
    write_png(args.out, img)
    print(f"write: {time.time()-t0:.3f}s -> {args.out}")
    result.update(render_s=render_s, overflow=bad, rgb=img,
                  depth=depth.cpu().numpy())
    if args.aa:
        result["ray_counts"] = dict(r.last_ray_counts)
    return result


if __name__ == "__main__":
    main()
