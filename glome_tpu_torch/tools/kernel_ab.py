"""K1 and K4 against an earlier commit's kernels on the card, in turns,
and K1's cost per phase.

    python -m glome_tpu_torch.tools.kernel_ab --old build/parent

`--old` names an unpacked checkout of the earlier commit (for example
`git archive <commit>` unpacked into the gitignored build/).  Its
csrc/mega_select.cu and csrc/dense_select.cu are built with this
checkout's nvcc flags and called through their C entries with the
arguments of OLD_ENTRIES: K1 with the per-node bvh2 tables (nf, ni) and
a (2, N) tally, K4 with the per-128-prim block_aabbs table.  These are
the entries of the commit before the child-pair records and the per-prim
cull; the tool refuses an --old tree whose sources declare them
otherwise.

On TestScene at 720x480 it prints, with the card's name, power limit and
SM clock:

  - each build's ptxas registers, spills and shared memory;
  - K1 on the L0 batch and the first shadow batch: old and new equal on
    every lane (t, winner, aux; in shadow mode which rays are blocked),
    then their device times (tools.device_time) in turns old, new, new,
    old;
  - K1's cost per phase for old and new (`attribution`);
  - both K1 work tallies per ray;
  - K4 on each dense group of the group route with the L0 batch: old and
    new equal, their tallies, device times old, new, new, old, and the
    new kernel through its C entry on old's inputs (raw: without what the
    wrapper launches) against old: raw, old, old, raw.

Everything it prints also goes to --json (default
build/kernel_ab.json).  It needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from .. import group_kernels as GK
from .. import intersect as TI
from .. import kernels
from .. import megakernel as MK
from .device_time import device_time

# the earlier commit's C entries, source -> (name, parameter list as its
# source declares it); the tool calls them with these arguments
OLD_ENTRIES = {
    "mega_select.cu": (
        "glome_mega_select",
        "const float* rays, int n, const float* pf, const int* pi, "
        "const float* nf, const int* ni, const float* bb, const int* meta, "
        "int n_phases, int shadow, float* out_t, int* out_w, int* out_a, "
        "int* tally, void* stream"),
    "dense_select.cu": (
        "glome_dense_select",
        "const float* rays, int n, const float* seeds, const float* tab, "
        "const float* vis, const float* bbox, int P, int FX, int nfld, "
        "int ptype, int xf, const float* cf, const int* cdesc, int shadow, "
        "float* out_t, int* out_l, int* tally, void* stream"),
}


def declared_params(path: str, fn: str):
    """The parameter list of `extern "C" int fn(...)` in the source at
    path, whitespace collapsed, or None."""
    with open(path) as f:
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", f.read())
    return None if m is None else " ".join(m.group(1).split())


def old_entry(lib_path: str, source: str):
    """The earlier commit's C entry of `source`, loaded from lib_path with
    the argument types of OLD_ENTRIES (main checks first that the source
    declares it so: another list would be undefined on the card)."""
    fn, params = OLD_ENTRIES[source]
    entry = getattr(ctypes.CDLL(lib_path), fn)
    entry.argtypes = [ctypes.c_void_p if "*" in p else ctypes.c_int
                      for p in params.split(", ")]
    entry.restype = ctypes.c_int
    return entry


# --- inputs ------------------------------------------------------------------

def l0_batch(cam, xres, yres, device):
    """Primary rays of an xres x yres frame in tile order, as the (8, N)
    table [o, d, seed = INFINITY, sid = 0] the tracer's first level
    intersects."""
    from ..config import INFINITY
    from ..render import pixel_coords, primary_rays, tile_order
    ys, xs = np.mgrid[0:yres, 0:xres]
    perm = tile_order(xres, yres)
    xc, yc = pixel_coords(
        xres, yres,
        torch.as_tensor(xs.reshape(-1)[perm], dtype=torch.float32,
                        device=device),
        torch.as_tensor(ys.reshape(-1)[perm], dtype=torch.float32,
                        device=device))
    o, d = primary_rays(cam, xc, yc)
    n = o.shape[0]
    return torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                        torch.full((n,), INFINITY, device=device),
                        torch.zeros(n, device=device)]).contiguous()


def l0_shadow(compiled, arrays, rays):
    """The shadow rays of the L0 hits (megakernel route), as the tracer's
    first shadow batch."""
    from ..trace import _light_arrays
    from ..trace_wavefront import shadow_rays
    hit = MK.mega_intersect_table(compiled, arrays, rays)
    lpos, _lcol, lrad = _light_arrays(compiled, arrays, compiled.lights)
    _pre, _segs, sh = shadow_rays(hit, rays[7], compiled.lights, lpos, lrad)
    return sh.contiguous()


# --- K1's cost per phase -----------------------------------------------------

def prefix_tables(tables, k: int):
    """A copy of K1's tables with phases >= k switched off (PH_VIS0 and
    PH_VIS1 zeroed in the descriptor table): the kernel then runs phases
    0 .. k-1 only, without a switch of its own."""
    phases = tables.phases.clone()
    n = len(tables.plan.phases)
    hdr = phases[:n * MK.PH_W].view(n, MK.PH_W)
    hdr[k:, MK.PH_VIS0] = 0
    hdr[k:, MK.PH_VIS1] = 0
    return dataclasses.replace(tables, phases=phases)


def describe(ph) -> str:
    """A phase's kind and size, as the attribution prints it."""
    if ph.kind in ("dense", "bvh2"):
        extra = f", {len(ph.cons)} clause(s)" if ph.cons else ""
        depth = f", depth {ph.depth}" if ph.kind == "bvh2" else ""
        return f"{ph.kind} {ph.P} {ph.ptype}{depth}{extra}"
    if ph.kind == "convex":
        return f"convex {len(ph.members)} members"
    rows = sum(cm.M for _pos, ms in (ph.cons or []) for cm in ms)
    return (f"deferred {ph.ptype} prim, {len(ph.cons or [])} clause(s) "
            f"of {rows} member rows, {len(ph.regions or [])} region(s)")


def attribution(time_ms, tables):
    """[(phase index, description, ms, share)] of one K1 launch:
    time_ms(tables') is the launch's time on tables' = prefix_tables(
    tables, k); the best t carries in plan order, so time(k + 1) -
    time(k) is phase k's cost inside the full launch.  The first entry
    (index -1, "no phase") is time(0): loading and storing the rays."""
    n = len(tables.plan.phases)
    times = [time_ms(prefix_tables(tables, k)) for k in range(n + 1)]
    full = times[-1]
    rows = [(-1, "no phase", times[0], times[0] / full)]
    for k, ph in enumerate(tables.plan.phases):
        ms = times[k + 1] - times[k]
        rows.append((k, describe(ph), ms, ms / full))
    return rows, full


def print_attribution(label, rows, full):
    print(f"  {label}: full launch {full:.4f} ms")
    for k, what, ms, share in rows:
        print(f"    phase {k:3d} {what:60s} {ms:8.4f} ms {100 * share:6.1f}%")


# --- the runs ----------------------------------------------------------------

def _smi(query):
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"


def clocks():
    return _smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")


def _ptxas(path):
    return [line.strip() for line in
            kernels.BUILD_INFO[path]["log"].splitlines()
            if "entry function" in line or "registers" in line
            or "spill" in line or "smem" in line]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="root of the earlier commit's checkout")
    ap.add_argument("--json", default=os.path.join("build",
                                                   "kernel_ab.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    old_csrc = os.path.join(args.old, "glome_tpu_torch", "csrc")
    if not os.path.isdir(old_csrc):
        print(f"kernel_ab: {old_csrc} not found", file=sys.stderr)
        return 2
    import glome_tpu_torch as T
    from glome_tpu_torch.scenes import test_scene
    dev = torch.device("cuda", 0)
    out = {"device": _smi("name,power.limit"), "clocks_start": clocks()}
    print(f"[{out['device']}] clocks at the start: {out['clocks_start']}")

    # -- builds
    for source in OLD_ENTRIES:
        fn, params = OLD_ENTRIES[source]
        if declared_params(os.path.join(old_csrc, source), fn) != params:
            print(f"kernel_ab: {old_csrc}/{source} does not declare "
                  f"{fn}({params}); unpack the commit before the redesign "
                  "as --old", file=sys.stderr)
            return 2
    paths = {"new K1": kernels.build(kernels.MEGA_SOURCES, "glome_mega"),
             "old K1": kernels.build(kernels.MEGA_SOURCES, "glome_mega_old",
                                     csrc=old_csrc),
             "new K4": kernels.build(kernels.DENSE_SOURCES, "glome_dense"),
             "old K4": kernels.build(kernels.DENSE_SOURCES, "glome_dense_old",
                                     csrc=old_csrc)}
    out["ptxas"] = {}
    for name, path in paths.items():
        out["ptxas"][name] = _ptxas(path)
        print(f"  {name}: nvcc {kernels.BUILD_INFO[path]['seconds']:.2f} s")
        for line in out["ptxas"][name]:
            print(f"    ptxas: {line}")
    new_k1 = MK.mega_select
    old_k1 = old_entry(paths["old K1"], "mega_select.cu")
    new_k4 = kernels.dense_select_lib()
    old_k4 = old_entry(paths["old K4"], "dense_select.cu")

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def k1_outputs(n):
        return (torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev))

    def run_old_k1(tabs, rays, shadow, tally=None):
        n = rays.shape[1]
        t, w, a = k1_outputs(n)
        err = old_k1(
            rays.data_ptr(), n, tabs.pf.data_ptr(), tabs.pi.data_ptr(),
            tabs.nf.data_ptr(), tabs.ni.data_ptr(), tabs.bb.data_ptr(),
            tabs.phases.data_ptr(), len(tabs.plan.phases), int(shadow),
            t.data_ptr(), w.data_ptr(), a.data_ptr(),
            kernels.tally_ptr(tally), stream())
        kernels.check_launch(new_k4, err, "old mega_select")
        return t, w, a

    # -- TestScene
    solid, lights, cam = test_scene()
    compiled = T.compile_scene(solid, lights)
    plan = MK.get_plan(compiled)
    arrays = T.to_torch(compiled.arrays(), dev)
    cfg = T.RenderConfig.tuned()
    tables = MK.pack_tables(plan, compiled, arrays)
    q0 = l0_batch(cam, cfg.xres, cfg.yres, dev)
    batches = {"L0 intersect": (q0, False),
               "L0 shadow": (l0_shadow(compiled, arrays, q0), True)}

    def ms(fn):
        return device_time(fn) * 1e3

    # -- K1: equality, turns, attribution, tallies
    out["k1"] = {}
    for label, (rays, shadow) in batches.items():
        n = rays.shape[1]
        ref = [x.cpu() for x in run_old_k1(tables, rays, shadow)]
        got = [x.cpu() for x in new_k1(tables, rays, shadow)]
        same = (torch.equal(got[1] >= 0, ref[1] >= 0) if shadow else
                all(torch.equal(a, b) for a, b in zip(got, ref)))
        row = {"rays": n, "new_equals_old": bool(same)}
        before = clocks()
        fns = {"old": lambda: run_old_k1(tables, rays, shadow),
               "new": lambda: new_k1(tables, rays, shadow)}
        row["turns_old_new"] = [ms(fns[v])
                                for v in ("old", "new", "new", "old")]
        row["clocks"] = [before, clocks()]
        print(f"  [{out['device']}] K1 TestScene {label} ({n} rays): new == "
              f"old {row['new_equals_old']}; ms old / new / new / old "
              f"{' / '.join(f'{x:.4f}' for x in row['turns_old_new'])} "
              f"(clocks before {before}; after {row['clocks'][1]})")
        for vname, fn in (("old", lambda tb: run_old_k1(tb, rays, shadow)),
                          ("new", lambda tb: new_k1(tb, rays, shadow))):
            rows, full = attribution(lambda tb: ms(lambda: fn(tb)), tables)
            print_attribution(f"K1 {vname} {label} per phase", rows, full)
            row[f"attribution_{vname}"] = rows
        t_old = torch.zeros((2, n), dtype=torch.int32, device=dev)
        run_old_k1(tables, rays, shadow, tally=t_old)
        t_new = torch.zeros((MK.TALLY_ROWS, n), dtype=torch.int32,
                            device=dev)
        new_k1(tables, rays, shadow, tally=t_new)
        row["tally_old"] = (t_old.sum(dim=1).double() / n).tolist()
        row["tally_new"] = (t_new.sum(dim=1).double() / n).tolist()
        print(f"  K1 {label} tests per ray: old box / prim "
              f"{row['tally_old']}; new box / prim / point / member "
              f"{row['tally_new']}")
        out["k1"][label] = row

    # -- K4 on every dense group of the group route, L0 batch
    out["k4"] = {}
    seed = q0[6].contiguous()
    for si, sc in enumerate(compiled.scenes):
        for gi, g in enumerate(sc.groups):
            if g.vclass in ("deferred", "convex") or not g.size \
                    or g.accel_eligible:
                continue
            (ptype, pm, minv, vis, cons), cull = TI.dense_args(
                sc, arrays["scenes"][si], gi, False, dev)
            ga = arrays["scenes"][si][gi]
            block = GK.block_aabbs(ptype, {k: v.detach() for k, v in
                                           ga.items()
                                           if k not in ("m_inv", "m_fwd")},
                                   None if ga.get("m_fwd") is None
                                   else ga["m_fwd"].detach(), g.size)
            tab = GK._dense_table(pm, minv)
            n = q0.shape[1]

            def run_old(tally=None):
                t = torch.empty(n, dtype=torch.float32, device=dev)
                loc = torch.empty(n, dtype=torch.int32, device=dev)
                err = old_k4(
                    q0.data_ptr(), n, seed.data_ptr(), tab.data_ptr(),
                    vis.data_ptr(),
                    None if block is None else block.data_ptr(), g.size,
                    tab.shape[0], pm.shape[0], MK.PTYPE_CODE[ptype],
                    int(minv is not None), cons.cf.data_ptr(),
                    cons.desc.data_ptr(), 0, t.data_ptr(), loc.data_ptr(),
                    kernels.tally_ptr(tally), stream())
                kernels.check_launch(new_k4, err, "old dense_select")
                return t, loc

            def run_new(tally=None):
                return GK.dense_select(ptype, pm, minv, vis, cons, q0, seed,
                                       block_bbox=cull, tally=tally)

            def run_raw():
                # the new kernel through its C entry on old's inputs: what
                # the wrapper adds (its table concatenation) left out
                t = torch.empty(n, dtype=torch.float32, device=dev)
                loc = torch.empty(n, dtype=torch.int32, device=dev)
                err = new_k4.glome_dense_select(
                    q0.data_ptr(), n, seed.data_ptr(), tab.data_ptr(),
                    vis.data_ptr(), None if cull is None else cull.data_ptr(),
                    g.size, tab.shape[0], pm.shape[0], MK.PTYPE_CODE[ptype],
                    int(minv is not None), cons.cf.data_ptr(),
                    cons.desc.data_ptr(), 0, t.data_ptr(), loc.data_ptr(),
                    None, stream())
                kernels.check_launch(new_k4, err, "dense_select")
                return t, loc
            ref, got, raw = run_old(), run_new(), run_raw()
            same = all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(ref, got, raw))
            tallies = []
            for fn in (run_old, run_new):
                tl = torch.zeros((2, n), dtype=torch.int32, device=dev)
                fn(tally=tl)
                tallies.append((tl.sum(dim=1).double() / n).tolist())
            before = clocks()
            fns = {"old": run_old, "new": run_new, "raw": run_raw}
            turns = [ms(fns[v]) for v in ("old", "new", "new", "old")]
            raw_turns = [ms(fns[v]) for v in ("raw", "old", "old", "raw")]
            label = (f"{si}.g{gi} ({g.size} {ptype}"
                     f"{', transformed' if minv is not None else ''}"
                     f"{', constrained' if g.constraints else ''})")
            out["k4"][label] = {"equal": bool(same), "tally_old": tallies[0],
                                "tally_new": tallies[1], "turns": turns,
                                "turns_raw_old": raw_turns,
                                "clocks": [before, clocks()]}
            print(f"  [{out['device']}] K4 {label} L0 ({n} rays): new == old "
                  f"{same}; box / prim tests per ray old {tallies[0]}, new "
                  f"{tallies[1]}; ms old / new / new / old "
                  f"{' / '.join(f'{x:.4f}' for x in turns)}; new through its "
                  f"C entry (raw) / old / old / raw "
                  f"{' / '.join(f'{x:.4f}' for x in raw_turns)} (clocks "
                  f"before {before})")
    out["clocks_end"] = clocks()
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    ok = (all(r["new_equals_old"] for r in out["k1"].values())
          and all(r["equal"] for r in out["k4"].values()))
    print("kernel_ab: " + ("every kernel equals its predecessor" if ok
                           else "MISMATCH"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
