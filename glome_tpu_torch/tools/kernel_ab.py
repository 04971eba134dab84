"""K1-K5 against an earlier commit's kernels on the card, in turns, and
K1's cost per phase.

    python -m glome_tpu_torch.tools.kernel_ab --old build/parent

`--old` names an unpacked checkout of the earlier commit (for example
`git archive <commit>` unpacked into the gitignored build/).  The tool
compares every kernel whose earlier C entry that tree declares, as one
of the parameter lists of OLD_ENTRIES:

  - K1 (csrc/mega_select.cu) before the child-pair records (per-node bvh2
    tables nf/ni, a (2, N) tally), or with the records and a fixed
    32-entry stack (no stack argument);
  - K4 (csrc/dense_select.cu) with per-128-prim block_aabbs;
  - K2 (csrc/block_select.cu) walking per-node tables (nf, ni = [left,
    right, leaf block]) with a fixed stack (the tool rebuilds them,
    per_node_tables);
  - K3 (csrc/mesh_block_select.cu) walking a skip-link tree over its
    blocks, with 9-float rows in that tree's leaf order (the tool
    rebuilds that plan, skip_link_plan);
  - K5 (csrc/bvh_select.cu) walking the group's skip-link tree itself
    (nf, ni = [skip, leaf start, count] per node; the tool rebuilds them,
    skip_link_tables), or its child-pair records as this checkout does
    (a variant of this checkout's kernel, built from another tree).

  - M1 (csrc/micro_prims.cu) and M2 (csrc/micro_kwide.cu), the card
    microbenchmarks, whose C entries keep one signature per variant
    across designs (the tool checks that every variant's entry is
    declared alike in both trees).

It refuses (exit 2) an --old tree that declares none of them.  The old
sources are built with this checkout's nvcc flags.  It prints, with the
card's name, power limit and SM clock:

  - each build's ptxas registers, spills and shared memory;
  - K1 on TestScene 720x480's L0 batch and first shadow batch: old and
    new equal on every lane (t, winner, aux; in shadow mode which rays
    are blocked), their device times (tools.device_time) in turns old,
    new, new, old, K1's cost per phase for both (`attribution`) and both
    work tallies per ray;
  - K4 on each dense group of the group route with TestScene's L0 batch:
    old and new equal, their tallies, device times old, new, new, old,
    and the new kernel through its C entry on old's inputs (raw: without
    what the wrapper launches) against old: raw, old, old, raw;
  - K2 on mesh_scene(100_000) and K3 on mesh_scene(250_000), on their
    1920x1080 L0 batch and its shadow batch: old and new equal t on
    every lane and equal group-local winners except on exact t ties (the
    old walks kept the first row they visited, the new ones the lowest;
    the count of such ties is printed), in shadow mode which rays are
    blocked; device times old, new, new, old; both tallies per ray.  The
    old K2 runs on its own 8-row blocks, and again on the new kernel's
    blocks (the same tree: the walks alone compared), in turns too;
  - every M1 and M2 variant at the tools' size (256 tiles): old and new
    equal on every ray (f_mxu128, a 3xTF32 tensor-core product, within
    micro_prims.MXU_RTOL / MXU_ATOL on >= MXU_AGREE of the rays), device
    times old, new, new, old, and each build's registers, spills, shared
    memory and SASS instructions (the function's, its innermost loops').

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

from .. import accel as A
from .. import block_kernel as BK
from .. import group_kernels as GK
from ..intersect import bvh_args, dense_args
from .. import kernels
from .. import megakernel as MK
from .. import mesh_kernel as MSH
from ..compile import group_accel, group_device_params
from .device_time import device_time
from . import micro_kwide as MKW
from . import micro_prims as MPR

# the earlier commits' C entries, source -> {design: (name, parameter list
# as its source declares it)}; the tool calls an entry with these
# arguments
OLD_ENTRIES = {
    "mega_select.cu": {
        "per-node tables": (
            "glome_mega_select",
            "const float* rays, int n, const float* pf, const int* pi, "
            "const float* nf, const int* ni, const float* bb, "
            "const int* meta, int n_phases, int shadow, float* out_t, "
            "int* out_w, int* out_a, int* tally, void* stream"),
        "records, fixed stack": (
            "glome_mega_select",
            "const float* rays, int n, const float* pf, const int* pi, "
            "const float* nf, const int* ni, const float* nodes, "
            "const float* bb, const float* pbox, const int* meta, "
            "int n_meta, int n_phases, int shadow, float* out_t, "
            "int* out_w, int* out_a, int* tally, void* stream")},
    "dense_select.cu": {
        "block aabbs": (
            "glome_dense_select",
            "const float* rays, int n, const float* seeds, const float* tab, "
            "const float* vis, const float* bbox, int P, int FX, int nfld, "
            "int ptype, int xf, const float* cf, const int* cdesc, "
            "int shadow, float* out_t, int* out_l, int* tally, "
            "void* stream")},
    "block_select.cu": {
        "per-node tables": (
            "glome_block_select",
            "const float* rays, int n, const float* seeds, const float* nf, "
            "const int* ni, const float* tab, int n_nodes, int bp, int F, "
            "int ptype, int xf, int nfld, const float* cf, "
            "const int* cdesc, int shadow, float* out_t, int* out_s, "
            "int* tally, void* stream")},
    "mesh_block_select.cu": {
        "skip links": (
            "glome_mesh_block_select",
            "const float* rays, int n, const float* seeds, const float* nf, "
            "const int* ni, int n_nodes, const float* tri, int bp, "
            "int shadow, float* out_t, int* out_s, int* tally, "
            "void* stream")},
    "bvh_select.cu": {
        "skip links": (
            "glome_bvh_select",
            "const float* rays, int n, const float* seeds, const float* nf, "
            "const int* ni, int n_nodes, const float* rows, const float* vis, "
            "int F, int ptype, const float* cf, const int* cdesc, int shadow, "
            "float* out_t, int* out_l, int* tally, void* stream"),
        "child-pair records": (
            "glome_bvh_select",
            "const float* rays, int n, const float* seeds, "
            "const float* nodes, int n_nodes, int stack, const float* rows, "
            "const float* vis, int F, int ptype, const float* cf, "
            "const int* cdesc, int shadow, float* out_t, int* out_l, "
            "int* tally, void* stream")},
    # M1 / M2: one entry per variant, each signature unchanged since the
    # first port; the first stands for the source (micro_entries checks
    # them all)
    "micro_prims.cu": {
        "variant entries": (
            "glome_micro_dense_fori",
            "const float* rays, int T, const float* pf, int P, float* out, "
            "void* stream")},
    "micro_kwide.cu": {
        "variant entries": (
            "glome_micro_walk",
            "const float* rays, int T, const float* nf, int M, int K, "
            "float* out, void* stream")},
}
# K5's rays on the check groups beyond TestScene
K5_RAYS = 65536
MESH_RES = (1920, 1080)


def declared_params(path: str, fn: str):
    """The parameter list of `extern "C" int fn(...)` in the source at
    path, whitespace collapsed, or None."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", f.read())
    return None if m is None else " ".join(m.group(1).split())


def old_designs(old_csrc: str):
    """{source: design} of the OLD_ENTRIES the tree at old_csrc declares."""
    found = {}
    for source, designs in OLD_ENTRIES.items():
        for design, (fn, params) in designs.items():
            if declared_params(os.path.join(old_csrc, source), fn) == params:
                found[source] = design
    return found


def micro_entries(old_csrc: str, source: str):
    """The C entries of a microbenchmark source (kernels.MICRO_*_ENTRIES)
    with their argument types, after checking that the tree at old_csrc
    declares every one as this checkout's source does."""
    entries = (kernels.MICRO_PRIMS_ENTRIES if source == "micro_prims.cu"
               else kernels.MICRO_KWIDE_ENTRIES)
    for fn in entries:
        new = declared_params(os.path.join(kernels.CSRC, source), fn)
        old = declared_params(os.path.join(old_csrc, source), fn)
        if old != new:
            raise ValueError(f"{old_csrc}/{source} declares {fn}({old}), "
                             f"this checkout {fn}({new})")
    return entries


def old_entry(lib_path: str, source: str, design: str):
    """The earlier commit's C entry of `source`, loaded from lib_path with
    the argument types of OLD_ENTRIES (main checks first that the source
    declares it so: another list would be undefined on the card)."""
    fn, params = OLD_ENTRIES[source][design]
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


def mesh_batches(compiled, arrays, cam, device, res=MESH_RES):
    """The res L0 rays of a mesh scene, the seed K1 (the ground plane)
    leaves for the mesh group, and the shadow rays of the L0 hits after
    the whole chain: (rays, seed, shadow rays)."""
    q = l0_batch(cam, *res, device)
    plan = MK.get_plan(compiled)
    t1, _w, _a = MK.mega_select(MK.pack_tables(plan, compiled, arrays), q,
                                False)
    return q, t1.contiguous(), l0_shadow(compiled, arrays, q)


def block_inputs(compiled, arrays, grp, device):
    """(plan, table, constraint rows) of K2's group grp = (si, gi)."""
    sc = compiled.scenes[grp[0]]
    g = sc.groups[grp[1]]
    plan = BK.get_block_plan(g, sc)
    ga = {k: v.detach() for k, v in
          group_device_params(g, arrays["scenes"][grp[0]][grp[1]]).items()
          if k != "m_fwd"}
    return (plan, BK.pack_blocks(plan, ga),
            BK.pack_cons(plan, sc, arrays["scenes"][grp[0]], device))


def mesh_inputs(compiled, arrays, grp):
    """(plan, table) of K3's group grp = (si, gi)."""
    g = compiled.scenes[grp[0]].groups[grp[1]]
    plan = MSH.get_block_plan(g)
    ga = group_device_params(g, arrays["scenes"][grp[0]][grp[1]])
    return plan, MSH.pack_tri_blocks(
        plan, {k: ga[k].detach() for k in ("p1", "p2", "p3")})


@dataclasses.dataclass
class SkipLinkPlan:
    """K3's plan before the child-pair records: a skip-link tree
    (accel.build_bvh, leaves of at most SKIP_LINK_LEAF blocks) over blocks
    of SKIP_LINK_BP triangles, the table in that tree's leaf order, 9
    floats a row."""
    nf: torch.Tensor
    ni: torch.Tensor
    n_nodes: int
    row_perm: torch.Tensor
    sel_to_local: torch.Tensor


# the skip-link plan's blocks: 8 rows, at most 2 blocks per leaf
SKIP_LINK_BP, SKIP_LINK_LEAF = 8, 2


def skip_link_plan(g, device) -> SkipLinkPlan:
    bp = SKIP_LINK_BP
    n_blocks = (g.size + bp - 1) // bp
    bmin, bmax = A.group_bounds(g)
    pad = n_blocks * bp - g.size
    if pad:
        bmin = np.concatenate([bmin, np.repeat(bmin[-1:], pad, 0)])
        bmax = np.concatenate([bmax, np.repeat(bmax[-1:], pad, 0)])
    bvh = A.build_bvh(bmin.reshape(n_blocks, bp, 3).min(axis=1),
                      bmax.reshape(n_blocks, bp, 3).max(axis=1),
                      leaf_max=SKIP_LINK_LEAF)
    order = np.asarray(bvh.order, np.int64)
    row_perm = np.repeat(order * bp, bp) + np.tile(np.arange(bp), n_blocks)
    nf = np.concatenate([bvh.bmin, bvh.bmax], axis=1).astype(np.float32)
    ni = np.stack([bvh.skip, bvh.leaf_start, bvh.leaf_count],
                  axis=1).astype(np.int32)
    return SkipLinkPlan(
        torch.as_tensor(nf.reshape(-1), device=device),
        torch.as_tensor(ni.reshape(-1), device=device), bvh.n_nodes,
        torch.as_tensor(row_perm, device=device),
        torch.as_tensor(np.where(row_perm < g.size, row_perm, -1)
                        .astype(np.int32), device=device))


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


def ptxas_lines(path):
    return [line.strip() for line in
            kernels.BUILD_INFO[path]["log"].splitlines()
            if "entry function" in line or "registers" in line
            or "spill" in line or "smem" in line]


def _fmt(xs):
    return " / ".join(f"{x:.4f}" for x in xs)


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
    designs = old_designs(old_csrc)
    if not designs:
        print(f"kernel_ab: {old_csrc} declares none of the earlier C "
              "entries of OLD_ENTRIES", file=sys.stderr)
        return 2
    import glome_tpu_torch as T
    from glome_tpu_torch.scenes import mesh_scene, test_scene
    dev = torch.device("cuda", 0)
    out = {"device": _smi("name,power.limit"), "clocks_start": clocks(),
           "old_designs": designs}
    print(f"[{out['device']}] clocks at the start: {out['clocks_start']}")
    print(f"  old kernels: {designs}")

    # -- builds: each compared kernel, new and old
    paths, out["ptxas"] = {}, {}
    for source in designs:
        lib, srcs = next((name, srcs) for name, srcs in
                         kernels.LIBRARIES.items() if srcs[0] == source)
        paths[f"new {source}"] = kernels.build(srcs, lib)
        paths[f"old {source}"] = kernels.build(
            [s for s in srcs if os.path.exists(os.path.join(old_csrc, s))],
            lib + "_old", csrc=old_csrc)
    for name, path in paths.items():
        out["ptxas"][name] = ptxas_lines(path)
        print(f"  {name}: nvcc {kernels.BUILD_INFO[path]['seconds']:.2f} s")
        for line in out["ptxas"][name]:
            print(f"    ptxas: {line}")
    olds = {s: old_entry(paths[f"old {s}"], s, d) for s, d in designs.items()}
    any_lib = kernels.mega_select_lib()   # for check_launch's error names

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def empty(n, dtype):
        return torch.empty(n, dtype=dtype, device=dev)

    def ms(fn):
        return device_time(fn) * 1e3

    def turns(fns, order=("old", "new", "new", "old")):
        before = clocks()
        times = [ms(fns[v]) for v in order]
        return times, [before, clocks()]

    need_ts = any(s in designs for s in ("mega_select.cu", "dense_select.cu",
                                         "bvh_select.cu"))
    if need_ts:
        solid, lights, cam = test_scene()
        compiled = T.compile_scene(solid, lights)
        plan = MK.get_plan(compiled)
        arrays = T.to_torch(compiled.arrays(), dev)
        cfg = T.RenderConfig.tuned()
        tables = MK.pack_tables(plan, compiled, arrays)
        q0 = l0_batch(cam, cfg.xres, cfg.yres, dev)

    # -- K1: equality, turns, attribution, tallies
    if "mega_select.cu" in designs:
        old_k1, design = olds["mega_select.cu"], designs["mega_select.cu"]
        tally_rows = 2 if design == "per-node tables" else MK.TALLY_ROWS

        def run_old_k1(tabs, rays, shadow, tally=None):
            n = rays.shape[1]
            t, w, a = (empty(n, torch.float32), empty(n, torch.int32),
                       empty(n, torch.int32))
            if design == "per-node tables":
                tabs_args = (tabs.nf.data_ptr(), tabs.ni.data_ptr(),
                             tabs.bb.data_ptr(), tabs.phases.data_ptr(),
                             len(tabs.plan.phases))
            else:
                tabs_args = (tabs.nf.data_ptr(), tabs.ni.data_ptr(),
                             tabs.nodes.data_ptr(), tabs.bb.data_ptr(),
                             tabs.pbox.data_ptr(), tabs.phases.data_ptr(),
                             tabs.phases.numel(), len(tabs.plan.phases))
            err = old_k1(rays.data_ptr(), n, tabs.pf.data_ptr(),
                         tabs.pi.data_ptr(), *tabs_args, int(shadow),
                         t.data_ptr(), w.data_ptr(), a.data_ptr(),
                         kernels.tally_ptr(tally), stream())
            kernels.check_launch(any_lib, err, "old mega_select")
            return t, w, a

        new_k1 = MK.mega_select
        print(f"  K1: new walk stack {MK.walk_stack(plan)} entries per "
              f"thread (deepest bvh2 tree: depth "
              f"{max(ph.depth for ph in plan.phases if ph.kind == 'bvh2')})")
        out["k1"] = {}
        for label, (rays, shadow) in {
                "L0 intersect": (q0, False),
                "L0 shadow": (l0_shadow(compiled, arrays, q0), True)}.items():
            n = rays.shape[1]
            ref = [x.cpu() for x in run_old_k1(tables, rays, shadow)]
            got = [x.cpu() for x in new_k1(tables, rays, shadow)]
            same = (torch.equal(got[1] >= 0, ref[1] >= 0) if shadow else
                    all(torch.equal(a, b) for a, b in zip(got, ref)))
            row = {"rays": n, "new_equals_old": bool(same)}
            row["turns_old_new"], row["clocks"] = turns(
                {"old": lambda: run_old_k1(tables, rays, shadow),
                 "new": lambda: new_k1(tables, rays, shadow)})
            print(f"  [{out['device']}] K1 TestScene {label} ({n} rays): new "
                  f"== old {row['new_equals_old']}; ms old / new / new / old "
                  f"{_fmt(row['turns_old_new'])} (clocks before "
                  f"{row['clocks'][0]}; after {row['clocks'][1]})")
            for vname, fn in (("old", lambda tb: run_old_k1(tb, rays, shadow)),
                              ("new", lambda tb: new_k1(tb, rays, shadow))):
                rows, full = attribution(lambda tb: ms(lambda: fn(tb)), tables)
                print_attribution(f"K1 {vname} {label} per phase", rows, full)
                row[f"attribution_{vname}"] = rows
            t_old = torch.zeros((tally_rows, n), dtype=torch.int32, device=dev)
            run_old_k1(tables, rays, shadow, tally=t_old)
            t_new = torch.zeros((MK.TALLY_ROWS, n), dtype=torch.int32,
                                device=dev)
            new_k1(tables, rays, shadow, tally=t_new)
            row["tally_old"] = (t_old.sum(dim=1).double() / n).tolist()
            row["tally_new"] = (t_new.sum(dim=1).double() / n).tolist()
            print(f"  K1 {label} tests per ray (box / prim [/ point / "
                  f"member]): old {row['tally_old']}; new {row['tally_new']}")
            out["k1"][label] = row

    # -- K4 on every dense group of the group route, L0 batch
    if "dense_select.cu" in designs:
        old_k4, new_k4 = olds["dense_select.cu"], kernels.dense_select_lib()
        out["k4"] = {}
        seed = q0[6].contiguous()
        for si, sc in enumerate(compiled.scenes):
            for gi, g in enumerate(sc.groups):
                if g.vclass in ("deferred", "convex") or not g.size \
                        or g.accel_eligible:
                    continue
                out["k4"].update(_k4_group(
                    out["device"], sc, si, gi, g, arrays, q0, seed, dev,
                    old_k4, new_k4, stream, ms, turns))

    # -- K2 on mesh100k, K3 on mesh250k: 1080p L0 and shadow batches
    for source, n_tris, key in (("block_select.cu", 100_000, "k2"),
                                ("mesh_block_select.cu", 250_000, "k3")):
        if source not in designs:
            continue
        s, lt, c = mesh_scene(n_tris, cast_shadows=True)
        cc = T.compile_scene(s, lt)
        garrs = T.to_torch(cc.arrays(), dev)
        mp = MK.get_plan(cc)
        grp = (mp.blocks + mp.external)[0]
        g = cc.scenes[grp[0]].groups[grp[1]]
        q, t1, sh = mesh_batches(cc, garrs, c, dev)
        if key == "k2":
            runs = _k2_runs(cc, garrs, grp, g, dev, olds[source], stream,
                            any_lib)
        else:
            runs = _k3_runs(cc, garrs, grp, g, dev, olds[source], stream,
                            any_lib)
        out[key] = {}
        for label, rays, seed, shadow in (("L0 intersect", q, t1, False),
                                          ("L0 shadow", sh, sh[6], True)):
            seed = seed.contiguous()
            n = rays.shape[1]
            old, new = runs["old"], runs["new"]
            (to, lo), (tn, ln) = old(rays, seed, shadow), new(rays, seed,
                                                             shadow)
            if shadow:
                same, ties = bool(torch.equal(lo >= 0, ln >= 0)), 0
            else:
                diff = lo != ln
                same = bool(torch.equal(to, tn)
                            and torch.equal(lo >= 0, ln >= 0))
                ties = int(diff.sum())
            row = {"rays": n, "new_equals_old": same,
                   "winner_ties": ties}
            row["turns_old_new"], row["clocks"] = turns(
                {"old": lambda: old(rays, seed, shadow),
                 "new": lambda: new(rays, seed, shadow)})
            for vname in runs:
                tl = torch.zeros((2, n), dtype=torch.int32, device=dev)
                runs[vname](rays, seed, shadow, tally=tl)
                row[f"tally {vname}"] = (tl.sum(dim=1).double() / n).tolist()
            print(f"  [{out['device']}] {key.upper()} mesh_scene({n_tris}) "
                  f"1080p {label} ({n} rays): t and hit equal on every lane "
                  f"{same}; group-local winners differ at {ties} exact t "
                  f"ties; ms old / new / new / old "
                  f"{_fmt(row['turns_old_new'])}; box / triangle tests per "
                  f"ray old {row['tally old']}, new {row['tally new']} "
                  f"(clocks before {row['clocks'][0]}; after "
                  f"{row['clocks'][1]})")
            if "old on new blocks" in runs:
                same_blocks = runs["old on new blocks"]
                t_s, l_s = same_blocks(rays, seed, shadow)
                row["old_on_new_blocks_equal"] = bool(
                    torch.equal(l_s >= 0, ln >= 0) if shadow else
                    torch.equal(t_s, tn) and torch.equal(l_s >= 0, ln >= 0))
                row["new_equals_old"] &= row["old_on_new_blocks_equal"]
                row["turns_old_on_new_blocks"], _clk = turns(
                    {"old": lambda: same_blocks(rays, seed, shadow),
                     "new": lambda: new(rays, seed, shadow)})
                print(f"    the old walk on the new blocks: equal "
                      f"{row['old_on_new_blocks_equal']}; ms old / new / "
                      f"new / old {_fmt(row['turns_old_on_new_blocks'])}; "
                      f"tests per ray {row['tally old on new blocks']}")
            out[key][label] = row
    # -- K5 on TestScene's lattice groups and the two check groups
    if "bvh_select.cu" in designs:
        out["k5"] = {}
        for label, sc, garrs, gi, batches in _k5_cases(compiled, arrays, q0,
                                                        dev):
            bvh = group_accel(sc.groups[gi])
            recs = GK.bvh_records(bvh, dev)
            print(f"  K5 {label}: skip-link tree {bvh.n_nodes} nodes; records "
                  f"of {recs.n_nodes} nodes, depth {recs.depth}, walk stack "
                  f"{kernels.walk_stack(recs.depth)} entries per thread")
            for mode, rays, seed in batches:
                shadow = mode == "shadow"
                runs = _k5_runs(olds["bvh_select.cu"],
                                designs["bvh_select.cu"],
                                bvh_args(sc, garrs, gi, shadow, dev)[0],
                                dev, stream, any_lib)
                n = rays.shape[1]
                (to, lo), (tn, ln) = (runs["old"](rays, seed, shadow),
                                      runs["new"](rays, seed, shadow))
                same = bool(torch.equal(lo >= 0, ln >= 0) if shadow else
                            torch.equal(to, tn) and torch.equal(lo, ln))
                row = {"rays": n, "new_equals_old": same,
                       "hits_new": int((ln >= 0).sum())}
                row["turns_old_new"], row["clocks"] = turns(
                    {v: (lambda f=f: f(rays, seed, shadow))
                     for v, f in runs.items()})
                for vname, fn in runs.items():
                    tl = torch.zeros((2, n), dtype=torch.int32, device=dev)
                    fn(rays, seed, shadow, tally=tl)
                    row[f"tally {vname}"] = (tl.sum(dim=1).double()
                                             / n).tolist()
                print(f"  [{out['device']}] K5 {label} {mode} ({n} rays, "
                      f"{row['hits_new']} {'blocked' if shadow else 'hit'}): "
                      f"new == old on every lane {same}; ms old / new / new "
                      f"/ old {_fmt(row['turns_old_new'])}; box / prim "
                      f"tests per ray old {row['tally old']}, new "
                      f"{row['tally new']} (clocks before "
                      f"{row['clocks'][0]}; after {row['clocks'][1]})")
                out["k5"][f"{label} {mode}"] = row
    # -- M1 and M2: every variant, old against new, at the tools' size
    for source, key in (("micro_prims.cu", "m1"), ("micro_kwide.cu", "m2")):
        if source in designs:
            old_lib = ctypes.CDLL(paths[f"old {source}"])
            old_lib.glome_cuda_error_name.argtypes = [ctypes.c_int]
            old_lib.glome_cuda_error_name.restype = ctypes.c_char_p
            kernels.set_entries(old_lib, micro_entries(old_csrc, source))
            out[key] = _micro_rows(out["device"], source, old_lib,
                                   paths[f"old {source}"],
                                   paths[f"new {source}"], dev, turns)
    out["clocks_end"] = clocks()
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    ok = (all(r["new_equals_old"] for k in ("k1", "k2", "k3", "k5")
              for r in out.get(k, {}).values())
          and all(r["equal"] for r in out.get("k4", {}).values())
          and all(r["new_equals_old"] for k in ("m1", "m2")
                  for r in out.get(k, {}).values()))
    print("kernel_ab: " + ("every kernel equals its predecessor" if ok
                           else "MISMATCH"))
    return 0 if ok else 1


def _sass_summary(funcs, symbol):
    """(instructions, [innermost loops' instructions]) of the function
    whose name holds `symbol`."""
    instrs = funcs[MPR.find_function(funcs, symbol)]
    return len(instrs), [n for _a, _b, n in MPR.innermost_loops(instrs)]


def _micro_rows(device, source, old_lib, old_path, new_path, dev, turns):
    """M1 or M2 (by `source`): every variant's old and new launch on the
    tool's inputs at its size, compared, timed in turns, and both
    builds' ptxas figures and SASS sizes."""
    tool = MPR if source == "micro_prims.cu" else MKW
    inp = tool.device_inputs(dev)
    figs = {v: kernels.ptxas_figures(kernels.BUILD_INFO[p]["log"])
            for v, p in (("old", old_path), ("new", new_path))}
    sass = {v: MPR.sass_functions(kernels.sass(p))
            for v, p in (("old", old_path), ("new", new_path))}
    rows = {}
    for v in tool.VARIANTS:
        tables = [inp[t] for t in v.tables]
        entry, args = tool.c_call(v.name, *tables)
        runs = {"old": lambda: MPR.launch(old_lib, entry, inp["rays"],
                                          *args),
                "new": lambda: v.kernel(inp["rays"], *tables)}
        got = {k: fn() for k, fn in runs.items()}
        torch.cuda.synchronize()
        if v.name == "f_mxu128":
            frac = float(torch.isclose(got["new"], got["old"],
                                       rtol=MPR.MXU_RTOL, atol=MPR.MXU_ATOL)
                         .float().mean())
            same = frac >= MPR.MXU_AGREE
            how = (f"within rtol {MPR.MXU_RTOL} / atol {MPR.MXU_ATOL} on "
                   f"{100 * frac:.4f}% of rays")
        else:
            same = bool(torch.equal(got["new"], got["old"]))
            how = "equal on every ray" if same else "NOT equal"
        row = {"new_equals_old": bool(same), "max_abs_diff": float(
            (got["new"] - got["old"]).abs().max())}
        row["turns_old_new"], row["clocks"] = turns(runs)
        for b in ("old", "new"):
            name = MPR.find_function(figs[b], v.symbol)
            row[f"ptxas_{b}"] = figs[b][name]
            row[f"sass_{b}"] = _sass_summary(sass[b], v.symbol)
        print(f"  [{device}] {v.name}: new vs old {how} (max |diff| "
              f"{row['max_abs_diff']:.3g}); ms old / new / new / old "
              f"{_fmt(row['turns_old_new'])} (clocks before "
              f"{row['clocks'][0]}; after {row['clocks'][1]})")
        for b in ("old", "new"):
            n, loops = row[f"sass_{b}"]
            print(f"    {b}: ptxas {row[f'ptxas_{b}']}; SASS {n} "
                  f"instructions, innermost loops {loops}")
        rows[v.name] = row
    return rows


def _k4_group(device, sc, si, gi, g, arrays, q0, seed, dev, old_k4, new_k4,
              stream, ms, turns):
    """{label: row} of K4 old against new on one dense group with the L0
    batch q0."""
    (ptype, pm, minv, vis, cons), cull = dense_args(
        sc, arrays["scenes"][si], gi, False, dev)
    ga = arrays["scenes"][si][gi]
    block = GK.block_aabbs(ptype, {k: v.detach() for k, v in ga.items()
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
            vis.data_ptr(), None if block is None else block.data_ptr(),
            g.size, tab.shape[0], pm.shape[0], MK.PTYPE_CODE[ptype],
            int(minv is not None), cons.cf.data_ptr(), cons.desc.data_ptr(),
            0, t.data_ptr(), loc.data_ptr(), kernels.tally_ptr(tally),
            stream())
        kernels.check_launch(new_k4, err, "old dense_select")
        return t, loc

    def run_new(tally=None):
        return GK.dense_select(ptype, pm, minv, vis, cons, q0, seed,
                               block_bbox=cull, tally=tally)

    def run_raw():
        # the new kernel through its C entry on old's inputs: what the
        # wrapper adds (its table concatenation) left out
        t = torch.empty(n, dtype=torch.float32, device=dev)
        loc = torch.empty(n, dtype=torch.int32, device=dev)
        err = new_k4.glome_dense_select(
            q0.data_ptr(), n, seed.data_ptr(), tab.data_ptr(),
            vis.data_ptr(), None if cull is None else cull.data_ptr(),
            g.size, tab.shape[0], pm.shape[0], MK.PTYPE_CODE[ptype],
            int(minv is not None), cons.cf.data_ptr(), cons.desc.data_ptr(),
            0, t.data_ptr(), loc.data_ptr(), None, stream())
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
    fns = {"old": run_old, "new": run_new, "raw": run_raw}
    times, clk = turns(fns)
    raw_times, _ = turns(fns, ("raw", "old", "old", "raw"))
    label = (f"{si}.g{gi} ({g.size} {ptype}"
             f"{', transformed' if minv is not None else ''}"
             f"{', constrained' if g.constraints else ''})")
    print(f"  [{device}] K4 {label} L0 ({n} rays): new == old {same}; box / "
          f"prim tests per ray old {tallies[0]}, new {tallies[1]}; ms old / "
          f"new / new / old {_fmt(times)}; new through its C entry (raw) / "
          f"old / old / raw {_fmt(raw_times)} (clocks before {clk[0]})")
    return {label: {"equal": bool(same), "tally_old": tallies[0],
                    "tally_new": tallies[1], "turns": times,
                    "turns_raw_old": raw_times, "clocks": clk}}


# the per-node plan's blocks: 8 rows each
PER_NODE_BP = 8


def per_node_tables(g, plan, ga, bp, device):
    """(nf, ni, n_nodes, table) of K2's per-node layout over blocks of bp
    rows, as K2's plan built them before the child-pair records: the
    binary tree over the block boxes (accel.build_bvh2, one block a leaf),
    nf = (bmin, bmax) and ni = [left, right, leaf block] per node, and the
    group's rows cut into (n_blocks, bp, F) blocks, the last padded with
    copies of the last row, nfld (+ 12 inverse-matrix) floats each.
    `plan` is this checkout's BlockPlan of g (its ptype), `ga` the
    group's parameters."""
    n_blocks = -(-g.size // bp)
    bmin, bmax = A.group_bounds(g)
    pad = n_blocks * bp - g.size
    if pad:
        bmin = np.concatenate([bmin, np.repeat(bmin[-1:], pad, 0)])
        bmax = np.concatenate([bmax, np.repeat(bmax[-1:], pad, 0)])
    bvh = A.build_bvh2(bmin.reshape(n_blocks, bp, 3).min(axis=1),
                       bmax.reshape(n_blocks, bp, 3).max(axis=1), leaf_max=1)
    leaf_blk = np.where(bvh.leaf_count > 0, np.asarray(bvh.order)[
        np.clip(bvh.leaf_start, 0, n_blocks - 1)], -1)
    nf = np.concatenate([bvh.bmin, bvh.bmax], axis=1).astype(np.float32)
    ni = np.stack([bvh.left, bvh.right, leaf_blk], axis=1).astype(np.int32)
    rows = BK._rows(plan.ptype, ga, plan.transformed)
    if pad:
        rows = torch.cat([rows, rows[-1:].expand(pad, -1)])
    return (torch.as_tensor(nf.reshape(-1), device=device),
            torch.as_tensor(ni.reshape(-1), device=device), bvh.n_nodes,
            rows.reshape(n_blocks, bp, rows.shape[1]).contiguous())


def _k2_runs(compiled, arrays, grp, g, dev, old_k2, stream, err_lib):
    """{"old", "old on new blocks", "new"}: K2 on the group as fn(rays,
    seed, shadow, tally=None) -> (t, group-local winner * 2 + slot).  The
    old kernel walks per_node_tables: over PER_NODE_BP-row blocks (its
    own plan), and over this checkout's BP-row blocks (the new kernel's
    tree, so that the two walks alone are compared)."""
    plan, tab, cf = block_inputs(compiled, arrays, grp, dev)
    ga = {k: v.detach() for k, v in
          group_device_params(g, arrays["scenes"][grp[0]][grp[1]]).items()
          if k != "m_fwd"}
    cdesc = plan.device_tables(dev)[1]

    def local(sel2):
        row = torch.clamp(sel2 // 2, 0, g.size - 1)
        return torch.where(sel2 >= 0, row * 2 + sel2 % 2, -1)

    def old_on(bp):
        nf, ni, n_nodes, otab = per_node_tables(g, plan, ga, bp, dev)

        def old(rays, seed, shadow, tally=None):
            n = rays.shape[1]
            t = torch.empty(n, dtype=torch.float32, device=dev)
            s = torch.empty(n, dtype=torch.int32, device=dev)
            err = old_k2(rays.data_ptr(), n, seed.data_ptr(), nf.data_ptr(),
                         ni.data_ptr(), otab.data_ptr(), n_nodes, bp,
                         otab.shape[2],
                         MK.PTYPE_CODE[plan.ptype], int(plan.transformed),
                         plan.nfld, cf.data_ptr(), cdesc.data_ptr(),
                         int(shadow), t.data_ptr(), s.data_ptr(),
                         kernels.tally_ptr(tally), stream())
            kernels.check_launch(err_lib, err, "old block_select")
            return t, local(s)
        return old

    def new(rays, seed, shadow, tally=None):
        t, s = BK.block_select(plan, tab, cf, rays, seed, shadow, tally=tally)
        return t, local(s)
    print(f"  K2 block plan: {plan.n_blocks} blocks of {BK.BP}, "
          f"{plan.n_nodes} nodes, depth {plan.depth}; the old kernel's own "
          f"blocks: {PER_NODE_BP} rows")
    return {"old": old_on(PER_NODE_BP), "old on new blocks": old_on(BK.BP),
            "new": new}


def _k3_runs(compiled, arrays, grp, g, dev, old_k3, stream, err_lib):
    """{"old", "new"}: K3 on the group as fn(rays, seed, shadow, tally=None)
    -> (t, group-local triangle).  The old kernel walks skip_link_plan's
    tree over 9-float rows in that tree's leaf order."""
    plan, tri = mesh_inputs(compiled, arrays, grp)
    sp = skip_link_plan(g, dev)
    ga = group_device_params(g, arrays["scenes"][grp[0]][grp[1]])
    rows = torch.cat([ga[k].detach() for k in ("p1", "p2", "p3")],
                     dim=-1).to(torch.float32)
    rows = torch.cat([rows, rows.new_zeros((len(sp.row_perm) - g.size, 9))])
    old_tri = rows[sp.row_perm].contiguous()
    s2l = plan.device_tables(dev)[2]

    def old(rays, seed, shadow, tally=None):
        n = rays.shape[1]
        t = torch.empty(n, dtype=torch.float32, device=dev)
        s = torch.empty(n, dtype=torch.int32, device=dev)
        err = old_k3(rays.data_ptr(), n, seed.data_ptr(), sp.nf.data_ptr(),
                     sp.ni.data_ptr(), sp.n_nodes, old_tri.data_ptr(),
                     SKIP_LINK_BP, int(shadow), t.data_ptr(), s.data_ptr(),
                     kernels.tally_ptr(tally), stream())
        kernels.check_launch(err_lib, err, "old mesh_block_select")
        return t, torch.where(s >= 0, sp.sel_to_local[s.clamp(min=0).long()],
                              -1)

    def new(rays, seed, shadow, tally=None):
        t, s = MSH.mesh_block_select(plan, tri, rays, seed, shadow,
                                     tally=tally)
        return t, torch.where(s >= 0, s2l[s.clamp(min=0).long()], -1)
    print(f"  K3 mesh plan: {plan.n_blocks} blocks of {MSH.BP}, at most "
          f"{MSH.BLOCK_LEAF_MAX} per leaf, {plan.n_nodes} nodes, depth "
          f"{plan.depth}; the old skip-link tree {sp.n_nodes} nodes")
    return {"old": old, "new": new}


def skip_link_tables(bvh, device):
    """(nf (M * 6,) float32, ni (M * 3,) int32 [skip, leaf start, count])
    of a skip-link tree on `device`: K5's tables before the child-pair
    records."""
    nf = np.concatenate([bvh.bmin, bvh.bmax], axis=1).astype(np.float32)
    ni = np.stack([bvh.skip, bvh.leaf_start, bvh.leaf_count],
                  axis=1).astype(np.int32)
    return (torch.as_tensor(nf.reshape(-1), device=device),
            torch.as_tensor(ni.reshape(-1), device=device))


def _k5_cases(compiled, arrays, q0, dev):
    """[(label, scene, device arrays, group, [(mode, rays, seed)])]: K5's
    comparison cases -- each lattice group of TestScene with the L0 batch
    q0 and its first shadow batch, then the sphere cloud and the
    coincident chain with K5_RAYS block_rays, intersect and shadow."""
    from ..compile import compile_scene, to_torch
    from ..config import INFINITY
    from ..scenes.phasescene import (block_rays, coincident_scene,
                                     phase_kinds_lights, sphere_cloud_scene)
    sh = l0_shadow(compiled, arrays, q0)
    ts = [(mode, rays, rays[6].contiguous())
          for mode, rays in (("intersect", q0), ("shadow", sh))]
    sc = compiled.scenes[0]
    cases = [(f"TestScene 0.g{gi} ({g.size} {g.ptype}"
              f"{', constrained' if g.constraints else ''}) L0", sc,
              arrays["scenes"][0], gi, ts)
             for gi, g in enumerate(sc.groups) if g.accel_eligible]
    for label, solid, span, min_size in (
            ("sphere cloud (20,000 spheres)", sphere_cloud_scene(), 14.0,
             None),
            ("coincident chain (1,000 spheres)", coincident_scene(), 6.0,
             64)):
        kw = {} if min_size is None else {"accel_min_size": min_size}
        cc = compile_scene(solid, phase_kinds_lights(), **kw)
        o, d = block_rays(K5_RAYS, 4, span)
        batches = []
        for mode, seed_t in (("intersect", INFINITY), ("shadow", 7.0)):
            rays = torch.as_tensor(np.stack(
                [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                 np.full(K5_RAYS, seed_t, np.float32),
                 np.zeros(K5_RAYS, np.float32)]), device=dev).contiguous()
            batches.append((mode, rays, rays[6].contiguous()))
        cases.append((label, cc.scenes[0],
                      to_torch(cc.arrays(), dev)["scenes"][0], 0, batches))
    return cases


def _k5_runs(old_k5, design, args, dev, stream, err_lib):
    """{"old", "new"}: K5 on one group's inputs args = (ptype, bvh, rows,
    vis, cons) (intersect.bvh_args) as fn(rays, seed, shadow, tally=None)
    -> (t, leaf-order winner).  The old kernel walks the skip-link tables
    (skip_link_tables) or, for a records design, this checkout's
    records."""
    ptype, bvh, rows, vis, cons = args
    if design == "skip links":
        nf, ni = skip_link_tables(bvh, dev)

        def tree():
            return nf.data_ptr(), ni.data_ptr(), bvh.n_nodes
    else:
        recs = GK.bvh_records(bvh, dev)

        def tree():
            return (recs.nodes.data_ptr(), recs.n_nodes,
                    kernels.walk_stack(recs.depth))

    def old(rays, seed, shadow, tally=None):
        n = rays.shape[1]
        t = torch.empty(n, dtype=torch.float32, device=dev)
        leaf = torch.empty(n, dtype=torch.int32, device=dev)
        err = old_k5(rays.data_ptr(), n, seed.data_ptr(), *tree(),
                     rows.data_ptr(), vis.data_ptr(), rows.shape[1],
                     MK.PTYPE_CODE[ptype], cons.cf.data_ptr(),
                     cons.desc.data_ptr(), int(shadow), t.data_ptr(),
                     leaf.data_ptr(), kernels.tally_ptr(tally), stream())
        kernels.check_launch(err_lib, err, "old bvh_select")
        return t, leaf

    def new(rays, seed, shadow, tally=None):
        return GK.bvh_select(ptype, bvh, rows, vis, cons, rays, seed,
                             shadow, tally=tally)
    return {"old": old, "new": new}


if __name__ == "__main__":
    sys.exit(main())
