"""The port's microbenchmarks (glome_tpu_torch.tools: M1 micro_prims, M2
micro_kwide, device_time) against the TPU tools (tools/micro_prims.py,
tools/micro_kwide.py) on the CPU.

  - the inputs the port draws equal the tools' module globals bit for bit;
  - each of the 15 variants' plain torch version (what CPU tensors run)
    gives the tool's Pallas kernel's output in interpret mode on the
    first TILES tiles: the walk's visited counts and the scratch reads
    exactly, the sphere variants within RTOL / ATOL;
  - the entry points: --device cpu prints checksums and no time, and
    without CUDA device_time and the default device raise;
  - the wrappers check shapes, dtypes, layout and devices.

Importing a TPU tool runs it (its module level times every variant), so
the `jax_tools` fixture imports both with pallas_call refusing (each run's
own try/except reports the refusal), then lets pallas_call run in
interpret mode and cuts the tools' tile count to TILES; `mk` and
`mk_walk` read T when called.  Everything is restored afterwards.
"""

import contextlib
import functools
import importlib
import io
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from glome_tpu_torch.tools import device_time as DT
from glome_tpu_torch.tools import micro_kwide as KW
from glome_tpu_torch.tools import micro_prims as MP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILES = 3
# The sphere variants' t: XLA's CPU code contracts a * b + c into fused
# multiply-adds (the plain versions and the card's kernels, built with
# -fmad=false, round each product), so the two differ by up to 6.3e-5 of
# t on most lanes (b at 3 tiles; t near 0 makes the relative error
# large).  f differs by ~2e-6 (the matmul's summation order).
RTOL, ATOL = 5e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _refuse(*_args, **_kwargs):
    raise RuntimeError("pallas_call refused while the tool is imported")


@pytest.fixture(scope="module")
def jax_tools():
    """(tools.micro_prims, tools.micro_kwide), their pallas_calls in
    interpret mode over TILES tiles."""
    real = pl.pallas_call
    added = ROOT not in sys.path
    if added:
        sys.path.insert(0, ROOT)
    saved = []
    try:
        pl.pallas_call = _refuse
        with contextlib.redirect_stdout(io.StringIO()):
            mods = (importlib.import_module("tools.micro_prims"),
                    importlib.import_module("tools.micro_kwide"))
        pl.pallas_call = functools.partial(real, interpret=True)
        for m in mods:
            saved.append((m, m.T))
            m.T = TILES
        yield mods
    finally:
        pl.pallas_call = real
        for m, t in saved:
            m.T = t
        if added:
            sys.path.remove(ROOT)


def _exact_exp2(x):
    return jnp.ldexp(jnp.ones_like(x), x.astype(jnp.int32))


def test_inputs_equal_the_tools(jax_tools):
    mp, mk = jax_tools
    rays, pf, pf_lane = MP.make_inputs()
    assert rays.dtype == pf.dtype == pf_lane.dtype == np.float32
    assert np.array_equal(rays, mp.rays)
    assert np.array_equal(pf, mp.pf)
    assert np.array_equal(pf_lane, mp.pf_lane)
    rays, nf = KW.make_inputs()
    assert np.array_equal(rays, mk.rays)
    assert np.array_equal(nf, mk.nf)
    assert nf.shape == (6 * KW.M,)


@pytest.mark.parametrize("name", [v.name for v in MP.VARIANTS])
def test_micro_prims_plain_matches_tool(jax_tools, monkeypatch, name):
    mp, _mk = jax_tools
    v = next(v for v in MP.VARIANTS if v.name == name)
    if name == "d_bits168":
        # the tool packs its words as float sums of exp2(k); XLA's CPU
        # exp2 is off at k = 13, 15, 17, 19 (2^19 by 0.22), which garbles
        # the bits it then reads back, so the reference runs with an
        # exact exp2: its words are then the intended integers
        monkeypatch.setattr(jnp, "exp2", _exact_exp2)
    fn, args, _units = mp.runs[name]
    want = np.asarray(fn(mp.rays_d, *args))
    rays, pf, pf_lane = MP.make_inputs()
    tables = [torch.as_tensor({"pf": pf, "pf_lane": pf_lane}[t])
              for t in v.tables]
    tally = torch.zeros(TILES, dtype=torch.int64)
    calls = sum(fn.calls for fn in MP.PLAIN)
    got = v.plain(torch.as_tensor(rays[:, :TILES].copy()), *tables,
                  tally=tally).numpy()
    assert got.shape == want.shape == (TILES, 8, 128)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (tally > 0).all() and (tally <= v.units).all()
    assert sum(fn.calls for fn in MP.PLAIN) == calls + 1
    # the wrapper on CPU tensors is the plain version
    again = v.kernel(torch.as_tensor(rays[:, :TILES].copy()),
                     *tables).numpy()
    assert np.array_equal(again, got)


def test_bits168_words():
    """The words d reads: the tool's layout (bit k of word w is lane
    w*21 + k of sub-row 0, word 7 sub-row 1's lanes 0..20)."""
    rays = np.zeros((8, 1, 8, 128), np.float32)
    lanes = [0, 20, 21, 125, 126, 127]
    rays[0, 0, 0, lanes] = 1.0
    rays[0, 0, 1, [0, 20, 21]] = 1.0
    rays[0, 0, 2, :] = 1.0              # sub-rows past 1 are not read
    words = MP.tile_words(torch.as_tensor(rays))[0].tolist()
    assert words == [1 | 1 << 20, 1, 0, 0, 0, 1 << 20, 3, 1 | 1 << 20]


@pytest.mark.parametrize("K", KW.KS)
def test_walk_plain_matches_tool(jax_tools, K):
    _mp, mk = jax_tools
    want = np.asarray(mk.mk_walk(K)(mk.rays_d))
    rays, nf = KW.make_inputs()
    tally = torch.zeros(TILES, dtype=torch.int64)
    got = KW.VARIANTS[KW.KS.index(K)].plain(
        torch.as_tensor(rays[:, :TILES].copy()), torch.as_tensor(nf),
        tally=tally).numpy()
    assert np.array_equal(got, want)
    assert got[0, 0, 0] == 359.0 and got[1, 0, 0] == 359.0
    assert tally.tolist() == got[:, 0, 0].tolist()


@pytest.mark.parametrize("nread", KW.NREADS)
def test_vread_plain_matches_tool(jax_tools, nread):
    _mp, mk = jax_tools
    want = np.asarray(mk.mk_vread(nread)(mk.rays_d))
    rays, _nf = KW.make_inputs()
    got = KW.VREADS[nread](torch.as_tensor(rays[:, :TILES].copy())).numpy()
    assert np.array_equal(got, want)


def test_main_cpu_prints_checksums(capsys):
    rows = MP.main(["--device", "cpu", "--tiles", "1"])
    out = capsys.readouterr().out
    assert len(rows) == len(MP.VARIANTS)
    assert all(sec is None and bool(torch.isfinite(out).all())
               for _v, sec, out in rows)
    assert "checksum" in out and " ms" not in out and "ns/" not in out
    rows = KW.main(["--device", "cpu", "--tiles", "1"])
    out = capsys.readouterr().out
    assert [r[1] for r in rows] == [None] * (len(KW.KS) + len(KW.NREADS))
    # every K pops the same nodes: those some ray of the tile hits, and
    # their children (the tool draws the heap after the rays, so it
    # depends on --tiles)
    visited = {float(out[0, 0, 0]) for v, _s, out in rows
               if v.name.startswith("walk")}
    assert len(visited) == 1 and visited.pop() > 1
    assert " ms" not in out and "ns/" not in out


def test_card_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        DT.device_time(lambda: None)
    with pytest.raises(RuntimeError):
        MP.main([])
    with pytest.raises(RuntimeError):
        KW.main(["--tiles", "1"])
    with pytest.raises(ValueError):
        MP.run("meta", 1)


def test_wrappers_reject_bad_inputs():
    rays, pf, pf_lane = (torch.as_tensor(a) for a in MP.make_inputs(1))
    with pytest.raises(ValueError):
        MP.dense_fori(rays[:7], pf)
    with pytest.raises(TypeError):
        MP.dense_fori(rays.double(), pf)
    with pytest.raises(ValueError):
        MP.dense_fori(rays.transpose(2, 3).contiguous().transpose(2, 3), pf)
    with pytest.raises(ValueError):
        MP.vote_while(rays, pf[:-1])
    with pytest.raises(ValueError):
        MP.bits168(rays, pf[:4 * 100])
    with pytest.raises(ValueError):
        MP.mxu128(rays, pf_lane[:, :4])
    with pytest.raises(ValueError):
        MP.gate8(rays.to("meta"), pf.to("meta"))
    with pytest.raises(ValueError):
        MP.lane8x128(rays, pf_lane.to("meta"))
    krays, nf = (torch.as_tensor(a) for a in KW.make_inputs(1))
    # only the built K and NREAD have a wrapper (the C entry refuses others)
    assert 3 not in KW.WALKS and 32 not in KW.VREADS
    with pytest.raises(ValueError):
        KW.WALKS[1](krays, torch.zeros(6 * (KW.STACK + 1)))
    with pytest.raises(ValueError):
        KW.WALKS[1](krays, nf[:-1])
    with pytest.raises(TypeError):
        KW.WALKS[1](krays, nf.double())
    with pytest.raises(ValueError):
        KW.VREADS[16](krays.to("meta"))


# --- the build readers behind the issue floor (kernels.ptxas_figures,
# tools/micro_prims.py) ---

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_Z17dense_fori_kernelPKfiS0_iPf' for 'sm_90a'
ptxas info    : Function properties for _Z17dense_fori_kernelPKfiS0_iPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 16 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z11walk_kernelILi8EEvPKfiS1_iPf' for 'sm_90a'
ptxas info    : Function properties for _Z11walk_kernelILi8EEvPKfiS1_iPf
    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 16 bytes cumulative stack size, 28744 bytes smem
ptxas info    : Compiling entry function '_Z16lane8x128_kernelPKfiS0_Pf' for 'sm_90a'
ptxas info    : Function properties for _Z16lane8x128_kernelPKfiS0_Pf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers
"""


def test_ptxas_figures():
    from glome_tpu_torch import kernels
    figs = kernels.ptxas_figures(PTXAS_LOG)
    assert figs["_Z17dense_fori_kernelPKfiS0_iPf"] == dict(
        stack_frame=0, spill_stores=0, spill_loads=0, registers=30, smem=16)
    assert figs["_Z11walk_kernelILi8EEvPKfiS1_iPf"] == dict(
        stack_frame=16, spill_stores=16, spill_loads=16, registers=32,
        smem=28744)
    assert figs["_Z16lane8x128_kernelPKfiS0_Pf"]["smem"] == 0
    assert MP.find_function(figs, "walk_kernelILi8E").startswith("_Z11")
    with pytest.raises(KeyError):
        MP.find_function(figs, "kernel")        # names three


def _sass(lines):
    """cuobjdump -sass text of one function, one instruction per line at
    0x10 steps (each followed by its control word line, as cuobjdump
    prints it); a line "label:" labels the next instruction."""
    out = ["\tcode for sm_90a", "\t\tFunction : _Z3fooPf"]
    addr = 0
    for ln in lines:
        if ln.endswith(":"):
            out.append(ln)
            continue
        out.append(f"        /*{addr:04x}*/                   {ln} ;"
                   f"            /* 0x000fe20000000f00 */")
        out.append("                                       "
                   "/* 0x000fc80000000000 */")
        addr += 0x10
    return "\n".join(out)


@pytest.mark.parametrize("form", ["address", "label"])
def test_sass_loops_and_instructions_per_test(form):
    """An outer loop (0x10..0x90) around an inner one (0x20..0x60) and a
    later single loop (0xb0..0xe0), branches by address or by label;
    NOPs are not counted."""
    def bra(addr, label, pred="@P0 "):
        return (f"{pred}BRA 0x{addr:x}" if form == "address"
                else f"{pred}BRA `(.L_x_{label})")
    lines = ["S2R R0, SR_TID.X",                       # 0x00
             ".L_x_1:", "IADD3 R1, R1, 0x1, RZ",       # 0x10
             ".L_x_2:", "FADD R2, R2, R3",             # 0x20
             "MUFU.RSQ R4, R2", "FMUL R5, R4, R2",     # 0x30, 0x40
             "@!P1 BRA 0x70" if form == "address" else "@!P1 BRA `(.L_x_9)",
             bra(0x20, 2),                             # 0x60 inner back edge
             ".L_x_9:", "ISETP.GE.AND P0, PT, R1, R6, PT",   # 0x70
             "NOP",                                    # 0x80
             bra(0x10, 1),                             # 0x90 outer back edge
             "BAR.SYNC.DEFER_BLOCKING 0x0",            # 0xa0
             ".L_x_3:", "LDS.128 R8, [R9]",            # 0xb0
             "FMNMX R10, R10, R8, PT", "FMNMX R11, R11, R9, PT",
             bra(0xb0, 3),                             # 0xe0
             "EXIT",                                   # 0xf0
             ".L_x_4:", bra(0x100, 4, pred="")]        # 0x100 self loop
    funcs = MP.sass_functions(_sass(lines))
    instrs = funcs["_Z3fooPf"]
    assert len(instrs) == 16                           # 17 lines, one NOP
    assert [i for i in instrs if i[1] == "BRA"][0][2] == 0x70
    assert MP.innermost_loops(instrs) == [(0x20, 0x60, 5), (0xb0, 0xe0, 4),
                                          (0x100, 0x100, 1)]
    assert MP.thread_instructions(instrs, 5) == 1.0    # the 5-instr loop
    assert MP.hot_loop(instrs) == 5
    assert MP.thread_instructions(instrs, 0) == 16.0
    with pytest.raises(ValueError):
        MP.thread_instructions([(0, "EXIT", None)], 1)


def test_issue_floor():
    """A looping variant issues its instructions per test on every ray of
    a tile for each of the tests tallied; one with no loop its whole
    function on every thread of its grid."""
    loop = [(0, "S2R", None), (0x10, "FADD", None), (0x20, "FMUL", None),
            (0x30, "LDS", None), (0x40, "BRA", 0x10), (0x50, "EXIT", None)]
    funcs = {"_Z17dense_fori_kernelPKfiS0_iPf": loop,
             "_Z16lane8x128_kernelPKfiS0_Pf": loop}
    b = next(v for v in MP.VARIANTS if v.name == "b_dense_fori")
    e = next(v for v in MP.VARIANTS if v.name == "e_lane8x128")
    assert b.per_pass == MP.DENSE_UNROLL and b.grid == MP.SPLIT_GRID
    ms, per = MP.issue_floor(b, funcs, tests=2 * 1024, tiles=2, sms=132,
                             clock_mhz=2000.0)
    assert per == 4 / MP.DENSE_UNROLL
    # the loop per test per ray, the two instructions outside it per thread
    assert ms == pytest.approx((per * 2 * 1024 * MP.TILE + 2 * 2 * 4 * 256)
                               / (132 * 128 * 2000e6) * 1e3)
    ms, per = MP.issue_floor(e, funcs, tests=0, tiles=3, sms=132,
                             clock_mhz=1000.0)
    assert per == 6.0
    assert ms == pytest.approx(6 * 3 * 1024 / (132 * 128 * 1e9) * 1e3)


def test_variants_name_their_builds():
    """Every variant names one kernel and one C entry, with the grid the
    entry launches; the C calls carry the tables' pointers and sizes."""
    rays, pf, pf_lane = (torch.as_tensor(a) for a in MP.make_inputs(1))
    _krays, nf = (torch.as_tensor(a) for a in KW.make_inputs(1))
    tables = {"pf": pf, "pf_lane": pf_lane, "nf": nf}
    symbols = [v.symbol for tool in (MP, KW) for v in tool.VARIANTS]
    assert len(set(symbols)) == len(symbols) == 15
    for tool in (MP, KW):
        for v in tool.VARIANTS:
            assert v.grid[0] * v.grid[1] in (MP.TILE, MP.TILE // 4,
                                             2 * MP.TILE)
            entry, args = tool.c_call(v.name, *(tables[t] for t in v.tables))
            assert entry.startswith("glome_micro_")
            if "pf" in v.tables:
                assert args[:2] == (pf.data_ptr(), MP.P)
    assert MP.c_call("a_vote_while", pf)[1][2] == MP.STEPS
    assert KW.c_call("walk_K8", nf) == ("glome_micro_walk",
                                        (nf.data_ptr(), KW.M, 8))
    assert KW.c_call("vread_64") == ("glome_micro_vread", (64,))
    with pytest.raises(ValueError):
        MP.store_tile(rays, MP.SPLIT_GRID)             # a card kernel


def _cu_text(*names):
    from glome_tpu_torch import kernels
    text = ""
    for name in names:
        with open(os.path.join(kernels.CSRC, name)) as f:
            text += f.read() + "\n"
    return text


def _cu_constants(text):
    """{name: value} of the `constexpr int NAME = expr;` lines of a
    source, in order (C's integer division)."""
    consts = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        consts[name] = eval(expr.replace("/", "//"), {}, dict(consts))
    return consts


def _cu_launches(text, consts, kernel, arg):
    """{(blocks per tile, threads)} of the launches `kernel<a><<<T * n,
    threads, ...` in a source whose template argument a is `arg`, a
    parameter's name or absent."""
    found = set()
    for kern, a, grid, block in re.findall(
            r"(\w+?)(?:<(\w+)>)?<<<([^,]+),\s*([^,]+),", text):
        if kern == kernel and (not a or a == arg or not a.isdigit()):
            found.add((eval(grid, {}, {**consts, "T": 1}),
                       eval(block, {}, consts)))
    return found


_CU_FILES = {MP: ("micro.cuh", "micro_prims.cu"),
             KW: ("micro.cuh", "micro_kwide.cu")}


@pytest.mark.parametrize("v", [v for tool in (MP, KW) for v in tool.VARIANTS],
                         ids=lambda v: v.name)
def test_variant_grid_is_the_launch(v):
    """Each variant's grid (its issue and launch floors' grid) is the one
    its C entry launches, and its tests per pass of the hot loop are the
    kernel's own constants (csrc/micro_prims.cu DENSE_UNROLL, MXU_ACC; a
    gate's LEAF; a walk's K): the tools' copies of them cannot drift from
    the sources."""
    tool = MP if v in MP.VARIANTS else KW
    text = _cu_text(*_CU_FILES[tool])
    consts = _cu_constants(text)
    kern, arg = re.fullmatch(r"(\w+?)(?:ILi(\d+)E)?", v.symbol).groups()
    assert _cu_launches(text, consts, kern, arg) == {v.grid}
    per_pass = {"dense_fori_kernel": consts.get("DENSE_UNROLL"),
                "mxu128_kernel": consts.get("MXU_ACC"),
                "gated_kernel": int(arg or 0), "walk_kernel": int(arg or 0)}
    assert v.per_pass == per_pass.get(kern, v.per_pass)
    if kern in ("dense_fori_kernel", "lane8x128_kernel"):
        assert v.grid == MP.SPLIT_GRID == (consts["SPLIT"],
                                           consts["SPLIT_THREADS"])
    if kern == "mxu128_kernel":
        assert v.grid == MP.MXU_GRID
        assert MP.MXU_PASS == consts["MXU_ACC"]
    if kern == "dense_fori_kernel":
        assert MP.DENSE_UNROLL == consts["DENSE_UNROLL"]


def test_moved_bytes():
    """A variant's bound moves what its function needs: vread<N> its
    output and the 32-byte sectors of its N elements of each tile's ox
    (one per element for N = 16 and 64), every other variant its ray
    components and tables whole and its output."""
    inp = {k: torch.as_tensor(a) for k, a in
           zip(("rays", "pf", "pf_lane"), MP.make_inputs(3))}
    kin = {k: torch.as_tensor(a) for k, a in
           zip(("rays", "nf"), KW.make_inputs(3))}
    out = 4 * 3 * MP.TILE
    for n in KW.NREADS:
        addrs = {(i % 8) * 128 + (i * 13) % 128 for i in range(n)}
        assert len(addrs) == n
        assert KW.vread_sectors(n) == len({4 * a // 32 for a in addrs}) == n
        v = next(v for v in KW.VARIANTS if v.name == f"vread_{n}")
        assert MP.moved_bytes(v, kin) == out + 3 * 32 * n
    walk = KW.VARIANTS[0]
    assert MP.moved_bytes(walk, kin) == out + 6 * out + 4 * 6 * KW.M
    b = next(v for v in MP.VARIANTS if v.name == "b_dense_fori")
    assert MP.moved_bytes(b, inp) == out + 7 * out + 4 * 4 * MP.P
    f = next(v for v in MP.VARIANTS if v.name == "f_mxu128")
    assert MP.moved_bytes(f, inp) == out + 7 * out + 4 * 4 * 1024


def test_kernel_ab_checks_micro_entries(tmp_path):
    """kernel_ab compares M1/M2 with an earlier tree only where every
    variant's C entry is declared as this checkout declares it."""
    from glome_tpu_torch import kernels
    from glome_tpu_torch.tools import kernel_ab as KAB
    csrc = tmp_path / "glome_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    for name in ("micro_prims.cu", "micro_kwide.cu"):
        with open(os.path.join(kernels.CSRC, name)) as f:
            (csrc / name).write_text(f.read())
    assert KAB.old_designs(str(csrc)) == {"micro_prims.cu": "variant entries",
                                         "micro_kwide.cu": "variant entries"}
    assert set(KAB.micro_entries(str(csrc), "micro_prims.cu")) == set(
        kernels.MICRO_PRIMS_ENTRIES)
    text = (csrc / "micro_prims.cu").read_text().replace(
        "glome_micro_gate16(const float* rays, int T,",
        "glome_micro_gate16(const float* rays, long T,")
    (csrc / "micro_prims.cu").write_text(text)
    with pytest.raises(ValueError, match="glome_micro_gate16"):
        KAB.micro_entries(str(csrc), "micro_prims.cu")
