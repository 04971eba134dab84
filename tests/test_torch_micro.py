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
