"""BENCHMARK.json against the benchmark's contract: names, units, the
files each entry names, the metrics each cell reports, the bounds and the
chip time a full check takes."""

import json
import os
import re
import types

import pytest

from benchmark.harness import check as CK
from benchmark.harness import manifest as M

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KEYS = {"top": {"command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"},
        "config": {"name", "source", "file", "reduced", "why"},
        "cell": {"name", "config", "traffic", "chips", "why"},
        "e2e": {"name", "unit", "better", "bound", "source"},
        "layer": {"name", "unit", "better", "source", "layer", "moves"}}
# a width may never be cut (hidden, state or projection sizes and the like)
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|"
                   r"_dim$|_rank$|expansion|experts_per)")


@pytest.fixture(scope="module")
def man():
    return M.load()


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes(man):
    assert set(man) == KEYS["top"]
    assert os.path.getsize(os.path.join(M.ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(man["command"]) <= 32
    for w in man["command"]:
        assert line(w) and not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in man["paths"])
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51
    for c in man["configs"]:
        assert set(c) == KEYS["config"]
    for w in man["workloads"]:
        assert set(w) == KEYS["cell"]
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"]
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"]


def test_names_units_and_lines(man):
    groups = (man["configs"], man["workloads"],
              man["end_to_end"] + man["per_layer"])
    for group in groups:
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert line(w["why"])
        assert w["chips"] in (1, 4)
    for c in man["configs"]:
        assert line(c["why"]) and line(c["source"])
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in man["per_layer"]:
        assert line(m["layer"])


def test_configs_and_cells_fit_together(man):
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))
    for c in man["configs"]:
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        conf = M.config(man, c["name"])
        assert conf["reduced"] == c["reduced"] and "assumed" in conf
        assert conf["source"] == c["source"]
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    n4 = sum(w["chips"] == 4 for w in man["workloads"])
    assert n4 <= max(1, len(man["workloads"]) // 4)
    for w in man["workloads"]:
        # each cell compares some of the check's numbers, each with a limit
        lim = M.limits(w["name"])
        assert lim and set(lim) <= set(CK.NUMBERS)
        assert all(v > 0 for v in lim.values())


def test_every_cell_reports_what_it_must(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in man["workloads"]:
        names = {m["name"] for m in M.end_to_end(man, w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert M.per_layer(man, w["name"])
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            # the metric's end-to-end metric is reported in each of its cells
            assert m["moves"] in {x["name"] for x in
                                  M.end_to_end(man, cell)}
        assert callable(M.reader(m["name"]))
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
            assert m["unit"] == "%"


def test_bounds(man):
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"]
            for m in man["end_to_end"]}["setup_s"] == 0.25


def test_full_check_fits_the_time_with_24_cells(man):
    runs = 2 + 14 * 24
    total = runs * (man["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_manifest_is_plain_json():
    with open(os.path.join(M.ROOT, "BENCHMARK.json")) as f:
        assert isinstance(json.load(f), dict)


def test_every_reader_reads_an_untraced_run_as_nothing(man):
    # a run whose traced stretch holds nothing: each reader returns None
    # (and is called as the harness calls it)
    for m in man["per_layer"]:
        for cell in m["workloads"]:
            w = M.cell(man, cell)
            run = types.SimpleNamespace(
                cell=cell, conf=M.config(man, w["config"]),
                mix=M.traffic(w["traffic"]),
                entry=M.traffic(w["traffic"])["entry"], frames=0,
                captures=0, pool_bytes=0, outside_s=[], rays=[], pixels=1,
                prof=None, prof_rays=[])
            assert M.reader(m["name"])(run) is None, m["name"]
