"""BENCHMARK.json and the files it names, found by name.

Everything that belongs to one configuration, one traffic mix, one
cell's limits or one per-layer metric sits in a file of its own:

    benchmark/configs/<config>.json    the scene recipe and render sizes
    benchmark/traffic/<traffic>.json   the mix: entry, jitter, sampling
    benchmark/limits/<cell>.json       the check's limits for one cell
    benchmark/metrics/<metric>.py      read(run) -> number or None

so a later change adds a cell, a mix or a metric by adding files and
entries, never by editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _json(path):
    with open(path) as f:
        return json.load(f)


def load(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: str = ROOT) -> dict:
    """The configuration's file, as it is run."""
    for c in manifest["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, root: str = ROOT) -> dict:
    return _json(os.path.join(root, "benchmark", "traffic", f"{name}.json"))


def limits(cell_name: str, root: str = ROOT) -> dict:
    return _json(os.path.join(root, "benchmark", "limits",
                              f"{cell_name}.json"))


def reader(metric: str, root: str = ROOT):
    """The read(run) function of benchmark/metrics/<metric>.py."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _in_cell(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(manifest: dict, cell_name: str) -> list:
    """The end-to-end metrics the cell reports (its --trace 0 line)."""
    return [m for m in manifest["end_to_end"] if _in_cell(m, cell_name)]


def per_layer(manifest: dict, cell_name: str) -> list:
    """The per-layer metrics the cell reports (its --trace 1 line): those
    that list it, and those without a list whose end-to-end metric the
    cell reports."""
    e2e = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
