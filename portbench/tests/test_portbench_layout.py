"""The benchmark's files: BENCHMARK.json's shape, every cell's files found by name, every
per-layer metric's reader, and what the harness and the reference may import."""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

from portbench import harness
from portbench.tests.support import ROOT

PKG = os.path.join(ROOT, "portbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    harness.load_module("drivers", c.traffic["driver"])
    for m in c.per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.traffic["limits"]) and c.config["name"] in {x["name"] for x in bench()["configs"]}


def test_every_metric_reports_in_a_cell_that_reports_what_it_moves():
    b = bench()
    for m in b["per_layer"]:
        for cell in m["workloads"]:
            c = harness.load_cell(ROOT, cell)
            assert m["moves"] in {e["name"] for e in c.end_to_end}


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def _sources(sub: str = ""):
    for d, _, files in os.walk(os.path.join(PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = _imports(path)
        assert "palettenerf_torch" not in tops and "portbench" not in tops, path


def test_forbidden_modules_compares_top_level_names_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "palettenerf_tpu_like", types.ModuleType("x"))
    assert "palettenerf_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert "jax" in harness.forbidden_modules()
