"""BENCHMARK.json against the contract's shape, and every cell's files
found by the names in it."""

import json
import re

import pytest

from benchmark import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    _, w, config, traffic, limits = harness.load_cell(cell)
    entry = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    for key in entry["reduced"]:
        assert key in config and key in config["reduced"]
    assert (harness.HERE / "loops" / f"{traffic['loop']}.py").exists()
    assert limits
    e2e = harness.cell_metrics(BENCH["end_to_end"], cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = harness.cell_metrics(BENCH["per_layer"], cell)
    assert layer
    moves = {m["name"] for m in e2e}
    for m in layer:
        assert m["moves"] in moves
        assert callable(harness.reader(m["name"]))


def test_metric_workloads_name_cells():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
