"""BENCHMARK.json against the benchmark's contract, and each of its names
against the files the harness finds by them."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", [*BENCH["configs"], *BENCH["workloads"],
                                   *METRICS], ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for key in ("why", "layer"):
        if key in entry:
            assert LINE.match(entry[key])
    if "file" in entry:                 # a configuration's source
        assert LINE.match(entry["source"])
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_are_unique_and_configs_used():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_end_to_end_sources():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_what_its_metrics_move(cell):
    name = cell["name"]
    assert cell["chips"] == 1
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if name in m.get("workloads", [name])}
    layer = [m for m in BENCH["per_layer"]
             if name in m.get("workloads", [name])]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell_name in m.get("workloads", []):
            assert cell_name in moved.get("workloads", [cell_name])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(cell):
    from port_bench import harness
    spec = harness.resolve(ROOT, cell["name"])
    assert spec["config"]["name"] == cell["config"]
    assert set(spec["readers"]) == {m["name"] for m in spec["per_layer"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
