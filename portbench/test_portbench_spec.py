"""BENCHMARK.json against the benchmark's contract, and every cell against
its files."""

import json
import re

import pytest

from portbench import harness, spec

BENCH = spec.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
TEXT = re.compile(r"[^\t\n\r]{1,200}")
FILE = re.compile(r"[A-Za-z0-9_.\-/]+")
RUN_ALLOWANCE_S, COMPILE_S, SPARE_S, CHECK_S, MAX_CELLS = 60, 2 * 90, 1200, 43200, 24


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.cell(name, BENCH)
    assert cell.traffic["config"] == cell.config_name
    per_layer = [m["name"] for m in cell.per_layer]
    assert per_layer and "setup_s" in [m["name"] for m in cell.end_to_end]
    assert len(cell.end_to_end) >= 2
    for m in per_layer:
        assert callable(spec.reader(m))
    part = {"step_s": [0.1, 0.2], "steps": 2, "window_s": 0.3, "peak_bytes": 1,
            "window_wall": 1.0}
    assert set(m["name"] for m in cell.end_to_end) <= set(harness.end_to_end(cell, [part], 0.0))


def test_names_units_and_texts():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert spec.NAME.fullmatch(name), name
    for m in metrics:
        assert spec.UNIT.fullmatch(m["unit"]) and len(m["unit"]) <= 16, m
        assert m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert TEXT.fullmatch(entry["why"]), entry["name"]
    for c in BENCH["configs"]:
        assert TEXT.fullmatch(c["source"]) and c["source"].startswith("https://")
        assert c["reduced"] == []
        assert FILE.fullmatch(c["file"]) and c["file"].startswith("portbench/")


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and TEXT.fullmatch(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", CELLS):
            assert w in CELLS and spec.applies(e2e[m["moves"]], w)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"entry", "planner", "row transforms", "distributed", "kernels",
                           "device"}


def test_chips_and_run_length():
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert four == ["qsim31-f64-4gpu.roundtrip"]
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * MAX_CELLS
    assert runs * (rs + RUN_ALLOWANCE_S) + MAX_CELLS * COMPILE_S + SPARE_S <= CHECK_S


def test_files_under_paths_are_named_from_name_characters():
    for path in spec.HERE.rglob("*"):
        rel = path.relative_to(spec.ROOT).as_posix()
        if "__pycache__" in rel:
            continue
        assert FILE.fullmatch(rel) and len(rel) <= 200, rel


def test_size():
    assert len(json.dumps(BENCH)) < 64 * 1024
