"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names its configuration, whose entry
in ``configs`` names its file; its traffic is
``portbench/workloads/<cell>.json``; each per-layer metric it reports is
read by ``portbench/metrics/<metric>.py``. Adding a cell, a configuration
or a metric adds files; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

from . import traffic as traffic_mod

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
CONFIG_KEYS = {"source", "deployment", "precision", "entry", "limits", "assumed"}
#: A configuration's ``entry``: the port's planner C2C, ``fft_distributed``
#: over ranks, or the real transforms (R2C forward, C2R inverse) on a planner.
ENTRIES = ("planner", "distributed", "real")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def check_config(config: dict, name: str) -> dict:
    if not CONFIG_KEYS <= set(config):
        raise ValueError(f"configuration {name}: missing {sorted(CONFIG_KEYS - set(config))}")
    if config["precision"] not in ("f32", "f64") or config["entry"] not in ENTRIES:
        raise ValueError(f"configuration {name}: precision f32 / f64, entry one of {ENTRIES}")
    return config


def check_pair(config: dict, traffic: dict, chips: int, name: str) -> None:
    """A cell's configuration and traffic fit together on ``chips`` cards:
    a distributed entry takes a card a rank, the others one card and one
    rank; a real entry's step starts with the forward (its inverse takes a
    Hermitian spectrum, which only the forward makes)."""
    entry, ranks = config["entry"], traffic["ranks"]
    want_chips = ranks if entry == "distributed" else 1
    if chips != want_chips or (entry == "distributed") == (ranks == 1):
        raise ValueError(f"workload {name}: {chips} chips for a {entry} entry on {ranks} ranks")
    if entry == "real" and traffic["step"][0] != "forward":
        raise ValueError(f"workload {name}: a real entry's step starts with the forward, "
                         f"not {traffic['step']}")


def cell(name: str, bench: dict = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = bench or load_bench(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    w = entries[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = check_config(json.load(f), w["config"])
    with open(HERE / "workloads" / f"{name}.json") as f:
        traffic = traffic_mod.check(json.load(f), name)
    if traffic["config"] != w["config"]:
        raise ValueError(f"workload {name}: file says config {traffic['config']}, "
                         f"BENCHMARK.json {w['config']}")
    check_pair(config, traffic, w["chips"], name)
    return Cell(name, w["chips"], w["config"], config, traffic,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def reader(metric: str):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    if not NAME.fullmatch(metric):
        raise ValueError(f"bad metric name {metric!r}")
    path = HERE / "metrics" / f"{metric}.py"
    found = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", metric), path)
    module = importlib.util.module_from_spec(found)
    found.loader.exec_module(module)
    return module.read
