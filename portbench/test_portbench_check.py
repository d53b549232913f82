"""``correct`` on the CPU at small sizes, through the harness's own window
and check: true for the port, false for the control (the reference one
precision lower in the port's place) and for each fault a cell can have,
planted under the timed path (``faults.py``). Across four gloo ranks the
cells run through the launcher as on the card. The control at the cells'
own sizes runs on the card (``chip``)."""

import json
import time

import pytest

from portbench import harness, launch, spec

SEED = 2 ** 33 + 17
BENCH = spec.load_bench()


def small(config: str, n: int, batch: int, ranks: int = 1) -> spec.Cell:
    with open(spec.ROOT / f"portbench/configs/{config}.json") as f:
        conf = json.load(f)
    traffic = {"config": config, "n": n, "batch": batch, "step": ["forward", "inverse"],
               "ranks": ranks, "input": "normal", "fingerprint": 64}
    return spec.Cell(f"small.{config}", 1, config, conf, traffic, [], [])


def checked(cell, system, seconds=0.2):
    t0 = time.time()
    if cell.traffic["ranks"] == 1:
        parts = harness.run_rank(cell, [SEED], seconds, False, "cpu", system=system)
    else:
        parts = [r[0] for r in launch.run_ranks(cell, [SEED], seconds, False, device="cpu",
                                                system=system, deadline_s=300)]
    out, lines = harness.result(cell, parts, t0, False, "cpu")
    assert len(lines) == len(out["checks"]) and list(out)[-1] == "checks"
    return out


ONE = [small("reuse-f32", 1 << 12, 8), small("reuse-f32", 1 << 10, 64),
       small("qsim30-f64", 1 << 16, 1)]
DIST = small("qsim31-f64-4gpu", 1 << 14, 1, ranks=4)


@pytest.mark.parametrize("cell", ONE, ids=lambda c: f"{c.config_name}-{c.traffic['n']}")
def test_port_is_correct(cell):
    out = checked(cell, "port")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("cell", ONE, ids=lambda c: f"{c.config_name}-{c.traffic['n']}")
def test_control_is_not(cell):
    out = checked(cell, "control")
    assert not out["correct"] and out["failed"] == out["attempted"]
    for c in out["checks"].values():
        assert c["value"] > 3 * c["limit"]


@pytest.mark.parametrize("fault", ["identity", "half_batch", "altered"])
def test_fault_is_not(fault):
    out = checked(small("reuse-f32", 1 << 12, 8), "fault:" + fault)
    assert not out["correct"] and out["failed"] > 0


@pytest.mark.parametrize("fault", ["identity", "altered"])
def test_fault_on_one_signal_is_not(fault):
    assert not checked(small("qsim30-f64", 1 << 16, 1), "fault:" + fault)["correct"]


def real(config: str, n: int, batch: int) -> spec.Cell:
    cell = small(config, n, batch)
    return spec.Cell(f"real.{config}", 1, config, dict(cell.config, entry="real"),
                     cell.traffic, [], [])


REAL = [real("reuse-f32", 1 << 12, 4), real("qsim30-f64", 1 << 12, 4),
        real("qsim30-f64", 1 << 16, 1)]


@pytest.mark.parametrize("cell", REAL, ids=lambda c: f"{c.config_name}-{c.traffic['n']}")
@pytest.mark.parametrize("system", ["control", "fault:altered", "fault:conjugate",
                                    "fault:half_batch"])
def test_real_entry_control_and_faults_are_not(cell, system):
    """The real entry: the control (the reference one precision lower, its
    inverse from the whole Hermitian spectrum) and each fault it can have
    (``identity`` has none: an R2C's output is not its input's shape)."""
    if system == "fault:half_batch" and cell.traffic["batch"] == 1:
        with pytest.raises(ValueError):
            checked(cell, system)
        return
    out = checked(cell, system)
    assert not out["correct"] and out["failed"] > 0
    if system == "control":
        assert out["failed"] == out["attempted"]
        for c in out["checks"].values():
            assert c["value"] > 3 * c["limit"]


def test_real_entry_has_no_identity():
    with pytest.raises(ValueError):
        checked(REAL[0], "fault:identity")


@pytest.mark.parametrize("cell", ONE, ids=lambda c: f"{c.config_name}-{c.traffic['n']}")
def test_conjugate_is_not(cell):
    assert not checked(cell, "fault:conjugate")["correct"]


@pytest.mark.parametrize("system,correct", [("port", True), ("control", False),
                                            ("fault:no_exchange", False),
                                            ("fault:identity", False),
                                            ("fault:altered", False)])
def test_four_ranks(system, correct):
    out = checked(DIST, system, seconds=0.5)
    assert out["correct"] is correct and out["device"]["count"] == 4


@pytest.mark.chip
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"] if w["chips"] == 1])
def test_control_at_the_cells_size(card, name):
    """The control at the cell's own size on three seeds: not correct."""
    cell = spec.cell(name, BENCH)
    parts = harness.run_rank(cell, [SEED, SEED + 1, SEED + 2], 1.0, False, card,
                             system="control")
    for part in parts:
        out, _ = harness.result(cell, [part], time.time(), False, "gpu")
        assert not out["correct"]
