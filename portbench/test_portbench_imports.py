"""What the benchmark loads: no JAX and no JAX package anywhere, and a
reference that takes nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), imports=imports)],
                         capture_output=True, text=True, timeout=120, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax():
    """The harness, the port and every per-layer metric's reader, loaded
    as a traced run loads them, bring in no JAX."""
    metrics = sorted(p.stem for p in (HERE / "metrics").glob("*.py"))
    assert metrics
    tops = loaded("import portbench.run, portbench.harness, portbench.launch, "
                  "portbench.readings, portbench.faults\nimport phastft_tpu_torch, "
                  "phastft_tpu_torch.parallel\nfrom portbench import spec\n"
                  f"readers = [spec.reader(m) for m in {metrics!r}]")
    assert "phastft_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_a_reader_that_loads_jax_stops_the_result(tmp_path, monkeypatch):
    """A metric's reader that brings in a forbidden module after the window
    leaves the run with no result line: the check runs after the result is
    made."""
    from portbench import run, spec

    def reader(name):
        def read(view):
            sys.modules.setdefault("jax", sys)
            return 1.0
        return read

    part = {"rank": 0, "seed": 1, "steps": 2, "step_s": [0.1, 0.1], "host_s": [0.01] * 4,
            "window_s": 0.2, "window_wall": 0.0, "setup": {}, "marks": [], "peak_bytes": 0,
            "trace": None, "forbidden": [],
            "judge": {k: {"full": [0.0, 1.0], "steps": [[0.0, 0.0], 1.0]}
                      for k in ("fwd_rel_l2", "roundtrip_rel_l2")}}
    monkeypatch.setattr(spec, "reader", reader)
    monkeypatch.setitem(sys.modules, "jax", sys)
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setattr(harness, "run_rank", lambda *a, **k: [part])
    monkeypatch.setattr(run, "power_limits", lambda asked, count: ["none"])
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "test card")
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    args = run.parse(["--workload", "reuse-f32.n12-b524288", "--seed", "1",
                      "--seconds", "1", "--trace", "1"])
    out = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: out.append((a, k.get("file"))))
    assert run.measure(args, None) == 1
    assert not [a for a, f in out if f is None]
    assert any("jax" in str(a) for a, f in out if f is sys.stderr)


def test_reference_takes_nothing_of_the_port():
    tops = loaded("import portbench.reference")
    assert not tops & set(harness.FORBIDDEN) and "phastft_tpu_torch" not in tops
    tree = ast.parse((HERE / "reference.py").read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
    assert all(not n.startswith(("phastft", "jax", "flax")) for n in names), names
    assert all(not n.startswith(".") for n in names)


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("phastft_tpu", "jax", "jaxlib", "flax"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "phastft_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert [m for m in harness.forbidden_modules() if m in ("phastft_tpu", "jax")] == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


@pytest.mark.parametrize("cell", ["reuse-f32.n12-b524288", "qsim31-f64-4gpu.roundtrip"])
def test_no_card_no_result(cell):
    """Without a CUDA card the command exits non-zero and prints nothing on
    standard output (a cell of four chips stops the ranks it started)."""
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", cell,
                          "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
