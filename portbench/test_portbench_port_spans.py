"""The port's spans in a synthetic profiler timeline (``port_spans.py``),
the five readers of what it finds, and the ``port`` summary that a traced
run keeps."""

import json
import time

import pytest

from portbench import harness, port_spans, spec, trace
from portbench.test_portbench_metrics import TIMELINE, ev

READERS = ("entry_self_ms", "launch_us", "launches_per_step", "port_idle_ms",
           "plans_built_per_step")


def span(name, ts, dur):
    return {**ev("user_annotation", name, ts, dur), "tid": 1}


#: Two steps' worth of calls in a window of 1000 us: a split forward and a
#: leaf inverse with its scale, a plan built inside the window and one
#: before it, and the device busy on [60, 100], [130, 290], [310, 450],
#: [540, 690] and [720, 950].
PORT_TIMELINE = [
    ev("user_annotation", "portbench.window", 0, 1000),
    span("phastft.plan", -50, 40),
    ev("user_annotation", "portbench.forward", 10, 390),
    span("phastft.fft", 20, 370),
    span("phastft.pass.split", 40, 340),
    span("phastft.launch.phastft_col64", 50, 10),
    span("phastft.pass.leaf", 100, 100),
    span("phastft.launch.phastft_leaf64", 110, 20),
    span("phastft.launch.phastft_transpose2_64", 300, 10),
    span("phastft.plan", 395, 3),
    ev("user_annotation", "portbench.inverse", 500, 400),
    span("phastft.fft", 510, 370),
    span("phastft.pass.leaf", 520, 80),
    span("phastft.launch.phastft_leaf64", 530, 10),
    span("phastft.scale", 700, 20),
    ev("kernel", "col64_kernel", 60, 40, stream=7),
    ev("kernel", "leaf64_block", 130, 160, stream=7),
    ev("kernel", "transpose64", 310, 140, stream=7),
    ev("kernel", "leaf64_block", 540, 150, stream=7),
    ev("kernel", "void at::native::vectorized_elementwise_kernel<4>", 720, 230, stream=7),
]


def test_self_times_and_counts():
    s = port_spans.summary(PORT_TIMELINE)
    assert s["calls"] == 2
    assert s["spans"] == {
        "phastft.fft": {"count": 2, "host_us": 740, "self_us": 30 + 270},
        "phastft.pass.split": {"count": 1, "host_us": 340, "self_us": 220},
        "phastft.pass.leaf": {"count": 2, "host_us": 180, "self_us": 80 + 70},
        "phastft.launch.phastft_col64": {"count": 1, "host_us": 10, "self_us": 10},
        "phastft.launch.phastft_leaf64": {"count": 2, "host_us": 30, "self_us": 30},
        "phastft.launch.phastft_transpose2_64": {"count": 1, "host_us": 10, "self_us": 10},
        "phastft.plan": {"count": 1, "host_us": 3, "self_us": 3},
        "phastft.scale": {"count": 1, "host_us": 20, "self_us": 20},
    }


def test_idle_split_by_the_innermost_span():
    """Idle inside the spans: [20, 60], [100, 130], [290, 310], [510, 540],
    [690, 720]; the window's idle outside them ([0, 20], [450, 510], ...)
    is not the port's."""
    s = port_spans.summary(PORT_TIMELINE)
    assert s["idle_us"] == pytest.approx(150)
    assert s["idle_by_span"] == pytest.approx({
        "phastft.pass.split": 40, "phastft.launch.phastft_leaf64": 30,
        "phastft.launch.phastft_transpose2_64": 20, "phastft.pass.leaf": 30,
        "phastft.scale": 30})
    # the harness's own summary names the innermost span of each gap too
    gaps = dict(trace.summary(PORT_TIMELINE)["idle_gaps"])
    assert gaps["phastft.launch.phastft_leaf64 in portbench.forward"] == pytest.approx(30e-6)


def test_readers_on_the_port_timeline():
    cell = spec.cell("qsim30-f64.roundtrip")
    summary = dict(trace.summary(PORT_TIMELINE), port=port_spans.summary(PORT_TIMELINE))
    run = harness.RunView(cell, [{"steps": 2, "trace": summary, "host_s": [], "setup": {}}])
    read = {name: spec.reader(name)(run) for name in READERS}
    assert read == pytest.approx({
        "entry_self_ms": 300 / 2 / 1e3, "launch_us": 50 / 4, "launches_per_step": 2.0,
        "port_idle_ms": 150 / 2 / 1e3, "plans_built_per_step": 0.5})


def test_a_root_inside_a_root_is_one_call():
    """A distributed R2C: ``phastft.dist`` inside ``phastft.dist``; no
    window span, so the whole trace is read."""
    s = port_spans.summary([span("phastft.dist", 0, 100), span("phastft.dist", 10, 80),
                            span("phastft.dist.a2a", 20, 5),
                            {**span("phastft.dist.wait", 30, 50), "tid": 2}])
    assert s["calls"] == 1
    assert s["spans"]["phastft.dist"] == {"count": 2, "host_us": 180, "self_us": 20 + 75}
    assert s["idle_us"] == pytest.approx(100)


def test_spans_nest_on_their_own_thread():
    s = port_spans.summary([span("phastft.fft", 0, 100),
                            {**span("phastft.launch.phastft_leaf", 10, 20), "tid": 2}])
    assert s["spans"]["phastft.fft"]["self_us"] == 100
    assert s["calls"] == 1


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_the_port_spans(name):
    """No trace, a trace of a program without spans (``TIMELINE``),
    or a summary made before the ``port`` key existed: no value."""
    cell = spec.cell("reuse-f32.n24-b128")
    assert port_spans.summary(TIMELINE) == {}
    for summary in (None, trace.summary(TIMELINE),
                    dict(trace.summary(TIMELINE), port=port_spans.summary(TIMELINE))):
        run = harness.RunView(cell, [{"steps": 3, "trace": summary, "host_s": [],
                                      "setup": {}}])
        assert spec.reader(name)(run) is None


@pytest.mark.parametrize("entry", ["planner", "real"])
def test_a_traced_run_carries_the_port(monkeypatch, entry):
    """A traced ``run_rank`` keeps ``port_spans.summary`` beside the trace
    summary, and the five readers read it. On the CPU the wrappers run their
    plain versions and launch nothing, so each is wrapped in the launch span
    that ``ops/_build.call`` opens on the card."""
    from phastft_tpu_torch import tracing
    from phastft_tpu_torch.ops import route

    for name, fn in list(vars(route.KERNELS).items()):
        def launched(*args, _fn=fn, _name=name, **kwargs):
            with tracing.span("phastft.launch.phastft_" + _name):
                return _fn(*args, **kwargs)
        monkeypatch.setattr(route.KERNELS, name, launched)
    with open(spec.ROOT / "portbench/configs/qsim30-f64.json") as f:
        conf = dict(json.load(f), entry=entry)
    traffic = {"config": "qsim30-f64", "n": 1 << 12, "batch": 2,
               "step": ["forward", "inverse"], "ranks": 1, "input": "normal", "fingerprint": 16}
    cell = spec.Cell("traced", 1, "qsim30-f64", conf, traffic, [], [])
    parts = harness.run_rank(cell, [7], 0.1, True, "cpu")
    port = parts[0]["trace"]["port"]
    root = "phastft.real" if entry == "real" else "phastft.fft"
    assert port["calls"] == 2 * parts[0]["steps"] == port["spans"][root]["count"]
    run = harness.RunView(cell, parts)
    read = {name: spec.reader(name)(run) for name in READERS}
    assert all(v is not None for v in read.values()), read
    assert read["launches_per_step"] >= 2 and read["plans_built_per_step"] == 0
    assert read["entry_self_ms"] > 0 and read["launch_us"] > 0 and read["port_idle_ms"] > 0
    out, _ = harness.result(cell, parts, time.time(), True, "cpu")
    assert out["correct"]


def test_the_five_readers_are_listed():
    """``BENCHMARK.json`` lists the five span metrics in every cell."""
    bench = spec.load_bench()
    for name in [w["name"] for w in bench["workloads"]]:
        listed = [m["name"] for m in spec.cell(name, bench).per_layer]
        assert set(READERS) <= set(listed), name
