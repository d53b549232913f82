"""The yardstick and the readers on a synthetic profiler timeline."""

import pytest

from portbench import harness, peaks, spec, trace


def test_bound_reads_the_same_from_the_shape():
    s, by = peaks.transform_bound_s(1 << 30, 1, "f64")
    assert by == "bytes" and s * 1e3 == pytest.approx(10.256, abs=1e-3)
    s32, _ = peaks.transform_bound_s(1 << 24, 32, "f32")
    assert s32 == pytest.approx(16 * (1 << 29) / 3.35e12)
    assert peaks.transform_bound_s(1 << 12, 1 << 17, "f32")[0] == pytest.approx(s32)
    assert peaks.transform_bound_s(1 << 31, 1, "f64", 4)[0] == pytest.approx(s / 2)
    for name in ("qsim30-f64.roundtrip", "reuse-f32.n24-b128", "reuse-f32.n12-b524288",
                 "qsim31-f64-4gpu.roundtrip"):
        cell = spec.cell(name)
        one, by = peaks.transform_bound_s(cell.traffic["n"], cell.traffic["batch"],
                                          cell.config["precision"], cell.traffic["ranks"])
        assert by == "bytes"
        assert peaks.step_bound_s(cell.traffic, cell.config["precision"]) == 2 * one


def test_real_bound_from_the_shape():
    """A real transform reads its n reals and writes its n/2 + 1 bins (or
    the reverse) against 2.5 n log2 n flops: bytes at f64 2^31 and f32
    2^26."""
    s, by = peaks.real_bound_s(1 << 31, 1, "f64")
    assert by == "bytes" and s == (8 * 2 ** 31 + 16 * (2 ** 30 + 1)) / 3.35e12
    assert s * 1e3 == pytest.approx(10.2566, abs=1e-4)
    assert 2.5 * 2 ** 31 * 31 / 34e12 < s
    s32, by = peaks.real_bound_s(1 << 26, 1, "f32")
    assert by == "bytes" and s32 == (4 * 2 ** 26 + 8 * (2 ** 25 + 1)) / 3.35e12
    assert s32 * 1e3 == pytest.approx(0.16026, abs=1e-5)
    assert peaks.real_bound_s(1 << 12, 3, "f32")[0] == pytest.approx(
        3 * peaks.real_bound_s(1 << 12, 1, "f32")[0])
    traffic = {"n": 1 << 31, "batch": 1, "step": ["forward", "inverse"], "ranks": 1}
    assert peaks.step_bound_s(traffic, "f64", "real") == 2 * s
    assert peaks.step_bound_s(traffic, "f64") == 2 * peaks.transform_bound_s(1 << 31, 1,
                                                                           "f64")[0]


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


TIMELINE = [
    ev("user_annotation", "portbench.window", 0, 1000),
    ev("user_annotation", "portbench.forward", 10, 90),
    ev("cpu_op", "aten::empty", 20, 5),
    ev("cuda_runtime", "cudaLaunchKernel", 30, 5, correlation=1),
    ev("user_annotation", "portbench.inverse", 100, 350),
    ev("cpu_op", "aten::mul_", 120, 20),
    ev("cuda_runtime", "cudaLaunchKernel", 125, 5, correlation=2),
    ev("user_annotation", "portbench.fingerprint", 460, 20),
    ev("cuda_runtime", "cudaLaunchKernel", 465, 5, correlation=3),
    ev("cpu_op", "cudaDeviceSynchronize", 700, 200),
    ev("kernel", "leaf64_block<4>(double const*)", 100, 200, stream=7, correlation=1),
    ev("kernel", "void at::native::vectorized_elementwise_kernel<4>", 250, 150, stream=7,
       correlation=2),
    ev("kernel", "void at::native::index_elementwise_kernel", 480, 20, stream=7,
       correlation=3),
    ev("kernel", "ncclDevKernel_SendRecv", 600, 100, stream=20, correlation=4),
    ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 700, 50, stream=20, correlation=5),
    ev("gpu_memset", "Memset (Device)", 950, 100, stream=7, correlation=6),
    ev("gpu_user_annotation", "portbench.forward", 0, 1000, stream=7),
]


def test_summary_of_a_timeline():
    s = trace.summary(TIMELINE)
    assert s["window_us"] == 1000
    # union: [100, 400] + [480, 500] + [600, 750] + [950, 1000]
    assert s["busy_us"] == 300 + 20 + 150 + 50
    assert s["class_us"] == {"port": 200, "torch": 150 + 50, "harness": 20, "nccl": 150}
    assert s["device_ops"][0] == ["leaf64_block<4>(double const*)", 200e-6]
    gaps = dict(s["idle_gaps"])
    assert gaps == pytest.approx({"portbench.forward": 100e-6, "portbench.inverse": 80e-6,
                                  "portbench.window": 100e-6,
                                  "cudaDeviceSynchronize in portbench.window": 200e-6})


def test_readers_on_a_timeline():
    cell = spec.cell("qsim31-f64-4gpu.roundtrip")
    part = {"steps": 2, "trace": trace.summary(TIMELINE), "host_s": [0.001, 0.003],
            "setup": {"plan_build_s": 0.5}}
    run = harness.RunView(cell, [part])
    read = {m["name"]: spec.reader(m["name"])(run) for m in cell.per_layer}
    assert read["idle_pct"] == pytest.approx(48.0)
    assert read["kernel_ms"] == pytest.approx(0.1)
    assert read["torch_ops_ms"] == pytest.approx(0.1)
    assert read["nccl_ms"] == pytest.approx(0.075)
    assert read["host_call_ms"] == pytest.approx(2.0)
    assert read["plan_build_s"] == 0.5
    assert read["step_roofline"] == pytest.approx(100 * run.bound_s / (520e-6 / 2))


def test_readers_find_nothing_without_a_trace():
    cell = spec.cell("reuse-f32.n24-b128")
    run = harness.RunView(cell, [{"steps": 3, "trace": None, "host_s": [], "setup": {}}])
    for m in cell.per_layer:
        assert spec.reader(m["name"])(run) is None, m["name"]
    assert spec.reader("nccl_ms")(run) is None
