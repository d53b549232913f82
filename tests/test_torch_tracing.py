"""The port's spans and its launch counter (``phastft_tpu_torch/tracing.py``).

Under ``torch.profiler.profile(activities=[CPU])`` each entry records its
span tree on the CPU's plain passes: the root span of the entry, the
levels of the plan, the scale where it is a pass of its own (the df64
engine, the staged oracle; the fast and native inverses fold it into their
last kernel), a conversion, the planner on a cache miss,
and across two gloo ranks the distributed column stage. ``_build.call`` on
a fake library counts every launch once under its kernel's name, no
query, and opens a ``phastft.launch.*`` span only while a profiler records.
"""

import datetime
import json
import os
import pickle
import tempfile
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import phastft_tpu_torch as pt
from phastft_tpu_torch import tracing
from phastft_tpu_torch.ops import _build


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def span_tree(prof) -> list:
    """The ``phastft.*`` spans of a profile as nested (name, [children])
    lists in time order, read from its chrome trace as the benchmark reads
    it (the profiler's own event tree merges a span into a lone child of
    the same name)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("phastft."))
    top = []
    stack = [(float("inf"), top)]
    for a, b, name in spans:
        while stack[-1][0] < b - 0.01:
            stack.pop()
        node = (name, [])
        stack[-1][1].append(node)
        stack.append((b, node[1]))
    return top


def names(tree) -> list:
    """Every span name of ``tree``, depth first."""
    out = []
    for name, kids in tree:
        out.append(name)
        out.extend(names(kids))
    return out


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return span_tree(prof)


def _planes(n, dtype=torch.float32, rows=None):
    g = torch.Generator().manual_seed(n)
    shape = (n,) if rows is None else (rows, n)
    return (torch.randn(shape, generator=g, dtype=dtype),
            torch.randn(shape, generator=g, dtype=dtype))


LEAF = ("phastft.pass.leaf", [])

#: case -> (planner, call on it, the span tree of the call once warm)
CASES = {
    "f32_leaf": (
        lambda: pt.PlannerDit32(1 << 10, device="cpu"),
        lambda p: pt.fft_32_dit_with_planner(*_planes(1 << 10), "f", p),
        [("phastft.fft", [LEAF])]),
    "f32_classic_split": (
        lambda: pt.PlannerDit32(1 << 17, options=pt.Options(leaf_fft_size=1 << 9),
                                device="cpu"),
        lambda p: pt.fft_32_dit_with_planner(*_planes(1 << 17), "f", p),
        [("phastft.fft", [("phastft.pass.split", [LEAF])])]),
    "f32_fused_split": (
        lambda: pt.PlannerDit32(1 << 17, options=pt.Options(leaf_fft_size=1 << 10),
                                device="cpu"),
        lambda p: pt.fft_32_dit_with_planner(*_planes(1 << 17), "f", p),
        [("phastft.fft", [("phastft.pass.fused", [])])]),
    "f32_leaf_columns": (
        lambda: pt.PlannerDit32(1 << 18, options=pt.Options(leaf_fft_size=1 << 18),
                                device="cpu"),
        lambda p: pt.fft_32_dit_with_planner(*_planes(1 << 18), "f", p),
        [("phastft.fft", [("phastft.pass.leaf", [("phastft.pass.columns", [])])])]),
    "f32_inverse": (
        lambda: pt.PlannerDit32(1 << 10, device="cpu"),
        lambda p: pt.fft_32_dit_with_planner(*_planes(1 << 10), "r", p),
        [("phastft.fft", [LEAF])]),
    "f32_numpy_input": (
        lambda: pt.PlannerDit32(1 << 10, device="cpu"),
        lambda p: pt.fft_32_dit_with_planner(*(x.numpy() for x in _planes(1 << 10)),
                                             "f", p),
        [("phastft.fft", [("phastft.convert", []), ("phastft.convert", []), LEAF])]),
    "f64_native_split": (
        lambda: pt.PlannerDit64(1 << 17, device="cpu"),
        lambda p: pt.fft_64_dit_with_planner(*_planes(1 << 17, torch.float64), "f", p),
        [("phastft.fft", [("phastft.pass.split", [LEAF])])]),
    "f64_native_inverse": (
        lambda: pt.PlannerDit64(1 << 12, device="cpu"),
        lambda p: pt.fft_64_dit_with_planner(*_planes(1 << 12, torch.float64), "r", p),
        [("phastft.fft", [LEAF])]),
    "df64_leaf": (
        lambda: pt.PlannerDit64(1 << 10, options=pt.Options(f64_engine="df64"),
                                device="cpu"),
        lambda p: pt.fft_64_dit_with_planner(*_planes(1 << 10, torch.float64), "f", p),
        [("phastft.fft", [LEAF])]),
    "df64_inverse": (
        lambda: pt.PlannerDit64(1 << 10, options=pt.Options(f64_engine="df64"),
                                device="cpu"),
        lambda p: pt.fft_64_dit_with_planner(*_planes(1 << 10, torch.float64), "r", p),
        [("phastft.fft", [LEAF, ("phastft.scale", [])])]),
    "r2c": (
        lambda: pt.PlannerR2c32(1 << 11, device="cpu"),
        lambda p: pt.r2c_fft_f32_with_planner(_planes(1 << 11)[0], p),
        [("phastft.real", [LEAF])]),
    "c2r": (
        lambda: pt.PlannerR2c32(1 << 11, device="cpu"),
        lambda p: pt.c2r_fft_f32_with_planner(*_planes((1 << 10) + 1), p),
        [("phastft.real", [LEAF])]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_warm_call_records_its_span_tree(case):
    make, call, want = CASES[case]
    planner = make()
    call(planner)
    assert traced(lambda: call(planner)) == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plan_shows_only_while_it_is_built(case):
    """The planner built under the profiler records ``phastft.plan``; the
    second call on it records none."""
    make, call, want = CASES[case]
    holder = []
    first = traced(lambda: holder.append(make()))
    assert "phastft.plan" in names(first)
    call(holder[0])
    second = traced(lambda: call(holder[0]))
    assert "phastft.plan" not in names(second)
    assert second == want


def test_the_auto_planned_entry_builds_its_planner_once():
    n = 1 << 9
    pt.fft.__dict__["_cached_planner"].cache_clear()
    x = _planes(n)
    first = traced(lambda: pt.fft_32_dit(*x, "f", device="cpu"))
    assert first[0] == ("phastft.plan", [("phastft.plan", [])])
    assert first[1][0] == "phastft.fft"
    assert traced(lambda: pt.fft_32_dit(*x, "f", device="cpu")) == [("phastft.fft", [LEAF])]


def test_staged_oracle_spans():
    p = pt.PlannerDit32(1 << 8, device="cpu")
    opts = pt.Options(strategy="staged")
    x = _planes(1 << 8)
    pt.fft_32_dit_with_planner_and_opts(*x, "r", p, opts)
    tree = traced(lambda: pt.fft_32_dit_with_planner_and_opts(*x, "r", p, opts))
    assert tree == [("phastft.fft", [("phastft.scale", [])])]


def test_no_profiler_no_span():
    """With no profiler recording, ``span`` hands out one shared null
    context; under one, a profiler span."""
    off = tracing.span("phastft.fft")
    assert off is tracing.span("phastft.launch.phastft_leaf")
    with off as entered:
        assert entered is None
    with profile(activities=[ProfilerActivity.CPU]):
        on = tracing.span("phastft.fft")
        assert on is not off
        assert isinstance(on, torch.profiler.record_function)


class _FakeLibrary:
    """Every C entry as a function that returns ``err`` and records its
    name."""

    def __init__(self, err=0):
        self.err, self.called = err, []

    def __getattr__(self, name):
        def entry(*args):
            self.called.append(name)
            return self.err
        return entry


def _args(name):
    return (0,) * len(_build._SIGNATURES[name])


QUERIES = ("_clusters", "_blocks", "_exact")


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_call_counts_launches_and_spans_only_under_a_profiler(monkeypatch, name):
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    launch = not name.endswith(QUERIES)
    assert (name in _build._LAUNCH_SPANS) == launch
    kernel = name.removeprefix("phastft_") + "_wrapper"
    before = tracing.launch_count()
    assert _build.call(name, _args(name), kernel=kernel) == 0
    assert tracing.launch_count(kernel) == launch
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _build.call(name, _args(name), kernel=kernel)
    assert lib.called == [name, name]
    assert tracing.launch_count(kernel) == 2 * launch
    assert tracing.launch_count() == before + 2 * launch
    tracing.launches.pop(kernel, None)
    spans = [e.name for e in prof.events() if e.name.startswith("phastft.")]
    assert spans == (["phastft.launch." + name] if launch else [])


@pytest.mark.parametrize("name", sorted(_build._LAUNCH_SPANS))
def test_a_launch_names_its_kernel(monkeypatch, name):
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    before = tracing.launch_count()
    with pytest.raises(ValueError, match="names its kernel"):
        _build.call(name, _args(name))
    assert lib.called == [] and tracing.launch_count() == before


def test_a_failed_launch_is_not_counted(monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: _FakeLibrary(err=719))
    before = tracing.launch_count()
    assert _build.call("phastft_leaf", _args("phastft_leaf"), kernel="leaf") == 719
    assert tracing.launch_count() == before


def test_launch_count_sums_entries(monkeypatch):
    monkeypatch.setattr(tracing, "launches", tracing.launches.__class__(
        {"leaf": 3, "colfft_out3d": 2, "colfft": 1}))
    assert tracing.launch_count("leaf") == 3
    assert tracing.launch_count("colfft_out3d") == 2
    assert tracing.launch_count("leaf", "colfft_out3d", "leaft") == 5
    assert tracing.launch_count() == 6


def test_the_launch_table_is_frozen():
    assert _build._LAUNCH_SPANS["phastft_colfft"] == "phastft.launch.phastft_colfft"
    with pytest.raises(TypeError):
        _build._LAUNCH_SPANS["phastft_leaf_clusters"] = "x"


def test_no_span_outside_tracing():
    """Every span of the package goes through ``tracing.span``: no module
    but ``tracing.py`` names ``record_function``."""
    root = os.path.dirname(pt.__file__)
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            if f.endswith(".py") and path != tracing.__file__:
                with open(path) as fh:
                    assert "record_function" not in fh.read(), path


# -- fft_distributed on two gloo ranks ---------------------------------------

DIST_N = 1 << 12
INIT_S, DEADLINE_S = 60, 120


def _rank_main(rank, d, store, out_dir):
    import torch.distributed as dist

    from phastft_tpu_torch.parallel import fft_distributed

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=d, timeout=datetime.timedelta(seconds=INIT_S))
    try:
        p = pt.PlannerDit32(DIST_N, options=pt.Options(leaf_fft_size=1 << 8), device="cpu")
        m = DIST_N // d
        x = tuple(t[rank * m:(rank + 1) * m] for t in _planes(DIST_N))
        out = {}
        for chunks in (1, 2):
            os.environ["PHASTFT_TPU_DIST_CHUNKS"] = str(chunks)
            fft_distributed(*x, "f", p)
            for direction in ("f", "r"):
                out[chunks, direction] = traced(lambda: fft_distributed(*x, direction, p))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def dist_trees(tmp_path_factory):
    """{(chunks, direction): span tree} of each of two gloo ranks."""
    import torch.multiprocessing as mp

    d = 2
    tmp = tmp_path_factory.mktemp("gloo_tracing")
    ctx = mp.start_processes(_rank_main, args=(d, str(tmp / "store"), str(tmp)),
                             nprocs=d, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"{d} gloo ranks did not finish in {DEADLINE_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    trees = []
    for r in range(d):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            trees.append(pickle.load(f))
    return trees


SEND_A2A = [("phastft.dist.send", []), ("phastft.dist.a2a", [])]
LANDS = [("phastft.dist.land", []), ("phastft.dist.land", [])]
#: the rows of 2^12 = 16 x 256 points on a leaf of 2^8: one leaf plan
ROWS = LEAF


@pytest.mark.parametrize("rank", (0, 1))
@pytest.mark.parametrize("direction", ("f", "r"))
def test_distributed_one_chunk_spans(dist_trees, rank, direction):
    """One chunk: the column stage's send copies and collectives, the
    column pass, the landing of both planes, the rows, the last
    collectives; nothing waits, and the inverse's scale is folded into the
    last transpose, with no span of its own."""
    want = (SEND_A2A * 2 + [("phastft.dist.column", [])]
            + [("phastft.dist.a2a", [])] * 2 + LANDS + [ROWS] + SEND_A2A * 2)
    assert dist_trees[rank][1, direction] == [("phastft.dist", want)]


@pytest.mark.parametrize("rank", (0, 1))
def test_distributed_two_chunk_spans(dist_trees, rank):
    """Two chunks: each chunk's sends and collectives in flight, a wait
    before each plane lands or enters a column pass."""
    (root, kids), = dist_trees[rank][2, "f"]
    assert root == "phastft.dist"
    got = [name for name, _ in kids]
    count = {s: got.count(s) for s in set(got)}
    assert count == {"phastft.dist.send": 4 + 2, "phastft.dist.a2a": 4 + 4 + 2,
                     "phastft.dist.column": 2, "phastft.dist.wait": 8,
                     "phastft.dist.land": 4, "phastft.pass.leaf": 1}
    assert got.index("phastft.dist.wait") < got.index("phastft.dist.column")
    assert all(k == [] for _, k in kids)
