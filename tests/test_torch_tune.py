"""The port's PlannerMode.Tune on the CPU (phastft_tpu_torch/tune.py),
against the JAX package's tune.py and planners.

The candidates are the JAX package's leaf sizes on the port's engines plus
the heuristic's options; the wisdom file is the port's own
(tune-torch-<device>.json) beside the JAX package's tune-<device_kind>.json;
a candidate that runs out of device memory is skipped and any other failure
propagates. Tune planners are held to the JAX planner on the tuned options
and to the JAX transform: f32 within the repo's f32 bound, f64 within
1e-12.
"""

import json
import os

import numpy as np
import pytest
import torch

import phastft_tpu
import phastft_tpu_torch as pt
from phastft_tpu import tune as jax_tune
from phastft_tpu_torch import tune
from phastft_tpu_torch.ops.fourstep import plan_rows


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """A fresh wisdom directory and empty in-process caches (both packages')."""
    monkeypatch.setenv("PHASTFT_TPU_TUNE_CACHE", str(tmp_path))
    tune.clear_tune_cache()
    jax_tune.clear_tune_cache()
    yield tmp_path
    tune.clear_tune_cache()
    jax_tune.clear_tune_cache()


@pytest.fixture
def no_disk(monkeypatch):
    monkeypatch.setenv("PHASTFT_TPU_TUNE_CACHE", "0")
    tune.clear_tune_cache()
    yield
    tune.clear_tune_cache()


def _bound(n):
    # the f32 bound of tests/test_torch_fft.py (tests/test_pallas_leaft.py)
    return 5e-7 * max(1.0, (n.bit_length() - 1) / 18.0)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _c(pair):
    return np.asarray(pair[0], np.float64) + 1j * np.asarray(pair[1], np.float64)


def _engine(f64_engine):
    """The f64 engine as both packages resolve it."""
    engine = f64_engine or "native"
    if not engine.startswith("df64"):
        return "native"
    return engine if engine in ("df64-split", "df64-oz") else "df64"


LOGS = range(3, 31)
DTYPES = [np.float32, np.float64]


def test_leaf_candidates_are_the_jax_packages():
    assert tune._LEAF_CANDIDATES == jax_tune._LEAF_CANDIDATES


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_r2c_candidates_are_the_jax_packages_plus_the_heuristic(dtype):
    """(leaf_fft_size, f64_engine) in the JAX package's order, then
    guess_options(n/2) unless it plans what a JAX candidate plans."""
    for log_n in LOGS:
        n, half = 1 << log_n, 1 << (log_n - 1)
        jax = [(o.leaf_fft_size, o.f64_engine)
               for o in jax_tune._r2c_candidates(n, np.dtype(dtype))]
        guess = pt.Options.guess_options(half, dtype)
        seen = {(plan_rows(half, leaf), _engine(e)) for leaf, e in jax}
        extra = [] if (plan_rows(half, guess.leaf_fft_size), "native") in seen else [
            (guess.leaf_fft_size, guess.f64_engine)]
        got = [(o.leaf_fft_size, o.f64_engine) for o in tune._r2c_candidates(n, dtype)]
        assert got == jax + extra, log_n


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_c2c_candidates_hold_the_jax_leaf_sizes(dtype):
    """The JAX package's leaf sizes, the heuristic's options, the port's
    engines only, and no two candidates running the same plan on the same
    kernels."""
    for log_n in LOGS:
        n = 1 << log_n
        got = tune._candidates(n, dtype)
        jax_leaves = {o.leaf_fft_size for o in jax_tune._candidates(n, np.dtype(dtype))}
        assert jax_leaves <= {o.leaf_fft_size for o in got}, log_n
        guess = pt.Options.guess_options(n, dtype)
        keys = [(plan_rows(n, o.leaf_fft_size), _engine(o.f64_engine), o.leaf_kernel)
                for o in got]
        assert len(set(keys)) == len(keys), log_n
        assert (plan_rows(n, guess.leaf_fft_size), "native", None) in keys
        if dtype == np.float32:
            assert all(o.f64_engine is None and o.leaf_kernel in (None, "hybrid")
                       for o in got)
        else:
            engines = {o.f64_engine for o in got}
            assert {"native", "df64"} <= engines
            assert ("df64-split" in engines) == (n >= 1 << 16)
            assert ("df64-oz" in engines) == ((1 << 20) <= n <= (1 << 24))


def _stub_measure(monkeypatch, seconds):
    """tune._measure replaced: ``seconds(opts)``, each call recorded."""
    calls = []

    def measure(n, dtype, opts, device):
        calls.append(opts)
        return seconds(opts)

    monkeypatch.setattr(tune, "_measure", measure)
    return calls


def test_tune_writes_and_reuses_disk_cache(cache_dir, monkeypatch):
    """tests/test_tune.py's round trip: a poisoned disk entry is what a fresh
    in-process cache returns, without measuring again."""
    opts1 = tune.tune_options(1 << 9, np.float32, "cpu")
    path = cache_dir / "tune-torch-cpu.json"
    assert sorted(os.listdir(cache_dir)) == ["tune-torch-cpu.json"]
    table = json.loads(path.read_text())
    entry = table["512:float32"]
    assert entry["leaf_fft_size"] == opts1.leaf_fft_size
    assert entry["seconds"] > 0 and set(entry) == {"leaf_fft_size", "f64_engine",
                                                    "leaf_kernel", "seconds"}
    table["512:float32"] = dict(entry, leaf_fft_size=128, leaf_kernel="hybrid")
    path.write_text(json.dumps(table))
    tune.clear_tune_cache()
    calls = _stub_measure(monkeypatch, lambda o: 1.0)
    opts2 = tune.tune_options(1 << 9, np.float32, "cpu")
    assert calls == []
    assert (opts2.leaf_fft_size, opts2.leaf_kernel) == (128, "hybrid")
    assert opts2.tiled_bit_reversal is False


def test_wisdom_files_of_both_packages_coexist(cache_dir, monkeypatch):
    """One PHASTFT_TPU_TUNE_CACHE directory: the JAX package's
    tune-cpu.json is never read or written by the port, and the JAX
    package does not read the port's."""
    jax_path = jax_tune._disk_path("cpu")
    jax_tune._store_disk(jax_path, {"512:float32": {
        "leaf_fft_size": 256, "leaf_engine": "vpu", "f64_engine": None,
        "leaf_kernel": None, "col_engine": None, "seconds": 1.0}})
    jax_bytes = open(jax_path, "rb").read()
    _stub_measure(monkeypatch, lambda o: 1.0 / o.leaf_fft_size)
    got = tune.tune_options(1 << 9, np.float32, "cpu")
    assert got.leaf_fft_size == 512  # measured, not the JAX entry's 256
    assert open(jax_path, "rb").read() == jax_bytes
    assert sorted(os.listdir(cache_dir)) == ["tune-cpu.json", "tune-torch-cpu.json"]
    ours = json.loads((cache_dir / "tune-torch-cpu.json").read_text())
    assert ours["512:float32"]["leaf_fft_size"] == 512
    # the JAX package reads its own entry back, not the port's
    assert jax_tune.tune_options(1 << 9, np.float32).leaf_fft_size == 256
    # and the port's r2c key lands in its own file too
    tune.tune_r2c_options(1 << 10, np.float32, "cpu")
    assert "r2c:1024:float32" in json.loads((cache_dir / "tune-torch-cpu.json").read_text())
    assert open(jax_path, "rb").read() == jax_bytes


def test_tune_memoizes_in_process(no_disk, monkeypatch):
    calls = _stub_measure(monkeypatch, lambda o: float(o.leaf_fft_size))
    o1 = tune.tune_options(1 << 11, np.float64, "cpu")
    measured = len(calls)
    o2 = tune.tune_options(1 << 11, np.float64, "cpu")
    assert o1 is o2 and len(calls) == measured == len(tune._candidates(1 << 11, np.float64))
    assert o1.leaf_fft_size == 1 << 10


def test_explicit_options_win_over_tune(no_disk, monkeypatch):
    calls = _stub_measure(monkeypatch, lambda o: 1.0)
    opts = pt.Options(leaf_fft_size=128)
    for cls in (pt.PlannerDit32, pt.PlannerDit64):
        planner = cls(1 << 10, pt.PlannerMode.Tune, options=opts, device="cpu")
        assert planner.options is opts and planner.mode is pt.PlannerMode.Tune
    r2c = pt.PlannerR2c32(1 << 10, pt.PlannerMode.Tune, inner_options=opts, device="cpu")
    assert r2c.inner_opts is opts
    assert calls == []


def test_out_of_memory_is_skipped_and_other_failures_propagate(no_disk, monkeypatch):
    n = 1 << 12
    cands = tune._candidates(n, np.float32)

    def oom_first(opts):
        if opts == cands[0]:
            raise torch.OutOfMemoryError("candidate too large")
        return 1.0

    calls = _stub_measure(monkeypatch, oom_first)
    got = tune.tune_options(n, np.float32, "cpu")
    assert got == cands[1] and calls == cands
    tune.clear_tune_cache()

    def all_oom(opts):
        raise torch.OutOfMemoryError("candidate too large")

    _stub_measure(monkeypatch, all_oom)
    assert tune.tune_options(n, np.float32, "cpu") == pt.Options.guess_options(n, np.float32)
    tune.clear_tune_cache()

    def broken(opts):
        raise RuntimeError("a kernel failed")

    _stub_measure(monkeypatch, broken)
    with pytest.raises(RuntimeError, match="a kernel failed"):
        tune.tune_options(n, np.float32, "cpu")
    with pytest.raises(RuntimeError, match="a kernel failed"):
        pt.PlannerDit32(n, pt.PlannerMode.Tune, device="cpu")


def _jax_opts(opts):
    return phastft_tpu.Options(leaf_fft_size=opts.leaf_fft_size)


@pytest.mark.parametrize("log_n", [7, 12])
@pytest.mark.parametrize("bits", [32, 64])
def test_tune_planner_matches_jax(no_disk, log_n, bits):
    """A Tune planner (real measurements) plans as a JAX planner on the
    tuned leaf, agrees with the JAX transform and round-trips."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n + bits)
    dt = np.float32 if bits == 32 else np.float64
    re, im = rng.standard_normal((2, 3, n)).astype(dt)
    cls = pt.PlannerDit32 if bits == 32 else pt.PlannerDit64
    planner = cls.with_mode(n, pt.PlannerMode.Tune, device="cpu")
    assert planner.options in tune._candidates(n, dt)
    jax_cls = phastft_tpu.PlannerDit32 if bits == 32 else phastft_tpu.PlannerDit64
    jax_planner = jax_cls(n, options=_jax_opts(planner.options))
    assert planner.plan == jax_planner.plan
    fwd = pt.fft_32_dit_with_planner if bits == 32 else pt.fft_64_dit_with_planner
    jax_fwd = (phastft_tpu.fft_32_dit_with_planner if bits == 32
               else phastft_tpu.fft_64_dit_with_planner)
    got = fwd(re, im, pt.Direction.Forward, planner)
    want = jax_fwd(re, im, phastft_tpu.Direction.Forward, jax_planner)
    tol = _bound(n) if bits == 32 else 1e-12
    assert _rel(_c(got), _c(want)) <= 2 * tol
    assert _rel(_c(got), np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1)) <= tol
    back = fwd(got[0], got[1], pt.Direction.Reverse, planner)
    assert _rel(_c(back), _c((re, im))) <= tol


@pytest.mark.parametrize("log_n", [4, 12])
@pytest.mark.parametrize("bits", [32, 64])
def test_tune_r2c_planner_matches_jax(no_disk, log_n, bits):
    n = 1 << log_n
    dt = np.float32 if bits == 32 else np.float64
    x = np.random.default_rng(log_n).standard_normal((2, n)).astype(dt)
    cls = pt.PlannerR2c32 if bits == 32 else pt.PlannerR2c64
    planner = cls(n, pt.PlannerMode.Tune, device="cpu")
    assert planner.mode is pt.PlannerMode.Tune
    assert planner.inner_opts in tune._r2c_candidates(n, dt)
    assert planner.dit_planner.mode is pt.PlannerMode.Heuristic
    jax_cls = phastft_tpu.PlannerR2c32 if bits == 32 else phastft_tpu.PlannerR2c64
    jax_planner = jax_cls(n, inner_options=_jax_opts(planner.inner_opts))
    assert planner.dit_planner.plan == jax_planner.dit_planner.plan
    r2c = pt.r2c_fft_f32_with_planner if bits == 32 else pt.r2c_fft_f64_with_planner
    c2r = pt.c2r_fft_f32_with_planner if bits == 32 else pt.c2r_fft_f64_with_planner
    jax_r2c = (phastft_tpu.r2c_fft_f32_with_planner if bits == 32
               else phastft_tpu.r2c_fft_f64_with_planner)
    got = r2c(x, planner)
    want = jax_r2c(x, jax_planner)
    tol = _bound(n) if bits == 32 else 1e-12
    assert _rel(_c(got), _c(want)) <= 2 * tol
    assert _rel(_c(got), np.fft.rfft(x.astype(np.float64), axis=-1)) <= tol
    back = c2r(got[0], got[1], planner).numpy()
    assert np.linalg.norm(back - x) <= tol * np.linalg.norm(x)
