"""The port's distributed real transforms (``parallel/real_dist.py``) on
gloo, against the JAX package's ``r2c_fft_distributed`` /
``c2r_fft_distributed`` on a CPU mesh of the same size and against numpy's
``rfft`` / ``irfft``.

As in tests/test_torch_dist64.py, one module-scope fixture per world size
(2 and 4) spawns its gloo ranks once; every rank runs every case on its
shard of the same seeded numpy inputs (the forward on its n/d reals, the
inverse on its bins of numpy's rfft in the port's layout: L = n/(2d) bins a
rank, the last rank L + 1) and writes its results to a file, and the tests
gather them in rank order, which is the global order. The ranks import no
JAX.

Tolerances: f64 (native and df64) rel L2 <= 1e-12 against the JAX package
and numpy; f32 <= 2e-6 against the JAX package and <= 1e-5 against numpy's
f64 transforms.

The chunked column stage of the half-length ``fft_distributed``: the
CHUNKED cases run with PHASTFT_TPU_DIST_CHUNKS set on every rank and in the
JAX reference (its built pipelines dropped before and after), each also at
one chunk on the ranks; the chunked results match the JAX package's at the
same count, numpy's, and the port's one-chunk results within ONE_CHUNK_TOL
(each chunk's shard twiddle factored on its own columns).
"""

import contextlib
import datetime
import functools
import os
import pickle
import time

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL_F64 = 1e-12
TOL_JAX_F32 = 2e-6
TOL_NUMPY_F32 = 1e-5
#: Seconds for the ranks' init (each) and for all of them to finish.
INIT_S = 60
DEADLINE_S = 150
WORLDS = (2, 4)

#: case -> (log2 n, dtype, inner options)
CASES = {
    "f64_2^12": (12, "f64", {}),
    "f32_2^12": (12, "f32", {}),
    "df64_2^12": (12, "f64", {"f64_engine": "df64"}),
    "f64_leaf128_2^14": (14, "f64", {"leaf_fft_size": 128}),
}
#: case -> (log2 n, dtype, inner options, chunks): the half-length transform
#: (2^13) on a 256-point leaf, n1 = 32, blocks of 128 / 64 columns.
CHUNKED = {
    "chunks4_f32_2^14": (14, "f32", {"leaf_fft_size": 256}, 4),
    "chunks4_f64_2^14": (14, "f64", {"leaf_fft_size": 256}, 4),
}
ONE_CHUNK_TOL = {"f32": 5e-7, "f64": 1e-14}
#: The JAX package's distributed dd pipeline compiles for ~10 s a shape on
#: the CPU: the df64 case is held to it at one world size, to numpy at both.
JAX_DD_WORLD = 2
ERRORS = ("too_small", "planner_size", "c2r_shard_length", "c2r_unequal")


def _signal(log_n, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(1 << log_n).astype(dtype)


def _spectrum(log_n, dtype):
    spec = np.fft.rfft(_signal(log_n, 200 + log_n))
    return (np.ascontiguousarray(spec.real).astype(dtype),
            np.ascontiguousarray(spec.imag).astype(dtype))


@contextlib.contextmanager
def _chunks(value):
    """PHASTFT_TPU_DIST_CHUNKS set to ``value`` inside the block, restored
    after it."""
    old = os.environ.get("PHASTFT_TPU_DIST_CHUNKS")
    os.environ["PHASTFT_TPU_DIST_CHUNKS"] = str(value)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PHASTFT_TPU_DIST_CHUNKS", None)
        else:
            os.environ["PHASTFT_TPU_DIST_CHUNKS"] = old


# -- the ranks ---------------------------------------------------------------

def _rank_cases(rank, d):
    import phastft_tpu_torch as pt
    from phastft_tpu_torch.parallel import c2r_fft_distributed, r2c_fft_distributed

    def shard(x):
        m = x.shape[-1] // d
        return x[rank * m:(rank + 1) * m]

    def bins(x, n):
        length = n // 2 // d
        return x[rank * length:(rank + 1) * length + int(rank == d - 1)]

    def planner(log_n, dtype, **opts):
        cls = pt.PlannerR2c32 if dtype == "f32" else pt.PlannerR2c64
        return cls(1 << log_n, inner_options=pt.Options(**opts) if opts else None,
                   device="cpu")

    out = {}
    for case, (log_n, dtype, opts) in CASES.items():
        n = 1 << log_n
        dt = np.float32 if dtype == "f32" else np.float64
        p = planner(log_n, dtype, **opts)
        x = _signal(log_n, log_n, dt)
        spec = r2c_fft_distributed(shard(x), p)
        out[f"r2c_{case}"] = (spec[0].numpy(), spec[1].numpy())
        sre, sim = _spectrum(log_n, dt)
        out[f"c2r_{case}"] = c2r_fft_distributed(bins(sre, n), bins(sim, n), p).numpy()
        out[f"roundtrip_{case}"] = c2r_fft_distributed(*spec, p).numpy()
        out[f"no_full_table_{case}"] = np.array([p._c2r_tw is None])
    for case, (log_n, dtype, opts, chunks) in CHUNKED.items():
        n = 1 << log_n
        dt = np.float32 if dtype == "f32" else np.float64
        p = planner(log_n, dtype, **opts)
        x = _signal(log_n, log_n, dt)
        sre, sim = _spectrum(log_n, dt)
        for count, tag in ((chunks, case), (1, f"{case}@1")):
            with _chunks(count):
                spec = r2c_fft_distributed(shard(x), p)
                out[f"r2c_{tag}"] = (spec[0].numpy(), spec[1].numpy())
                out[f"c2r_{tag}"] = c2r_fft_distributed(bins(sre, n), bins(sim, n), p).numpy()
    small = 4 * d * d  # n/2 < 4 d^2
    calls = {
        "too_small": lambda: r2c_fft_distributed(
            np.zeros(small // d), planner(small.bit_length() - 1, "f64")),
        "planner_size": lambda: r2c_fft_distributed(np.zeros(1024 // d),
                                                    planner(12, "f64")),
        "c2r_shard_length": lambda: c2r_fft_distributed(
            np.zeros(1024 // d), np.zeros(1024 // d), planner(12, "f64")),
        "c2r_unequal": lambda: c2r_fft_distributed(
            np.zeros(2048 // d), np.zeros(1), planner(12, "f64")),
    }
    errors = {}
    for name, call in calls.items():
        try:
            call()
            errors[name] = None
        except Exception as e:  # the test reads the class and message
            errors[name] = (type(e).__name__, str(e))
    out["errors"] = errors
    return out


def _rank_main(rank, d, store, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=d,
                            timeout=datetime.timedelta(seconds=INIT_S))
    try:
        out = _rank_cases(rank, d)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda d: f"d{d}")
def world(request, tmp_path_factory):
    """(d, {case: gathered result}) from d gloo ranks spawned once."""
    import torch.multiprocessing as mp

    d = request.param
    tmp = tmp_path_factory.mktemp(f"gloo_real_{d}")
    ctx = mp.start_processes(_rank_main, args=(d, str(tmp / "store"), str(tmp)),
                             nprocs=d, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"{d} gloo ranks did not finish in {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    parts = []
    for r in range(d):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            parts.append(pickle.load(f))
    out = {"errors": [p["errors"] for p in parts]}
    for key in parts[0]:
        if key.startswith("r2c_"):
            out[key] = tuple(np.concatenate([p[key][i] for p in parts]) for i in range(2))
        elif key != "errors":
            out[key] = np.concatenate([p[key] for p in parts])
    return d, out


# -- the reference -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax(case, d, kind):
    """The JAX package's distributed real transform of a case on a CPU mesh
    of d devices, its planner on the case's inner options."""
    import jax
    import phastft_tpu
    from phastft_tpu.parallel import c2r_fft_distributed, default_mesh, r2c_fft_distributed

    log_n, dtype, opts = CASES[case]
    dt = np.float32 if dtype == "f32" else np.float64
    cls = phastft_tpu.PlannerR2c32 if dtype == "f32" else phastft_tpu.PlannerR2c64
    p = cls(1 << log_n, inner_options=phastft_tpu.Options(**opts) if opts else None)
    mesh = default_mesh("x", devices=jax.devices()[:d])
    if kind == "r2c":
        out = r2c_fft_distributed(_signal(log_n, log_n, dt), p, mesh=mesh)
        return np.asarray(out[0], np.float64) + 1j * np.asarray(out[1], np.float64)
    return np.asarray(c2r_fft_distributed(*_spectrum(log_n, dt), p, mesh=mesh))


def _jax_chunked(case, d, kind):
    """``_jax`` of a CHUNKED case at its chunk count, the JAX package's built
    pipelines dropped before and after (their cache key does not hold the
    count)."""
    import jax
    import phastft_tpu
    from phastft_tpu.parallel import c2r_fft_distributed, default_mesh, r2c_fft_distributed
    from phastft_tpu.parallel.fourstep_dist import _build_distributed

    log_n, dtype, opts, chunks = CHUNKED[case]
    dt = np.float32 if dtype == "f32" else np.float64
    cls = phastft_tpu.PlannerR2c32 if dtype == "f32" else phastft_tpu.PlannerR2c64
    p = cls(1 << log_n, inner_options=phastft_tpu.Options(**opts))
    mesh = default_mesh("x", devices=jax.devices()[:d])
    _build_distributed.cache_clear()
    try:
        with _chunks(chunks):
            if kind == "r2c":
                out = r2c_fft_distributed(_signal(log_n, log_n, dt), p, mesh=mesh)
                return np.asarray(out[0], np.float64) + 1j * np.asarray(out[1], np.float64)
            return np.asarray(c2r_fft_distributed(*_spectrum(log_n, dt), p, mesh=mesh))
    finally:
        _build_distributed.cache_clear()


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _held_to_jax(case, d):
    return not case.startswith("df64") or d == JAX_DD_WORLD


@pytest.mark.parametrize("case", sorted(CASES))
def test_r2c_matches_jax_and_numpy(world, case):
    d, got = world
    log_n, dtype, _ = CASES[case]
    n = 1 << log_n
    sre, sim = got[f"r2c_{case}"]
    assert sre.shape == (n // 2 + 1,)
    g = sre.astype(np.float64) + 1j * sim
    x = _signal(log_n, log_n, np.float32 if dtype == "f32" else np.float64)
    f32 = dtype == "f32"
    assert _rel(g, np.fft.rfft(x.astype(np.float64))) <= (TOL_NUMPY_F32 if f32 else TOL_F64)
    if _held_to_jax(case, d):
        assert _rel(g, _jax(case, d, "r2c")) <= (TOL_JAX_F32 if f32 else TOL_F64)
    assert sim[0] == 0 and sim[-1] == 0  # DC and Nyquist real


@pytest.mark.parametrize("case", sorted(CASES))
def test_c2r_matches_jax_and_numpy(world, case):
    d, got = world
    log_n, dtype, _ = CASES[case]
    g = got[f"c2r_{case}"]
    assert g.shape == (1 << log_n,)
    f32 = dtype == "f32"
    want = np.fft.irfft(np.fft.rfft(_signal(log_n, 200 + log_n)))
    assert _rel(g, want) <= (TOL_NUMPY_F32 if f32 else TOL_F64)
    if _held_to_jax(case, d):
        assert _rel(g, _jax(case, d, "c2r")) <= (TOL_JAX_F32 if f32 else TOL_F64)


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_matches_jax_and_one_chunk(world, case, kind):
    """The chunked half-length transform at 2 and 4 ranks: the JAX
    package's result at the same chunk count, numpy's, and the port's
    one-chunk result."""
    d, got = world
    log_n, dtype, _, _ = CHUNKED[case]
    f32 = dtype == "f32"
    if kind == "r2c":
        g = got[f"r2c_{case}"][0].astype(np.float64) + 1j * got[f"r2c_{case}"][1]
        one = got[f"r2c_{case}@1"][0].astype(np.float64) + 1j * got[f"r2c_{case}@1"][1]
        x = _signal(log_n, log_n, np.float32 if f32 else np.float64)
        want = np.fft.rfft(x.astype(np.float64))
    else:
        g, one = got[f"c2r_{case}"], got[f"c2r_{case}@1"]
        want = np.fft.irfft(np.fft.rfft(_signal(log_n, 200 + log_n)))
    assert g.shape == want.shape
    assert _rel(g, want) <= (TOL_NUMPY_F32 if f32 else TOL_F64)
    assert _rel(g, _jax_chunked(case, d, kind)) <= (TOL_JAX_F32 if f32 else TOL_F64)
    assert _rel(g, one) <= ONE_CHUNK_TOL[dtype]


@pytest.mark.parametrize("case", sorted(CASES))
def test_roundtrip(world, case):
    _, got = world
    log_n, dtype, _ = CASES[case]
    x = _signal(log_n, log_n, np.float32 if dtype == "f32" else np.float64)
    assert _rel(got[f"roundtrip_{case}"], x) <= (TOL_NUMPY_F32 if dtype == "f32" else TOL_F64)


@pytest.mark.parametrize("case", sorted(CASES))
def test_c2r_builds_no_full_table(world, case):
    """Every rank's C2R reads the quarter table: the planner's full-length
    table stays unbuilt."""
    d, got = world
    assert got[f"no_full_table_{case}"].tolist() == [True] * d


#: error case -> (class, words its message holds), on every rank alike; the
#: first two mirror the JAX package's _check_r2c_size and planner check
#: (phastft_tpu/parallel/real_dist.py:43-53, :78-81)
WANT_ERRORS = {
    "too_small": ("NonPowerOfTwoError", "too small to shard the half-length transform"),
    "planner_size": ("LengthMismatchError", "planner is for size 4096 but input has size 1024"),
    "c2r_shard_length": ("LengthMismatchError", "spec must have length N/2 + 1 = 2049"),
    "c2r_unequal": ("LengthMismatchError", "must be of equal length"),
}


@pytest.mark.parametrize("name", ERRORS)
def test_errors(world, name):
    _, got = world
    cls, words = WANT_ERRORS[name]
    for errs in got["errors"]:
        err = errs[name]
        assert err is not None, f"{name}: nothing raised"
        assert err[0] == cls and words in err[1], err
