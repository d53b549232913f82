"""The port's distributed four-step in f64 (the native engine in all three
layouts, df64 and df64-oz in natural order) and past the column kernels'
n1 = 2048 (f32 and f64), on gloo, against the JAX package's
``fft_distributed`` on a CPU mesh of the same size and against numpy.

As in tests/test_torch_dist.py, one module-scope fixture per world size (2
and 4) spawns its gloo ranks once; every rank runs every case on its shard
of the same seeded numpy inputs and writes its shards to a file, and the
tests gather them. The ranks import no JAX.

Tolerances: native and df64, rel L2 <= 1e-12 against the JAX package and
against numpy's FFT (both ~1e-15 / ~1e-14 apart in fact); f32,
5e-7 * max(1, log2(n) / 18) against numpy and 2e-6 against the JAX package
(two f32 pipelines that sum in different orders).

The chunked column stage: the CHUNKED cases run with
PHASTFT_TPU_DIST_CHUNKS set on every rank and in the JAX reference (its
built pipelines dropped before and after), each also at one chunk on the
ranks. The chunked result matches the JAX package's at the same count and
the port's one-chunk result: bit for bit in permuted input and where every
df64 chunk holds the 256 columns its tables are factored on, else within
ONE_CHUNK_TOL (each chunk's twiddle tables factored on its own columns).
"""

import contextlib
import datetime
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
#: Seconds for the ranks' init (each) and for all of them to finish.
INIT_S = 60
DEADLINE_S = 150
WORLDS = (2, 4)

#: case -> (log2 n, dtype, options, flags) of the transforms each rank runs.
#: "long": leaf 128 at 2^19 gives n1 = 4096 at d = 2 and 4, past the column
#: kernels' 2048. "df64_narrow": 2^10 gives column blocks of 64 / 32 columns,
#: under the JAX dd kernel's 128. "one_column": a leaf of d points ("d")
#: gives n2 = d, column blocks of one column (col64 and col64_nocorr at
#: n2 = 1). "df64_narrowest": 2^7, the smallest n the dd factorization
#: shards over 4 ranks, gives blocks of 8 / 4 columns (the dd factorization
#: n1 = max(8, d) keeps n2 / d >= 4 at d <= 4: no one-column dd block).
TRANSFORMS = {
    "native_2^10": (10, "f64", {}, {}),
    "native_2^12": (12, "f64", {}, {}),
    "native_permuted_output_2^12": (12, "f64", {}, {"permuted_output": True}),
    "native_permuted_input_2^12": (12, "f64", {}, {"permuted_input": True}),
    "df64_2^12": (12, "f64", {"f64_engine": "df64"}, {}),
    "df64_narrow_2^10": (10, "f64", {"f64_engine": "df64"}, {}),
    "df64_split_2^13": (13, "f64", {"f64_engine": "df64-split"}, {}),
    "df64_oz_2^12": (12, "f64", {"f64_engine": "df64-oz"}, {}),
    "df64_permuted_output_2^12": (12, "f64", {"f64_engine": "df64"},
                                  {"permuted_output": True}),
    "long_f64_2^19": (19, "f64", {"leaf_fft_size": 128}, {}),
    "long_f64_permuted_output_2^19": (19, "f64", {"leaf_fft_size": 128},
                                      {"permuted_output": True}),
    "long_f64_permuted_input_2^19": (19, "f64", {"leaf_fft_size": 128},
                                     {"permuted_input": True}),
    "long_f32_2^19": (19, "f32", {"leaf_fft_size": 128}, {}),
    "native_one_column_2^10": (10, "f64", {"leaf_fft_size": "d"}, {}),
    "native_one_column_permuted_output_2^10": (10, "f64", {"leaf_fft_size": "d"},
                                               {"permuted_output": True}),
    "native_one_column_permuted_input_2^10": (10, "f64", {"leaf_fft_size": "d"},
                                              {"permuted_input": True}),
    "df64_narrowest_2^7": (7, "f64", {"f64_engine": "df64"}, {}),
}
#: The cases held to numpy alone: the JAX package compiles its dd pipeline
#: for ~11 s a shape on the CPU, so of the dd cases only df64_2^12 is held to
#: it (the split and oz leaves' rows are held to it in tests/test_torch_fft.py
#: and tests/test_torch_ozaki.py; the narrow blocks' products are the same
#: tables' as ddcol's, tests/test_torch_col64.py).
NUMPY_ONLY = ("df64_narrow_2^10", "df64_split_2^13", "df64_oz_2^12")
#: The long cases are held to the JAX package at d = 2 only (its 2^19
#: graphs take ~2-3 s each to compile); to numpy at both world sizes.
JAX_LONG_WORLD = 2
ROUNDTRIPS = ("native", "native_permuted", "df64", "long_f64")
#: case -> (log2 n, dtype, options, flags, chunks): the chunked column stage,
#: native on a 256-point leaf (n1 = 32), df64 (n1 = 8, blocks of 512 / 256
#: columns at d = 2 / 4), past n1 = 2048 on a 128-point leaf (n1 = 4096;
#: held to the JAX package at JAX_LONG_WORLD, as the long cases above).
CHUNKED = {
    "chunks2_native_2^13": (13, "f64", {"leaf_fft_size": 256}, {}, 2),
    "chunks4_native_2^13": (13, "f64", {"leaf_fft_size": 256}, {}, 4),
    "chunks8_native_2^13": (13, "f64", {"leaf_fft_size": 256}, {}, 8),
    "chunks4_native_permuted_input_2^13": (13, "f64", {"leaf_fft_size": 256},
                                           {"permuted_input": True}, 4),
    "chunks2_df64_2^13": (13, "f64", {"f64_engine": "df64"}, {}, 2),
    "chunks4_df64_2^13": (13, "f64", {"f64_engine": "df64"}, {}, 4),
    "chunks8_df64_2^13": (13, "f64", {"f64_engine": "df64"}, {}, 8),
    "chunks4_long_f64_2^19": (19, "f64", {"leaf_fft_size": 128}, {}, 4),
    "chunks4_long_f32_2^19": (19, "f32", {"leaf_fft_size": 128}, {}, 4),
}
#: The chunked result against the port's one-chunk result (rel L2).
ONE_CHUNK_TOL = {"f64": 1e-14, "f32": 5e-7}
ERRORS = ("dd_too_small", "f64_planner_size", "f64_flags")


def _signal(log_n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(1 << log_n).astype(dtype),
            rng.standard_normal(1 << log_n).astype(dtype))


def _leaf(log_n, opts, d):
    """The leaf of the planners of a case over d ranks: the options' ("d":
    d points), else the f64 rule of ``guess_options`` (the same in both
    packages)."""
    import phastft_tpu_torch as pt

    leaf = opts.get("leaf_fft_size",
                    pt.Options.guess_options(1 << log_n).leaf_fft_size)
    return d if leaf == "d" else leaf


def _perm(log_n, d, opts):
    """Indices of the permuted layout of the native factorization: P[k1*n2 +
    k2] = x[k1 + k2*n1]."""
    from phastft_tpu_torch.parallel.fourstep_dist import _factor

    n = 1 << log_n
    n1, n2 = _factor(n, d, _leaf(log_n, opts, d))
    return np.arange(n).reshape(n2, n1).T.reshape(-1)


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


@contextlib.contextmanager
def _jax_chunks(value):
    """``_chunks`` for the JAX reference: its built pipelines are dropped
    before and after the block (their cache keys do not hold the count)."""
    from phastft_tpu.parallel.fourstep_dist import _build_distributed, _build_distributed_dd

    def drop():
        _build_distributed.cache_clear()
        _build_distributed_dd.cache_clear()

    drop()
    try:
        with _chunks(value):
            yield
    finally:
        drop()


def _inputs(case, d):
    log_n, dtype, opts, flags = (TRANSFORMS[case] if case in TRANSFORMS
                                 else CHUNKED[case][:4])
    re, im = _signal(log_n, log_n, np.float32 if dtype == "f32" else np.float64)
    if flags.get("permuted_input"):
        p = _perm(log_n, d, opts)
        re, im = re[p], im[p]
    return re, im


# -- the ranks ---------------------------------------------------------------

def _rank_cases(rank, d):
    import phastft_tpu_torch as pt
    from phastft_tpu_torch.parallel import fft_distributed

    def shard(x):
        m = x.shape[-1] // d
        return x[..., rank * m:(rank + 1) * m]

    def planner(log_n, dtype="f64", **opts):
        cls = pt.PlannerDit32 if dtype == "f32" else pt.PlannerDit64
        options = pt.Options(leaf_fft_size=_leaf(log_n, opts, d), **{
            k: v for k, v in opts.items() if k != "leaf_fft_size"})
        return cls(1 << log_n, options=options, device="cpu")

    def pair(out):
        return out[0].numpy(), out[1].numpy()

    fwd = pt.Direction.Forward
    inv = pt.Direction.Reverse
    out = {}
    for case, (log_n, dtype, opts, flags) in TRANSFORMS.items():
        re, im = _inputs(case, d)
        out[case] = pair(fft_distributed(shard(re), shard(im), fwd,
                                         planner(log_n, dtype, **opts), **flags))
    for case, (log_n, dtype, opts, flags, chunks) in CHUNKED.items():
        re, im = _inputs(case, d)
        for count, key in ((chunks, case), (1, f"{case}@1")):
            with _chunks(count):
                out[key] = pair(fft_distributed(shard(re), shard(im), fwd,
                                                planner(log_n, dtype, **opts), **flags))
    # round trips: natural, permuted output into permuted input, df64, and
    # past n1 = 2048
    for kind, log_n, opts, flags in (
            ("native", 12, {}, {}),
            ("native_permuted", 12, {}, {"permuted_output": True}),
            ("df64", 12, {"f64_engine": "df64"}, {}),
            ("long_f64", 19, {"leaf_fft_size": 128}, {})):
        re, im = _signal(log_n, 100 + log_n)
        p = planner(log_n, **opts)
        f = fft_distributed(shard(re), shard(im), fwd, p, **flags)
        back = {"permuted_input": True} if flags else {}
        out[f"roundtrip_{kind}"] = pair(fft_distributed(f[0], f[1], inv, p, **back))
    # the inverse of N * delta is exactly ones: the scale is 1/N
    n = 1 << 12
    delta = np.zeros(n)
    delta[0] = n
    for kind, opts in (("native", {}), ("df64", {"f64_engine": "df64"})):
        out[f"inverse_delta_{kind}"] = pair(fft_distributed(
            shard(delta), shard(np.zeros(n)), inv, planner(12, **opts)))
    # circular convolution in the permuted layout (tests/test_parallel.py)
    x, h = _signal(12, 23)
    z = np.zeros(n)
    p = planner(12)
    xr, xi = fft_distributed(shard(x), shard(z), fwd, p, permuted_output=True)
    hr, hi = fft_distributed(shard(h), shard(z), fwd, p, permuted_output=True)
    out["convolution"] = pair(fft_distributed(
        xr * hr - xi * hi, xr * hi + xi * hr, inv, p, permuted_input=True))
    # the errors, each before any collective
    n10 = np.zeros((1 << 10) // d)
    calls = {
        "dd_too_small": lambda: fft_distributed(
            np.zeros(32 // d), np.zeros(32 // d), fwd,
            planner(5, f64_engine="df64")),
        "f64_planner_size": lambda: fft_distributed(n10, n10, fwd, planner(12)),
        "f64_flags": lambda: fft_distributed(n10, n10, fwd, planner(10),
                                             permuted_output=True,
                                             permuted_input=True),
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
    tmp = tmp_path_factory.mktemp(f"gloo64_{d}")
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
        if key != "errors":
            out[key] = tuple(np.concatenate([p[key][i] for p in parts])
                             for i in range(2))
    return d, out


# -- the reference -----------------------------------------------------------

def _jax_distributed(re, im, d, log_n, dtype="f64", opts=None,
                     direction="Forward", **flags):
    """The JAX package's ``fft_distributed`` on a CPU mesh of d devices, its
    planner on the case's leaf and engine. Past n1 = 2048 its XLA column
    pass reads Stockham tables of length n1, which its planner, built for
    the whole transform's plan, does not hold (a KeyError): there the test
    runs the package's ``_build_distributed`` itself and hands them in."""
    import jax
    import jax.numpy as jnp
    import phastft_tpu
    from jax.sharding import NamedSharding, PartitionSpec
    from phastft_tpu.ops.stockham import radix_tables_host
    from phastft_tpu.parallel import default_mesh, fft_distributed
    from phastft_tpu.parallel.fourstep_dist import _build_distributed, _factor

    opts = dict(opts or {})
    leaf = _leaf(log_n, opts, d)
    opts.pop("leaf_fft_size", None)
    cls = phastft_tpu.PlannerDit32 if dtype == "f32" else phastft_tpu.PlannerDit64
    n = 1 << log_n
    p = cls(n, options=phastft_tpu.Options(leaf_fft_size=leaf, **opts))
    mesh = default_mesh("x", devices=jax.devices()[:d])
    direction = getattr(phastft_tpu.Direction, direction)
    n1, _ = _factor(n, d, leaf)
    if n1 <= 2048:
        out = fft_distributed(re, im, direction, p, mesh=mesh, **flags)
        return np.asarray(out[0]), np.asarray(out[1])
    assert direction is phastft_tpu.Direction.Forward
    run, mesh = _build_distributed(
        n, d, "x", leaf, False, flags.get("permuted_output", False),
        tuple(mesh.devices.flat), p.options.use_pallas, p.options.leaf_kernel,
        p.options.col_engine, flags.get("permuted_input", False))
    tables = dict(p.fast_tables)
    for key, entry in radix_tables_host(n1, p.dtype.name).items():
        tables.setdefault(key, tuple((jnp.asarray(a), jnp.asarray(b))
                                     for a, b in entry))
    sharding = NamedSharding(mesh, PartitionSpec("x"))
    out = run(jax.device_put(jnp.asarray(re), sharding),
              jax.device_put(jnp.asarray(im), sharding), tables, p.leaf_corrs)
    return np.asarray(out[0]), np.asarray(out[1])


def _c(pair):
    return np.asarray(pair[0], np.float64) + 1j * np.asarray(pair[1], np.float64)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_transform_matches_jax_and_numpy(world, case):
    d, got = world
    log_n, dtype, opts, flags = TRANSFORMS[case]
    re, im = _inputs(case, d)
    g = _c(got[case])
    assert g.shape == (1 << log_n,)
    # element for element: the permuted layouts too
    want_jax = None
    if case not in NUMPY_ONLY and (not case.startswith("long") or d == JAX_LONG_WORLD):
        want_jax = _c(_jax_distributed(re, im, d, log_n, dtype, opts, **flags))
    x, y = _signal(log_n, log_n)
    spectrum = np.fft.fft(x + 1j * y)
    if flags.get("permuted_output"):
        spectrum = spectrum[_perm(log_n, d, opts)]
    if want_jax is not None:
        assert _rel(g, want_jax) <= (TOL_JAX_F32 if dtype == "f32" else TOL_F64)
    if dtype == "f32":
        assert _rel(g, spectrum) <= 5e-7 * max(1.0, log_n / 18.0)
    else:
        assert _rel(g, spectrum) <= TOL_F64


@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_matches_jax_and_one_chunk(world, case):
    """The chunked column stage at 2 and 4 ranks (the long cases against the
    JAX package at JAX_LONG_WORLD): the JAX package's result at the same
    chunk count, numpy's, and the port's one-chunk result."""
    from phastft_tpu_torch.parallel.fourstep_dist import _factor_dd

    d, got = world
    log_n, dtype, opts, flags, chunks = CHUNKED[case]
    re, im = _inputs(case, d)
    g = _c(got[case])
    one = _c(got[f"{case}@1"])
    assert g.shape == (1 << log_n,)
    if "long" not in case or d == JAX_LONG_WORLD:
        with _jax_chunks(chunks):
            want_jax = _c(_jax_distributed(re, im, d, log_n, dtype, opts, **flags))
        assert _rel(g, want_jax) <= (TOL_JAX_F32 if dtype == "f32" else TOL_F64)
    x, y = _signal(log_n, log_n)
    assert _rel(g, np.fft.fft(x + 1j * y)) <= (5e-7 * max(1.0, log_n / 18.0)
                                               if dtype == "f32" else TOL_F64)
    dd_width = (_factor_dd(1 << log_n, d)[1] // d // chunks
                if opts.get("f64_engine") == "df64" else 0)
    if flags.get("permuted_input") or dd_width >= 256:
        assert np.array_equal(g, one)
    else:
        assert _rel(g, one) <= ONE_CHUNK_TOL[dtype]


@pytest.mark.parametrize("kind", ROUNDTRIPS)
def test_roundtrip(world, kind):
    _, got = world
    log_n = 19 if kind == "long_f64" else 12
    re, im = _signal(log_n, 100 + log_n)
    assert _rel(_c(got[f"roundtrip_{kind}"]), re + 1j * im) <= TOL_F64


@pytest.mark.parametrize("kind", ["native", "df64"])
def test_inverse_scale_is_exact(world, kind):
    _, got = world
    out = got[f"inverse_delta_{kind}"]
    assert np.all(out[0] == 1.0)
    assert np.all(out[1] == 0.0)


def test_convolution_pipeline(world):
    d, got = world
    x, h = _signal(12, 23)
    z = np.zeros_like(x)
    xr, xi = _jax_distributed(x, z, d, 12, permuted_output=True)
    hr, hi = _jax_distributed(h, z, d, 12, permuted_output=True)
    ref = _jax_distributed(xr * hr - xi * hi, xr * hi + xi * hr, d, 12,
                           direction="Reverse", permuted_input=True)
    assert _rel(_c(got["convolution"]), _c(ref)) <= TOL_F64
    want = np.fft.ifft(np.fft.fft(x) * np.fft.fft(h))
    assert _rel(_c(got["convolution"]), want) <= TOL_F64


#: error case -> (class, words its message holds), on every rank alike.
WANT_ERRORS = {
    "dd_too_small": ("NonPowerOfTwoError", "too small to dd-shard"),
    "f64_planner_size": ("NonPowerOfTwoError", "planner is for size 4096"),
    "f64_flags": ("ValueError", "mutually exclusive"),
}


@pytest.mark.parametrize("name", ERRORS)
def test_errors(world, name):
    _, got = world
    cls, words = WANT_ERRORS[name]
    for errs in got["errors"]:
        err = errs[name]
        assert err is not None, f"{name}: nothing raised"
        assert err[0] == cls and words in err[1], err


def test_df64_oz_rows_arm_the_oz_kernels_in_both_packages():
    """The dd pipeline's row planner at 2^23 over 8 (n2 = 2^20, leaf 2^13,
    the row plan 128 x 8192, inside the oz window): its "df64-oz" tables
    hold the oz keys of the JAX package's ``_dd_dist_state``, and none of
    the "df64" planner's ddpcol key, as the JAX one does; so ``fft_rows_dd``
    runs ``ozcol`` + ``ozleaft`` on it in both packages. The transform's
    numbers are left to the card (the oz kernels' plain versions take
    minutes here)."""
    from phastft_tpu.parallel.fourstep_dist import _dd_dist_state

    from phastft_tpu_torch.parallel.fourstep_dist import (
        _dd_row_planner, _factor_dd,
    )

    n1, n2 = _factor_dd(1 << 23, 2)
    assert (n1, n2) == (8, 1 << 20)
    plan, _, jax_corrs, _, _ = _dd_dist_state(n1, n2, 1 << 13, "df64-oz")
    rp = _dd_row_planner(n2, 1 << 13, "df64-oz", torch.device("cpu"))
    assert rp.plan == plan == ("split", 128, ("leaf", 64), 8192)
    ours = set(rp.dd_state[1])
    assert {"ozcol128x8192", "ozleafT8192"} <= ours
    assert {k for k in jax_corrs if k.startswith("oz")} == {
        k for k in ours if k.startswith("oz")}
    assert "ddpcol128x8192" not in ours
    plain = _dd_row_planner(n2, 1 << 13, "df64", torch.device("cpu"))
    assert "ddpcol128x8192" in plain.dd_state[1]


#: The long columns on one block (no process group; ``ops/longcol``, which
#: the distributed four-step and the single-device leaves past 2^17 run):
#: (dtype, batch, n1, c, n,
#: col_base, bare, MAX_N1 lowered to). n1 = 4096 over n = 2^16: one level of
#: 64 x 64; c = 16 is a block of every column (f32: colfft's own shard
#: twiddle), c = 4 a shard block (f32: colfft_nocorr and the twiddle in
#: torch); a lowered MAX_N1 nests the second pass once more.
LONG_BLOCKS = [
    ("f64", (), 4096, 16, 1 << 16, 0, False, None),
    ("f64", (2,), 4096, 4, 1 << 16, 8, False, None),
    ("f64", (), 4096, 4, 1 << 16, 4, True, None),
    ("f32", (), 4096, 16, 1 << 16, 0, False, None),
    ("f32", (2,), 4096, 4, 1 << 16, 8, False, None),
    ("f32", (), 4096, 4, 1 << 16, 0, True, None),
    ("f64", (), 1024, 4, 1 << 14, 4, False, 16),
    ("f32", (), 1024, 4, 1 << 14, 4, True, 16),
]


@pytest.mark.parametrize("dtype,batch,n1,c,n,col_base,bare,max_n1", LONG_BLOCKS)
def test_long_columns_match_jax_and_numpy(monkeypatch, dtype, batch, n1, c, n, col_base,
                                          bare, max_n1):
    """The column pass past n1 = 2048 (two column passes with the twiddles
    in their tables, two transposes; nested again past MAX_N1) on a block of
    columns [col_base, col_base + c) of an n-point transform: the JAX
    package's XLA column pass (``stockham_axis2`` and
    ``_local_correction_cols``, fourstep_dist.py:266-274) and numpy, rows k1
    in natural order."""
    import jax.numpy as jnp
    from phastft_tpu.ops.stockham import radix_tables_host
    from phastft_tpu.ops.stockham import stockham_axis2 as jax_st
    from phastft_tpu.parallel.fourstep_dist import _local_correction_cols

    from phastft_tpu_torch.ops import longcol

    if max_n1:
        monkeypatch.setattr(longcol, "MAX_N1", max_n1)
    f64 = dtype == "f64"
    np_dtype = np.float64 if f64 else np.float32
    rng = np.random.default_rng(n1 + c + col_base)
    shape = batch + (n1, c)
    re = rng.standard_normal(shape).astype(np_dtype)
    im = rng.standard_normal(shape).astype(np_dtype)
    out = longcol.long_columns([torch.from_numpy(re), torch.from_numpy(im)], n, n1,
                               col_base, bare, f64)
    got = out[0].numpy().astype(np.float64) + 1j * out[1].numpy()
    assert got.shape == shape
    z = re.astype(np.float64) + 1j * im
    k1, j = np.arange(n1)[:, None], np.arange(c)[None, :]
    tw = 1.0 if bare else np.exp(-2j * np.pi * ((k1 * (col_base + j)) % n) / n)
    assert _rel(got, np.fft.fft(z, axis=-2) * tw) <= (TOL_F64 if f64 else 1e-6)
    radix = {k: tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in v)
             for k, v in radix_tables_host(n1, np_dtype.__name__).items()}
    br, bi = jax_st(jnp.asarray(re), jnp.asarray(im), radix, n1)
    want = np.asarray(br, np.float64) + 1j * np.asarray(bi, np.float64)
    if not bare:
        cr, ci = _local_correction_cols(n1, n // n1, jnp.asarray(col_base), c,
                                        jnp.float64)
        want = want * (np.asarray(cr) + 1j * np.asarray(ci))
    assert _rel(got, want) <= (TOL_F64 if f64 else TOL_JAX_F32)
