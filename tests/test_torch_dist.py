"""The port's distributed four-step and batch sharding on gloo, against
the JAX package's on a CPU mesh of the same size.

One module-scope fixture per world size (2 and 4) spawns its gloo ranks
once (``torch.multiprocessing``, a ``file://`` store in a temporary
directory). Every rank runs every case on its shard of the same seeded
numpy inputs and writes its shards to a file; the tests gather them and
compare with ``phastft_tpu.parallel`` on ``default_mesh("x",
devices=jax.devices()[:d])`` with a JAX ``PlannerDit32``. The ranks import
no JAX: this module imports it only inside the reference functions. Both
the ranks' init and the join have a deadline, after which the ranks are
killed and the fixture fails.

Tolerances: the port against the JAX package, rel L2 <= 2e-6 (two f32
pipelines that sum in different orders); each against numpy's f64 FFT,
<= 1e-5, as tests/test_parallel.py holds the f32 path.

The chunked column stage: the CHUNKED cases run with
PHASTFT_TPU_DIST_CHUNKS set on every rank and in the JAX reference (whose
built pipelines are dropped before and after, as their cache key does not
hold the count), each also at one chunk on the ranks: the chunked result
matches the JAX package's at the same count and the port's one-chunk
result, bit for bit in permuted input (an exact twiddle per element, a bare
column pass) and within ONE_CHUNK_TOL elsewhere (each chunk's shard
twiddle factored on its own columns, as in the JAX package).
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


TOL_JAX = 2e-6
TOL_F64 = 1e-5
#: Seconds for the ranks' init (each) and for all of them to finish.
INIT_S = 60
DEADLINE_S = 120
WORLDS = (2, 4)

#: case -> (log2 n, flags): the transforms each rank runs, natural or with
#: the permuted layouts. For "jax_chunked" both packages are forced to 4
#: chunks of the column block (under 8 MiB both take one by default), which
#: leave the layout as it is. The "two_column" cases plan both packages on a
#: leaf of 2d points: n2 = 2d, column blocks of two columns (colfft's shard
#: and bare modes at n2 = 2), tiny rows of 2d points.
TRANSFORMS = {
    "natural_2^10": (10, {}),
    "natural_2^12": (12, {}),
    "jax_chunked_2^13": (13, {}),
    "permuted_output_2^12": (12, {"permuted_output": True}),
    "permuted_input_2^12": (12, {"permuted_input": True}),
    "two_column_2^10": (10, {}),
    "two_column_permuted_input_2^10": (10, {"permuted_input": True}),
}
JAX_CHUNKED = "jax_chunked_2^13"
#: case -> (log2 n, flags, chunks, use_pallas=False): the chunked column
#: stage on a leaf of 256 points (n1 = 32, blocks of 128 / 64 columns at
#: d = 2 / 4), each also run at one chunk.
CHUNKED = {
    "chunks2_natural_2^13": (13, {}, 2, False),
    "chunks4_natural_2^13": (13, {}, 4, False),
    "chunks8_natural_2^13": (13, {}, 8, False),
    "chunks4_permuted_output_2^13": (13, {"permuted_output": True}, 4, False),
    "chunks2_permuted_input_2^13": (13, {"permuted_input": True}, 2, False),
    "chunks4_permuted_input_2^13": (13, {"permuted_input": True}, 4, False),
    "chunks8_permuted_input_2^13": (13, {"permuted_input": True}, 8, False),
    "chunks4_plain_natural_2^13": (13, {}, 4, True),
    "chunks4_plain_permuted_input_2^13": (13, {"permuted_input": True}, 4, True),
}
CHUNK_LEAF = 256
#: The chunked result against the port's one-chunk result (rel L2).
ONE_CHUNK_TOL = 5e-7
BATCH_ROWS, BATCH_LOG = 2, 10
ERRORS = ("flags", "planner_size", "too_small", "batch_1d")


def _signal(log_n, seed, rows=None):
    rng = np.random.default_rng(seed)
    shape = (1 << log_n,) if rows is None else (rows, 1 << log_n)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _leaf(case, n, d):
    """The planners' leaf of a case over d ranks: 2d points for the
    two-column cases, CHUNK_LEAF for the chunked ones, else the default leaf
    of n."""
    import phastft_tpu_torch as pt

    if case.startswith("two_column"):
        return 2 * d
    if case in CHUNKED:
        return CHUNK_LEAF
    return pt.Options.guess_options(n, np.float32).leaf_fft_size


@contextlib.contextmanager
def _chunks(value):
    """PHASTFT_TPU_DIST_CHUNKS set to ``value`` (None: as it was) inside the
    block, restored after it."""
    old = os.environ.get("PHASTFT_TPU_DIST_CHUNKS")
    if value is not None:
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
    before and after the block (their cache key does not hold the count)."""
    from phastft_tpu.parallel.fourstep_dist import _build_distributed

    _build_distributed.cache_clear()
    try:
        with _chunks(value):
            yield
    finally:
        _build_distributed.cache_clear()


def _perm(n, d, case=""):
    """Indices of the permuted layout: P[k1*n2 + k2] = x[k1 + k2*n1], for
    the JAX package's factorization of n over d ranks at the case's
    leaf."""
    from phastft_tpu_torch.parallel.fourstep_dist import _factor

    n1, n2 = _factor(n, d, _leaf(case, n, d))
    return np.arange(n).reshape(n2, n1).T.reshape(-1)


def _inputs(case, d):
    log_n, flags = (TRANSFORMS[case] if case in TRANSFORMS else CHUNKED[case][:2])
    re, im = _signal(log_n, log_n)
    if flags.get("permuted_input"):
        p = _perm(1 << log_n, d, case)
        re, im = re[p], im[p]
    return re, im


# -- the ranks ---------------------------------------------------------------

def _rank_cases(rank, d):
    import phastft_tpu_torch as pt
    from phastft_tpu_torch.parallel import batch_fft_sharded, fft_distributed

    def shard(x):
        m = x.shape[-1] // d
        return x[..., rank * m:(rank + 1) * m]

    def planner(log_n, **kw):
        return pt.PlannerDit32(1 << log_n, device="cpu", **kw)

    def pair(out):
        return out[0].numpy(), out[1].numpy()

    fwd = pt.Direction.Forward
    inv = pt.Direction.Reverse
    out = {}
    for case, (log_n, flags) in TRANSFORMS.items():
        re, im = _inputs(case, d)
        opts = pt.Options(leaf_fft_size=_leaf(case, 1 << log_n, d))
        with _chunks(4 if case == JAX_CHUNKED else None):
            out[case] = pair(fft_distributed(shard(re), shard(im), fwd,
                                             planner(log_n, options=opts), **flags))
    for case, (log_n, flags, chunks, plain) in CHUNKED.items():
        re, im = _inputs(case, d)
        opts = pt.Options(leaf_fft_size=CHUNK_LEAF, use_pallas=False if plain else None)
        for count, key in ((chunks, case), (1, f"{case}@1")):
            with _chunks(count):
                out[key] = pair(fft_distributed(shard(re), shard(im), fwd,
                                                planner(log_n, options=opts), **flags))
    # round trips: natural, and permuted output into permuted input
    re, im = _signal(12, 12)
    p = planner(12)
    f = fft_distributed(shard(re), shard(im), fwd, p)
    out["roundtrip_natural"] = pair(fft_distributed(f[0], f[1], inv, p))
    f = fft_distributed(shard(re), shard(im), fwd, p, permuted_output=True)
    out["roundtrip_permuted"] = pair(
        fft_distributed(f[0], f[1], inv, p, permuted_input=True))
    # the inverse of N * delta is exactly ones: the scale is 1/N
    n = 1 << 12
    delta = np.zeros(n, np.float32)
    delta[0] = n
    out["inverse_delta"] = pair(fft_distributed(
        shard(delta), shard(np.zeros(n, np.float32)), inv, p))
    # circular convolution in the permuted layout (tests/test_parallel.py)
    x, h = _signal(12, 23)
    z = np.zeros(n, np.float32)
    xr, xi = fft_distributed(shard(x), shard(z), fwd, p, permuted_output=True)
    hr, hi = fft_distributed(shard(h), shard(z), fwd, p, permuted_output=True)
    out["convolution"] = pair(fft_distributed(
        xr * hr - xi * hi, xr * hi + xi * hr, inv, p, permuted_input=True))
    # batch sharding: this rank's rows of a (d * BATCH_ROWS, n) batch
    re, im = _signal(BATCH_LOG, 7, rows=d * BATCH_ROWS)
    rows = slice(rank * BATCH_ROWS, (rank + 1) * BATCH_ROWS)
    out["batch"] = pair(batch_fft_sharded(re[rows], im[rows], fwd,
                                          planner(BATCH_LOG)))
    # the errors, each before any collective
    n10 = np.zeros((1 << 10) // d, np.float32)
    tiny = np.zeros(1, np.float32)
    calls = {
        "flags": lambda: fft_distributed(n10, n10, fwd, planner(10),
                                         permuted_output=True,
                                         permuted_input=True),
        "planner_size": lambda: fft_distributed(n10, n10, fwd, planner(12)),
        "too_small": lambda: fft_distributed(tiny, tiny, fwd, planner(
            d.bit_length() - 1)),
        "batch_1d": lambda: batch_fft_sharded(n10, n10, fwd, planner(10)),
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
    tmp = tmp_path_factory.mktemp(f"gloo{d}")
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

def _jax_distributed(re, im, d, direction="Forward", leaf=None, plain=False, **flags):
    import jax
    import phastft_tpu
    from phastft_tpu.parallel import default_mesh, fft_distributed

    mesh = default_mesh("x", devices=jax.devices()[:d])
    opts = None if leaf is None else phastft_tpu.Options(
        leaf_fft_size=leaf, use_pallas=False if plain else None)
    p = phastft_tpu.PlannerDit32(re.shape[-1], options=opts)
    out = fft_distributed(re, im, getattr(phastft_tpu.Direction, direction),
                          p, mesh=mesh, **flags)
    return np.asarray(out[0]), np.asarray(out[1])


def _c(pair):
    return np.asarray(pair[0], np.float64) + 1j * np.asarray(pair[1], np.float64)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_transform_matches_jax_and_numpy(world, case):
    d, got = world
    log_n, flags = TRANSFORMS[case]
    re, im = _inputs(case, d)
    with _jax_chunks(4 if case == JAX_CHUNKED else None):
        want_jax = _c(_jax_distributed(re, im, d, leaf=_leaf(case, 1 << log_n, d), **flags))
    g = _c(got[case])
    assert g.shape == (1 << log_n,)
    # element for element: the permuted layout too
    assert _rel(g, want_jax) <= TOL_JAX
    x, y = _signal(log_n, log_n)
    spectrum = np.fft.fft(x.astype(np.float64) + 1j * y)
    if flags.get("permuted_output"):
        spectrum = spectrum[_perm(1 << log_n, d, case)]
    assert _rel(g, spectrum) <= TOL_F64


@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_matches_jax_and_one_chunk(world, case):
    """The chunked column stage at 2 and 4 ranks: the JAX package's result
    at the same chunk count, numpy's, and the port's one-chunk result."""
    d, got = world
    log_n, flags, chunks, plain = CHUNKED[case]
    re, im = _inputs(case, d)
    g = _c(got[case])
    one = _c(got[f"{case}@1"])
    assert g.shape == (1 << log_n,)
    with _jax_chunks(chunks):
        want_jax = _c(_jax_distributed(re, im, d, leaf=CHUNK_LEAF, plain=plain, **flags))
    assert _rel(g, want_jax) <= TOL_JAX
    x, y = _signal(log_n, log_n)
    spectrum = np.fft.fft(x.astype(np.float64) + 1j * y)
    if flags.get("permuted_output"):
        spectrum = spectrum[_perm(1 << log_n, d, case)]
    assert _rel(g, spectrum) <= TOL_F64
    if flags.get("permuted_input"):
        assert np.array_equal(g, one)
    else:
        assert _rel(g, one) <= ONE_CHUNK_TOL


@pytest.mark.parametrize("kind", ["natural", "permuted"])
def test_roundtrip(world, kind):
    _, got = world
    re, im = _signal(12, 12)
    assert _rel(_c(got[f"roundtrip_{kind}"]), _c((re, im))) <= TOL_F64


def test_inverse_scale_is_exact(world):
    _, got = world
    assert np.all(got["inverse_delta"][0] == 1.0)
    assert np.all(got["inverse_delta"][1] == 0.0)


def test_convolution_pipeline(world):
    d, got = world
    x, h = _signal(12, 23)
    z = np.zeros_like(x)
    xr, xi = _jax_distributed(x, z, d, permuted_output=True)
    hr, hi = _jax_distributed(h, z, d, permuted_output=True)
    ref = _jax_distributed(xr * hr - xi * hi, xr * hi + xi * hr, d,
                           "Reverse", permuted_input=True)
    assert _rel(_c(got["convolution"]), _c(ref)) <= TOL_JAX
    x64, h64 = x.astype(np.float64), h.astype(np.float64)
    want = np.fft.ifft(np.fft.fft(x64) * np.fft.fft(h64))
    assert _rel(_c(got["convolution"]), want) <= TOL_F64


def test_batch_fft_sharded_matches_jax(world):
    import jax
    import phastft_tpu
    from phastft_tpu.parallel import batch_fft_sharded, default_mesh

    d, got = world
    re, im = _signal(BATCH_LOG, 7, rows=d * BATCH_ROWS)
    ref = batch_fft_sharded(re, im, phastft_tpu.Direction.Forward,
                            phastft_tpu.PlannerDit32(1 << BATCH_LOG),
                            mesh=default_mesh("data", devices=jax.devices()[:d]))
    g = _c(got["batch"])
    assert g.shape == re.shape
    assert _rel(g, _c(ref)) <= TOL_JAX
    want = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1)
    assert _rel(g, want) <= TOL_F64


#: error case -> (class, words its message holds), on every rank alike.
WANT_ERRORS = {
    "flags": ("ValueError", "mutually exclusive"),
    "planner_size": ("NonPowerOfTwoError", "planner is for size 4096"),
    "too_small": ("NonPowerOfTwoError", "too small to shard"),
    "batch_1d": ("LengthMismatchError", "at least 2 dims"),
}


@pytest.mark.parametrize("name", ERRORS)
def test_errors(world, name):
    _, got = world
    cls, words = WANT_ERRORS[name]
    for errs in got["errors"]:
        err = errs[name]
        assert err is not None, f"{name}: nothing raised"
        assert err[0] == cls and words in err[1], err
