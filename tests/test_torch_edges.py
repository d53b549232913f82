"""The window's edges on the CPU: leaves outside 128..2^16 points, and the
column kernels' plain versions at the shapes they bring, against the JAX
package and numpy.

- Transforms: ``Options.leaf_fft_size`` of 1, 2, 16 and 64 (the rows of
  the last split level are 1..64 points: the column passes take n2 = 1..64)
  and 2^17 (the leaf on ``leaf3`` at a = 256), 2^17 under a split and
  2^19 = n (a leaf of n1 = 4096: the long columns, ``ops/longcol``; in
  df64 the long dd columns), forward and inverse, on a batch of 3, in f32,
  native f64 and df64. Planned as the JAX package plans them; against the
  JAX package's transform on the same plan (the f32 one for f32, its
  native f64 engine for f64: its dd pipeline compiles for 12-22 s a shape
  here, so the 2^17 df64 leaf alone is held to its df64 engine) and
  numpy's FFT.
- Kernels: ``leaf3_plain`` at a = 256 against the JAX ``leaf_fft_pallas3``
  in interpret mode (as tests/test_pallas_leaf.py runs it); the column
  passes' plain versions at n2 = 1..64 (classic, shard and bare modes)
  against the JAX package's ``stockham_axis2`` (f32 and f64) or
  ``stockham_axis2_dd`` and the split twiddle.
- Tables: planners built on a JAX planner's numpy tables
  (``from_numpy_tables``) for these plans give the port's own planner's
  result bit for bit.

Tolerances: tests/test_torch_fft.py's: f32 5e-7 * max(1, log2(n) / 18)
against numpy and twice that against the JAX package; f64 1e-13 against
the JAX package and 1e-12 against numpy; the column passes 1e-6 (f32) and
1e-13 (f64, dd) against the JAX functions.
"""

import functools

import numpy as np
import pytest
import torch

import phastft_tpu
import phastft_tpu_torch as pt

F64_JAX_TOL = 1e-13
F64_NUMPY_TOL = 1e-12
COL_TOL_F32 = 1e-6
COL_TOL_F64 = 1e-13
BATCH = 3

#: (log2 n, leaf_fft_size) of the transforms: rows of 1..64 points
#: under a split, the leaf of 2^17 alone and under a split, and a leaf of
#: 2^19.
ALL = ("f32", "native", "df64")
EDGES = [(10, 1), (12, 2), (13, 16), (14, 64), (17, 1 << 17), (18, 1 << 17), (19, 1 << 19)]
CASES = [(log_n, leaf, engine) for log_n, leaf in EDGES for engine in ALL]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs six test processes on the CPU at
    once, and this module's plain versions, at 2^17..2^19 points, slow every
    process down when each spreads over all cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bound(log_n):
    return 5e-7 * max(1.0, log_n / 18.0)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _g(out):
    return np.asarray(out[0], np.float64) + 1j * np.asarray(out[1], np.float64)


def _signal(log_n, dtype):
    rng = np.random.default_rng(log_n)
    x = rng.standard_normal((2, BATCH, 1 << log_n))
    return x[0].astype(dtype), x[1].astype(dtype)


def _planner(pkg, engine, n, leaf, **kw):
    if engine == "f32":
        return pkg.PlannerDit32(n, options=pkg.Options(leaf_fft_size=leaf), **kw)
    return pkg.PlannerDit64(n, options=pkg.Options(leaf_fft_size=leaf, f64_engine=engine),
                            **kw)


@functools.lru_cache(maxsize=None)
def _jax_out(f32, log_n, leaf, direction):
    """The JAX package's transform of the case's input: its f32 one, or its
    native f64 one for both f64 engines (see the module docstring). The
    inverse is its forward on the swapped planes, swapped back and scaled by
    1/n, the swap trick its own inverse runs, so both directions share one
    compiled graph."""
    re, im = _signal(log_n, np.float32 if f32 else np.float64)
    jp = _planner(phastft_tpu, "f32" if f32 else "native", 1 << log_n, leaf)
    entry = (phastft_tpu.fft_32_dit_with_planner if f32
             else phastft_tpu.fft_64_dit_with_planner)
    if direction == "Forward":
        return jp.plan, _g(entry(re, im, phastft_tpu.Direction.Forward, jp))
    out_im, out_re = entry(im, re, phastft_tpu.Direction.Forward, jp)
    return jp.plan, _g((out_re, out_im)) / (1 << log_n)


@pytest.mark.parametrize("direction", ["Forward", "Reverse"])
@pytest.mark.parametrize("log_n,leaf,engine", CASES)
def test_edges_match_jax_and_numpy(log_n, leaf, engine, direction):
    n = 1 << log_n
    f32 = engine == "f32"
    re, im = _signal(log_n, np.float32 if f32 else np.float64)
    planner = _planner(pt, engine, n, leaf, device="cpu")
    entry = pt.fft_32_dit_with_planner if f32 else pt.fft_64_dit_with_planner
    got = entry(re, im, getattr(pt.Direction, direction), planner)
    assert all(tuple(x.shape) == (BATCH, n) for x in got)
    got = _g(got)
    jax_plan, want_jax = _jax_out(f32, log_n, leaf, direction)
    assert planner.plan == jax_plan
    x = re.astype(np.float64) + 1j * im
    want = np.fft.fft(x, axis=-1) if direction == "Forward" else np.fft.ifft(x, axis=-1)
    if f32:
        assert _rel(got, want) <= _bound(log_n)
        assert _rel(got, want_jax) <= 2 * _bound(log_n)
    else:
        assert _rel(got, want) <= F64_NUMPY_TOL
        assert _rel(got, want_jax) <= F64_JAX_TOL


def test_df64_leaf_2_17_matches_jax_df64():
    """The df64 leaf of 2^17 (``ddcol`` with the leaf correction, two
    transposes, ``ddcol_nocorr`` over 128) against the JAX package's df64
    engine, forward."""
    log_n = 17
    n = 1 << log_n
    re, im = (x[:1] for x in _signal(log_n, np.float64))
    opts = dict(leaf_fft_size=n, f64_engine="df64")
    got = _g(pt.fft_64_dit_with_planner(re, im, "f", pt.PlannerDit64(
        n, options=pt.Options(**opts), device="cpu")))
    ref = _g(phastft_tpu.fft_64_dit_with_planner(
        re, im, phastft_tpu.Direction.Forward,
        phastft_tpu.PlannerDit64(n, options=phastft_tpu.Options(**opts))))
    assert _rel(got, ref) <= F64_JAX_TOL
    assert _rel(got, np.fft.fft(re + 1j * im, axis=-1)) <= F64_NUMPY_TOL


# -- the kernels' plain versions ---------------------------------------------

def test_leaf3_plain_a256_matches_pallas_interpret():
    """``leaf3_plain`` at a = 256, b = 128 (the 2^17 leaf) against the JAX
    ``leaf_fft_pallas3`` in interpret mode on the JAX planner's
    ``mxu3_1024``, and numpy."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from phastft_tpu.ops.pallas_leaf import leaf_fft_pallas3

    from phastft_tpu_torch.ops.leaf import leaf3_plain

    n = 1 << 17
    jp = phastft_tpu.PlannerDit32(n, options=phastft_tpu.Options(leaf_fft_size=n))
    mats = jp.leaf_corrs["mxu3_1024"]
    assert mats[0].shape == (256, 256) and mats[3].shape == (128, 128)
    rng = np.random.default_rng(3)
    re, im = (rng.standard_normal((2, n)).astype(np.float32) for _ in range(2))
    got = _g(leaf3_plain(torch.from_numpy(re), torch.from_numpy(im),
                         tuple(torch.from_numpy(np.array(a)) for a in mats), 256, 128))
    with pltpu.force_tpu_interpret_mode():
        out = leaf_fft_pallas3(jnp.asarray(re), jnp.asarray(im), mats, 256, 128)
    assert out is not None
    want = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1)
    assert _rel(got, want) <= _bound(17)
    assert _rel(got, _g(out)) <= 2 * _bound(17)


def _jax_columns(re, im, n1, dtype_name):
    """The JAX package's ``stockham_axis2`` over axis -2 (its XLA column
    pass), on its own radix tables."""
    import jax.numpy as jnp
    from phastft_tpu.ops.stockham import radix_tables_host, stockham_axis2

    tables = {k: tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in v)
              for k, v in radix_tables_host(n1, dtype_name).items()}
    return _g(stockham_axis2(jnp.asarray(re), jnp.asarray(im), tables, n1))


def _twiddle(n1, n2, n_total, col_base):
    k1, j = np.arange(n1)[:, None], np.arange(n2)[None, :]
    return np.exp(-2j * np.pi * ((k1 * (col_base + j)) % n_total) / n_total)


@pytest.mark.parametrize("n1", [16, 1024, 2048])
@pytest.mark.parametrize("n2", [1, 2, 4, 64])
def test_colfft_plain_narrow_matches_jax(n1, n2):
    """``colfft_plain`` at n2 = 1..64: classic on the planner's
    ``pcol{n1}x{n2}`` (n2 columns wide), the shard mode on the blocks of 4
    ranks, and the bare mode, against the JAX ``stockham_axis2`` and the
    twiddle from exact phases."""
    from phastft_tpu_torch.ops.colfft import (
        col_split_tables_host, col_tile, colfft_nocorr_plain, colfft_plain)

    rng = np.random.default_rng(n1 + n2)
    re, im = (rng.standard_normal((2, n1, n2)).astype(np.float32) for _ in range(2))
    tre, tim = torch.from_numpy(re), torch.from_numpy(im)
    base = _jax_columns(re, im, n1, "float32")
    tabs = tuple(torch.from_numpy(a)
                 for a in col_split_tables_host(n1, n2, "float32", t=col_tile(n1, n2)))
    assert tabs[0].shape == (n1, n2)  # n2 columns wide below 128
    got = _g(colfft_plain(tre, tim, tabs, n1))
    assert _rel(got, base * _twiddle(n1, n2, n1 * n2, 0)) <= COL_TOL_F32
    n_total = n1 * n2 * 4
    for r in range(4):
        got = _g(colfft_plain(tre, tim, None, n1, n_total=n_total, col_base=r * n2))
        assert _rel(got, base * _twiddle(n1, n2, n_total, r * n2)) <= COL_TOL_F32
    assert _rel(_g(colfft_nocorr_plain(tre, tim, n1)), base) <= COL_TOL_F32


@pytest.mark.parametrize("n1", [16, 1024])
@pytest.mark.parametrize("bare", [False, True])
def test_col64_plain_one_column_matches_jax(n1, bare):
    """``col64_plain`` / ``col64_nocorr_plain`` on a one-column block (the
    shard tables of column 3 of a 4-column transform) against the JAX
    ``stockham_axis2`` in f64 and the twiddle."""
    from phastft_tpu_torch.ops.native import (
        col64_nocorr_plain, col64_plain, col64_shard_tables, dif_twiddles)

    rng = np.random.default_rng(n1)
    re, im = rng.standard_normal((2, 2, n1, 1))
    tre, tim = torch.from_numpy(re), torch.from_numpy(im)
    steps = dif_twiddles(n1, torch.device("cpu"))
    base = _jax_columns(re, im, n1, "float64")
    if bare:
        got = _g(col64_nocorr_plain(tre, tim, n1, steps))
        assert _rel(got, base) <= COL_TOL_F64
        return
    tabs = col64_shard_tables(4 * n1, n1, 1, 3, torch.device("cpu"))
    assert all(tuple(t.shape) == (n1, 1) for t in tabs)
    got = _g(col64_plain(tre, tim, tabs, n1, steps))
    assert _rel(got, base * _twiddle(n1, 1, 4 * n1, 3)) <= COL_TOL_F64


@pytest.mark.parametrize("n2", [1, 8, 64])
def test_ddcol_plain_narrow_matches_jax(n2):
    """``ddcol_plain`` at n2 = 1, 8, 64 on ``dd_col_tables_host(n1, n2)``
    and ``ddcol_nocorr_plain`` at n2 = 1, against the JAX
    ``stockham_axis2_dd`` and its dd products of the same tables."""
    import jax.numpy as jnp
    from phastft_tpu.ops.df64 import dd_cmul, dd_radix_tables_host, split_hi_lo
    from phastft_tpu.ops.df64 import stockham_axis2_dd

    from phastft_tpu_torch.ops.dd import dd_col_tables_host, ddcol_nocorr_plain, ddcol_plain

    n1 = 64
    rng = np.random.default_rng(n2)
    x = rng.standard_normal((2, 3, n1, n2))
    quad = tuple(np.asarray(p, np.float32) for p in (*split_hi_lo(x[0]), *split_hi_lo(x[1])))
    t, t1, t2 = dd_col_tables_host(n1, n2)
    tq = tuple(torch.from_numpy(q.copy()) for q in quad)

    def joined(out):
        return _g((np.asarray(out[0], np.float64) + np.asarray(out[1], np.float64),
                   np.asarray(out[2], np.float64) + np.asarray(out[3], np.float64)))

    tables = {k: tuple(tuple(jnp.asarray(a) for a in e) for e in v)
              for k, v in dd_radix_tables_host(n1).items()}
    y = stockham_axis2_dd(*(jnp.asarray(q) for q in quad), tables, n1)
    view = (3, n1, n2 // t, t)
    y = tuple(a.reshape(view) for a in y)
    y = dd_cmul(*y, *(jnp.asarray(a)[:, :, None] for a in t1))
    want = dd_cmul(*y, *(jnp.asarray(a)[:, None, :] for a in t2))
    got = ddcol_plain(*tq, tuple(map(torch.from_numpy, t1)), tuple(map(torch.from_numpy, t2)),
                      n1)
    assert _rel(joined(got), joined(want).reshape(3, n1, n2)) <= COL_TOL_F64
    if n2 == 1:
        bare = tuple(stockham_axis2_dd(*(jnp.asarray(q) for q in quad), tables, n1))
        assert _rel(joined(ddcol_nocorr_plain(*tq, n1)), joined(bare)) <= COL_TOL_F64


@pytest.mark.parametrize("n1,c", [(2048, 2), (4096, 2), (1 << 13, 1)])
def test_dd_long_columns_match_numpy(n1, c):
    """``longcol.dd_columns`` at the dd column kernel's 2048 (one pass) and
    past it (the df64 leaves past 2^18: P = 64 x Q = 64, and 64 x 128 whose
    second pass is ``ddcol`` at n1 = 128): the DFT over n1 times
    W_{n1 c}^(k1*j), on the joined f64 values, against numpy."""
    from phastft_tpu_torch.ops.df64 import split_f64
    from phastft_tpu_torch.ops.longcol import dd_columns

    rng = np.random.default_rng(n1 + c)
    x = rng.standard_normal((2, n1, c)) + 1j * rng.standard_normal((2, n1, c))
    quad = [*split_f64(torch.from_numpy(x.real.copy())),
            *split_f64(torch.from_numpy(x.imag.copy()))]

    def joined(out):
        return _g((out[0].double() + out[1].double(), out[2].double() + out[3].double()))

    got = joined(dd_columns(list(quad), n1))
    want = np.fft.fft(x, axis=-2) * _twiddle(n1, c, n1 * c, 0)
    assert _rel(got, want) <= F64_NUMPY_TOL


# -- the planners' tables carried over from the JAX package ------------------

def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_np_tree(v) for v in x)
    return np.asarray(x)


@pytest.mark.parametrize("log_n,leaf", [(14, 64), (17, 1 << 17), (19, 1 << 19)])
def test_f32_tables_carry_over(log_n, leaf):
    n = 1 << log_n
    jp = phastft_tpu.PlannerDit32(n, options=phastft_tpu.Options(leaf_fft_size=leaf))
    opts = pt.Options(leaf_fft_size=leaf)
    carried = pt.PlannerDit32.from_numpy_tables(n, _np_tree(jp.leaf_corrs), device="cpu",
                                                options=opts)
    own = pt.PlannerDit32(n, options=opts, device="cpu")
    assert carried.leaf_corrs.keys() == own.leaf_corrs.keys()
    re, im = (x[:1] for x in _signal(log_n, np.float32))
    a = pt.fft_32_dit_with_planner(re, im, "f", carried)
    b = pt.fft_32_dit_with_planner(re, im, "f", own)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("log_n,leaf", [(13, 16), (17, 1 << 17)])
def test_f64_tables_carry_over(log_n, leaf):
    """The native state (fast tables and leaf_corrs) and the dd state of the
    JAX planner, carried over, give the port's own planner's result bit for
    bit in both engines."""
    n = 1 << log_n
    jp = phastft_tpu.PlannerDit64(n, options=phastft_tpu.Options(
        leaf_fft_size=leaf, f64_engine="native"))
    re, im = (x[:1] for x in _signal(log_n, np.float64))
    for engine in ("native", "df64"):
        opts = pt.Options(leaf_fft_size=leaf, f64_engine=engine)
        carried = pt.PlannerDit64.from_numpy_tables(
            n, device="cpu", options=opts, dd_state=_np_tree(jp.dd_state),
            native_state=(_np_tree(jp.fast_tables), _np_tree(jp.leaf_corrs)))
        own = pt.PlannerDit64(n, options=opts, device="cpu")
        a = pt.fft_64_dit_with_planner(re, im, "f", carried)
        b = pt.fft_64_dit_with_planner(re, im, "f", own)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
