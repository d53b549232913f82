"""The port's host tables and plans against the JAX package's.

Every table the port's planner builds must equal the JAX builder's bit for
bit, so both packages compute from the same twiddles; ``plan_rows`` and
the f32 leaf rule must give the same plans over the port's window.
"""

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


N1S = (128, 2048)
N2S = (1024, 16384)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("m", sorted({*N1S, 8, 128, *(n2 // 128 for n2 in N2S)}))
def test_dft_matrix_bitwise(m):
    from phastft_tpu.ops.mxu import dft_matrix_host as jax_dft

    from phastft_tpu_torch.ops.mxu import dft_matrix_host

    _same(dft_matrix_host(m, "float32"), jax_dft(m, "float32"))


@pytest.mark.parametrize("n2", N2S)
def test_leaf_correction_bitwise(n2):
    from phastft_tpu.ops.stockham import leaf_correction_host as jax_corr

    from phastft_tpu_torch.ops.stockham import leaf_correction_host

    a = n2 // 128
    _same(leaf_correction_host(a, 128, "float32"),
          jax_corr(a, 128, "float32"))


@pytest.mark.parametrize("n1", N1S)
@pytest.mark.parametrize("n2", N2S)
def test_col_split_tables_bitwise(n1, n2):
    from phastft_tpu.ops import pallas_col

    from phastft_tpu_torch.ops import colfft

    t = colfft.col_tile3d(n1, n2)
    assert t == pallas_col.col_tile3d(n1, n2)
    _same(colfft.col_split_tables_host(n1, n2, "float32", t=t),
          pallas_col.col_split_tables_host(n1, n2, "float32", t=t))


@pytest.mark.parametrize("n2", N2S)
def test_leaft_tables_bitwise(n2):
    from phastft_tpu.ops.pallas_leaft import leaft_tables_host as jax_leaft

    from phastft_tpu_torch.ops.leaft import leaft_tables_host

    _same(leaft_tables_host(n2, "float32"), jax_leaft(n2, "float32"))


@pytest.mark.parametrize("log_n", range(17, 26))
def test_plans_match(log_n):
    from phastft_tpu.ops.fourstep import plan_rows as jax_plan
    from phastft_tpu.options import Options as JaxOptions

    from phastft_tpu_torch.ops.fourstep import plan_rows
    from phastft_tpu_torch.options import Options

    n = 1 << log_n
    leaf = Options.guess_options(n, np.float32).leaf_fft_size
    assert leaf == JaxOptions.guess_options(n, np.float32).leaf_fft_size
    plan = plan_rows(n, leaf)
    assert plan == jax_plan(n, leaf)
    # the slice's one plan shape: one split over a leaf, fused-two-pass gates
    kind, n1, inner, n2 = plan
    assert kind == "split" and inner[0] == "leaf"
    assert 128 <= n1 <= 2048 and 8 <= n2 // 128 <= 128


@pytest.mark.parametrize("log_n", range(26, 31))
def test_nested_plans_match(log_n):
    """The default plans of 2^26..2^30: one classic outer level around the
    fused 128 x 2^14 level, the same in both packages."""
    from phastft_tpu.ops.fourstep import plan_rows as jax_plan
    from phastft_tpu.options import Options as JaxOptions

    from phastft_tpu_torch.ops.fourstep import (
        fused_two_pass, plan_rows, split_levels,
    )
    from phastft_tpu_torch.options import Options

    n = 1 << log_n
    leaf = Options.guess_options(n, np.float32).leaf_fft_size
    assert leaf == JaxOptions.guess_options(n, np.float32).leaf_fft_size == 1 << 14
    plan = plan_rows(n, leaf)
    assert plan == jax_plan(n, leaf)
    inner = ("split", 128, ("leaf", 128), 1 << 14)
    assert plan == ("split", n >> 21, inner, 1 << 21)
    assert [fused_two_pass(*lv) for lv in split_levels(plan)] == [False, True]


@pytest.mark.parametrize("n1,n2", [(2, 1 << 16), (32, 1 << 21), (512, 1 << 21),
                                   (2048, 128)])
def test_col_split_tables_classic_bitwise(n1, n2):
    """The classic mode's T2 table is factored on col_tile, the JAX
    function's default width."""
    from phastft_tpu.ops import pallas_col

    from phastft_tpu_torch.ops import colfft

    t = colfft.col_tile(n1, n2)
    assert t == pallas_col.col_tile(n1, n2)
    _same(colfft.col_split_tables_host(n1, n2, "float32", t=t),
          pallas_col.col_split_tables_host(n1, n2, "float32"))


def test_nested_planner_tables():
    """A default nested planner (2^26) holds the classic outer table and
    the fused inner tables, and no leaf table: `leaft` has its own."""
    from phastft_tpu_torch import PlannerDit32

    mine = PlannerDit32(1 << 26, device="cpu")
    assert set(mine.leaf_corrs) == {"pcol32x2097152", "pcolT128x16384",
                                    "leafT16384"}
    assert tuple(mine.leaf_corrs["pcol32x2097152"][0].shape) == (32, 512)


def test_planner_tables_match_jax_planner():
    """The port's planner holds exactly the JAX planner's two-pass tables."""
    from phastft_tpu.planner import PlannerDit32 as JaxPlanner

    from phastft_tpu_torch import PlannerDit32

    n = 1 << 18
    mine = PlannerDit32(n, device="cpu")
    ref = JaxPlanner(n).leaf_corrs
    assert mine.plan == JaxPlanner(n).plan
    assert set(mine.leaf_corrs) == {"pcolT128x2048", "leafT2048"}
    for key, arrays in mine.leaf_corrs.items():
        _same([a.numpy() for a in arrays], [np.asarray(a) for a in ref[key]])


# -- the leaf plans (n <= 2^16) ----------------------------------------------

@pytest.mark.parametrize("n2", (*N2S, 256, 1 << 15, 1 << 16))
def test_leaf_correction_leaf_sizes_bitwise(n2):
    """leaf_correction_host at the leaf plans' (n1, 128), n1 = 2, 256 and
    512 (the hybrid leaf's, which the JAX package takes from C++), as well
    as the row pass's (A, 128)."""
    from phastft_tpu.ops.stockham import leaf_correction_host as jax_corr

    from phastft_tpu_torch.ops.stockham import leaf_correction_host

    n1 = n2 // 128
    _same(leaf_correction_host(n1, 128, "float32"),
          jax_corr(n1, 128, "float32"))


@pytest.mark.parametrize("n1", [1, 2, 32, 256])
def test_mxu_leaf_tables_bitwise(n1):
    from phastft_tpu.ops.mxu import mxu_leaf_tables_host as jax_tables

    from phastft_tpu_torch.ops.mxu import mxu_leaf_tables_host

    got, want = mxu_leaf_tables_host(n1, "float32"), jax_tables(n1, "float32")
    # (F(n1), F(128), correction); F(n1) and the correction are None at 1
    assert [g is None for g in got] == [n1 == 1, False, n1 == 1]
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _same(g, w)


@pytest.mark.parametrize("a,b", [(8, 8), (128, 128)])
def test_mxu_leaf_tables3_bitwise(a, b):
    from phastft_tpu.ops.mxu import mxu_leaf_tables3_host as jax_tables

    from phastft_tpu_torch.ops.mxu import mxu_leaf_tables3_host

    _same(mxu_leaf_tables3_host(a, b, "float32"), jax_tables(a, b, "float32"))


@pytest.mark.parametrize("log_n", range(0, 17))
def test_leaf_plans_match(log_n):
    from phastft_tpu.ops.fourstep import plan_rows as jax_plan
    from phastft_tpu.options import Options as JaxOptions

    from phastft_tpu_torch.ops.fourstep import plan_rows
    from phastft_tpu_torch.options import Options

    n = 1 << log_n
    leaf = Options.guess_options(n, np.float32).leaf_fft_size
    assert leaf == JaxOptions.guess_options(n, np.float32).leaf_fft_size
    plan = plan_rows(n, leaf)
    assert plan == jax_plan(n, leaf)
    assert plan == (("tiny", n) if n < 128 else ("leaf", n // 128))


@pytest.mark.parametrize("log_n", [7, 8, 15, 16])
def test_leaf_planner_tables_match_jax_planner(log_n):
    """The port's planner holds, under the JAX planner's keys, exactly the
    tables its leaf kernel reads, equal to the JAX planner's bit for bit."""
    from phastft_tpu.planner import PlannerDit32 as JaxPlanner

    from phastft_tpu_torch import PlannerDit32

    n = 1 << log_n
    n1 = n // 128
    mine = PlannerDit32(n, device="cpu")
    ref = JaxPlanner(n)
    assert mine.plan == ref.plan == ("leaf", n1)
    want = ({f"mxu3_{n1}"} if log_n == 16
            else {f"mxu{n1}"} | ({f"leaf{n1}"} if n1 > 1 else set()))
    assert set(mine.leaf_corrs) == want
    for key, arrays in mine.leaf_corrs.items():
        _same([a.numpy() for a in arrays],
              [np.asarray(a) for a in ref.leaf_corrs[key]])


def test_tiny_planner_has_no_tables():
    from phastft_tpu_torch import PlannerDit32

    for n in (1, 2, 64):
        assert PlannerDit32(n, device="cpu").leaf_corrs == {}


# -- the df64 engine's host tables and the f64 planner --------------------------

def _same_nested(got, want):
    """Equal bit for bit through any nesting of tuples."""
    if isinstance(want, np.ndarray) or hasattr(want, "dtype"):
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_nested(g, w)


def test_split_hi_lo_bitwise():
    from phastft_tpu.ops import df64 as jax_df64

    from phastft_tpu_torch.ops import df64

    x = np.random.default_rng(0).standard_normal(4096) * 1e3
    _same(df64.split_hi_lo(x), jax_df64.split_hi_lo(x))
    hi, lo = df64.split_hi_lo(x)
    assert hi.dtype == lo.dtype == np.float32
    assert np.max(np.abs(df64.join_hi_lo(hi, lo) - x) / np.abs(x)) <= 2.0 ** -47


@pytest.mark.parametrize("m", [8, 128, 2048])
def test_radix_schedule_and_dd_radix_tables_bitwise(m):
    from phastft_tpu.ops import df64 as jax_df64
    from phastft_tpu.ops.stockham import radix_schedule as jax_schedule

    from phastft_tpu_torch.ops import df64
    from phastft_tpu_torch.ops.stockham import radix_schedule

    assert radix_schedule(m) == jax_schedule(m)
    assert radix_schedule(m, 4) == jax_schedule(m, 4)
    mine, ref = df64.dd_radix_tables_host(m), jax_df64.dd_radix_tables_host(m)
    assert set(mine) == set(ref)
    for key in ref:
        _same_nested(mine[key], ref[key])


@pytest.mark.parametrize("n1,n2", [(2, 128), (64, 128), (16, 256),
                                   (256, 1 << 16), (2048, 1 << 13)])
def test_dd_correction_tables_bitwise(n1, n2):
    from phastft_tpu.ops import df64 as jax_df64
    from phastft_tpu.ops import pallas_dd

    from phastft_tpu_torch.ops import dd, df64

    _same(df64.dd_leaf_correction_host(n1, 128),
          jax_df64.dd_leaf_correction_host(n1, 128))
    s, t1, t2 = df64.dd_split_correction_host(n1, n2)
    rs, r1, r2 = jax_df64.dd_split_correction_host(n1, n2)
    assert s == rs
    _same(t1, r1)
    _same(t2, r2)
    t, p1, p2 = dd.dd_col_tables_host(n1, n2)
    rt, q1, q2 = pallas_dd.dd_col_tables_host(n1, n2)
    assert t == rt == min(dd.DD_COL_TILE, n2) == min(pallas_dd.DD_COL_TILE, n2)
    _same(p1, q1)
    _same(p2, q2)


@pytest.mark.parametrize("log_n", [0, 5, 7, 8, 13, 14, 21, 22, 24, 27, 28, 30])
def test_f64_plans_match(log_n):
    """The f64 leaf rule and the plans it gives equal the JAX package's
    (whose f64 leaf is 2^13 inside its Ozaki window too); the port's f64
    default engine is the native one (None) at every n, as the H100 race
    decided."""
    from phastft_tpu.ops.fourstep import plan_rows as jax_plan
    from phastft_tpu.options import Options as JaxOptions

    from phastft_tpu_torch.ops.fourstep import plan_rows
    from phastft_tpu_torch.options import Options

    n = 1 << log_n
    opts = Options.guess_options(n, np.float64)
    assert opts.f64_engine is None
    ref = JaxOptions.guess_options(n, np.float64)
    if not 20 <= log_n <= 24:  # there the JAX rule is the Ozaki kernels' 2^13
        assert opts.leaf_fft_size == ref.leaf_fft_size
    want = (1 << 13) if log_n <= 21 else (1 << 16)
    assert opts.leaf_fft_size == min(max(n, 256), want)
    assert plan_rows(n, opts.leaf_fft_size) == jax_plan(n, opts.leaf_fft_size)


def _jax_dd_state_numpy(n, leaf=None):
    import phastft_tpu

    kw = {}
    if leaf is not None:
        kw["options"] = phastft_tpu.Options(leaf_fft_size=leaf)
    jp = phastft_tpu.PlannerDit64(n, **kw)
    tables, corrs = jp.dd_state

    def conv(v):
        return tuple(conv(x) for x in v) if isinstance(v, tuple) else np.asarray(v)

    return (jp, {k: conv(v) for k, v in tables.items()},
            {k: conv(v) for k, v in corrs.items()})


@pytest.mark.parametrize("log_n,corr_keys", [
    (5, set()), (11, {"ddleaf16"}), (15, {"ddleaf64", "ddpcol4x8192"})])
def test_planner64_dd_state_matches_jax(log_n, corr_keys):
    """PlannerDit64.dd_state holds what the transform reads (a tiny plan's
    radix tables, else the plan's leaf and split corrections) under the
    JAX planner's keys, its arrays bit for bit, as f32 tensors on the
    planner's device."""
    import torch

    from phastft_tpu_torch import PlannerDit64

    n = 1 << log_n
    jp, jtables, jcorrs = _jax_dd_state_numpy(n)
    planner = PlannerDit64(n, device="cpu")
    assert planner.plan == jp.plan
    assert planner.options.f64_engine is None  # native; dd_state on demand
    tables, corrs = planner.dd_state
    assert planner.dd_state is planner.dd_state  # built once
    assert set(tables) == (set(jtables) if planner.plan[0] == "tiny" else set())
    assert set(corrs) == corr_keys <= set(jcorrs)

    def conv(v):
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        assert isinstance(v, torch.Tensor) and v.dtype == torch.float32
        assert v.device.type == "cpu"
        return v.numpy()

    for key in tables:
        _same_nested(conv(tables[key]), jtables[key])
    for key in corrs:
        _same_nested(conv(corrs[key]), jcorrs[key])


def test_planner64_from_numpy_tables():
    """from_numpy_tables carries the JAX planner's dd_state across, takes
    only what the plan reads, and refuses a missing key, a wrong shape and
    a non-f32 array."""
    import torch

    from phastft_tpu_torch import PlannerDit64

    n = 1 << 15
    jp, jtables, jcorrs = _jax_dd_state_numpy(n)
    carried = PlannerDit64.from_numpy_tables(n, (jtables, jcorrs), device="cpu")
    own = PlannerDit64(n, device="cpu")
    assert carried.plan == own.plan == jp.plan == ("split", 4, ("leaf", 64), 8192)
    ctab, ccorr = carried.dd_state
    otab, ocorr = own.dd_state
    assert ctab == otab == {}
    assert set(ccorr) == set(ocorr) == {"ddleaf64", "ddpcol4x8192"}
    for key in ocorr:
        flat_c = [a for half in ccorr[key] for a in
                  (half if isinstance(half, tuple) else (half,))]
        flat_o = [a for half in ocorr[key] for a in
                  (half if isinstance(half, tuple) else (half,))]
        assert all(torch.equal(a, b) for a, b in zip(flat_c, flat_o))

    # what the transform never reads is not required
    needed = {k: jcorrs[k] for k in ("ddleaf64", "ddpcol4x8192")}
    PlannerDit64.from_numpy_tables(n, ({}, needed), device="cpu")
    missing = {k: v for k, v in jcorrs.items() if k != "ddpcol4x8192"}
    with pytest.raises(KeyError, match="ddpcol4x8192"):
        PlannerDit64.from_numpy_tables(n, (jtables, missing), device="cpu")
    bad = dict(jcorrs)
    bad["ddleaf64"] = tuple(a[:, :64] for a in jcorrs["ddleaf64"])
    with pytest.raises(ValueError, match="ddleaf64"):
        PlannerDit64.from_numpy_tables(n, (jtables, bad), device="cpu")
    bad = dict(jcorrs)
    bad["ddleaf64"] = tuple(a.astype(np.float64) for a in jcorrs["ddleaf64"])
    with pytest.raises(TypeError, match="float32"):
        PlannerDit64.from_numpy_tables(n, (jtables, bad), device="cpu")

    # a tiny plan reads the radix tables and nothing else
    _, ttables, tcorrs = _jax_dd_state_numpy(32)
    tiny = PlannerDit64.from_numpy_tables(32, (ttables, {}), device="cpu")
    assert set(tiny.dd_state[0]) == set(ttables) and tiny.dd_state[1] == {}
    with pytest.raises(KeyError):
        PlannerDit64.from_numpy_tables(32, ({}, tcorrs), device="cpu")
