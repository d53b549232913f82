"""The port's host tables and plans against the JAX package's.

Every table the port's planner builds must equal the JAX builder's bit for
bit, so both packages compute from the same twiddles; ``plan_rows`` and
the f32 leaf rule must give the same plans over the port's window.
"""

import numpy as np
import pytest

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

@pytest.mark.parametrize("n2", (*N2S, 256, 1 << 15))
def test_leaf_correction_leaf_sizes_bitwise(n2):
    """leaf_correction_host at the leaf plans' (n1, 128), n1 = 2 and 256, as
    well as the row pass's (A, 128)."""
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
