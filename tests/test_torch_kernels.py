"""The port's kernel modules against the Pallas kernels they replace.

On the CPU each wrapper runs its plain torch version; the JAX side runs
its Pallas kernel in interpret mode, as tests/test_pallas_leaft.py does.
Both get the same numpy inputs and the same host tables. The two sum in
different orders (the Pallas engines factor F(n1) and F(A) otherwise), so
they agree to f32 rounding: rel L2 <= 1e-6.
"""

import numpy as np
import pytest
import torch

TOL = 1e-6


def _run_interpret(fn, *args, **kw):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return fn(*args, **kw)


def _rel(got, want):
    g = np.asarray(got[0], np.float64) + 1j * np.asarray(got[1], np.float64)
    w = np.asarray(want[0], np.float64) + 1j * np.asarray(want[1], np.float64)
    assert g.shape == w.shape
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def _pair(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("n1,n2,b", [(128, 1024, None), (256, 1024, 2)])
def test_colfft_plain_matches_pallas(n1, n2, b):
    import jax.numpy as jnp
    from phastft_tpu.ops import pallas_col

    from phastft_tpu_torch.ops import colfft

    rng = np.random.default_rng(n1 + n2)
    shape = ((b,) if b else ()) + (n1, n2)
    re, im = _pair(rng, shape)
    host = colfft.col_split_tables_host(n1, n2, "float32",
                                        t=colfft.col_tile3d(n1, n2))
    want = _run_interpret(
        pallas_col.colfft_pallas, jnp.asarray(re), jnp.asarray(im),
        tuple(jnp.asarray(a) for a in host), n1, out3d=True,
    )
    before = colfft.colfft_out3d.launches
    got = colfft.colfft_out3d(torch.from_numpy(re), torch.from_numpy(im),
                              tuple(torch.from_numpy(a) for a in host), n1)
    assert colfft.colfft_out3d.launches == before  # CPU: no kernel launch
    assert tuple(got[0].shape) == shape[:-2] + (n2 // 128, n1, 128)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("n1,n2,b", [(32, 1024, None), (256, 1024, None),
                                     (8, 512, 3), (1024, 256, None)])
def test_colfft_classic_plain_matches_pallas(n1, n2, b):
    """colfft against colfft_pallas(..., out3d=False) at each depth's
    default engine: dense (n1 < 128), radix-4, radix-16 (n1 >= 1024)."""
    import jax.numpy as jnp
    from phastft_tpu.ops import pallas_col

    from phastft_tpu_torch.ops import colfft

    rng = np.random.default_rng(n1 * 7 + n2)
    shape = ((b,) if b else ()) + (n1, n2)
    re, im = _pair(rng, shape)
    t = colfft.col_tile(n1, n2)
    assert t == pallas_col.col_tile(n1, n2)
    host = colfft.col_split_tables_host(n1, n2, "float32", t=t)
    for mine, ref in zip(host,
                         pallas_col.col_split_tables_host(n1, n2, "float32")):
        assert np.array_equal(mine, ref)
    want = _run_interpret(
        pallas_col.colfft_pallas, jnp.asarray(re), jnp.asarray(im),
        tuple(jnp.asarray(a) for a in host), n1,
    )
    before = colfft.colfft.launches
    got = colfft.colfft(torch.from_numpy(re), torch.from_numpy(im),
                        tuple(torch.from_numpy(a) for a in host), n1)
    assert colfft.colfft.launches == before  # CPU: no kernel launch
    assert tuple(got[0].shape) == shape
    assert _rel(got, want) <= TOL


def _col_oracle(re, im, n1, n2):
    """Column DFT over axis -2 times the split twiddle, in f64."""
    z = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-2)
    k1 = np.arange(n1)[:, None]
    i2 = np.arange(n2)[None, :]
    z = z * np.exp(-2j * np.pi * ((k1 * i2) % (n1 * n2)) / (n1 * n2))
    return z.real, z.imag


@pytest.mark.parametrize("n1,n2", [(2, 256), (4, 128), (2048, 128)])
def test_colfft_plain_matches_oracle(n1, n2):
    """The column factors outside the TPU kernel's window (it declines
    n1 < 8) and the deepest one, against an f64 oracle."""
    import jax.numpy as jnp
    from phastft_tpu.ops import pallas_col

    from phastft_tpu_torch.ops.colfft import (
        col_split_tables_host, col_tile, colfft,
    )

    rng = np.random.default_rng(n1 + n2)
    re, im = _pair(rng, (2, n1, n2))
    host = col_split_tables_host(n1, n2, "float32", t=col_tile(n1, n2))
    if n1 < 8:
        assert pallas_col.colfft_pallas(
            jnp.asarray(re), jnp.asarray(im),
            tuple(jnp.asarray(a) for a in host), n1) is None
    got = colfft(torch.from_numpy(re), torch.from_numpy(im),
                 tuple(torch.from_numpy(a) for a in host), n1)
    assert _rel(got, _col_oracle(re, im, n1, n2)) <= 5e-7


@pytest.mark.parametrize("rows,cols", [(512, 256), (256, 1024), (64, 512)])
def test_transpose2_plain_matches_pallas(rows, cols):
    import jax.numpy as jnp
    from phastft_tpu.ops.pallas_transpose import transpose2_pallas

    from phastft_tpu_torch.ops import transpose

    rng = np.random.default_rng(rows + cols)
    a, b = _pair(rng, (rows, cols))
    want = _run_interpret(transpose2_pallas, jnp.asarray(a), jnp.asarray(b))
    before = transpose.transpose2.launches
    got = transpose.transpose2(torch.from_numpy(a), torch.from_numpy(b))
    assert transpose.transpose2.launches == before  # CPU: no kernel launch
    for g, w in zip(got, want):
        assert g.is_contiguous() and tuple(g.shape) == (cols, rows)
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", [(3, 2, 64), (2, 5, 32, 1), (1, 128)])
def test_transpose2_batch_and_thin_shapes(shape):
    """Leading batch dims and R or C below any tile, which the TPU kernel
    does not take (it is unbatched): equal to numpy bit for bit."""
    from phastft_tpu_torch.ops.transpose import transpose2, transpose2_plain

    rng = np.random.default_rng(len(shape))
    a, b = _pair(rng, shape)
    for fn in (transpose2, transpose2_plain):
        got = fn(torch.from_numpy(a), torch.from_numpy(b))
        assert np.array_equal(got[0].numpy(), np.swapaxes(a, -1, -2))
        assert np.array_equal(got[1].numpy(), np.swapaxes(b, -1, -2))


@pytest.mark.parametrize("n1,leaf_n1", [(16, 4), (2, 512), (32, 1)])
def test_classic_pipeline_matches_numpy(n1, leaf_n1):
    """colfft -> leaf rows -> transpose2 is the whole length-n transform:
    the classic branch, module by module."""
    from phastft_tpu_torch.ops.colfft import (
        col_split_tables_host, col_tile, colfft,
    )
    from phastft_tpu_torch.ops.fourstep import fft_rows
    from phastft_tpu_torch.ops.transpose import transpose2
    from phastft_tpu_torch.planner import PlannerDit32

    n2 = leaf_n1 * 128
    rng = np.random.default_rng(n1 + leaf_n1)
    re, im = _pair(rng, (2, n1 * n2))
    tabs = tuple(torch.from_numpy(a) for a in
                 col_split_tables_host(n1, n2, "float32", t=col_tile(n1, n2)))
    rows = PlannerDit32(n2, device="cpu")
    view = (2, n1, n2)
    c = colfft(torch.from_numpy(re).view(view), torch.from_numpy(im).view(view),
               tabs, n1)
    d = fft_rows(c[0], c[1], rows.plan, rows.leaf_corrs)
    o = transpose2(d[0], d[1])
    got = (o[0].reshape(2, -1), o[1].reshape(2, -1))
    want = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1)
    assert _rel(got, (want.real, want.imag)) <= 5e-7


@pytest.mark.parametrize("n1,n2,b", [(128, 1024, None), (128, 2048, 2)])
def test_leaft_plain_matches_pallas(n1, n2, b):
    import jax.numpy as jnp
    from phastft_tpu.ops.pallas_leaft import leaft_pallas

    from phastft_tpu_torch.ops import leaft as leaft_mod

    a = n2 // 128
    rng = np.random.default_rng(a + n1)
    shape = ((b,) if b else ()) + (a, n1, 128)
    cre, cim = _pair(rng, shape)
    host = leaft_mod.leaft_tables_host(n2, "float32")
    want = _run_interpret(
        leaft_pallas, jnp.asarray(cre), jnp.asarray(cim),
        tuple(jnp.asarray(x) for x in host), n1, engine="dense",
    )
    before = leaft_mod.leaft.launches
    got = leaft_mod.leaft(torch.from_numpy(cre), torch.from_numpy(cim),
                          tuple(torch.from_numpy(x) for x in host), n1)
    assert leaft_mod.leaft.launches == before
    assert tuple(got[0].shape) == shape[:-3] + (a * 128 * n1,)
    assert _rel(got, want) <= TOL


def test_col_out3d_layout():
    """out3d landing spots: column block j of the (n1, n2) result is the
    (j, n1, 128) slab of the 3-d layout, checked against an f64 oracle of
    the column DFT times the split twiddle."""
    from phastft_tpu_torch.ops import colfft

    n1, n2 = 16, 512
    n = n1 * n2
    rng = np.random.default_rng(3)
    re, im = _pair(rng, (n1, n2))
    tabs = tuple(torch.from_numpy(a)
                 for a in colfft.col_split_tables_host(n1, n2, "float32"))
    c3 = colfft.colfft_out3d(torch.from_numpy(re), torch.from_numpy(im),
                             tabs, n1)
    assert tuple(c3[0].shape) == (n2 // 128, n1, 128)
    k1 = np.arange(n1)[:, None]
    i2 = np.arange(n2)[None, :]
    flat = np.fft.fft(re.astype(np.float64) + 1j * im, axis=0)
    flat = flat * np.exp(-2j * np.pi * ((k1 * i2) % n) / n)
    want = np.transpose(flat.reshape(n1, n2 // 128, 128), (1, 0, 2))
    np.testing.assert_allclose(c3[0].numpy(), want.real, rtol=0, atol=1e-4)
    np.testing.assert_allclose(c3[1].numpy(), want.imag, rtol=0, atol=1e-4)


def test_two_pass_matches_numpy():
    """colfft_out3d -> leaft is the whole length-n transform of each row."""
    from phastft_tpu_torch.ops.colfft import (
        col_split_tables_host, col_tile3d, colfft_out3d,
    )
    from phastft_tpu_torch.ops.leaft import leaft, leaft_tables_host

    n1, n2, b = 128, 1024, 2
    rng = np.random.default_rng(11)
    re, im = _pair(rng, (b, n1 * n2))
    tabs = tuple(torch.from_numpy(a) for a in
                 col_split_tables_host(n1, n2, "float32", t=col_tile3d(n1, n2)))
    mats = tuple(torch.from_numpy(a) for a in leaft_tables_host(n2))
    view = (b, n1, n2)
    c3 = colfft_out3d(torch.from_numpy(re).view(view),
                      torch.from_numpy(im).view(view), tabs, n1)
    got = leaft(c3[0], c3[1], mats, n1)
    want = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1)
    assert _rel(got, (want.real, want.imag)) <= 5e-7


@pytest.mark.parametrize("bad", ["dtype", "shape", "tables"])
def test_wrappers_reject_bad_arguments(bad):
    from phastft_tpu_torch.ops.colfft import col_split_tables_host, colfft_out3d
    from phastft_tpu_torch.ops.leaft import leaft, leaft_tables_host

    n1, n2 = 128, 1024
    x = torch.zeros(n1, n2)
    tabs = tuple(torch.from_numpy(a)
                 for a in col_split_tables_host(n1, n2, "float32"))
    c = torch.zeros(n2 // 128, n1, 128)
    mats = tuple(torch.from_numpy(a) for a in leaft_tables_host(n2))
    if bad == "dtype":
        with pytest.raises(TypeError):
            colfft_out3d(x.double(), x.double(), tabs, n1)
        with pytest.raises(TypeError):
            leaft(c.double(), c.double(), mats, n1)
    elif bad == "shape":
        with pytest.raises(ValueError):
            colfft_out3d(x, x[:, :512], tabs, n1)
        with pytest.raises(ValueError):
            leaft(c, c, mats, n1 // 2)
    else:
        with pytest.raises(ValueError):
            colfft_out3d(x, x, (tabs[0][:, :128], tabs[1][:, :128]), n1)
        with pytest.raises(ValueError):
            leaft(c, c, mats[:6], n1)


@pytest.mark.parametrize("bad", ["dtype", "shape", "tables", "device"])
def test_classic_wrappers_reject_bad_arguments(bad):
    from phastft_tpu_torch.ops.colfft import (
        col_split_tables_host, col_tile, colfft,
    )
    from phastft_tpu_torch.ops.transpose import transpose2

    n1, n2 = 32, 256
    x = torch.zeros(n1, n2)
    tabs = tuple(torch.from_numpy(a) for a in
                 col_split_tables_host(n1, n2, "float32", t=col_tile(n1, n2)))
    if bad == "dtype":
        with pytest.raises(TypeError):
            colfft(x.double(), x.double(), tabs, n1)
        with pytest.raises(TypeError):
            transpose2(x.double(), x.double())
    elif bad == "shape":
        with pytest.raises(ValueError):
            colfft(x, x[:, :128], tabs, n1)
        with pytest.raises(ValueError):  # n2 below the kernel's 128 columns
            colfft(x[:, :64], x[:, :64], tabs, n1)
        with pytest.raises(ValueError):
            transpose2(x, x[:, :128])
        with pytest.raises(ValueError):  # not a power of two
            transpose2(x[:, :96], x[:, :96])
    elif bad == "tables":
        with pytest.raises(ValueError):
            colfft(x, x, (tabs[0][:, :128], tabs[1][:, :128]), n1)
        with pytest.raises(ValueError):
            colfft(x, x, tabs[:1], n1)
    else:
        with pytest.raises(ValueError, match="device"):
            colfft(x.to("meta"), x.to("meta"),
                   tuple(t.to("meta") for t in tabs), n1)
        with pytest.raises(ValueError, match="device"):
            transpose2(x.to("meta"), x.to("meta"))


# -- the leaf kernels (n <= 2^16) -------------------------------------------

def _oracle(re, im):
    want = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1)
    return want.real, want.imag


@pytest.mark.parametrize("n1,rows", [(16, 4), (16, 2), (4, 8), (4, 9)])
def test_leaf_plain_matches_pallas(n1, rows):
    """leaf_plain against leaf_fft_pallas on the JAX planner's tables. At 9
    rows the TPU kernel declines the batch (it does not tile by 4) and the
    JAX package runs leaf_fft_mxu: the port's leaf takes it."""
    import jax.numpy as jnp
    from phastft_tpu.ops.mxu import leaf_fft_mxu
    from phastft_tpu.ops.pallas_leaf import leaf_fft_pallas
    from phastft_tpu.planner import PlannerDit32 as JaxPlanner

    from phastft_tpu_torch.ops import leaf as leaf_mod

    n = n1 * 128
    corrs = JaxPlanner(n).leaf_corrs
    pmats = corrs[f"mxu{n1}"][:6] + corrs[f"leaf{n1}"]
    rng = np.random.default_rng(n1 * 10 + rows)
    re, im = _pair(rng, (rows, n))
    want = _run_interpret(leaf_fft_pallas, jnp.asarray(re), jnp.asarray(im),
                          pmats, n1)
    if rows == 9:
        assert want is None
        want = leaf_fft_mxu(jnp.asarray(re), jnp.asarray(im),
                            corrs[f"mxu{n1}"], n1)
    before = leaf_mod.leaf.launches
    got = leaf_mod.leaf(torch.from_numpy(re), torch.from_numpy(im),
                        tuple(torch.from_numpy(np.array(a)) for a in pmats),
                        n1)
    assert leaf_mod.leaf.launches == before  # CPU: no kernel launch
    assert tuple(got[0].shape) == (rows, n)
    assert _rel(got, want) <= TOL
    assert _rel(got, _oracle(re, im)) <= 5e-7


def test_leaf_plain_n1_1_matches_mxu_leaf():
    """n = 128: one F(128) on the JAX planner's mxu1 (zero-size F(1) and
    correction placeholders), against leaf_fft_mxu."""
    import jax.numpy as jnp
    from phastft_tpu.ops.mxu import leaf_fft_mxu
    from phastft_tpu.planner import PlannerDit32 as JaxPlanner

    from phastft_tpu_torch.ops.leaf import leaf

    mats = JaxPlanner(128).leaf_corrs["mxu1"]
    rng = np.random.default_rng(1)
    re, im = _pair(rng, (3, 128))
    want = leaf_fft_mxu(jnp.asarray(re), jnp.asarray(im), mats, 1)
    got = leaf(torch.from_numpy(re), torch.from_numpy(im),
               tuple(torch.from_numpy(np.array(a)) for a in mats), 1)
    assert _rel(got, want) <= TOL
    assert _rel(got, _oracle(re, im)) <= 5e-7


@pytest.mark.parametrize("log_n", [1, 3, 6])
def test_leaf_plain_tiny_matches_tiny_fft(log_n):
    """n < 128, no tables: one dense F(n), against the JAX tiny_fft."""
    import jax.numpy as jnp
    from phastft_tpu.ops.stockham import tiny_fft
    from phastft_tpu.planner import PlannerDit32 as JaxPlanner

    from phastft_tpu_torch.ops.leaf import leaf

    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    re, im = _pair(rng, (5, n))
    want = tiny_fft(jnp.asarray(re), jnp.asarray(im),
                    JaxPlanner(n).fast_tables, n)
    got = leaf(torch.from_numpy(re), torch.from_numpy(im), (), 1)
    assert _rel(got, want) <= TOL
    assert _rel(got, _oracle(re, im)) <= 5e-7


@pytest.mark.parametrize("a,b,rows", [(8, 8, 4), (16, 8, 2), (8, 16, 3),
                                      (128, 128, 4)])
def test_leaf3_plain_matches_pallas(a, b, rows):
    import jax.numpy as jnp
    from phastft_tpu.ops.pallas_leaf import leaf_fft_pallas3

    from phastft_tpu_torch.ops import leaf as leaf_mod
    from phastft_tpu_torch.ops.mxu import mxu_leaf_tables3_host

    n = a * 4 * b
    host = mxu_leaf_tables3_host(a, b, "float32")
    rng = np.random.default_rng(a * 31 + b + rows)
    re, im = _pair(rng, (rows, n))
    want = _run_interpret(leaf_fft_pallas3, jnp.asarray(re), jnp.asarray(im),
                          tuple(jnp.asarray(t) for t in host), a, b)
    before = leaf_mod.leaf3.launches
    got = leaf_mod.leaf3(torch.from_numpy(re), torch.from_numpy(im),
                         tuple(torch.from_numpy(t) for t in host), a, b)
    assert leaf_mod.leaf3.launches == before
    assert tuple(got[0].shape) == (rows, n)
    assert _rel(got, want) <= TOL
    # the bound of tests/test_pallas_leaf.py: 5e-6 at the small (a, b)
    assert _rel(got, _oracle(re, im)) <= (5e-7 if a == 128 else 5e-6)


@pytest.mark.parametrize("bad", ["dtype", "shape", "tables", "device"])
def test_leaf_wrappers_reject_bad_arguments(bad):
    from phastft_tpu_torch.ops.leaf import leaf, leaf3
    from phastft_tpu_torch.ops.mxu import mxu_leaf_tables3_host
    from phastft_tpu_torch.planner import PlannerDit32

    n1 = 4
    x = torch.zeros(2, n1 * 128)
    corrs = PlannerDit32(n1 * 128, device="cpu").leaf_corrs
    mats = corrs[f"mxu{n1}"][:6] + corrs[f"leaf{n1}"]
    x3 = torch.zeros(2, 8 * 4 * 8)
    mats3 = tuple(torch.from_numpy(t) for t in mxu_leaf_tables3_host(8, 8, "float32"))
    if bad == "dtype":
        with pytest.raises(TypeError):
            leaf(x.double(), x.double(), mats, n1)
        with pytest.raises(TypeError):
            leaf3(x3.double(), x3.double(), mats3, 8, 8)
    elif bad == "shape":
        with pytest.raises(ValueError):
            leaf(x, x, mats, n1 * 2)
        with pytest.raises(ValueError):
            leaf(torch.zeros(2, 128 * 512), torch.zeros(2, 128 * 512), mats, 512)
        with pytest.raises(ValueError):
            leaf(torch.zeros(3, 1), torch.zeros(3, 1), (), 1)  # n = 1: a copy
        with pytest.raises(ValueError):
            leaf3(x3, x3[:, :128], mats3, 8, 8)
    elif bad == "tables":
        with pytest.raises(ValueError):
            leaf(x, x, mats[:6], n1)
        with pytest.raises(ValueError):
            leaf(x, x, (), n1)
        with pytest.raises(ValueError):
            leaf3(x3, x3, mats3[:8], 8, 8)
    else:
        with pytest.raises(ValueError, match="device"):
            leaf(x.to("meta"), x.to("meta"), tuple(t.to("meta") for t in mats), n1)
        with pytest.raises(ValueError, match="device"):
            leaf3(x3.to("meta"), x3.to("meta"), tuple(t.to("meta") for t in mats3),
                  8, 8)
