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

from phastft_tpu_torch.tracing import launch_count


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    before = launch_count("colfft_out3d")
    got = colfft.colfft_out3d(torch.from_numpy(re), torch.from_numpy(im),
                              tuple(torch.from_numpy(a) for a in host), n1)
    assert launch_count("colfft_out3d") == before  # CPU: no kernel launch
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
    before = launch_count("colfft")
    got = colfft.colfft(torch.from_numpy(re), torch.from_numpy(im),
                        tuple(torch.from_numpy(a) for a in host), n1)
    assert launch_count("colfft") == before  # CPU: no kernel launch
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
    before = launch_count("transpose2")
    got = transpose.transpose2(torch.from_numpy(a), torch.from_numpy(b))
    assert launch_count("transpose2") == before  # CPU: no kernel launch
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
    before = launch_count("leaft")
    got = leaft_mod.leaft(torch.from_numpy(cre), torch.from_numpy(cim),
                          tuple(torch.from_numpy(x) for x in host), n1)
    assert launch_count("leaft") == before
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
        with pytest.raises(ValueError):  # tables of another width than n2's
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
    before = launch_count("leaf")
    got = leaf_mod.leaf(torch.from_numpy(re), torch.from_numpy(im),
                        tuple(torch.from_numpy(np.array(a)) for a in pmats),
                        n1)
    assert launch_count("leaf") == before  # CPU: no kernel launch
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
    before = launch_count("leaf3")
    got = leaf_mod.leaf3(torch.from_numpy(re), torch.from_numpy(im),
                         tuple(torch.from_numpy(t) for t in host), a, b)
    assert launch_count("leaf3") == before
    assert tuple(got[0].shape) == (rows, n)
    assert _rel(got, want) <= TOL
    # the bound of tests/test_pallas_leaf.py: 5e-6 at the small (a, b)
    assert _rel(got, _oracle(re, im)) <= (5e-7 if a == 128 else 5e-6)


def _leaf3_by_blocks(re, im, mats):
    """leaf3 at a = b = 128 as csrc/leaf3.cu splits a row over a cluster of
    8 blocks, with leaf3_plain's dense products for each factor. Block c
    holds columns i_r in [64c, 64c + 64) (i_p = c // 2, i_b in
    [64h, 64h + 64), h = c % 2) of every i_a and runs F(a) and c1 on them;
    block d then gathers k_a in [16d, 16d + 16) for each (i_p, i_b) from
    block 2*i_p + i_b // 64, runs the radix-4, c2 and F(b), and stores
    out[k_b*512 + p*128 + 16d + k_l]."""
    from phastft_tpu_torch.ops.leaf import _cmul

    f1r, f1i, _, f2r, f2i, _, c1r, c1i, c2r, c2i = mats
    rows = re.shape[0]
    xr, xi = re.reshape(rows, 128, 512), im.reshape(rows, 128, 512)
    held = []  # per block: u over (k_a, 64 local columns)
    for c in range(8):
        cols = slice(64 * c, 64 * c + 64)
        tr, ti = _cmul(f1r, f1i, xr[..., cols], xi[..., cols])
        held.append((tr * c1r[:, cols] - ti * c1i[:, cols],
                     tr * c1i[:, cols] + ti * c1r[:, cols]))
    out_r = torch.empty(rows, 1 << 16)
    out_i = torch.empty(rows, 1 << 16)
    ib = torch.arange(128)
    for d in range(8):
        ka = slice(16 * d, 16 * d + 16)
        s = [[held[2 * ip + h][part][:, ka, :] for h in (0, 1)]
             for ip in range(4) for part in (0, 1)]
        # s_p[k_l, i_b]: i_b < 64 from block 2p, the rest from block 2p + 1
        sr = [torch.cat(s[2 * ip], dim=-1) for ip in range(4)]
        si = [torch.cat(s[2 * ip + 1], dim=-1) for ip in range(4)]
        e_r, e_i = sr[0] + sr[2], si[0] + si[2]
        d_r, d_i = sr[0] - sr[2], si[0] - si[2]
        g_r, g_i = sr[1] + sr[3], si[1] + si[3]
        h_r, h_i = sr[1] - sr[3], si[1] - si[3]
        y = ((e_r + g_r, e_i + g_i), (d_r + h_i, d_i - h_r),
             (e_r - g_r, e_i - g_i), (d_r - h_i, d_i + h_r))
        for p, (yr, yi) in enumerate(y):
            wr = (yr * c2r[p] - yi * c2i[p]).transpose(1, 2)
            wi = (yr * c2i[p] + yi * c2r[p]).transpose(1, 2)
            o_r, o_i = _cmul(f2r, f2i, wr, wi)  # (rows, k_b, k_l)
            at = (ib[:, None] * 512 + p * 128 + 16 * d
                  + torch.arange(16)[None, :]).reshape(-1)
            out_r[:, at] = o_r.reshape(rows, -1)
            out_i[:, at] = o_i.reshape(rows, -1)
    return out_r, out_i


def test_leaf3_eight_block_split_matches_plain_and_pallas():
    """The 8-block split of csrc/leaf3.cu, rebuilt in torch on 3 rows of
    2^16, equals leaf3_plain whole (1e-7) and leaf_fft_pallas3 (1e-6)."""
    import jax.numpy as jnp
    from phastft_tpu.ops.pallas_leaf import leaf_fft_pallas3

    from phastft_tpu_torch.ops.leaf import leaf3_plain
    from phastft_tpu_torch.ops.mxu import mxu_leaf_tables3_host

    host = mxu_leaf_tables3_host(128, 128, "float32")
    mats = tuple(torch.from_numpy(t) for t in host)
    re, im = _pair(np.random.default_rng(316), (3, 1 << 16))
    got = _leaf3_by_blocks(torch.from_numpy(re), torch.from_numpy(im), mats)
    whole = leaf3_plain(torch.from_numpy(re), torch.from_numpy(im), mats, 128, 128)
    want = _run_interpret(leaf_fft_pallas3, jnp.asarray(re), jnp.asarray(im),
                          tuple(jnp.asarray(t) for t in host), 128, 128)
    assert _rel(got, whole) <= 1e-7
    assert _rel(got, want) <= TOL
    assert _rel(got, _oracle(re, im)) <= 5e-7


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


# -- the dd (double-float) kernels' plain versions ------------------------------
# Tolerances are on joined f64 values (hi + lo in f64). The JAX plain branch
# (stockham_axis2_dd and dd_cmul, eager on the CPU) runs the same arithmetic
# as the port's plain versions: <= 1e-13. The Pallas dd kernels in interpret
# mode are held to 1e-6 only, the interpreter's own limit (it may contract
# the error-free transforms, see tests/test_pallas_dd.py).

DD_TOL = 1e-13
DD_NUMPY_TOL = 1e-12


def _quad(rng, shape):
    """Four f32 planes (re_hi, re_lo, im_hi, im_lo) of a random f64 complex
    array, and the array."""
    from phastft_tpu_torch.ops.df64 import split_hi_lo

    x = rng.standard_normal(shape)
    y = rng.standard_normal(shape)
    return split_hi_lo(x) + split_hi_lo(y), x + 1j * y


def _join(quad):
    a = [np.asarray(q, np.float64) for q in quad]
    return (a[0] + a[1]) + 1j * (a[2] + a[3])


def _rel_c(got, want):
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _t(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def test_dd_error_free_transforms_exact():
    """TwoSum and Dekker's TwoProd in eager torch: residual exactly 0
    against f64 (the CPU form of the card's dd_exact phase)."""
    from phastft_tpu_torch.ops import df64

    rng = np.random.default_rng(7)
    n = 1 << 16
    sign = rng.integers(0, 2, (2, n)) * 2.0 - 1.0
    mag = rng.uniform(2.0 ** -4, 2.0 ** 4, (2, n))
    a, b = (torch.from_numpy((sign[i] * mag[i]).astype(np.float32)) for i in (0, 1))
    s, e = df64._two_sum(a, b)
    p, pe = df64._two_prod(a, b)
    a64, b64 = a.double(), b.double()
    assert float(((s.double() + e.double()) - (a64 + b64)).abs().max()) == 0.0
    assert float(((p.double() + pe.double()) - (a64 * b64)).abs().max()) == 0.0
    hi, lo = df64._veltkamp(a)
    assert torch.equal(hi + lo, a)


@pytest.mark.parametrize("op", ["dd_add", "dd_sub", "dd_mul", "dd_cmul"])
def test_dd_arithmetic_matches_jax_and_f64(op):
    """The dd sums and products agree with the JAX package's bit for bit
    (the same f32 operations in the same order) and with f64 to ~2^-44."""
    import jax.numpy as jnp
    from phastft_tpu.ops import df64 as jax_df64

    from phastft_tpu_torch.ops import df64

    rng = np.random.default_rng(11)
    count = 8 if op == "dd_cmul" else 4
    vals = [rng.standard_normal(4096) for _ in range(count // 2)]
    planes = [p for v in vals for p in df64.split_hi_lo(v)]
    got = getattr(df64, op)(*_t(planes))
    ref = getattr(jax_df64, op)(*(jnp.asarray(p) for p in planes))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    joined = [np.float64(g.numpy()) for g in got]
    if op == "dd_cmul":
        a, b = vals[0] + 1j * vals[1], vals[2] + 1j * vals[3]
        want = a * b
        res = (joined[0] + joined[1]) + 1j * (joined[2] + joined[3])
    else:
        want = {"dd_add": vals[0] + vals[1], "dd_sub": vals[0] - vals[1],
                "dd_mul": vals[0] * vals[1]}[op]
        res = joined[0] + joined[1]
    scale = np.abs(vals[0]) + np.abs(vals[1]) if op in ("dd_add", "dd_sub") \
        else np.abs(want) + 1e-300
    assert np.max(np.abs(res - want) / scale) <= 2.0 ** -43


def _jax_ddcol_plain_branch(quad, n1, n2, corr=True):
    """The JAX package's plain branch of the dd column pass
    (ops/fourstep.py, behind the Pallas kernel): stockham_axis2_dd, then
    the two dd_cmuls of the factored correction."""
    import jax.numpy as jnp
    from phastft_tpu.ops import df64 as jax_df64
    from phastft_tpu.ops.pallas_dd import dd_col_tables_host as jax_tables

    tables = {
        k: tuple(tuple(jnp.asarray(a) for a in digit) for digit in v)
        for k, v in jax_df64.dd_radix_tables_host(max(n1, 2)).items()
    }
    out = tuple(jax_df64.stockham_axis2_dd(
        *(jnp.asarray(q) for q in quad), tables, n1))
    if not corr:
        return _join(out)
    t, t1, t2 = jax_tables(n1, n2)
    batch = out[0].shape[:-2]
    out = tuple(a.reshape(batch + (n1, n2 // t, t)) for a in out)
    out = jax_df64.dd_cmul(*out, *(jnp.asarray(a)[:, :, None] for a in t1))
    out = jax_df64.dd_cmul(*out, *(jnp.asarray(a)[:, None, :] for a in t2))
    return _join(out).reshape(batch + (n1, n2))


def _ddcol_oracle(z, n1, n2):
    w = np.exp(-2j * np.pi * (np.arange(n1)[:, None] * np.arange(n2)[None, :])
               / (n1 * n2))
    return np.fft.fft(z, axis=-2) * w


@pytest.mark.parametrize("n1,n2,b", [(16, 256, None), (32, 512, 3)])
def test_ddcol_plain_matches_pallas_and_jax(n1, n2, b):
    import jax.numpy as jnp
    from phastft_tpu.ops import pallas_dd

    from phastft_tpu_torch.ops import dd

    rng = np.random.default_rng(n1 + n2)
    shape = ((b,) if b else ()) + (n1, n2)
    quad, z = _quad(rng, shape)
    _, t1, t2 = dd.dd_col_tables_host(n1, n2)
    before = launch_count("ddcol")
    got = dd.ddcol(*_t(quad), _t(t1), _t(t2), n1)
    assert launch_count("ddcol") == before  # CPU: no kernel launch
    assert all(tuple(g.shape) == shape and g.dtype == torch.float32 for g in got)
    g = _join([x.numpy() for x in got])
    assert _rel_c(g, _jax_ddcol_plain_branch(quad, n1, n2)) <= DD_TOL
    assert _rel_c(g, _ddcol_oracle(z, n1, n2)) <= DD_NUMPY_TOL
    want = _run_interpret(
        pallas_dd.ddcol_pallas, *(jnp.asarray(q) for q in quad),
        tuple(jnp.asarray(a) for a in t1), tuple(jnp.asarray(a) for a in t2), n1,
    )
    assert want is not None
    assert _rel_c(g, _join(want)) <= TOL


@pytest.mark.parametrize("n1", [2, 4])
def test_ddcol_plain_shapes_the_tpu_kernel_refuses(n1):
    """n1 < 8: ddcol_pallas returns None and the JAX package runs its plain
    branch; the port's ddcol takes the shape."""
    import jax.numpy as jnp
    from phastft_tpu.ops import pallas_dd

    from phastft_tpu_torch.ops import dd

    n2 = 128
    rng = np.random.default_rng(n1)
    quad, z = _quad(rng, (5, n1, n2))
    _, t1, t2 = dd.dd_col_tables_host(n1, n2)
    assert pallas_dd.ddcol_pallas(
        *(jnp.asarray(q) for q in quad), tuple(jnp.asarray(a) for a in t1),
        tuple(jnp.asarray(a) for a in t2), n1) is None
    got = dd.ddcol(*_t(quad), _t(t1), _t(t2), n1)
    g = _join([x.numpy() for x in got])
    assert _rel_c(g, _jax_ddcol_plain_branch(quad, n1, n2)) <= DD_TOL
    assert _rel_c(g, _ddcol_oracle(z, n1, n2)) <= DD_NUMPY_TOL


def test_ddcol_checks_its_arguments():
    from phastft_tpu_torch.ops import dd

    quad, _ = _quad(np.random.default_rng(0), (8, 128))
    _, t1, t2 = dd.dd_col_tables_host(8, 128)
    with pytest.raises(ValueError, match="unsupported shape"):  # not a power of two
        dd.ddcol(*_t(tuple(q[:, :96] for q in quad)), _t(t1), _t(t2), 8)
    with pytest.raises(ValueError, match="correction tables"):  # another n2's
        dd.ddcol(*_t(tuple(q[:, :64] for q in quad)), _t(t1), _t(t2), 8)
    with pytest.raises(ValueError, match="correction tables"):
        dd.ddcol(*_t(quad), _t(t2), _t(t1), 8)
    with pytest.raises(TypeError, match="float32"):
        dd.ddcol(*(x.double() for x in _t(quad)), _t(t1), _t(t2), 8)
    with pytest.raises(ValueError, match="unsupported leaf factor"):
        dd.ddleaf(*_t(tuple(q.reshape(-1) for q in quad)), None, 3)


@pytest.mark.parametrize("n1,n2,b", [(128, 256, None), (128, 2, 5)])
def test_ddcol_nocorr_plain_matches_pallas_and_jax(n1, n2, b):
    """The bare dd column DFT: against the JAX plain branch and numpy, and
    at the shape the Pallas kernel takes, against it in interpret mode
    (rows of 2 points it refuses)."""
    import jax.numpy as jnp
    from phastft_tpu.ops import pallas_dd

    from phastft_tpu_torch.ops import dd

    rng = np.random.default_rng(n1 * n2)
    shape = ((b,) if b else ()) + (n1, n2)
    quad, z = _quad(rng, shape)
    before = launch_count("ddcol_nocorr")
    got = dd.ddcol_nocorr(*_t(quad), n1)
    assert launch_count("ddcol_nocorr") == before  # CPU: no kernel launch
    assert all(tuple(g.shape) == shape for g in got)
    g = _join([x.numpy() for x in got])
    assert _rel_c(g, _jax_ddcol_plain_branch(quad, n1, n2, corr=False)) <= DD_TOL
    assert _rel_c(g, np.fft.fft(z, axis=-2)) <= DD_NUMPY_TOL
    want = pallas_dd.ddcol_pallas_nocorr if n2 >= 8 else None
    if want is not None:
        want = _run_interpret(want, *(jnp.asarray(q) for q in quad), n1)
        assert want is not None
        assert _rel_c(g, _join(want)) <= TOL


@pytest.mark.parametrize("n1", [1, 16, 64])
@pytest.mark.parametrize("b", [1, 2, 5])
def test_ddleaf_plain_matches_jax_and_numpy(n1, b):
    """ddleaf against the JAX package's leaf_fft_dd and numpy's f64 FFT
    (ddleaf_pallas in interpret mode is marked slow in tests/test_pallas_dd.py
    and takes no batch of 5)."""
    import jax.numpy as jnp
    from phastft_tpu.ops import df64 as jax_df64

    from phastft_tpu_torch.ops import dd, df64

    n = n1 * 128
    rng = np.random.default_rng(n1 * 10 + b)
    quad, z = _quad(rng, (b, n))
    corr = df64.dd_leaf_correction_host(n1, 128) if n1 > 1 else None
    before = launch_count("ddleaf")
    got = dd.ddleaf(*_t(quad), _t(corr) if corr else None, n1)
    assert launch_count("ddleaf") == before  # CPU: no kernel launch
    assert all(tuple(x.shape) == (b, n) and x.dtype == torch.float32 for x in got)
    g = _join([x.numpy() for x in got])
    tables = {
        k: tuple(tuple(jnp.asarray(a) for a in digit) for digit in v)
        for k, v in jax_df64.dd_radix_tables_host(max(n1, 128)).items()
    }
    jcorr = tuple(jnp.asarray(a) for a in corr) if corr else None
    want = jax_df64.leaf_fft_dd(*(jnp.asarray(q) for q in quad), tables, jcorr, n1)
    assert _rel_c(g, _join(want)) <= DD_TOL
    assert _rel_c(g, np.fft.fft(z, axis=-1)) <= DD_NUMPY_TOL


def test_tiny_fft_dd_matches_jax():
    import jax.numpy as jnp
    from phastft_tpu.ops import df64 as jax_df64

    from phastft_tpu_torch.ops import df64

    for n in (1, 2, 8, 64):
        quad, z = _quad(np.random.default_rng(n), (3, n))
        host = df64.dd_radix_tables_host(max(n, 2))
        tables = {k: tuple(_t(d) for d in v) for k, v in host.items()}
        jtables = {k: tuple(tuple(jnp.asarray(a) for a in d) for d in v)
                   for k, v in host.items()}
        got = df64.tiny_fft_dd(*_t(quad), tables, n)
        want = jax_df64.tiny_fft_dd(*(jnp.asarray(q) for q in quad), jtables, n)
        g = _join([x.numpy() for x in got])
        assert _rel_c(g, _join(want)) <= DD_TOL
        assert _rel_c(g, np.fft.fft(z, axis=-1)) <= DD_NUMPY_TOL


# -- the distributed four-step's column passes ---------------------------------

@pytest.mark.parametrize("n1,n2,b", [(8, 256, None), (64, 1024, None),
                                     (2048, 128, None), (16, 512, 3)])
def test_colfft_nocorr_plain_matches_pallas(n1, n2, b):
    """The bare column DFT against colfft_pallas_nocorr in interpret mode:
    the same Stockham steps on the same in-kernel twiddles."""
    import jax.numpy as jnp
    from phastft_tpu.ops import pallas_col

    from phastft_tpu_torch.ops import colfft

    rng = np.random.default_rng(n1 * 3 + n2)
    shape = ((b,) if b else ()) + (n1, n2)
    re, im = _pair(rng, shape)
    want = _run_interpret(pallas_col.colfft_pallas_nocorr, jnp.asarray(re),
                          jnp.asarray(im), n1)
    before = launch_count("colfft_nocorr")
    got = colfft.colfft_nocorr(torch.from_numpy(re), torch.from_numpy(im), n1)
    assert launch_count("colfft_nocorr") == before  # CPU: no kernel launch
    assert tuple(got[0].shape) == shape
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("n1,ccols,n,col_base", [(16, 256, 16 * 1024, 256),
                                                 (128, 512, 128 * 2048, 1536)])
def test_colfft_shard_plain_matches_pallas_col_chunk(n1, ccols, n, col_base):
    """colfft with n_total and col_base against the distributed four-step's
    chunk through colfft_pallas (interpret mode), as
    tests/test_parallel.py drives it: a shard's column block."""
    import jax.numpy as jnp
    from phastft_tpu.parallel.fourstep_dist import _pallas_col_chunk

    from phastft_tpu_torch.ops.colfft import colfft

    rng = np.random.default_rng(n1 + col_base)
    re, im = _pair(rng, (n1, ccols))
    want = _run_interpret(_pallas_col_chunk, jnp.asarray(re), jnp.asarray(im),
                          n1, n, jnp.asarray(col_base), ccols, None)
    got = colfft(torch.from_numpy(re), torch.from_numpy(im), None, n1,
                 n_total=n, col_base=col_base)
    assert _rel(got, want) <= TOL
    z = np.fft.fft(re.astype(np.float64) + 1j * im, axis=0)
    k1 = np.arange(n1)[:, None]
    i2 = np.arange(ccols)[None, :] + col_base
    oracle = z * np.exp(-2j * np.pi * ((k1 * i2) % n) / n)
    assert _rel(got, (oracle.real, oracle.imag)) <= 5e-7


@pytest.mark.parametrize("n1,n2,b", [(2, 2, None), (4, 64, 2), (2048, 4, None)])
def test_column_passes_take_narrow_blocks(n1, n2, b):
    """Shard blocks narrower than 128 columns, and n1 = 2, 4, which the TPU
    kernels decline, against an f64 oracle: the bare pass, and the shard
    pass of columns [n2, 2*n2) of a transform of 4 * n1 * n2 points."""
    from phastft_tpu_torch.ops.colfft import colfft, colfft_nocorr

    rng = np.random.default_rng(n1 + n2)
    shape = ((b,) if b else ()) + (n1, n2)
    re, im = _pair(rng, shape)
    z = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-2)
    got = colfft_nocorr(torch.from_numpy(re), torch.from_numpy(im), n1)
    assert _rel(got, (z.real, z.imag)) <= 5e-7
    n = 4 * n1 * n2
    k1 = np.arange(n1)[:, None]
    i2 = np.arange(n2)[None, :] + n2
    w = z * np.exp(-2j * np.pi * ((k1 * i2) % n) / n)
    got = colfft(torch.from_numpy(re), torch.from_numpy(im), None, n1,
                 n_total=n, col_base=n2)
    assert _rel(got, (w.real, w.imag)) <= 5e-7


@pytest.mark.parametrize("kw", [dict(n_total=3000), dict(n_total=1 << 10),
                                dict(n_total=1 << 14, col_base=-1),
                                dict(col_base=128)])
def test_colfft_rejects_bad_shard_arguments(kw):
    """n_total a power of two that holds the block's columns; col_base
    only with n_total."""
    from phastft_tpu_torch.ops.colfft import (
        col_split_tables_host, col_tile, colfft, colfft_plain,
    )

    x = torch.zeros(16, 128)
    tabs = None if "n_total" in kw else tuple(
        torch.from_numpy(a) for a in
        col_split_tables_host(16, 128, "float32", t=col_tile(16, 128)))
    for fn in (colfft, colfft_plain):
        with pytest.raises(ValueError):
            fn(x, x, tabs, 16, **kw)
