"""The arithmetic and the block splits of the leaf kernels csrc/ddleaf.cu
and csrc/leaf.cu, rebuilt in torch on the CPU.

A CUDA kernel cannot run here, so each test below repeats what its kernel
does, stage for stage and block for block, with the kernel's own index
formulas (which block holds which columns, which shared row a k1 sits at,
which lanes store what), and holds the result against the kernel's plain
version, the JAX package's function and numpy's f64 FFT:

* ``ddleaf``: radix-4 DIF stages (a product by -i a swap and a sign, the
  span-4 stage without products, a last radix-2 of sums for an odd log2),
  the correction multiplied after the last F(n1) stage, F(128) the same
  way; and the cluster split of 2^13..2^16 points over 2..16 blocks of 4096
  points, each block's 32 rows read straight into the first radix-4 pass
  of F(128). Joined hi + lo against ``ddleaf_plain`` (<= 1e-13), the JAX
  ``leaf_fft_dd`` (<= 1e-13) and numpy (<= 1e-12).
* ``leaf``: radix-2 DIF stages in f32 taken four a trip (F(128) as 4 + 3),
  the correction folded into the last F(n1) trip, and the cluster split of
  2^14 and 2^15 points over 2 and 4 blocks of 8192 points. With the
  kernel's f32 stages: numpy <= 5e-7, ``leaf_plain`` <= 1e-6 (the plain
  version's dense products round otherwise). With dense products per
  factor on the same split: ``leaf_plain`` <= 1e-7, ``leaf_fft_pallas`` in
  interpret mode <= 1e-6, numpy <= 5e-7.
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


DD_TOL = 1e-13
DD_NUMPY_TOL = 1e-12


def _bitrev(k, bits):
    k = np.asarray(k)
    out = np.zeros_like(k)
    for b in range(bits):
        out |= ((k >> b) & 1) << (bits - 1 - b)
    return out


def _log2(n):
    return n.bit_length() - 1


# -- dd arithmetic as csrc/dd.cuh's radix-4 passes compute it ------------------

def _cadd(a, b):
    from phastft_tpu_torch.ops.df64 import dd_add

    return dd_add(a[0], a[1], b[0], b[1]) + dd_add(a[2], a[3], b[2], b[3])


def _csub(a, b):
    from phastft_tpu_torch.ops.df64 import dd_sub

    return dd_sub(a[0], a[1], b[0], b[1]) + dd_sub(a[2], a[3], b[2], b[3])


def _cmul(a, w):
    from phastft_tpu_torch.ops.df64 import dd_cmul

    return dd_cmul(*a, *w)


def _neg_i(a):
    """x * (-i): a swap and a sign."""
    return (a[2], a[3], -a[0], -a[1])


def _dd_twiddle(table, k, log_n):
    """W_N^k for 0 <= k < N from the table of k < N/2 (4 planes):
    W^(k + N/2) = -W^k."""
    h = 1 << (log_n - 1)
    k = torch.as_tensor(k)
    w = table[:, k & (h - 1)]
    sign = torch.where((k & h) != 0, -1.0, 1.0).to(torch.float32)
    return tuple(w[p] * sign for p in range(4))


def _dd_dif4(x, log_n, table, log_l=None):
    """In-place DIF stages on the last axis (length N = 2^log_n) from span
    2^log_l down, as ddk::dif4_fft runs them: radix-4 butterflies, the span-4
    one without products, a last radix-2 of sums for an odd count. Natural
    order in, X[k] at position bitrev(k) out."""
    n = 1 << log_n
    log_l = log_n if log_l is None else log_l
    lead = x[0].shape[:-1]
    while log_l >= 2:
        span = 1 << log_l
        quarter = span // 4
        parts = [tuple(p.reshape(lead + (n // span, 4, quarter))[..., j, :] for p in x)
                 for j in range(4)]
        a, b = _cadd(parts[0], parts[2]), _cadd(parts[1], parts[3])
        c, d = _csub(parts[0], parts[2]), _neg_i(_csub(parts[1], parts[3]))
        y = [_cadd(a, b), _csub(a, b), _cadd(c, d), _csub(c, d)]
        if span > 4:
            k = torch.arange(quarter) * (n // span)
            y[1] = _cmul(y[1], _dd_twiddle(table, 2 * k, log_n))
            y[2] = _cmul(y[2], _dd_twiddle(table, k, log_n))
            y[3] = _cmul(y[3], _dd_twiddle(table, 3 * k, log_n))
        x = tuple(torch.stack([y[j][p] for j in range(4)], dim=-2).reshape(lead + (n,))
                  for p in range(4))
        log_l -= 2
    if log_l == 1:  # span 2: sums alone
        parts = [tuple(p.reshape(lead + (n // 2, 2))[..., j] for p in x) for j in range(2)]
        y = [_cadd(parts[0], parts[1]), _csub(parts[0], parts[1])]
        x = tuple(torch.stack([y[0][p], y[1][p]], dim=-1).reshape(lead + (n,))
                  for p in range(4))
    return x


def _dd_corr_at(corr, k1, i2):
    """corr[k1, i2] of the (n1, 128) dd correction, broadcast."""
    return tuple(c[k1, i2] for c in corr)


def _ddleaf_by_kernel(quad, corr, n1):
    """ddleaf as csrc/ddleaf.cu computes it. Up to 2^12 points the block's
    layout (i1, r, i2) puts every row through the same stages, so the whole
    batch is one block here; from 2^13 a row is split over C = n1 / 32
    blocks of W = 128 / C columns: block c runs F(n1) and the correction on
    columns [W c, W c + W) (i2 = W c + q), then block d reads rows k1 in
    [32d, 32d + 32) (item (k_l, r): i2 = r + 32j from block i2 // W, shared
    row bitrev(k1), column i2 mod W) into the radix-4 of span 128, runs the
    rest of F(128) in its own buffer, and stores out[k1 + n1 * k2] from
    shared (k_l, bitrev(k2)) with the kernel's lane mapping."""
    from phastft_tpu_torch.ops.dd import _dif_twiddles

    rows, n = quad[0].shape
    log_n1 = _log2(n1)
    tw2 = _dif_twiddles(128, torch.device("cpu"))
    tw1 = _dif_twiddles(n1, torch.device("cpu")) if n1 > 1 else None
    x = tuple(q.reshape(rows, n1, 128) for q in quad)
    if n1 < 64:  # one block: F(n1) over i1 (the last axis after a swap)
        if n1 > 1:
            t = _dd_dif4(tuple(p.transpose(1, 2) for p in x), log_n1, tw1)
            k1 = torch.as_tensor(_bitrev(np.arange(n1), log_n1))
            t = _cmul(t, _dd_corr_at(corr, k1[None, :], torch.arange(128)[:, None]))
            x = tuple(p.transpose(1, 2) for p in t)
        y = _dd_dif4(x, 7, tw2)  # shared (bitrev(k1), bitrev(k2))
        p1 = torch.as_tensor(_bitrev(np.arange(n1), log_n1))
        p2 = torch.as_tensor(_bitrev(np.arange(128), 7))
        # out[k1 + n1*k2] = shared (bitrev(k1), bitrev(k2))
        return tuple(p[:, p1[None, :], p2[:, None]].reshape(rows, n) for p in y)

    logc = log_n1 - 5
    blocks, w_cols = 1 << logc, 128 >> logc
    held = []
    for c in range(blocks):
        cols = slice(w_cols * c, w_cols * c + w_cols)
        t = _dd_dif4(tuple(p[:, :, cols].transpose(1, 2) for p in x), log_n1, tw1)
        k1 = torch.as_tensor(_bitrev(np.arange(n1), log_n1))
        i2 = w_cols * c + torch.arange(w_cols)
        t = _cmul(t, _dd_corr_at(corr, k1[None, :], i2[:, None]))
        held.append(tuple(p.transpose(1, 2) for p in t))  # shared (row p, column)
    held = [torch.stack([h[p] for h in held]) for p in range(4)]  # (block, rows, p, col)
    out = tuple(torch.empty(rows, n) for _ in range(4))
    e = np.arange(256)[:, None] + 256 * np.arange(4)[None, :]  # thread, item
    r, kl = (e & 31).reshape(-1), (e >> 5).reshape(-1)
    for d in range(blocks):
        # the exchange: item (k_l, r) gathers i2 = r + 32j
        row = _bitrev(32 * d + kl, log_n1)
        buf = [torch.full((rows, 32, 128), float("nan")) for _ in range(4)]
        for j in range(4):
            i2 = r + 32 * j
            src, col = i2 // w_cols, i2 % w_cols
            for p in range(4):
                buf[p][:, kl, i2] = held[p][src, :, row, col].T
        assert all(torch.isfinite(b).all() for b in buf)  # every entry written
        y = _dd_dif4(tuple(buf), 7, tw2)
        # the stores: lane, warp, j -> (k_b, k_l .. k_l + 3)
        tid = np.arange(256)[:, None]
        jj = np.arange(4)[None, :]
        lane, rest = tid & 31, (tid >> 5) + 8 * jj
        kls = (4 * ((lane & 3) + 4 * (rest & 1))).reshape(-1)
        kbs = (16 * (lane >> 2) + (rest >> 1)).reshape(-1)
        assert len({(a, b) for a, b in zip(kbs, kls)}) == 128 * 8
        for u in range(4):
            at = torch.as_tensor(kbs * n1 + 32 * d + kls + u)
            for p in range(4):
                out[p][:, at] = y[p][:, kls + u, _bitrev(kbs, 7)]
    return out


def _dd_case(n1, rows, seed):
    from phastft_tpu_torch.ops.df64 import dd_leaf_correction_host, split_hi_lo

    rng = np.random.default_rng(seed)
    z = rng.standard_normal((rows, n1 * 128)) + 1j * rng.standard_normal((rows, n1 * 128))
    quad = tuple(torch.from_numpy(a) for a in split_hi_lo(z.real) + split_hi_lo(z.imag))
    corr = (tuple(torch.from_numpy(a) for a in dd_leaf_correction_host(n1, 128))
            if n1 > 1 else None)
    return quad, corr, z


def _join(quad):
    a = [np.asarray(q, np.float64) for q in quad]
    return (a[0] + a[1]) + 1j * (a[2] + a[3])


def _rel_c(got, want):
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("n1,rows", [(1, 3), (2, 5), (8, 3), (32, 2), (64, 3), (512, 3)])
def test_ddleaf_radix4_and_cluster_split_match_plain_jax_and_numpy(n1, rows):
    """The kernel's radix-4 dd arithmetic, the folded correction and (from
    n1 = 64) the cluster split, against ddleaf_plain (radix-16 Stockham),
    the JAX leaf_fft_dd and numpy's f64 FFT."""
    import jax.numpy as jnp
    from phastft_tpu.ops import df64 as jax_df64

    from phastft_tpu_torch.ops.dd import ddleaf_plain

    quad, corr, z = _dd_case(n1, rows, 900 + n1)
    got = _join(_ddleaf_by_kernel(quad, corr, n1))
    plain = _join(ddleaf_plain(*quad, corr, n1))
    tables = {
        k: tuple(tuple(jnp.asarray(a) for a in digit) for digit in v)
        for k, v in jax_df64.dd_radix_tables_host(max(n1, 128)).items()
    }
    jcorr = tuple(jnp.asarray(a.numpy()) for a in corr) if corr else None
    want = _join(jax_df64.leaf_fft_dd(*(jnp.asarray(q.numpy()) for q in quad), tables,
                                      jcorr, n1))
    assert _rel_c(got, plain) <= DD_TOL
    assert _rel_c(got, want) <= DD_TOL
    assert _rel_c(got, np.fft.fft(z, axis=-1)) <= DD_NUMPY_TOL


def test_dd_twiddles_past_half_are_exact_negations():
    """W^(k + N/2) = -W^k: the radix-4 twiddles W^(3q) read past the table's
    N/2 entries come out as the negated entries, bit for bit, and within
    2^-47 of the f64 phase."""
    from phastft_tpu_torch.ops.dd import _dif_twiddles

    n = 512
    table = _dif_twiddles(n, torch.device("cpu"))
    k = torch.arange(n)
    w = _dd_twiddle(table, k, 9)
    assert torch.equal(w[0][n // 2:], -w[0][:n // 2])
    assert torch.equal(w[3][n // 2:], -w[3][:n // 2])
    ang = -2.0 * np.pi * np.arange(n) / n
    got = (w[0].double() + w[1].double()).numpy() + 1j * (w[2].double() + w[3].double()).numpy()
    assert np.max(np.abs(got - np.exp(1j * ang))) <= 2.0 ** -47


def test_dd_instruction_count_of_the_radix4_schedule():
    """The FP32 instructions a point takes through the kernel's stages
    (dd complex sum 22, product 42, dd.cuh; radix-4 with products 75.5, at
    span 4 44, a radix-2 of sums 22) are what chip_smoke.py's dd_dft_instr
    counts for the bound; the leaf at 2^16 adds its correction's 42."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    def kernel(log_len):
        count, log_l = 0.0, log_len
        while log_l >= 2:
            count += 44.0 if log_l == 2 else (8 * 22 + 3 * 42) / 4
            log_l -= 2
        return count + (22.0 if log_l == 1 else 0.0)

    assert chip_smoke.dd_dft_instr(16) == pytest.approx(572.5)
    for log_len in range(1, 17):
        # the bound's count drops the trivial stage's products wherever the
        # kernel does; odd counts end on the same radix-2 of sums
        assert chip_smoke.dd_dft_instr(log_len) == pytest.approx(kernel(log_len))
    # the leaf kernel at 2^16: F(512), the correction, F(128)
    assert kernel(9) + 42 + kernel(7) == pytest.approx(614.5)


# -- f32 leaf as csrc/leaf.cu computes it ------------------------------------

def _f32_dif(xr, xi, log_n, tw, log_l=None):
    """Radix-2 DIF stages in f32 on the last axis from span 2^log_l down,
    as fft_smem.cuh's dif_group runs them; tw = (re, im) of W_N^k, k < N/2.
    Natural order in, X[k] at bitrev(k) out."""
    n = 1 << log_n
    log_l = log_n if log_l is None else log_l
    lead = xr.shape[:-1]
    for ll in range(log_l, 0, -1):
        span = 1 << ll
        half = span // 2
        ar = xr.reshape(lead + (n // span, 2, half))
        ai = xi.reshape(lead + (n // span, 2, half))
        k = torch.arange(half) * (n // span)
        wr, wi = tw[0][k], tw[1][k]
        dr, di = ar[..., 0, :] - ar[..., 1, :], ai[..., 0, :] - ai[..., 1, :]
        yr = torch.stack([ar[..., 0, :] + ar[..., 1, :], dr * wr - di * wi], dim=-2)
        yi = torch.stack([ai[..., 0, :] + ai[..., 1, :], dr * wi + di * wr], dim=-2)
        xr, xi = yr.reshape(lead + (n,)), yi.reshape(lead + (n,))
    return xr, xi


def _f32_trips(log_n):
    """The stages a trip of dif_fft16: at most four, balanced."""
    out, log_l = [], log_n
    while log_l > 0:
        trips = (log_l + 3) >> 2
        s = (log_l + trips - 1) // trips
        out.append(s)
        log_l -= s
    return out


def _leaf_by_kernel(re, im, mats, n1, dense):
    """leaf at n1 = 128 or 256 as csrc/leaf.cu splits a row over C = n1 / 64
    blocks of W = 128 / C columns: block c runs F(n1) and the correction on
    columns [W c, W c + W), block d then reads rows k1 in [64d, 64d + 64)
    (item (k_l, r): i2 = r + 8j from block i2 // W, shared row bitrev(k1),
    column i2 mod W) into the radix-16 of F(128), runs its last three
    stages in its own buffer and stores out[k1 + n1 * k2] with the kernel's
    lane mapping. ``dense``: each factor as leaf_plain's dense products
    (then put in bit-reversed order), else the kernel's f32 stages."""
    from phastft_tpu_torch.ops.leaf import _cmul

    f1r, f1i, _, f2r, f2i, _, cr, ci = mats
    rows, n = re.shape
    log_n1 = _log2(n1)
    tw1, tw2 = (f1r[1, :n1 // 2], f1i[1, :n1 // 2]), (f2r[1, :64], f2i[1, :64])
    p1 = torch.as_tensor(_bitrev(np.arange(n1), log_n1))
    p2 = torch.as_tensor(_bitrev(np.arange(128), 7))
    xr, xi = re.reshape(rows, n1, 128), im.reshape(rows, n1, 128)
    logc = log_n1 - 6
    blocks, w_cols = 1 << logc, 128 >> logc
    held = []
    for c in range(blocks):
        cols = slice(w_cols * c, w_cols * c + w_cols)
        if dense:  # (rows, k1, col) -> shared row p holds k1 = bitrev(p)
            tr, ti = _cmul(f1r, f1i, xr[..., cols], xi[..., cols])
            tr, ti = tr[:, p1, :], ti[:, p1, :]
        else:
            tr, ti = _f32_dif(xr[..., cols].transpose(1, 2), xi[..., cols].transpose(1, 2),
                              log_n1, tw1)
            tr, ti = tr.transpose(1, 2), ti.transpose(1, 2)
        c_r, c_i = cr[p1][:, cols], ci[p1][:, cols]
        held.append((tr * c_r - ti * c_i, tr * c_i + ti * c_r))
    held = [torch.stack([h[p] for h in held]) for p in range(2)]  # (block, rows, p, col)
    out_r, out_i = torch.empty(rows, n), torch.empty(rows, n)
    e = np.arange(256)[:, None] + 256 * np.arange(2)[None, :]
    r, kl = (e & 7).reshape(-1), (e >> 3).reshape(-1)
    for d in range(blocks):
        row = _bitrev(64 * d + kl, log_n1)
        buf = [torch.full((rows, 64, 128), float("nan")) for _ in range(2)]
        for j in range(16):
            i2 = r + 8 * j
            src, col = i2 // w_cols, i2 % w_cols
            for p in range(2):
                buf[p][:, kl, i2] = held[p][src, :, row, col].T
        assert all(torch.isfinite(b).all() for b in buf)  # every entry written
        if dense:
            yr, yi = _cmul(buf[0], buf[1], f2r, f2i)
            yr, yi = yr[..., p2], yi[..., p2]
        else:
            yr, yi = _f32_dif(buf[0], buf[1], 7, tw2)
        tid = np.arange(256)[:, None]
        jj = np.arange(8)[None, :]
        lane, rest = tid & 31, (tid >> 5) + 8 * jj
        kls = (4 * ((lane & 3) + 4 * (rest & 3))).reshape(-1)
        kbs = (16 * (lane >> 2) + (rest >> 2)).reshape(-1)
        assert len({(a, b) for a, b in zip(kbs, kls)}) == 128 * 16
        for u in range(4):
            at = torch.as_tensor(kbs * n1 + 64 * d + kls + u)
            out_r[:, at] = yr[:, kls + u, _bitrev(kbs, 7)]
            out_i[:, at] = yi[:, kls + u, _bitrev(kbs, 7)]
    return out_r, out_i


def _leaf_case(n1, rows, seed):
    from phastft_tpu.planner import PlannerDit32 as JaxPlanner

    corrs = JaxPlanner(n1 * 128).leaf_corrs
    pmats = corrs[f"mxu{n1}"][:6] + corrs[f"leaf{n1}"]
    rng = np.random.default_rng(seed)
    re = rng.standard_normal((rows, n1 * 128)).astype(np.float32)
    im = rng.standard_normal((rows, n1 * 128)).astype(np.float32)
    return re, im, pmats


def _rel(got, want):
    g = np.asarray(got[0], np.float64) + 1j * np.asarray(got[1], np.float64)
    w = np.asarray(want[0], np.float64) + 1j * np.asarray(want[1], np.float64)
    assert g.shape == w.shape
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def _oracle(re, im):
    want = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1)
    return want.real, want.imag


@pytest.mark.parametrize("n1", [128, 256])
def test_leaf_cluster_split_matches_plain_and_pallas(n1):
    """The 2- and 4-block splits of csrc/leaf.cu with leaf_plain's dense
    products per factor: leaf_plain whole (1e-7), leaf_fft_pallas in
    interpret mode (1e-6), numpy (5e-7), on 4 rows (the TPU kernel tiles
    rows by 4)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from phastft_tpu.ops.pallas_leaf import leaf_fft_pallas

    from phastft_tpu_torch.ops.leaf import leaf_plain

    re, im, pmats = _leaf_case(n1, 4, 70 + n1)
    mats = tuple(torch.from_numpy(np.array(a)) for a in pmats)
    x = (torch.from_numpy(re), torch.from_numpy(im))
    got = _leaf_by_kernel(*x, mats, n1, dense=True)
    whole = leaf_plain(*x, mats, n1)
    with pltpu.force_tpu_interpret_mode():
        want = leaf_fft_pallas(jnp.asarray(re), jnp.asarray(im), pmats, n1)
    assert _rel(got, whole) <= 1e-7
    assert _rel(got, want) <= 1e-6
    assert _rel(got, _oracle(re, im)) <= 5e-7


@pytest.mark.parametrize("n1,rows", [(128, 3), (256, 3)])
def test_leaf_cluster_f32_stages_match_plain_and_numpy(n1, rows):
    """The same splits on the kernel's own f32 radix-2 stages (F(128) as a
    radix-16 trip then a radix-8): numpy <= 5e-7, leaf_plain <= 1e-6."""
    from phastft_tpu_torch.ops.leaf import leaf_plain

    re, im, pmats = _leaf_case(n1, rows, 80 + n1)
    mats = tuple(torch.from_numpy(np.array(a)) for a in pmats)
    x = (torch.from_numpy(re), torch.from_numpy(im))
    got = _leaf_by_kernel(*x, mats, n1, dense=False)
    assert _rel(got, _oracle(re, im)) <= 5e-7
    assert _rel(got, leaf_plain(*x, mats, n1)) <= 1e-6


@pytest.mark.parametrize("log_n", [8, 10, 13])
def test_leaf_one_block_two_trip_f128_and_folded_correction(log_n):
    """n <= 2^13 in one block of R = 8192 / n rows: F(n1) in trips of at most
    four f32 stages with the correction after the last, F(128) as 4 + 3,
    the store gathering shared (bitrev(k1), r, bitrev(k2)); numpy <= 5e-7,
    leaf_plain <= 1e-6."""
    from phastft_tpu_torch.ops.leaf import leaf_plain

    n1 = 1 << (log_n - 7)
    log_n1 = log_n - 7
    assert _f32_trips(7) == [4, 3] and _f32_trips(8) == [4, 4]
    assert _f32_trips(6) == [3, 3] and _f32_trips(5) == [3, 2]
    re, im, pmats = _leaf_case(n1, 3, 90 + log_n)
    mats = tuple(torch.from_numpy(np.array(a)) for a in pmats)
    f1r, f1i, _, f2r, f2i, _, cr, ci = mats
    rows, n = re.shape
    xr = torch.from_numpy(re).reshape(rows, n1, 128)
    xi = torch.from_numpy(im).reshape(rows, n1, 128)
    tr, ti = _f32_dif(xr.transpose(1, 2), xi.transpose(1, 2), log_n1,
                      (f1r[1, :n1 // 2], f1i[1, :n1 // 2]))
    p1 = torch.as_tensor(_bitrev(np.arange(n1), log_n1))
    c_r, c_i = cr[p1].T, ci[p1].T  # folded: k1 = bitrev(position)
    ur, ui = (tr * c_r - ti * c_i).transpose(1, 2), (tr * c_i + ti * c_r).transpose(1, 2)
    yr, yi = _f32_dif(ur, ui, 7, (f2r[1, :64], f2i[1, :64]))
    p2 = torch.as_tensor(_bitrev(np.arange(128), 7))
    got = (yr[:, p1[None, :], p2[:, None]].reshape(rows, n),
           yi[:, p1[None, :], p2[:, None]].reshape(rows, n))
    x = (torch.from_numpy(re), torch.from_numpy(im))
    assert _rel(got, _oracle(re, im)) <= 5e-7
    assert _rel(got, leaf_plain(*x, mats, n1)) <= 1e-6
