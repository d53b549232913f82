"""The block splits of the column kernel csrc/colfft.cu (long columns) and
the row kernel csrc/leaft.cu (R rows a cluster), rebuilt in torch on the
CPU.

A CUDA kernel cannot run here, so each test repeats what its kernel does,
block for block, on a flat copy of each block's shared memory addressed
with the kernel's own index formulas (which block loads which rows, the
word of each value, which block an exchange reads,
which lanes store what), and the kernel's f32 radix-2 stages. The result
is held against the kernel's plain version (1e-6), the Pallas kernel it
replaces in interpret mode (1e-6) and numpy's f64 FFT (5e-7):

* ``colfft`` at n1 = 1024 and 2048: a slab of 32 columns over a cluster of
  n1/256 blocks; n1 = P*Q, Q = 128, i1 = Q*p + q; F(P) in registers on the
  loaded column pairs, W_n1^(kp*q), an exchange of two kp a block into the first
  radix-16 trip of F(Q), its last three stages in the block's own buffer,
  and the store of rows k1 = kp + P*kq in the classic, out3d and bare
  modes, the split twiddle as T1 of the slab's first column (exact phase)
  times the T2 table.
* ``leaft`` at A = 8, 16, 32, 64 and 128 (1 to 16 blocks) on n1 = 128 (16
  row groups of 8): F(A) over iA on each block's W = 128/C columns with the
  correction folded in, an exchange of A/C values of kA a block into the
  first radix-16 trip of F(128), its last three stages, and the store of 8
  contiguous rows per (kA, kM).
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


TOL = 1e-6
NUMPY_TOL = 5e-7
THREADS = 256


def _bitrev(k, bits):
    k = np.asarray(k)
    out = np.zeros_like(k)
    for b in range(bits):
        out |= ((k >> b) & 1) << (bits - 1 - b)
    return out


def _log2(n):
    return n.bit_length() - 1


def _dif(xr, xi, log_n, tw, log_l, stages):
    """``stages`` radix-2 DIF stages in f32 on the last axis (length 2^log_n)
    from span 2^log_l down, as fft_smem.cuh's dif_group runs them; tw =
    (re, im) of W_N^k, k < N/2, N = 2^log_n."""
    n = 1 << log_n
    lead = xr.shape[:-1]
    for ll in range(log_l, log_l - stages, -1):
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


def _exact_twiddles(n, count):
    """W_n^k, k < count, from the exact phase in f64 rounded once to f32."""
    ang = -2.0 * np.pi * np.arange(count, dtype=np.float64) / n
    return (torch.from_numpy(np.cos(ang).astype(np.float32)),
            torch.from_numpy(np.sin(ang).astype(np.float32)))


def _rel(got, want):
    g = np.asarray(got[0], np.float64) + 1j * np.asarray(got[1], np.float64)
    w = np.asarray(want[0], np.float64) + 1j * np.asarray(want[1], np.float64)
    assert g.shape == w.shape
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def _pair(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _run_interpret(fn, *args, **kw):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return fn(*args, **kw)


class _Smem:
    """The shared memory of one block of every (batch, slab) at once: two
    flat f32 planes, NaN until written."""

    def __init__(self, lead, words):
        self.r = torch.full(lead + (words,), float("nan"))
        self.i = torch.full(lead + (words,), float("nan"))

    def write(self, at, vr, vi):
        at = torch.as_tensor(at)
        self.r[..., at] = vr
        self.i[..., at] = vi

    def read(self, at):
        at = torch.as_tensor(at)
        vr, vi = self.r[..., at], self.i[..., at]
        assert torch.isfinite(vr).all() and torch.isfinite(vi).all()  # written
        return vr, vi


# -- colfft: long columns over a cluster ---------------------------------------

CT, CQ, CKP = 32, 128, 2


def _colfft_by_kernel(re, im, mode, t2=None, n_total=None):
    """csrc/colfft.cu's colfft_cluster on (b, n1, n2), n1 = 1024 or 2048,
    block for block; mode "classic", "out3d" or "nocorr", the split twiddle
    T1 of the slab's first column (exact phase) times the T2 pair ``t2``."""
    b, n1, n2 = re.shape
    p_ = n1 // CQ
    log_p = _log2(p_)
    blocks = p_ // CKP
    qc = CQ // blocks
    log_qc = _log2(qc)
    slabs = n2 // CT
    n_total = n_total or n1 * n2
    twr, twi = _exact_twiddles(n1, n1 // 2)
    xr = re.reshape(b, n1, slabs, CT).permute(0, 2, 1, 3)  # (b, slab, i1, col)
    xi = im.reshape(b, n1, slabs, CT).permute(0, 2, 1, 3)

    # phase 1: block c loads rows Q*p + q, q in its range, as column pairs
    # (item e = (q, pair), two columns each), F(P), W_n1^(kp*q)
    smem = [_Smem((b, slabs), 8192) for _ in range(blocks)]
    for c in range(blocks):
        f = np.arange(qc * CT)
        e, half = f >> 1, f & 1
        col, ql = 2 * (e & (CT // 2 - 1)) + half, e >> 4
        q = qc * c + ql
        rows = CQ * np.arange(p_)[None, :] + q[:, None]  # (item, p)
        vr, vi = xr[:, :, rows, col[:, None]], xi[:, :, rows, col[:, None]]
        stride = n1 // p_
        vr, vi = _dif(vr, vi, log_p, (twr[::stride], twi[::stride]), log_p, log_p)
        kp = _bitrev(np.arange(p_), log_p)  # position u holds kp
        m = kp[None, :] * q[:, None]
        sign = torch.from_numpy(np.where(m >= n1 // 2, -1.0, 1.0).astype(np.float32))
        wr, wi = twr[m % (n1 // 2)] * sign, twi[m % (n1 // 2)] * sign
        at = ((kp[None, :] << log_qc) + ql[:, None]) * CT + col[:, None]
        smem[c].write(at, vr * wr - vi * wi, vr * wi + vi * wr)

    tw128 = (twr[::n1 // CQ], twi[::n1 // CQ])
    out_r = torch.full((b, n1, n2), float("nan"))
    out_i = torch.full((b, n1, n2), float("nan"))
    for d in range(blocks):
        # exchange: item (col, r, kl) takes q = r + 8j from block q / QC
        e = np.arange(2 * THREADS)
        col, r, kl = e & (CT - 1), (e >> 5) & 7, e >> 8
        kp = CKP * d + kl
        seq_r = torch.empty((b, slabs, len(e), CQ))
        seq_i = torch.empty_like(seq_r)
        for jj in range(16):
            q = r + 8 * jj
            at = ((kp << log_qc) + (q & (qc - 1))) * CT + col
            for src in range(blocks):
                sel = np.nonzero((q >> log_qc) == src)[0]
                vr, vi = smem[src].read(at[sel])
                seq_r[:, :, sel, q[sel]] = vr
                seq_i[:, :, sel, q[sel]] = vi
        seq_r, seq_i = _dif(seq_r, seq_i, 7, tw128, 7, 4)  # radix-16 over q
        own = _Smem((b, slabs), 8192)
        for jj in range(16):
            q = r + 8 * jj
            own.write(((kl << 7) + q) * CT + col,
                      seq_r[:, :, np.arange(len(e)), q], seq_i[:, :, np.arange(len(e)), q])
        # the last three stages: item (col, g, kl), q = 8g + s
        e = np.arange(4 * THREADS)
        col, g, kl = e & (CT - 1), (e >> 5) & 15, e >> 9
        at = (((kl[:, None] << 7) + 8 * g[:, None] + np.arange(8)[None, :]) * CT
              + col[:, None])
        vr, vi = own.read(at)
        vr, vi = _dif(vr, vi, 3, (tw128[0][::16], tw128[1][::16]), 3, 3)
        own.write(at, vr, vi)
        # store: lanes (4 columns, kl, kq), rows k1 = kp + P*kq
        e = np.arange(2048 * 4)  # float4 e // 4, element u = e % 4
        u, f = e & 3, e >> 2
        v, kl, kq = f & 7, (f >> 3) & 1, f >> 4
        vr, vi = own.read(((kl << 7) + _bitrev(kq, 7)) * CT + 4 * v + u)
        k1 = CKP * d + kl + p_ * kq
        i2 = np.arange(slabs)[:, None] * CT + (4 * v + u)[None, :]  # (slab, elem)
        if mode != "nocorr":
            ph = (k1[None, :].astype(np.int64) * (np.arange(slabs)[:, None] * CT)) % n_total
            t1 = torch.from_numpy(np.exp(-2j * np.pi * ph / n_total).astype(np.complex64))
            w = t1 * torch.complex(t2[0], t2[1])[torch.as_tensor(k1), torch.as_tensor(4 * v + u)]
            vr, vi = vr * w.real - vi * w.imag, vr * w.imag + vi * w.real
        k1t = torch.as_tensor(np.broadcast_to(k1[None, :], i2.shape).copy())
        assert torch.isnan(out_r[:, k1t, torch.as_tensor(i2)]).all()  # once each
        out_r[:, k1t, torch.as_tensor(i2)] = vr
        out_i[:, k1t, torch.as_tensor(i2)] = vi
    assert torch.isfinite(out_r).all() and torch.isfinite(out_i).all()
    if mode == "out3d":
        def relayout(o):
            return o.reshape(b, n1, n2 // 128, 128).permute(0, 2, 1, 3).contiguous()

        return relayout(out_r), relayout(out_i)
    return out_r, out_i


def _col_numpy(re, im, mode, n_total=None, col_base=0):
    b, n1, n2 = re.shape
    z = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-2)
    if mode != "nocorr":
        n_total = n_total or n1 * n2
        k1 = np.arange(n1)[:, None]
        i2 = np.arange(n2)[None, :] + col_base
        z = z * np.exp(-2j * np.pi * ((k1 * i2) % n_total) / n_total)
    if mode == "out3d":
        z = np.transpose(z.reshape(b, n1, n2 // 128, 128), (0, 2, 1, 3))
    return z.real, z.imag


@pytest.mark.parametrize("mode", ["nocorr", "classic", "out3d"])
@pytest.mark.parametrize("n1", [1024, 2048])
def test_colfft_cluster_split_matches_plain_and_pallas(n1, mode):
    """colfft_cluster's 4- and 8-block split of a 32-column slab, rebuilt
    block for block: the mode's plain version (1e-6), the Pallas kernel in
    interpret mode (1e-6), numpy (5e-7); n2 = 128 (4 slabs), one batch entry
    (two at n1 = 1024)."""
    import jax.numpy as jnp
    from phastft_tpu.ops import pallas_col

    from phastft_tpu_torch.ops import colfft as col

    n2, b = 128, 2 if n1 == 1024 else 1
    rng = np.random.default_rng(n1 + len(mode))
    re, im = _pair(rng, (b, n1, n2))
    x = (torch.from_numpy(re), torch.from_numpy(im))
    if mode == "nocorr":
        got = _colfft_by_kernel(*x, mode)
        plain = col.colfft_nocorr_plain(*x, n1)
        want = _run_interpret(pallas_col.colfft_pallas_nocorr, jnp.asarray(re),
                              jnp.asarray(im), n1)
    else:
        out3d = mode == "out3d"
        t = col.col_tile3d(n1, n2) if out3d else col.col_tile(n1, n2)
        host = col.col_split_tables_host(n1, n2, "float32", t=t)
        tabs = tuple(torch.from_numpy(a) for a in host)
        got = _colfft_by_kernel(*x, mode, tabs)
        plain = (col.colfft_out3d_plain if out3d else col.colfft_plain)(*x, tabs, n1)
        want = _run_interpret(pallas_col.colfft_pallas, jnp.asarray(re), jnp.asarray(im),
                              tuple(jnp.asarray(a) for a in host), n1, out3d=out3d)
    assert _rel(got, plain) <= TOL
    assert _rel(got, want) <= TOL
    assert _rel(got, _col_numpy(re, im, mode)) <= NUMPY_TOL


def test_colfft_cluster_split_on_a_shard_block():
    """The classic mode with n_total and col_base (a distributed shard's
    column block) on the 8-block split: colfft_plain (1e-6), numpy (5e-7)."""
    from phastft_tpu_torch.ops import colfft as col

    n1, n2, n_total, base = 2048, 64, 1 << 20, 320
    rng = np.random.default_rng(11)
    re, im = _pair(rng, (1, n1, n2))
    x = (torch.from_numpy(re), torch.from_numpy(im))
    t2 = col._shard_t2(n1, col.col_tile(n1, n2), n_total, base, torch.device("cpu"))
    got = _colfft_by_kernel(*x, "classic", t2, n_total)
    plain = col.colfft_plain(*x, None, n1, n_total=n_total, col_base=base)
    assert _rel(got, plain) <= TOL
    assert _rel(got, _col_numpy(re, im, "classic", n_total, base)) <= NUMPY_TOL


# -- leaft: R rows a cluster ----------------------------------------------------

M, LOG_R = 128, 3


def _pad(w):
    w = np.asarray(w)
    return w + ((w >> 5) << 2)


def _leaft_by_kernel(cre, cim, mats, n1):
    """csrc/leaft.cu's leaft_cluster on (b, A, n1, 128), block for block."""
    f1r, f1i, _, f2r, f2i, _, cr, ci = mats
    b, a, _, _ = cre.shape
    log_a = _log2(a)
    r_ = 1 << LOG_R
    log_c = log_a + LOG_R + 7 - 13
    blocks = 1 << log_c
    log_w = 7 - log_c
    w_ = 1 << log_w
    log_rw = LOG_R + log_w
    ka_ = a >> log_c
    groups = n1 >> LOG_R
    words = 8192 + 8192 // 8
    twa = (f1r[1, :a // 2], f1i[1, :a // 2])
    twm = (f2r[1, :64], f2i[1, :64])
    # (b, group, iA, row, iM)
    xr = cre.reshape(b, a, groups, r_, M).permute(0, 2, 1, 3, 4)
    xi = cim.reshape(b, a, groups, r_, M).permute(0, 2, 1, 3, 4)
    smem = [_Smem((b, groups), words) for _ in range(blocks)]
    for c in range(blocks):
        f = np.arange(8192)  # float4 f // 4 is shared word 4 (f // 4), pad()ded
        e, u = f >> 2, f & 3
        v, row = e & (w_ // 4 - 1), (e >> (log_w - 2)) & (r_ - 1)
        ia = e >> (log_rw - 2)
        im_ = w_ * c + 4 * v + u
        smem[c].write(_pad(4 * e + u), xr[:, :, ia, row, im_], xi[:, :, ia, row, im_])
        # F(A) over iA on the R*W columns (row, iM - W c), correction folded
        seq = np.arange(r_ * w_)
        at = _pad(np.arange(a)[None, :] * r_ * w_ + seq[:, None])  # (column, iA)
        vr, vi = smem[c].read(at)
        vr, vi = _dif(vr, vi, log_a, twa, log_a, log_a)
        ka = _bitrev(np.arange(a), log_a)[None, :]
        im_ = (w_ * c + (seq & (w_ - 1)))[:, None]
        c_r, c_i = cr[ka, im_], ci[ka, im_]
        smem[c].write(at, vr * c_r - vi * c_i, vr * c_i + vi * c_r)

    n = a * M * n1
    out_r = torch.full((b, n), float("nan"))
    out_i = torch.full((b, n), float("nan"))
    k0 = np.arange(groups) << LOG_R
    for d in range(blocks):
        # exchange: item (row, r, kl) takes iM = r + 8j from block iM / W
        e = np.arange(2 * THREADS)
        row, r, kl = e & (r_ - 1), (e >> LOG_R) & 7, e >> (LOG_R + 3)
        base = (_bitrev(ka_ * d + kl, log_a) << log_rw) + (row << log_w)
        seq_r = torch.empty((b, groups, len(e), M))
        seq_i = torch.empty_like(seq_r)
        for jj in range(16):
            i = r + 8 * jj
            at = _pad(base + (i & (w_ - 1)))
            for src in range(blocks):
                sel = np.nonzero((i >> log_w) == src)[0]
                vr, vi = smem[src].read(at[sel])
                seq_r[:, :, sel, i[sel]] = vr
                seq_i[:, :, sel, i[sel]] = vi
        seq_r, seq_i = _dif(seq_r, seq_i, 7, twm, 7, 4)  # radix-16 over iM
        own = _Smem((b, groups), words)
        for jj in range(16):
            i = r + 8 * jj
            own.write(_pad((((kl << 7) + i) << LOG_R) + row),
                      seq_r[:, :, np.arange(len(e)), i], seq_i[:, :, np.arange(len(e)), i])
        # the last three stages: item (row, g, kl), iM = 8g + s
        e = np.arange(4 * THREADS)
        row, g, kl = e & (r_ - 1), (e >> LOG_R) & 15, e >> (LOG_R + 4)
        at = _pad((((kl[:, None] << 7) + 8 * g[:, None] + np.arange(8)[None, :]) << LOG_R)
                  + row[:, None])
        vr, vi = own.read(at)
        vr, vi = _dif(vr, vi, 3, (twm[0][::16], twm[1][::16]), 3, 3)
        own.write(at, vr, vi)
        # store: R contiguous rows per (kA, kM) as float4s
        f = np.arange(8192)
        e, u = f >> 2, f & 3
        h, pos = e & (r_ // 4 - 1), (e >> (LOG_R - 2)) & (M - 1)
        kl = e >> (LOG_R - 2 + 7)
        vr, vi = own.read(_pad((((kl << 7) + pos) << LOG_R) + 4 * h) + u)
        km, ka = _bitrev(pos, 7), ka_ * d + kl
        o = torch.as_tensor((km * a + ka)[None, :] * n1 + k0[:, None] + (4 * h + u)[None, :])
        assert torch.isnan(out_r[:, o]).all()  # each output once
        out_r[:, o], out_i[:, o] = vr, vi
    assert torch.isfinite(out_r).all() and torch.isfinite(out_i).all()
    return out_r, out_i


@pytest.mark.parametrize("a", [8, 16, 32, 64, 128])
def test_leaft_cluster_split_matches_plain_and_pallas(a):
    """leaft_cluster's 8-row split (A/8 blocks: one at A = 8 up to 16 at
    A = 128, every instantiation) on n1 = 128, rebuilt block for block:
    leaft_plain (1e-6), leaft_pallas in interpret mode (1e-6), numpy
    (5e-7)."""
    import jax.numpy as jnp
    from phastft_tpu.ops.pallas_leaft import leaft_pallas

    from phastft_tpu_torch.ops.leaft import leaft_plain, leaft_tables_host

    n1, n2 = 128, a * M
    rng = np.random.default_rng(a)
    cre, cim = _pair(rng, (1, a, n1, M))
    host = leaft_tables_host(n2, "float32")
    mats = tuple(torch.from_numpy(np.array(t)) for t in host)
    x = (torch.from_numpy(cre), torch.from_numpy(cim))
    got = _leaft_by_kernel(*x, mats, n1)
    want = _run_interpret(leaft_pallas, jnp.asarray(cre), jnp.asarray(cim),
                          tuple(jnp.asarray(t) for t in host), n1, engine="dense")
    z = np.transpose(cre.astype(np.float64) + 1j * cim, (0, 2, 1, 3)).reshape(1, n1, n2)
    z = np.fft.fft(z, axis=-1).transpose(0, 2, 1).reshape(1, -1)
    assert _rel(got, leaft_plain(*x, mats, n1)) <= TOL
    assert _rel(got, want) <= TOL
    assert _rel(got, (z.real, z.imag)) <= NUMPY_TOL
