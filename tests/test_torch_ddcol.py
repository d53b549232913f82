"""The dd column kernel csrc/ddcol.cu, rebuilt in torch on the CPU.

A CUDA kernel cannot run here, so each test repeats what ddcol.cu does,
pass for pass and block for block, on a flat copy of each block's four
shared-memory planes (NaN until written) addressed with the kernel's own
index formulas, in the dd arithmetic of ``ops/df64.py``:

* the radix-4 trips of dd.cuh's ``dif4_pass`` (the items a pass hands its
  threads and the words they read; a product by -i a swap and a sign, the
  span-4 butterfly without products, the last trip of an odd stage count a
  radix-8) on the kernel's one twiddle table W_n1;
* the correction T1[k1, i2 // t] then T2[k1, i2 % t] folded into the last
  trip;
* ``ddcol_kernel``: a slab of T = 4096 / n1 columns a block, R entries a
  block laid out (i1, r, c) when an entry is smaller than the slab, the last
  block's missing entries masked, the store from shared row bitrev(k1);
* ``ddcol_cluster`` (n1 = 1024, 2048): a 32-column slab over a cluster of
  n1 / 128 blocks, n1 = P * 128, i1 = 128 p + q, k1 = kp + P kq: F(P) over p
  in registers from the loads and W_n1^(kp q), the exchange of one kp a block
  from every block into the first radix-4 trip of F(128), the rest of
  F(128) with the correction, the store of rows k1.

Joined hi + lo, the model is held against ``ddcol_plain`` /
``ddcol_nocorr_plain`` (<= 1e-13) and numpy's f64 FFT (<= 1e-12), and at one
shape per design against the JAX package: ``ddcol_pallas`` in interpret mode
(<= 1e-6, the interpreter's own limit, as in tests/test_torch_kernels.py)
and, at n1 = 2048, which the Pallas kernel refuses, the JAX plain branch
(<= 1e-13).
"""

import functools
import os
import re

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
PALLAS_TOL = 1e-6

# csrc/ddcol.cu's constants (test_model_constants_are_the_kernels pins them)
THREADS = 256
LOCAL, LOG_LOCAL = 4096, 12
WORDS = LOCAL + (LOCAL >> 5) * 4
VECS = LOCAL // 4 // THREADS
LOGCT, CT = 5, 32
LOGQ, Q = 7, 128
CLUSTER_N1 = 1024


def _log2(n):
    return int(n).bit_length() - 1


def _bitrev(k, bits):
    k = np.asarray(k)
    out = np.zeros_like(k)
    for b in range(bits):
        out |= ((k >> b) & 1) << (bits - 1 - b)
    return out


def _pad(w):
    w = np.asarray(w)
    return w + ((w >> 5) << 2)


class _Shared:
    """The four shared-memory planes of a set of blocks (leading dims),
    NaN until written."""

    def __init__(self, lead):
        self.p = [torch.full(lead + (WORDS,), float("nan")) for _ in range(4)]

    def read(self, at):
        at = torch.as_tensor(np.asarray(at))
        vals = tuple(p[..., at] for p in self.p)
        assert all(torch.isfinite(v).all() for v in vals)  # written before read
        return vals

    def write(self, at, vals):
        at = torch.as_tensor(np.asarray(at))
        for p, v in zip(self.p, vals):
            p[..., at] = v


# -- dd arithmetic and the radix-4 trips of csrc/dd.cuh -----------------------

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


def _twiddle(tw, k, log_w):
    """dd.cuh twiddle: W_W^k for 0 <= k < W from the table of k < W/2
    (four planes): W^(k + W/2) = -W^k."""
    h = 1 << (log_w - 1)
    k = torch.as_tensor(np.asarray(k))
    w = tw[:, k & (h - 1)]
    sign = torch.where((k & h) != 0, -1.0, 1.0).to(torch.float32)
    return tuple(w[p] * sign for p in range(4))


def _radix4(x, k, log_w, tw, trivial):
    a, b = _cadd(x[0], x[2]), _cadd(x[1], x[3])
    c, d = _csub(x[0], x[2]), _neg_i(_csub(x[1], x[3]))
    if trivial:
        return [_cadd(a, b), _csub(a, b), _cadd(c, d), _csub(c, d)]
    return [_cadd(a, b), _cmul(_csub(a, b), _twiddle(tw, 2 * k, log_w)),
            _cmul(_cadd(c, d), _twiddle(tw, k, log_w)),
            _cmul(_csub(c, d), _twiddle(tw, 3 * k, log_w))]


def _dif4_group(x, s, r, log_r, log_w, log_l, tw):
    """dd.cuh dif4_group<S> on a list of 2^S dd values (4-tuples over the
    items); r per item."""
    x = list(x)
    for t in range(0, s - 1, 2):
        h = 1 << (s - 2 - t)
        shift = log_w - log_l + t
        trivial = log_l - t == 2
        for j in range(1 << s):
            if j & (3 * h):
                continue
            q = r + ((j & (h - 1)) << log_r)
            x[j], x[j + h], x[j + 2 * h], x[j + 3 * h] = _radix4(
                [x[j], x[j + h], x[j + 2 * h], x[j + 3 * h]], q << shift, log_w, tw,
                trivial)
    if s & 1:
        shift = log_w - log_l + s - 1
        trivial = log_l - (s - 1) == 1
        for j in range(0, 1 << s, 2):
            a, b = x[j], x[j + 1]
            x[j] = _cadd(a, b)
            x[j + 1] = (_csub(a, b) if trivial
                        else _cmul(_csub(a, b), _twiddle(tw, r << shift, log_w)))
    return x


def _dif4_pass(sh, s, log_n, log_l, log_m, qs, is_, qfast, tw, log_w, fold, last):
    """dd.cuh dif4_pass<S>: every item's group loaded, run, folded (last
    trip) and stored back; the items' words are each word once."""
    log_r, log_g = log_l - s, log_n - s
    it = np.arange(1 << (log_g + log_m))
    if qfast:
        q, grp = it & ((1 << log_m) - 1), it >> log_m
    else:
        grp, q = it & ((1 << log_g) - 1), it >> log_g
    r = grp & ((1 << log_r) - 1)
    base = ((grp >> log_r) << log_l) + r
    at = [_pad(q * qs + (base + (j << log_r)) * is_) for j in range(1 << s)]
    assert len(np.unique(np.concatenate(at))) == (1 << (log_n + log_m))
    x = _dif4_group([sh.read(a) for a in at], s, r, log_r, log_w, log_l, tw)
    if last:
        x = [fold(x[j], _bitrev(base + j, log_n), q) for j in range(1 << s)]
    for a, v in zip(at, x):
        sh.write(a, v)


def _dif4_fft(sh, log_n, log_l, log_m, qs, is_, qfast, tw, log_w, fold=None):
    """dd.cuh dif4_fft: radix-4 trips from span 2^log_l down, the last of an
    odd count a radix-8; ``fold`` (if any) in the last trip."""
    while log_l > 0:
        s = 3 if log_l == 3 else 1 if log_l == 1 else 2
        _dif4_pass(sh, s, log_n, log_l, log_m, qs, is_, qfast, tw, log_w, fold,
                   fold is not None and log_l == s)
        log_l -= s


def _corr_fold(tables, n2, log_cols, col0, log_p=0, kp0=0, kp_mask=0):
    """ddcol.cu Corr: output k of sequence q is row
    k1 = (k << log_p) + kp0 + ((q >> log_cols) & kp_mask), column
    i2 = col0 + (q mod 2^log_cols); times T1[k1, i2 >> logt], then
    T2[k1, i2 mod t]. col0 per block (leading dims)."""
    t1, t2 = tables
    t = min(256, n2)
    logt, t1cols = _log2(t), n2 // t
    col0 = np.asarray(col0)[..., None]

    def fold(v, k, q):
        k1 = (k << log_p) + kp0 + ((q >> log_cols) & kp_mask)
        i2 = col0 + (q & ((1 << log_cols) - 1))
        a1 = torch.as_tensor(k1 * t1cols + (i2 >> logt))
        a2 = torch.as_tensor((k1 << logt) + (i2 & (t - 1)))
        v = _cmul(v, tuple(p.reshape(-1)[a1] for p in t1))
        return _cmul(v, tuple(p.reshape(-1)[a2] for p in t2))

    return fold


def _at(q, *idx):
    """q[idx] with numpy index arrays (broadcast)."""
    return q[tuple(torch.as_tensor(np.asarray(i)) for i in idx)]


def _put(out, entry, k1, col, vals, live=True):
    """Store vals at out[entry, k1, col] (index arrays broadcast to vals'
    shape) where ``live``; every element of out is stored once."""
    _, n1, n2 = out[0].shape
    shape = tuple(vals[0].shape)
    flat = np.broadcast_to((np.asarray(entry) * n1 + np.asarray(k1)) * n2 + np.asarray(col),
                           shape)
    live = np.broadcast_to(np.asarray(live), shape).copy()
    flat = flat[live]
    assert len(np.unique(flat)) == len(flat)
    idx, mask = torch.as_tensor(flat), torch.as_tensor(live)
    for o, v in zip(out, vals):
        dst = o.view(-1)
        assert torch.isnan(dst[idx]).all()  # not stored before
        dst[idx] = v[mask]


# -- the two designs of csrc/ddcol.cu -----------------------------------------

def _ddcol_by_kernel(quad, n1, tables=None):
    """csrc/ddcol.cu on (b, n1, n2) planes; ``tables`` = (T1, T2) as
    4-tuples, or None for ddcol_nocorr. Returns the four output planes and
    the design that ran."""
    from phastft_tpu_torch.ops.dd import _dif_twiddles

    b, _, n2 = quad[0].shape
    tw = _dif_twiddles(n1, torch.device("cpu"))
    out = tuple(torch.full((b, n1, n2), float("nan")) for _ in range(4))
    if n1 >= CLUSTER_N1 and n2 >= CT:
        _cluster(quad, n1, tables, tw, out)
        design = "cluster"
    else:
        _one_block(quad, n1, tables, tw, out)
        design = "block"
    assert all(torch.isfinite(o).all() for o in out)
    return out, design


def _one_block(quad, n1, tables, tw, out):
    """ddcol_kernel: the launch's T and R, then every block at once."""
    b, _, n2 = quad[0].shape
    log_n1 = _log2(n1)
    log_t = LOG_LOCAL - log_n1
    if (1 << log_t) > n2:
        log_t = _log2(n2)
    log_r = 0
    if (1 << log_t) == n2:
        while log_n1 + log_t + log_r < LOG_LOCAL and (1 << log_r) < b:
            log_r += 1
    nblk = n2 >> log_t
    blocks = ((b + (1 << log_r) - 1) >> log_r) * nblk
    bid = np.arange(blocks)[:, None]
    col0 = (bid & (nblk - 1)) << log_t
    b0 = (bid >> _log2(nblk)) << log_r
    log_m = log_t + log_r
    points = n1 << log_m
    log_e = log_n1 + log_t
    sh = _Shared((blocks,))

    # element g in device order (r, i1, c) -> shared (i1, r, c); missing
    # entries read as zeros
    g = np.arange(points)[None, :]
    r, i1, c = g >> log_e, (g >> log_t) & (n1 - 1), g & ((1 << log_t) - 1)
    live = b0 + r < b
    entry = np.minimum(b0 + r, b - 1)
    vals = tuple(torch.where(torch.as_tensor(live), _at(q, entry, i1, col0 + c), 0.0)
                 for q in quad)
    sh.write(_pad((i1 << log_m) + (r << log_t) + c)[0], vals)

    fold = (_corr_fold(tables, n2, log_t, col0[:, 0]) if tables is not None else None)
    _dif4_fft(sh, log_n1, log_n1, log_m, 1, 1 << log_m, True, tw, log_n1, fold)

    # shared order (row, r, c): row holds k1 = bitrev(row)
    row, r, c = g >> log_m, (g >> log_t) & ((1 << log_r) - 1), g & ((1 << log_t) - 1)
    _put(out, b0 + r, _bitrev(row, log_n1), col0 + c, sh.read(_pad(g)[0]),
         live=b0 + r < b)


def _cluster(quad, n1, tables, tw, out):
    """ddcol_cluster: every cluster (batch entry, slab) at once, block by
    block."""
    b, _, n2 = quad[0].shape
    log_n1 = _log2(n1)
    log_p = log_n1 - LOGQ
    log_c = log_n1 + LOGCT - LOG_LOCAL
    log_qc, log_kp = LOGQ - log_c, log_p - log_c
    log_m1, log_m2 = log_qc + LOGCT, log_kp + LOGCT
    blocks = 1 << log_c
    assert (1 << log_kp) * (Q // 4) * (CT // 4) == THREADS  # one exchange item a thread
    nblk = n2 >> LOGCT
    slab = np.arange(b * nblk)[:, None]
    col0, entry = (slab & (nblk - 1)) << LOGCT, slab >> _log2(nblk)

    # block c, F(P) in registers: a thread owns 16 / P sequences (ql, column), the column
    # its lane, loads rows i1 = 128 p + (c QC + ql), runs F(P), multiplies output u
    # (kp = bitrev(u)) by W_n1^(kp q) and writes shared (u, ql, column)
    shared = []
    seq = np.arange(1 << log_m1)
    assert len(seq) == THREADS * (16 >> log_p)  # sixteen points a thread
    col, ql = seq & (CT - 1), seq >> LOGCT
    for c in range(blocks):
        q = (c << log_qc) + ql
        x = [tuple(_at(pl, entry, (p << LOGQ) + q[None, :], col0 + col[None, :]) for pl in quad)
             for p in range(1 << log_p)]
        x = _dif4_group(x, log_p, np.zeros_like(seq), 0, log_n1, log_p, tw)
        sh = _Shared((len(slab),))
        for u in range(1 << log_p):
            sh.write(_pad((u << log_m1) + seq),
                     _cmul(x[u], _twiddle(tw, _bitrev(u, log_p) * q, log_n1)))
        shared.append(sh)

    # block d: item (4 columns, r, kpl) takes q = r + 32 j of kp = KP d + kpl
    # from block q / QC, shared row bitrev(kp), into the first radix-4 trip
    t = np.arange(THREADS)
    c4, r = t & (CT // 4 - 1), (t >> (LOGCT - 2)) & (Q // 4 - 1)
    kpl = t >> (LOGCT - 2 + LOGQ - 2)
    for d in range(blocks):
        row = _bitrev((d << log_kp) + kpl, log_p) << log_m1
        y = [[None] * 4 for _ in range(4)]  # [column][j]
        for j in range(4):
            q = r + (Q // 4) * j
            src = q >> log_qc
            for u in range(4):
                w = _pad(row + ((q & ((1 << log_qc) - 1)) << LOGCT) + 4 * c4 + u)
                got = [torch.empty(len(slab), THREADS) for _ in range(4)]
                for s in range(blocks):
                    sel = np.nonzero(src == s)[0]
                    vals = shared[s].read(w[sel])
                    for g_, v in zip(got, vals):
                        g_[:, torch.as_tensor(sel)] = v
                y[u][j] = tuple(got)
        for u in range(4):
            y[u] = _dif4_group(y[u], 2, r, LOGQ - 2, log_n1, LOGQ, tw)
        own = _Shared((len(slab),))
        for j in range(4):
            for u in range(4):
                own.write(_pad(((r + (Q // 4) * j) << log_m2) + (kpl << LOGCT) + 4 * c4 + u),
                          y[u][j])
        fold = (_corr_fold(tables, n2, LOGCT, col0[:, 0], log_p, d << log_kp,
                           (1 << log_kp) - 1) if tables is not None else None)
        _dif4_fft(own, LOGQ, LOGQ - 2, log_m2, 1, 1 << log_m2, True, tw, log_n1, fold)

        # rows k1 = kp + P kq: item (4 columns, kpl, kq)
        e = np.arange(VECS * THREADS)[None, :]
        e4, kl = e & (CT // 4 - 1), (e >> (LOGCT - 2)) & ((1 << log_kp) - 1)
        kq = e >> (LOGCT - 2 + log_kp)
        k1 = (d << log_kp) + kl + (kq << log_p)
        for u in range(4):
            w = _pad((_bitrev(kq, LOGQ) << log_m2) + (kl << LOGCT) + 4 * e4 + u)
            _put(out, entry, k1, col0 + 4 * e4 + u, own.read(w[0]))


# -- cases --------------------------------------------------------------------

def _quad(rng, shape):
    from phastft_tpu_torch.ops.df64 import split_hi_lo

    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    quad = tuple(torch.from_numpy(a) for a in split_hi_lo(z.real) + split_hi_lo(z.imag))
    return quad, z


def _tables(n1, n2):
    from phastft_tpu_torch.ops.dd import dd_col_tables_host

    _, t1, t2 = dd_col_tables_host(n1, n2)
    return (tuple(torch.from_numpy(a) for a in t1), tuple(torch.from_numpy(a) for a in t2))


def _join(quad):
    a = [np.asarray(q, np.float64) for q in quad]
    return (a[0] + a[1]) + 1j * (a[2] + a[3])


def _rel_c(got, want):
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _oracle(z, n1, n2, corr):
    y = np.fft.fft(z, axis=-2)
    if not corr:
        return y
    k1, i2 = np.arange(n1)[:, None], np.arange(n2)[None, :]
    return y * np.exp(-2j * np.pi * (k1 * i2) / (n1 * n2))


@functools.lru_cache(maxsize=None)
def _check(b, n1, n2, corr, want_design):
    """The model against the plain version (1e-13) and numpy (1e-12);
    returns the inputs, the tables and the model's joined output (cached:
    the JAX comparison reuses a case)."""
    from phastft_tpu_torch.ops.dd import ddcol_nocorr_plain, ddcol_plain

    quad, z = _quad(np.random.default_rng((b, n1, n2, corr)), (b, n1, n2))
    tables = _tables(n1, n2) if corr else None
    got, design = _ddcol_by_kernel(quad, n1, tables)
    assert design == want_design
    plain = ddcol_plain(*quad, *tables, n1) if corr else ddcol_nocorr_plain(*quad, n1)
    g = _join(got)
    assert _rel_c(g, _join(plain)) <= DD_TOL
    assert _rel_c(g, _oracle(z, n1, n2, corr)) <= DD_NUMPY_TOL
    return quad, tables, g


@pytest.mark.parametrize("n1,n2", [(2, 4096), (4, 2048), (8, 1024), (16, 512), (32, 256),
                                   (64, 128), (128, 64), (256, 32), (512, 16), (1024, 8),
                                   (2048, 4)])
def test_radix4_trips_with_the_radix8_end(n1, n2):
    """One block a slab, bare DFT: the radix-4 trips of every n1 (odd log2
    ending on a radix-8), two slabs an entry; at n1 = 1024 with 8 columns
    and 2048 with 4 the one-block design takes 4 and 2 columns a block (2
    element by element)."""
    _check(1, n1, n2, False, "block")


@pytest.mark.parametrize("n1,n2,b", [(2, 4096, 1), (8, 1024, 1), (64, 512, 2),
                                     (256, 256, 1), (512, 512, 1)])
def test_correction_t1_then_t2_in_the_last_trip(n1, n2, b):
    """The split correction multiplied in the registers of the last trip:
    T1 (several columns from n2 = 512) then T2, at the block's rows k1 and
    columns i2."""
    _check(b, n1, n2, True, "block")


@pytest.mark.parametrize("n1,n2,b,corr", [(1024, 128, 1, True), (1024, 32, 2, False),
                                          (2048, 128, 1, True), (2048, 32, 3, False)])
def test_cluster_split_and_exchange(n1, n2, b, corr):
    """Long columns: a 32-column slab over 8 (n1 = 1024) or 16 (2048)
    blocks, F(P) and W_n1^(kp q), the exchange from every block, F(128)
    with the correction folded in, the store of rows kp + P kq."""
    _check(b, n1, n2, corr, "cluster")


@pytest.mark.parametrize("b,n1,n2,corr", [(5, 2, 128, True), (7, 64, 16, False),
                                          (3, 128, 2, False), (5, 128, 8, False),
                                          (6, 16, 128, True)])
def test_entries_per_block_store_index_and_ragged_last_block(b, n1, n2, corr):
    """Entries smaller than the slab: R entries a block laid out (i1, r, c),
    the last block's missing entries masked on load and store, the store
    from shared row bitrev(k1) (n2 = 2 element by element)."""
    _check(b, n1, n2, corr, "block")


def _jax_plain_branch(quad, n1, n2):
    """The JAX package's plain branch of the dd column pass:
    stockham_axis2_dd, then the two dd_cmuls of the factored correction."""
    import jax.numpy as jnp
    from phastft_tpu.ops import df64 as jax_df64
    from phastft_tpu.ops.pallas_dd import dd_col_tables_host as jax_tables

    tables = {k: tuple(tuple(jnp.asarray(a) for a in digit) for digit in v)
              for k, v in jax_df64.dd_radix_tables_host(n1).items()}
    out = tuple(jax_df64.stockham_axis2_dd(*(jnp.asarray(q.numpy()) for q in quad),
                                           tables, n1))
    t, t1, t2 = jax_tables(n1, n2)
    batch = out[0].shape[:-2]
    out = tuple(a.reshape(batch + (n1, n2 // t, t)) for a in out)
    out = jax_df64.dd_cmul(*out, *(jnp.asarray(a)[:, :, None] for a in t1))
    out = jax_df64.dd_cmul(*out, *(jnp.asarray(a)[:, None, :] for a in t2))
    return _join(out).reshape(batch + (n1, n2))


@pytest.mark.parametrize("b,n1,n2,design", [(2, 8, 256, "block"), (1, 1024, 128, "cluster"),
                                            (1, 2048, 128, "cluster")])
def test_model_matches_the_jax_package(b, n1, n2, design):
    """One shape per design against the JAX package: ddcol_pallas in
    interpret mode (it takes n1 <= 1024), the JAX plain branch at 2048."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from phastft_tpu.ops import pallas_dd

    quad, tables, g = _check(b, n1, n2, True, design)
    if n1 > 1024:
        assert _rel_c(g, _jax_plain_branch(quad, n1, n2)) <= DD_TOL
        return
    with pltpu.force_tpu_interpret_mode():
        want = pallas_dd.ddcol_pallas(
            *(jnp.asarray(q.numpy()) for q in quad),
            *(tuple(jnp.asarray(a.numpy()) for a in tab) for tab in tables), n1)
    assert want is not None
    assert _rel_c(g, _join(want)) <= PALLAS_TOL


def test_model_constants_are_the_kernels():
    """The model's block, slab and cluster constants are csrc/ddcol.cu's."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "phastft_tpu_torch",
                        "csrc", "ddcol.cu")
    with open(path) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert const("THREADS") == THREADS
    assert const("LOCAL") == LOCAL and const("LOG_LOCAL") == LOG_LOCAL
    assert const("LOGCT") == LOGCT and const("LOGQ") == LOGQ
    assert const("CLUSTER_N1") == CLUSTER_N1
    assert "__launch_bounds__(THREADS, 2)" in src
