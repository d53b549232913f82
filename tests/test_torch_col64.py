"""The native f64 column kernel csrc/col64.cu at n1 = 1024 and 2048, rebuilt
in torch on the CPU, its bare mode, and its tables on a distributed shard's
column block.

A CUDA kernel cannot run here, so this file repeats what ``col64.cu`` does
at the long column factors, trip for trip and block for block, with the
kernel's own index formulas, on a flat copy of each block's shared memory
(NaN until written, so a read of a slot no step wrote shows in the output):

* ``col64_cluster`` (n1 = 1024, 2048 with n2 >= 32): a slab of W = 256 / P
  columns (32, 16) over a cluster of 8 blocks, n1 = P * 128, i1 = 128 p + q,
  k1 = kp + P kq: F(P) over p in registers straight from the loads (W / 16
  sequences a thread, the column its lane) and W_n1^(kp q), the exchange of
  the block's P / 8 values of kp from every block (a thread one column, one
  kp and q = r + 8 j) into a radix-16 group of F(128), the last radix-8
  with the split twiddle T1 then T2 folded in straight from the block's
  buffer to the store of rows kp + P kq;
* ``col64_kernel`` at those n1 with n2 < 32: one block a slab of
  min(4096 / n1, n2) columns, radix-4 DIF trips with the fold in the last.

The model is held against ``col64_plain`` (rel L2 <= 1e-13: the same DFT
summed in another order) and numpy. ``col64_plain`` itself is held against
the JAX package's ``stockham_axis2`` and its ``split{n1}x{n2}`` correction
at both factors. The bare mode (``col64_nocorr``, the twiddle products a
template argument of both designs) is the same model with no fold, held
against ``col64_nocorr_plain``; that and ``col64_plain`` on the tables of
``col64_shard_tables`` are held against the JAX package's ``stockham_axis2``
and its shard twiddle ``_local_correction_cols``
(``phastft_tpu/parallel/fourstep_dist.py:103``). The kernel on the card is
checked by ``chip_smoke.py``.
"""

import os
import re

import numpy as np
import pytest
import torch

from phastft_tpu_torch.ops.native import (
    col64, col64_nocorr, col64_nocorr_plain, col64_plain, col64_shard_tables,
    dif_twiddles_host,
)
from phastft_tpu_torch.ops.stockham import split_correction_host


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-13        # the same algorithm, summed in another order
NUMPY_TOL = 1e-12  # the f64 contract of the port's tests

# csrc/col64.cu's constants (test_model_constants_are_the_kernels pins them)
THREADS = 256
LOCAL, LOG_LOCAL = 4096, 12
LOGCT, CT = 5, 32
LOGQ = 7
LOGCB, CB = 3, 8
LOG_SLAB_POINTS = 8
CLUSTER_N1 = 1024
SLOTS = LOCAL + (LOCAL >> 3)


def _log2(n):
    return int(n).bit_length() - 1


def _t(index):
    return torch.as_tensor(np.array(index))


def _bitrev(k, bits):
    k = np.asarray(k)
    out = np.zeros_like(k)
    for b in range(bits):
        out |= ((k >> b) & 1) << (bits - 1 - b)
    return out


def _pad2(w):
    """f64.cuh pad2: one padding slot after every 8."""
    w = np.asarray(w)
    return w + (w >> 3)


class _Shared:
    """The shared buffers of a set of blocks (leading dims), NaN until
    written."""

    def __init__(self, lead):
        self.mem = torch.full(lead + (SLOTS,), complex(np.nan, np.nan), dtype=torch.complex128)

    def read(self, at):
        vals = self.mem[..., _t(at)]
        assert torch.isfinite(vals.real).all()  # written before read
        return vals

    def write(self, at, vals):
        self.mem[..., _t(at)] = vals


# -- f64.cuh's twiddles and radix-4 DIF trips ---------------------------------

def _twiddle(tw, k, log_n):
    """f64.cuh twiddle: W_N^k for 0 <= k < N from the table of k < N/2
    (W^(k + N/2) = -W^k)."""
    h = 1 << (log_n - 1)
    k = np.asarray(k)
    return tw[_t(k & (h - 1))] * _t(np.where(k & h, -1.0, 1.0))


def _radix4(x, k, log_w, tw, trivial):
    a, b = x[0] + x[2], x[1] + x[3]
    c, d = x[0] - x[2], (x[1] - x[3]) * -1j
    if trivial:
        return [a + b, a - b, c + d, c - d]
    return [a + b, (a - b) * _twiddle(tw, 2 * k, log_w), (c + d) * _twiddle(tw, k, log_w),
            (c - d) * _twiddle(tw, 3 * k, log_w)]


def _dif4_group(x, s, r, log_r, log_w, log_l, tw):
    """f64.cuh dif4_group<S> on a list of 2^S values; r per item."""
    x = list(x)
    r = np.asarray(r)
    for t in range(0, s - 1, 2):
        h = 1 << (s - 2 - t)
        shift = log_w - log_l + t
        trivial = log_l - t == 2
        for j in range(1 << s):
            if j & (3 * h):
                continue
            q = r + ((j & (h - 1)) << log_r)
            x[j], x[j + h], x[j + 2 * h], x[j + 3 * h] = _radix4(
                [x[j], x[j + h], x[j + 2 * h], x[j + 3 * h]], q << shift, log_w, tw, trivial)
    if s & 1:
        shift = log_w - log_l + s - 1
        trivial = log_l - (s - 1) == 1
        for j in range(0, 1 << s, 2):
            a, b = x[j], x[j + 1]
            x[j] = a + b
            x[j + 1] = a - b if trivial else (a - b) * _twiddle(tw, r << shift, log_w)
    return x


def _dif4_pass(sh, s, log_n, log_l, log_m, qs, is_, tw, log_w, fold, last):
    """f64.cuh dif4_pass<S> with ``qfast`` (neighbouring items on
    neighbouring sequences): every item's group read, run, folded (last
    trip) and written back; the items' slots are each slot once."""
    log_r, log_g = log_l - s, log_n - s
    it = np.arange(1 << (log_g + log_m))
    q, grp = it & ((1 << log_m) - 1), it >> log_m
    r = grp & ((1 << log_r) - 1)
    base = ((grp >> log_r) << log_l) + r
    at = [_pad2(q * qs + (base + (j << log_r)) * is_) for j in range(1 << s)]
    assert len(np.unique(np.concatenate(at))) == (1 << (log_n + log_m))
    x = _dif4_group([sh.read(a) for a in at], s, r, log_r, log_w, log_l, tw)
    if last:
        x = [fold(x[j], _bitrev(base + j, log_n), q) for j in range(1 << s)]
    for a, v in zip(at, x):
        sh.write(a, v)


def _dif4_fft(sh, log_n, log_l, log_m, qs, is_, tw, log_w, fold):
    """f64.cuh dif4_fft: trips from span 2^log_l down (trip_stages: radix-4,
    the last four stages 3 + 1, a last three one radix-8), ``fold`` in the
    last."""
    while log_l > 0:
        s = 3 if log_l in (3, 4) else 1 if log_l == 1 else 2
        _dif4_pass(sh, s, log_n, log_l, log_m, qs, is_, tw, log_w, fold, log_l == s)
        log_l -= s


def _split_fold(tables, n2, col0, log_p=0, kp0=0):
    """col64.cu SplitCorr: output k of sequence q is row k1 = (k << log_p) +
    kp0 and column i2 = col0 + q, times T1[k1, i2 >> logs], then
    T2[k1, i2 mod s]. col0 per block (leading dims). ``tables`` None: the
    bare mode (CORR false), which folds nothing."""
    if tables is None:
        return lambda v, k, q: v
    t1r, t1i, t2r, t2i = (torch.from_numpy(a) for a in tables)
    t1, t2 = torch.complex(t1r, t1i).reshape(-1), torch.complex(t2r, t2i).reshape(-1)
    logs = _log2(n2) // 2
    t1cols = n2 >> logs
    col0 = np.asarray(col0)[..., None]

    def fold(v, k, q):
        k1 = (np.asarray(k) << log_p) + kp0
        i2 = col0 + q
        return v * t1[_t(k1 * t1cols + (i2 >> logs))] * t2[_t((k1 << logs)
                                                            + (i2 & ((1 << logs) - 1)))]

    return fold


def _store(out, entry, k1, col, vals):
    """out[entry, k1, col] = vals (index arrays broadcast); every element
    of out is stored once."""
    _, n1, n2 = out.shape
    flat = np.broadcast_to((np.asarray(entry) * n1 + np.asarray(k1)) * n2 + np.asarray(col),
                           tuple(vals.shape)).reshape(-1)
    assert len(np.unique(flat)) == len(flat)
    dst = out.view(-1)
    assert torch.isnan(dst[_t(flat)].real).all()  # not stored before
    dst[_t(flat)] = vals.reshape(-1)


# -- the two designs of csrc/col64.cu -----------------------------------------

def _col64_by_kernel(x, n1, tables):
    """csrc/col64.cu on a complex (b, n1, n2) tensor; returns the output and
    the design that ran."""
    b, _, n2 = x.shape
    tw = torch.from_numpy(dif_twiddles_host(n1)).contiguous()
    tw = torch.complex(tw[:, 0].contiguous(), tw[:, 1].contiguous())
    out = torch.full((b, n1, n2), complex(np.nan, np.nan), dtype=torch.complex128)
    if n1 >= CLUSTER_N1 and n2 >= CT:
        _cluster(x, n1, tables, tw, out)
        design = "cluster"
    else:
        _one_block(x, n1, tables, tw, out)
        design = "block"
    assert torch.isfinite(out.real).all()
    return out, design


def _one_block(x, n1, tables, tw, out):
    """col64_kernel: a slab of T = min(4096 / n1, n2) columns a block; the
    shared order (i1, c), the trips, the store from row bitrev(k1)."""
    b, _, n2 = x.shape
    log_n1 = _log2(n1)
    log_t = min(LOG_LOCAL - log_n1, _log2(n2))
    nblk = n2 >> log_t
    bid = np.arange(b * nblk)[:, None]
    col0, entry = (bid & (nblk - 1)) << log_t, bid >> _log2(nblk)
    f = np.arange(n1 << log_t)[None, :]
    # the points a thread moves: two neighbouring columns of PAIRS double2s
    pairs = 2 * (np.arange(THREADS)[:, None] + THREADS * np.arange(LOCAL // 2 // THREADS))
    assert set(pairs.reshape(-1)) >= set(range(0, n1 << log_t, 2))
    sh = _Shared((len(bid),))
    sh.write(_pad2(f)[0], x[_t(entry), _t(f >> log_t), _t(col0 + (f & ((1 << log_t) - 1)))])
    fold = _split_fold(tables, n2, col0[:, 0])
    _dif4_fft(sh, log_n1, log_n1, log_t, 1, 1 << log_t, tw, log_n1, fold)
    _store(out, entry, _bitrev(f >> log_t, log_n1), col0 + (f & ((1 << log_t) - 1)),
           sh.read(_pad2(f)[0]))


def _cluster(x, n1, tables, tw, out):
    """col64_cluster<LOGP>: every cluster (batch entry, slab) at once, block
    by block."""
    b, _, n2 = x.shape
    log_n1 = _log2(n1)
    log_p = log_n1 - LOGQ
    p_ = 1 << log_p
    log_w = LOG_SLAB_POINTS - log_p
    w_ = 1 << log_w
    log_kp = log_p - LOGCB
    assert n1 * w_ == CB * LOCAL  # the cluster: one slab, 8 blocks of 4096 points
    log_qc = LOGQ - LOGCB
    log_m1 = log_qc + log_w
    nblk = n2 >> log_w
    slab = np.arange(b * nblk)[:, None]
    col0, entry = (slab & (nblk - 1)) << log_w, slab >> _log2(nblk)

    # block c: a thread owns W / 16 sequences seq = tid + 256 t, the column
    # its lane; loads rows i1 = 128 p + (16 c + ql), runs F(P), multiplies
    # output u (kp = bitrev(u)) by W_n1^(kp q), writes shared (u, ql, column)
    seq = (np.arange(THREADS)[None, :]
           + THREADS * np.arange((1 << log_m1) // THREADS)[:, None]).reshape(-1)
    assert np.array_equal(np.sort(seq), np.arange(1 << log_m1))
    col, ql = seq & (w_ - 1), seq >> log_w
    shared = []
    for c in range(CB):
        q = (c << log_qc) + ql
        v = [x[_t(entry), _t((p << LOGQ) + q[None, :]), _t(col0 + col[None, :])]
             for p in range(p_)]
        v = _dif4_group(v, log_p, np.zeros_like(seq), 0, log_n1, log_p, tw)
        sh = _Shared((len(slab),))
        for u in range(p_):
            sh.write(_pad2((u << log_m1) + seq),
                     v[u] * _twiddle(tw, _bitrev(u, log_p) * q, log_n1))
        shared.append(sh)

    # block d: item (column, r, kl) takes q = r + 8 j, j < 16, of
    # kp = KP d + kl from block q / 16, shared row bitrev(kp), into a
    # radix-16 group of F(128)
    t = np.arange(THREADS)
    tc, r, kl = t & (w_ - 1), (t >> log_w) & 7, t >> (log_w + 3)
    for d in range(CB):
        row = _bitrev((d << log_kp) + kl, log_p) << log_m1
        y = []
        for j in range(16):
            q = r + 8 * j
            src = q >> log_qc
            w = _pad2(row + ((q & ((1 << log_qc) - 1)) << log_w) + tc)
            got = torch.empty(len(slab), THREADS, dtype=torch.complex128)
            for s in range(CB):
                sel = np.nonzero(src == s)[0]
                got[:, _t(sel)] = shared[s].read(w[sel])
            y.append(got)
        y = _dif4_group(y, 4, r, 3, log_n1, LOGQ, tw)
        own = _Shared((len(slab),))
        for j in range(16):
            own.write(_pad2((((kl << LOGQ) + r + 8 * j) << log_w) + tc), y[j])

        # the last radix-8 of F(128) straight from the buffer to the stores:
        # item (column, g, kl), output j is kq = bitrev(8 g + j), row
        # k1 = kp + P kq, the split twiddle folded in
        for it in range(2):
            e = t + it * THREADS
            ec, g, el = e & (w_ - 1), (e >> log_w) & 15, e >> (log_w + 4)
            xs = [own.read(_pad2((((el << LOGQ) + 8 * g + j) << log_w) + ec))
                  for j in range(8)]
            xs = _dif4_group(xs, 3, np.zeros_like(e), 0, log_n1, 3, tw)
            kp0 = (d << log_kp) + el
            fold = _split_fold(tables, n2, col0[:, 0], log_p, kp0)
            for j in range(8):
                kq = _bitrev(8 * g + j, LOGQ)
                _store(out, entry, kp0 + (kq << log_p), col0 + ec, fold(xs[j], kq, ec))


# -- cases --------------------------------------------------------------------

def _case(b, n1, n2):
    rng = np.random.default_rng((b, n1, n2))
    z = rng.standard_normal((b, n1, n2)) + 1j * rng.standard_normal((b, n1, n2))
    return z, split_correction_host(n1, n2, "float64")[1:]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _oracle(z, n1, n2):
    k1, i2 = np.arange(n1)[:, None], np.arange(n2)[None, :]
    return np.fft.fft(z, axis=-2) * np.exp(-2j * np.pi * (k1 * i2) / (n1 * n2))


def _plain(z, n1, tables):
    tabs = tuple(torch.from_numpy(a) for a in tables)
    steps = torch.from_numpy(dif_twiddles_host(n1))
    out = col64_plain(torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy()), tabs,
                      n1, steps)
    return out[0].numpy() + 1j * out[1].numpy()


@pytest.mark.parametrize("b,n1,n2,design", [
    (1, 1024, 32, "cluster"), (2, 1024, 64, "cluster"), (1, 2048, 32, "cluster"),
    (1, 2048, 128, "cluster"), (3, 1024, 16, "block"), (1, 2048, 16, "block"),
    (2, 2048, 2, "block"),
])
def test_long_columns_schedule_matches_plain(b, n1, n2, design):
    """The cluster design (P x 128 split, F(P) in registers and W_n1^(kp q),
    the exchange into the radix-16 group, the last radix-8 trip with the
    split twiddle, the store of rows kp + P kq; several slabs and entries),
    and the one-block design below a 32-column slab, against col64_plain
    and numpy."""
    z, tables = _case(b, n1, n2)
    got, ran = _col64_by_kernel(torch.from_numpy(z), n1, tables)
    assert ran == design
    got = got.numpy()
    assert _rel(got, _plain(z, n1, tables)) <= TOL
    assert _rel(got, _oracle(z, n1, n2)) <= NUMPY_TOL


@pytest.mark.parametrize("n1,n2", [(1024, 64), (2048, 32)])
def test_col64_plain_matches_jax_column_pass(n1, n2):
    """col64_plain at the long factors against the JAX package's native
    column pass: stockham_axis2 on its f64 radix tables, then its
    split{n1}x{n2} tables T1 then T2 (phastft_tpu/ops/fourstep.py)."""
    import jax.numpy as jnp
    from phastft_tpu.ops.stockham import radix_tables_host, split_correction_host as jax_split
    from phastft_tpu.ops.stockham import stockham_axis2 as jax_st

    z, tables = _case(2, n1, n2)
    radix = {k: tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in v)
             for k, v in radix_tables_host(n1, "float64").items()}
    br, bi = jax_st(jnp.asarray(z.real), jnp.asarray(z.imag), radix, n1)
    s, t1r, t1i, t2r, t2i = jax_split(n1, n2, "float64")
    u = (np.asarray(br) + 1j * np.asarray(bi)).reshape(2, n1, n2 // s, s)
    want = (u * (t1r + 1j * t1i)[:, :, None] * (t2r + 1j * t2i)[:, None, :]).reshape(2, n1, n2)
    got = _plain(z, n1, tables)
    assert _rel(got, want) <= TOL
    assert _rel(got, _oracle(z, n1, n2)) <= NUMPY_TOL


def _nocorr_plain(z, n1):
    steps = torch.from_numpy(dif_twiddles_host(n1))
    out = col64_nocorr_plain(torch.from_numpy(z.real.copy()),
                             torch.from_numpy(z.imag.copy()), n1, steps)
    return out[0].numpy() + 1j * out[1].numpy()


@pytest.mark.parametrize("b,n1,n2,design", [
    (1, 1024, 32, "cluster"), (1, 2048, 64, "cluster"), (3, 1024, 16, "block"),
    (2, 64, 64, "block"), (1, 8, 2, "block"),
])
def test_nocorr_schedule_matches_plain(b, n1, n2, design):
    """The bare mode: both designs with no twiddle product in the last trip,
    against col64_nocorr_plain and numpy's column DFT."""
    z, _ = _case(b, n1, n2)
    got, ran = _col64_by_kernel(torch.from_numpy(z), n1, None)
    assert ran == design
    got = got.numpy()
    assert _rel(got, _nocorr_plain(z, n1)) <= TOL
    assert _rel(got, np.fft.fft(z, axis=-2)) <= NUMPY_TOL


def _jax_columns(z, n1):
    """The JAX package's f64 stockham_axis2 on its radix tables."""
    import jax.numpy as jnp
    from phastft_tpu.ops.stockham import radix_tables_host
    from phastft_tpu.ops.stockham import stockham_axis2 as jax_st

    radix = {k: tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in v)
             for k, v in radix_tables_host(n1, "float64").items()}
    br, bi = jax_st(jnp.asarray(z.real), jnp.asarray(z.imag), radix, n1)
    return np.asarray(br) + 1j * np.asarray(bi)


@pytest.mark.parametrize("n1,n2", [(8, 2), (256, 8), (2048, 4)])
def test_col64_nocorr_plain_matches_jax_stockham(n1, n2):
    """col64_nocorr_plain against the JAX package's stockham_axis2, the
    permuted-input branch's column pass (fourstep_dist.py:203)."""
    z, _ = _case(2, n1, n2)
    got = _nocorr_plain(z, n1)
    assert _rel(got, _jax_columns(z, n1)) <= TOL
    assert _rel(got, np.fft.fft(z, axis=-2)) <= NUMPY_TOL


#: (n, n1, ncols, col_base) of shard blocks: the one-block and cluster
#: designs' shapes, a base that is not a multiple of the block's width, and
#: the narrowest block col64 takes.
SHARD_BLOCKS = [(1 << 16, 64, 256, 512), (1 << 20, 1024, 64, 960),
                (1 << 12, 8, 2, 510), (1 << 22, 2048, 32, 2016)]


@pytest.mark.parametrize("n,n1,ncols,col_base", SHARD_BLOCKS)
def test_shard_tables_match_jax_local_correction(n, n1, ncols, col_base):
    """col64 on a shard's (n1, ncols) block with col64_shard_tables: the
    JAX package's column DFT times its _local_correction_cols, W_n^(k1 *
    (col_base + j)), and numpy; the kernel model runs the same tables."""
    import jax.numpy as jnp
    from phastft_tpu.parallel.fourstep_dist import _local_correction_cols

    rng = np.random.default_rng(ncols)
    z = rng.standard_normal((n1, ncols)) + 1j * rng.standard_normal((n1, ncols))
    tabs = col64_shard_tables(n, n1, ncols, col_base, torch.device("cpu"))
    steps = torch.from_numpy(dif_twiddles_host(n1))
    out = col64(torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy()), tabs,
                n1, steps)
    got = out[0].numpy() + 1j * out[1].numpy()
    cr, ci = _local_correction_cols(n1, n // n1, jnp.asarray(col_base), ncols,
                                    jnp.float64)
    want = _jax_columns(z, n1) * (np.asarray(cr) + 1j * np.asarray(ci))
    assert _rel(got, want) <= TOL
    k1, j = np.arange(n1)[:, None], np.arange(ncols)[None, :]
    oracle = np.fft.fft(z, axis=0) * np.exp(-2j * np.pi * (k1 * (col_base + j)) / n)
    assert _rel(got, oracle) <= NUMPY_TOL
    model, _ = _col64_by_kernel(torch.from_numpy(z[None]), n1,
                                tuple(t.numpy() for t in tabs))
    assert _rel(model.numpy()[0], got) <= TOL


def test_shard_tables_and_nocorr_check_their_arguments():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="do not lie"):
        col64_shard_tables(1 << 12, 8, 256, 384, cpu)  # past the 512 columns
    with pytest.raises(ValueError, match="do not lie"):
        col64_shard_tables(1 << 12, 8, 0, 0, cpu)  # no column
    x = torch.zeros(8, 16, dtype=torch.float64)
    steps = torch.from_numpy(dif_twiddles_host(8))
    with pytest.raises(ValueError, match="col64_nocorr: unsupported shape"):
        col64_nocorr(x[:, :3], x[:, :3], 8, steps)  # not a power of two
    with pytest.raises(TypeError, match="float64"):
        col64_nocorr(x.float(), x.float(), 8, steps)
    with pytest.raises(ValueError, match="dif8"):
        col64_nocorr(x, x, 8, torch.from_numpy(dif_twiddles_host(16)))


def test_model_constants_are_the_kernels():
    """The model's block, slab and cluster constants are csrc/col64.cu's,
    and the entry takes n1 up to 2048."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "phastft_tpu_torch",
                        "csrc", "col64.cu")
    with open(path) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert const("THREADS") == THREADS
    assert const("LOCAL") == LOCAL and const("LOG_LOCAL") == LOG_LOCAL
    assert const("LOGCT") == LOGCT and const("LOGQ") == LOGQ
    assert const("LOGCB") == LOGCB and const("LOG_SLAB_POINTS") == LOG_SLAB_POINTS
    assert const("CLUSTER_N1") == CLUSTER_N1
    assert "__launch_bounds__(THREADS, 2)" in src
    assert "n1 > 2048" in src and "phastft_col64_clusters" in src
    assert "phastft_col64_nocorr" in src and "CORR ? fold(x[j], kq, ec) : x[j]" in src
