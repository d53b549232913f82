"""Lane width, the radix schedule, the host tables (leaf and split
corrections, Stockham step twiddles), and the Stockham DFT along axis -2,
the leaf and the tiny transform in plain torch.

Counterpart of ``LANES``, ``radix_schedule``, ``radix_tables_host``,
``split_correction_host``, ``leaf_correction_host``, ``stockham_axis2``,
``leaf_fft`` and ``tiny_fft`` in the JAX package's ``ops/stockham.py``. The
radix schedule fixes the steps, and so the table keys, of the dd Stockham
DFT (``ops/df64.py``). Of the leaf correction only the numpy branch is
carried: the JAX package hands tables of n1 * lanes >= 2^16 to its C++ host
runtime, and the port asks for at most (256, 128) = 2^15 points (the leaf
plans up to 2^15; the row pass of the split plans needs A * 128 <= 2^14),
so the numpy branch is the one the JAX package takes there too. The
exceptions are the (512, 128) tables at 2^16 of the hybrid leaf (f32) and
of the native f64 leaf, which the JAX package takes from C++; the two are
equal bit for bit (``tests/test_torch_tables.py``,
``tests/test_torch_native.py``).

``stockham_axis2`` runs f32 planes in the JAX kernels' f32 arithmetic and
f64 planes on the f64 step tables of ``radix_tables_host``, as the JAX
package's f64 engine does. With ``leaf_fft`` and ``tiny_fft`` it is the
CPU lowering of the native f64 engine and the plain version of its kernels
(``ops/native.py``); none of them calls ``torch.fft``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["LANES", "DEFAULT_RADIX", "radix_schedule", "radix_tables_host",
           "split_correction_host", "leaf_correction_host", "stockham_axis2",
           "leaf_fft", "tiny_fft"]

LANES = 128

#: Largest radix of one Stockham step.
DEFAULT_RADIX = 16


def radix_schedule(m: int, max_radix: int = DEFAULT_RADIX) -> tuple:
    """Greedy largest-first radix factorization of power-of-2 ``m``."""
    out = []
    lm = m.bit_length() - 1
    lr = max_radix.bit_length() - 1
    while lm > 0:
        k = min(lm, lr)
        out.append(1 << k)
        lm -= k
    return tuple(out)


@functools.lru_cache(maxsize=64)
def radix_tables_host(max_m: int, dtype_name: str,
                      max_radix: int = DEFAULT_RADIX):
    """Host twiddle tables for the Stockham steps of every power-of-2
    length m <= max_m: key (cur, R) -> tuple of (W_cur^{j*p}, p < cur/R)
    pairs shaped (q, 1, 1) for j in 1..R-1, from exact f64 angles cast
    once. Steps with cur == R need no table."""
    dtype = np.dtype(dtype_name)
    tables = {}
    m = 2
    while m <= max_m:
        cur = m
        for radix in radix_schedule(m, max_radix):
            q = cur // radix
            if q > 1 and (cur, radix) not in tables:
                p = np.arange(q, dtype=np.float64)
                entry = []
                for j in range(1, radix):
                    ang = -2.0 * np.pi * j * p / cur
                    entry.append((np.cos(ang).reshape(q, 1, 1).astype(dtype),
                                  np.sin(ang).reshape(q, 1, 1).astype(dtype)))
                tables[(cur, radix)] = tuple(entry)
            cur //= radix
        m *= 2
    return tables


@functools.lru_cache(maxsize=32)
def split_correction_host(n1: int, n2: int, dtype_name: str):
    """Factored split-correction tables for W_n^(k1*i2), n = n1*n2: with
    i2 = a*s + b, s = 2^(log2(n2) // 2), W_n^(k1*i2) = T1[k1, a] *
    T2[k1, b], T1 (n1, n2/s) and T2 (n1, s). Returns (s, T1 re, T1 im,
    T2 re, T2 im), each from exact f64 angles cast once."""
    dtype = np.dtype(dtype_name)
    n = n1 * n2
    s = 1 << ((n2.bit_length() - 1) // 2)
    k1 = np.arange(n1, dtype=np.float64)[:, None]
    a = np.arange(n2 // s, dtype=np.float64)[None, :]
    b = np.arange(s, dtype=np.float64)[None, :]
    ang1 = (-2.0 * np.pi / n) * (k1 * (a * s))
    ang2 = (-2.0 * np.pi / n) * (k1 * b)
    return (s, np.cos(ang1).astype(dtype), np.sin(ang1).astype(dtype),
            np.cos(ang2).astype(dtype), np.sin(ang2).astype(dtype))


@functools.lru_cache(maxsize=64)
def leaf_correction_host(n1: int, lanes: int, dtype_name: str):
    """Host (n1, lanes) twiddle-correction table W_n^(k1*i2), n = n1*lanes."""
    dtype = np.dtype(dtype_name)
    k1 = np.arange(n1, dtype=np.float64)[:, None]
    i2 = np.arange(lanes, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * (k1 * i2) / float(n1 * lanes)
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def _dft_regs(pairs):
    """DFT across a list of 2^k (re, im) tensor pairs, unrolled with
    constant twiddles (recursive natural-order Cooley-Tukey), with the JAX
    package's special cases: w = 1, -i and the |c| = |s| diagonals."""
    m = len(pairs)
    if m == 1:
        return pairs
    ev = _dft_regs(pairs[0::2])
    od = _dft_regs(pairs[1::2])
    out = [None] * m
    for j in range(m // 2):
        er, ei = ev[j]
        orr, oi = od[j]
        ang = -2.0 * np.pi * j / m
        c, s = float(np.cos(ang)), float(np.sin(ang))
        if j == 0:
            tr, ti = orr, oi
        elif 4 * j == m:
            tr, ti = oi, -orr
        elif abs(abs(c) - abs(s)) < 1e-15:
            if s * c < 0:
                tr, ti = c * (orr + oi), c * (oi - orr)
            else:
                tr, ti = c * (orr - oi), c * (oi + orr)
        else:
            tr = orr * c - oi * s
            ti = orr * s + oi * c
        out[j] = (er + tr, ei + ti)
        out[j + m // 2] = (er - tr, ei - ti)
    return out


def _iota_tables(m: int, device):
    """The JAX kernels' in-kernel Stockham twiddles (``_iota_tables`` of
    ``ops/pallas_col.py``): f32 cos/sin of the f32 angle p * f32(-2 pi j /
    cur), as (q, 1, 1) tensors keyed (cur, radix)."""
    tables = {}
    cur = m
    for radix in radix_schedule(m):
        q = cur // radix
        if q > 1 and (cur, radix) not in tables:
            p = torch.arange(q, dtype=torch.float32, device=device).reshape(q, 1, 1)
            entry = []
            for j in range(1, radix):
                ang = p * float(np.float32(-2.0 * np.pi * j / cur))
                entry.append((torch.cos(ang), torch.sin(ang)))
            tables[(cur, radix)] = tuple(entry)
        cur //= radix
    return tables


def _f64_tables(m: int, device):
    """``radix_tables_host(m, "float64")`` as tensors on ``device``."""
    return {key: tuple((torch.from_numpy(wr).to(device), torch.from_numpy(wi).to(device))
                       for wr, wi in entry)
            for key, entry in radix_tables_host(m, "float64").items()}


def stockham_axis2(re, im, m: int):
    """DFT along axis -2 of (..., m, L) planar tensors, in the JAX
    package's arithmetic: radix-16 Stockham steps, natural order in and
    out, no scaling. f32 planes take the in-kernel twiddles
    (``_iota_tables``): the plain version of the Stockham passes inside
    ``leaf_fft_pallas_hybrid`` and ``colfft_pallas_nocorr``. f64 planes
    take the f64 step tables from exact angles (``radix_tables_host``), as
    the JAX package's f64 ``stockham_axis2`` reads them from its planner."""
    if re.dtype == torch.float64:
        tables = _f64_tables(m, re.device)
    else:
        tables = _iota_tables(m, re.device)
    batch = tuple(re.shape[:-2])
    lanes = int(re.shape[-1])
    r = 1
    re = re.reshape(batch + (m, 1, lanes))
    im = im.reshape(batch + (m, 1, lanes))
    cur = m
    for radix in radix_schedule(m):
        q = cur // radix
        xs = [(re[..., j * q:(j + 1) * q, :, :], im[..., j * q:(j + 1) * q, :, :])
              for j in range(radix)]
        ys = _dft_regs(xs)
        outs_r, outs_i = [ys[0][0]], [ys[0][1]]
        for j in range(1, radix):
            yr, yi = ys[j]
            if q > 1:
                wr, wi = tables[(cur, radix)][j - 1]
                yr, yi = yr * wr - yi * wi, yr * wi + yi * wr
            outs_r.append(yr)
            outs_i.append(yi)
        re = torch.stack(outs_r, dim=-3).reshape(batch + (q, radix * r, lanes))
        im = torch.stack(outs_i, dim=-3).reshape(batch + (q, radix * r, lanes))
        cur //= radix
        r *= radix
    return re.reshape(batch + (m, lanes)), im.reshape(batch + (m, lanes))


def leaf_fft(re, im, corr, n1: int):
    """DFT along the last axis of (..., n) planar tensors, n = n1 * LANES,
    as the JAX package's ``leaf_fft``: Stockham F(n1) over the columns of
    the (n1, 128) view, the correction ``corr`` = (re, im) of W_n^(k1*i2)
    (``leaf_correction_host(n1, 128)``; unused at n1 = 1), the swap, and
    Stockham F(128). Natural order in and out; new tensors."""
    batch = tuple(re.shape[:-1])
    re = re.reshape(batch + (n1, LANES))
    im = im.reshape(batch + (n1, LANES))
    if n1 > 1:
        re, im = stockham_axis2(re, im, n1)
        cr, ci = corr
        tr = re * cr - im * ci
        ti = re * ci + im * cr
    else:
        tr, ti = re, im
    tr, ti = stockham_axis2(tr.swapaxes(-1, -2), ti.swapaxes(-1, -2), LANES)
    return tr.reshape(batch + (n1 * LANES,)), ti.reshape(batch + (n1 * LANES,))


def tiny_fft(re, im, n: int):
    """DFT along the last axis for n < LANES, as the JAX package's
    ``tiny_fft``: one Stockham DFT with the row as axis -2; n = 1 is a
    copy. New tensors."""
    if n == 1:
        return re.clone(), im.clone()
    batch = tuple(re.shape[:-1])
    re, im = stockham_axis2(re.reshape(batch + (n, 1)), im.reshape(batch + (n, 1)), n)
    return re.reshape(batch + (n,)), im.reshape(batch + (n,))
