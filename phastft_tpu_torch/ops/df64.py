"""Double-float (df64) arithmetic: f64-class FFTs from paired f32 values.

Counterpart of the JAX package's ``ops/df64.py``. Each logical f64 value
is an unevaluated sum hi + lo of two f32s (~48 significand bits), and a
complex array is four f32 planes (re_hi, re_lo, im_hi, im_lo).

* The host side (numpy): the hi/lo split and join, and the tables, exact
  f64 angles split into dd pairs: the Stockham step twiddles, the leaf
  correction and the factored split correction.
* The dd arithmetic as plain functions on torch tensors: TwoSum, Dekker's
  TwoProd (split constant 4097 = 2^12 + 1), sums and products, the lazy
  forms that skip the renormalisation inside one radix step, the
  register-style DFT over a list of operands, and on them the Stockham
  DFT along axis -2, the leaf and the tiny transform.

These functions are the body of the plain versions of the dd kernels
(``ops/dd.py``) and the ``tiny`` path of ``fourstep.fft_rows_dd``. They
must run eagerly: every f32 operation rounds on its own, which the error-free
transforms need; a compiler that fuses a product into a following sum
breaks TwoProd. The CUDA kernels take TwoProd's error term from one fused
multiply-add instead (``csrc/dd.cuh``), the same exact value.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .stockham import LANES, radix_schedule

__all__ = [
    "split_hi_lo",
    "join_hi_lo",
    "split_f64",
    "dd_radix_tables_host",
    "dd_leaf_correction_host",
    "dd_split_correction_host",
    "dd_add",
    "dd_sub",
    "dd_mul",
    "dd_cmul",
    "stockham_axis2_dd",
    "leaf_fft_dd",
    "tiny_fft_dd",
]

_SPLIT = 4097.0  # 2^12 + 1, Dekker split point for f32


# ---------------------------------------------------------------- host side
def split_hi_lo(x64: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split f64 host array into (hi, lo) f32 with hi + lo == f64(x) to
    ~2^-48 relative."""
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def join_hi_lo(hi, lo) -> np.ndarray:
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def split_f64(x: torch.Tensor):
    """``split_hi_lo`` on an f64 torch tensor: (hi, lo) f32 planes with
    hi + lo == x to ~2^-48 relative."""
    hi = x.float()
    return hi, (x - hi.double()).float()


@functools.lru_cache(maxsize=32)
def dd_radix_tables_host(max_m: int, max_radix: int = 16):
    """Stockham step twiddles as dd pairs: key (cur, R) -> tuple over
    j = 1..R-1 of (re_hi, re_lo, im_hi, im_lo), each (q, 1, 1) f32."""
    tables = {}
    m = 2
    while m <= max_m:
        cur = m
        for R in radix_schedule(m, max_radix):
            q = cur // R
            if q > 1 and (cur, R) not in tables:
                p = np.arange(q, dtype=np.float64)
                entry = []
                for j in range(1, R):
                    ang = -2.0 * np.pi * j * p / cur
                    c = np.cos(ang).reshape(q, 1, 1)
                    s = np.sin(ang).reshape(q, 1, 1)
                    entry.append(split_hi_lo(c) + split_hi_lo(s))
                tables[(cur, R)] = tuple(entry)
            cur //= R
        m *= 2
    return tables


@functools.lru_cache(maxsize=32)
def dd_leaf_correction_host(n1: int, lanes: int):
    """(re_hi, re_lo, im_hi, im_lo) of W_n^(k1*i2), n = n1*lanes."""
    k1 = np.arange(n1, dtype=np.float64)[:, None]
    i2 = np.arange(lanes, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * (k1 * i2) / float(n1 * lanes)
    return split_hi_lo(np.cos(ang)) + split_hi_lo(np.sin(ang))


@functools.lru_cache(maxsize=32)
def dd_split_correction_host(n1: int, n2: int):
    """Factored dd split-correction tables for W_n^(k1*i2), n = n1*n2:
    with i2 = a*S + b, W_n^(k1*i2) = T1[k1,a] * T2[k1,b]; memory
    O(n1*sqrt(n2)) dd entries. Returns (S, T1 dd 4-tuple (n1, n2/S), T2 dd
    4-tuple (n1, S))."""
    n = n1 * n2
    s = 1 << ((n2.bit_length() - 1) // 2)
    k1 = np.arange(n1, dtype=np.float64)[:, None]
    a = np.arange(n2 // s, dtype=np.float64)[None, :]
    b = np.arange(s, dtype=np.float64)[None, :]
    ang1 = (-2.0 * np.pi / n) * (k1 * (a * s))
    ang2 = (-2.0 * np.pi / n) * (k1 * b)
    t1 = split_hi_lo(np.cos(ang1)) + split_hi_lo(np.sin(ang1))
    t2 = split_hi_lo(np.cos(ang2)) + split_hi_lo(np.sin(ang2))
    return s, t1, t2


# ------------------------------------------------------------- dd primitives
def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_renorm(s, e):
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def dd_add(ahi, alo, bhi, blo):
    s, e = _two_sum(ahi, bhi)
    e = e + (alo + blo)
    return _quick_renorm(s, e)


def dd_sub(ahi, alo, bhi, blo):
    return dd_add(ahi, alo, -bhi, -blo)


def _veltkamp(a):
    """Dekker/Veltkamp split a = hi + lo with 12-bit halves (exact)."""
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _veltkamp(a)
    bh, bl = _veltkamp(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _prod_presplit(a, alo, asp, b, blo, bsp):
    """Lazy dd*dd product with both operands' Veltkamp splits given
    (``asp``/``bsp`` = (hi, lo) split pairs of the HI components), so the
    four products of a complex multiply share them."""
    p = a * b
    e = ((asp[0] * bsp[0] - p) + asp[0] * bsp[1] + asp[1] * bsp[0]) + (
        asp[1] * bsp[1]
    )
    return p, e + (a * blo + alo * b)


def dd_mul(ahi, alo, bhi, blo):
    p, e = _two_prod(ahi, bhi)
    e = e + (ahi * blo + alo * bhi)
    return _quick_renorm(p, e)


def dd_cmul(ar, al, ai, ail, br, brl, bi, bil):
    """Complex dd multiply: (ar+i*ai) * (br+i*bi), each component dd.

    Each of the four operand HI components is Veltkamp-split once and the
    split shared across its two products; the products stay lazy until
    the final combine, one renormalisation per output."""
    arsp = _veltkamp(ar)
    aisp = _veltkamp(ai)
    brsp = _veltkamp(br)
    bisp = _veltkamp(bi)
    t1 = _prod_presplit(ar, al, arsp, br, brl, brsp)
    t2 = _prod_presplit(ai, ail, aisp, bi, bil, bisp)
    t3 = _prod_presplit(ar, al, arsp, bi, bil, bisp)
    t4 = _prod_presplit(ai, ail, aisp, br, brl, brsp)
    reh, rel = _dd_sub_lazy(t1[0], t1[1], t2[0], t2[1])
    imh, iml = _dd_add_lazy(t3[0], t3[1], t4[0], t4[1])
    return _quick_renorm(reh, rel) + _quick_renorm(imh, iml)


# ---------------------------------------------------------- lazy primitives
# Lazy (non-renormalizing) dd ops for the register-style DFT. Skipping
# _quick_renorm between butterfly levels lets |lo| grow to a few ulps of
# |hi| inside one radix step; the only term ever dropped is alo*blo,
# bounded by ~2^-44 of the operand scale, and stockham_axis2_dd
# renormalizes every output once per radix step.


def _dd_add_lazy(ahi, alo, bhi, blo):
    s, e = _two_sum(ahi, bhi)
    return s, e + (alo + blo)


def _dd_sub_lazy(ahi, alo, bhi, blo):
    return _dd_add_lazy(ahi, alo, -bhi, -blo)


def _dd_mul_const_lazy(ahi, alo, chi: float, clo: float):
    """Lazy dd * dd-constant (chi, clo python floats, f32-exact values).
    The constant enters as a 0-dim f32 tensor, so its Veltkamp split is
    taken in f32 like every other."""
    c = torch.tensor(chi, dtype=torch.float32, device=ahi.device)
    p, e = _two_prod(ahi, c)
    return p, e + (ahi * clo + alo * chi)


# ------------------------------------------------- dd register-style DFT
def _dft_regs_dd(pairs):
    """DFT across a list of 2^k complex dd values, each a 4-tuple
    (re_hi, re_lo, im_hi, im_lo) of tensors, by recursive natural-order
    Cooley-Tukey with constant twiddles; w = 1, -i and the diagonals are
    special-cased. All intermediates are lazy (unnormalized) dd values:
    the caller renormalizes."""
    m = len(pairs)
    if m == 1:
        return pairs
    ev = _dft_regs_dd(pairs[0::2])
    od = _dft_regs_dd(pairs[1::2])
    out = [None] * m
    for j in range(m // 2):
        erh, erl, eih, eil = ev[j]
        orh, orl, oih, oil = od[j]
        ang = -2.0 * np.pi * j / m
        c, s = float(np.cos(ang)), float(np.sin(ang))
        if j == 0:  # w = 1
            trh, trl, tih, til = orh, orl, oih, oil
        elif 4 * j == m:  # w = -i: t = (oi, -or)
            trh, trl, tih, til = oih, oil, -orh, -orl
        elif abs(abs(c) - abs(s)) < 1e-15:
            # w = c*(1 -+ i); c is not exactly representable in f32, so it
            # is a dd constant and the product two dd multiplies by it
            chi = float(np.float32(c))
            clo = float(np.float32(c - chi))
            if s * c < 0:  # w = c*(1 - i): t = c*(or + oi) + i*c*(oi - or)
                ph, pl = _dd_add_lazy(orh, orl, oih, oil)
                qh, ql = _dd_sub_lazy(oih, oil, orh, orl)
            else:  # w = c*(1 + i), c < 0: t = c*(or - oi) + i*c*(oi + or)
                ph, pl = _dd_sub_lazy(orh, orl, oih, oil)
                qh, ql = _dd_add_lazy(oih, oil, orh, orl)
            trh, trl = _dd_mul_const_lazy(ph, pl, chi, clo)
            tih, til = _dd_mul_const_lazy(qh, ql, chi, clo)
        else:
            chi = float(np.float32(c))
            clo = float(np.float32(c - chi))
            shi = float(np.float32(s))
            slo = float(np.float32(s - shi))
            t1h, t1l = _dd_mul_const_lazy(orh, orl, chi, clo)
            t2h, t2l = _dd_mul_const_lazy(oih, oil, shi, slo)
            t3h, t3l = _dd_mul_const_lazy(orh, orl, shi, slo)
            t4h, t4l = _dd_mul_const_lazy(oih, oil, chi, clo)
            trh, trl = _dd_sub_lazy(t1h, t1l, t2h, t2l)
            tih, til = _dd_add_lazy(t3h, t3l, t4h, t4l)
        out[j] = _dd_add_lazy(erh, erl, trh, trl) + _dd_add_lazy(
            eih, eil, tih, til
        )
        out[j + m // 2] = _dd_sub_lazy(erh, erl, trh, trl) + _dd_sub_lazy(
            eih, eil, tih, til
        )
    return out


# ------------------------------------------------------------ dd Stockham
def stockham_axis2_dd(rh, rl, ih, il, tables, m: int, max_radix: int = 16):
    """DFT along axis -2 of (..., m, L) dd-planar tensors (4 f32 tensors).
    ``tables``: ``dd_radix_tables_host`` entries as tensors on the data's
    device."""
    batch = tuple(rh.shape[:-2])
    lanes = int(rh.shape[-1])
    r = 1
    view = batch + (m, 1, lanes)
    rh, rl, ih, il = (a.reshape(view) for a in (rh, rl, ih, il))
    cur = m
    for R in radix_schedule(m, max_radix):
        q = cur // R
        xs = [
            tuple(
                a[..., j * q : (j + 1) * q, :, :] for a in (rh, rl, ih, il)
            )
            for j in range(R)
        ]
        ys = _dft_regs_dd(xs)

        def renorm(y):
            return _quick_renorm(y[0], y[1]) + _quick_renorm(y[2], y[3])

        # _dft_regs_dd outputs are lazy; every output is renormalized
        # exactly once per radix step: by dd_cmul's internal renorm on
        # the twiddled digits, explicitly on the untwiddled ones.
        outs = [renorm(ys[0])]
        if q == 1:
            outs += [renorm(ys[j]) for j in range(1, R)]
        else:
            entry = tables[(cur, R)]
            for j in range(1, R):
                outs.append(dd_cmul(*ys[j], *entry[j - 1]))
        shape = batch + (q, R * r, lanes)
        rh, rl, ih, il = (
            torch.stack([o[c] for o in outs], dim=-3).reshape(shape)
            for c in range(4)
        )
        cur //= R
        r *= R
    final = batch + (m, lanes)
    return tuple(a.reshape(final) for a in (rh, rl, ih, il))


def leaf_fft_dd(rh, rl, ih, il, tables, corr, n1: int):
    """DFT along the last axis of (..., n), n = n1 * LANES, dd planar."""
    batch = tuple(rh.shape[:-1])
    view = batch + (n1, LANES)
    rh, rl, ih, il = (a.reshape(view) for a in (rh, rl, ih, il))
    if n1 > 1:
        rh, rl, ih, il = stockham_axis2_dd(rh, rl, ih, il, tables, n1)
        rh, rl, ih, il = dd_cmul(rh, rl, ih, il, *corr)
    rh, rl, ih, il = (a.swapaxes(-1, -2) for a in (rh, rl, ih, il))
    rh, rl, ih, il = stockham_axis2_dd(rh, rl, ih, il, tables, LANES)
    out = batch + (n1 * LANES,)
    return tuple(a.reshape(out) for a in (rh, rl, ih, il))


def tiny_fft_dd(rh, rl, ih, il, tables, n: int):
    """DFT along the last axis for n < LANES, dd planar."""
    if n == 1:
        return rh.clone(), rl.clone(), ih.clone(), il.clone()
    batch = tuple(rh.shape[:-1])
    view = batch + (n, 1)
    out = stockham_axis2_dd(
        *(a.reshape(view) for a in (rh, rl, ih, il)), tables, n
    )
    return tuple(a.reshape(batch + (n,)) for a in out)
