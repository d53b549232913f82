"""Column passes of any factor: the column kernels up to their 2048, and
past it the long columns, a column factor n1 = P * Q as two column passes
and two transposes.

A column pass takes a block (..., n1, c) whose columns [col_base,
col_base + c) lie in a transform of n points split n1 x n / n1, and
returns the DFT over n1 times, unless ``bare``, the twiddle
W_n^(k1*(col_base + j)). The distributed four-step runs it on a rank's
column block (``parallel/fourstep_dist.py``); a single-device leaf past the
leaf kernels' 2^17 points runs it on its (n1, 128) view, the block of every
column (``ops/fourstep.py``). Up to n1 = 2048 it is one launch of the
column kernel (``colfft`` with ``n_total`` and ``col_base``, or
``colfft_nocorr``; ``col64`` on the block's tables, or ``col64_nocorr``),
at any width c >= 1.

Past 2048 (the JAX package's XLA column pass there, where its column
kernel declines the shape: ``phastft_tpu/parallel/fourstep_dist.py``
``:103-110``, ``:266-274``, and its XLA ``leaf_fft``,
``phastft_tpu/ops/stockham.py:236``), with n1 = P * Q (``long_split``),
i1 = Q p + q and k1 = kp + P kq:

  1. the DFT over p on the (P, Q c) view, times W_n1^(kp q) and the
     block's twiddle's share W_n^(kp (col_base + j)): ``col64`` on
     ``_level_tables``; in f32, ``colfft`` where that is its own shard
     twiddle (a block of every column, c = n / n1, not bare), else
     ``colfft_nocorr`` and the twiddle in plain torch (``twiddle_``);
  2. the DFT over q of the (Q, c) blocks, a batch of P, times the rest
     W_{n/P}^(kq (col_base + j)): a column pass once more, on a transform
     of n / P points;
  3. (P, Q, c) -> (Q, P, c), rows k1 in natural order: two transposes.

It won the H100 timing against the other route, the block transposed to
(c, n1), the row plan of length n1, the twiddle in torch and the transpose
back (``PERF.md``). ``dd_columns`` is the same for the df64 engine's dd
quadruples, on a block of every column (col_base = 0, not bare): ``ddcol``
with ``dd_col_tables_host`` up to 2048, and past it both passes on
``ddcol`` with the split tables of their views, and two paired transposes
per hi/lo pair. Each intermediate is dropped once the next pass has read
it. Every function runs its kernels through ``passes`` (``ops/route``):
the wrappers, or with ``PLAIN`` their plain versions on any device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .colfft import MAX_N1
from .dd import dd_col_tables_host
from .native import col64_shard_tables, col64_tables, dif_twiddles
from .route import KERNELS

__all__ = ["columns", "dd_columns", "long_columns", "long_split", "level_exponents",
           "transpose4", "twiddle_", "MAX_N1"]

#: Points of one slab of the plain-torch twiddle.
_TWIDDLE_SLAB = 1 << 22


def twiddle_(re, im, n: int, rows, cols) -> None:
    """(R, C) planes times W_n^(rows[r] * cols[c]), in place, in slabs of
    rows (``rows``, ``cols``: int64 exponents on the planes' device): the
    phase as an exact integer mod n, the angle in f64, the product in the
    planes' precision (complex64 for f32, as the JAX package casts its cos
    and sin to f32)."""
    cdt = torch.complex128 if re.dtype == torch.float64 else torch.complex64
    step = max(1, _TWIDDLE_SLAB // len(cols))
    for r0 in range(0, len(rows), step):
        r1 = min(len(rows), r0 + step)
        ang = ((rows[r0:r1, None] * cols[None, :]) % n).double() * (-2.0 * np.pi / n)
        w = torch.polar(torch.ones_like(ang), ang).to(cdt)
        del ang
        z = torch.complex(re[r0:r1], im[r0:r1]) * w
        re[r0:r1] = z.real
        im[r0:r1] = z.imag


def columns(pair, n: int, n1: int, col_base: int, bare: bool, f64: bool,
            passes=KERNELS):
    """The column pass of a block (..., n1, c) handed over in the list
    ``pair``, whose columns [col_base, col_base + c) lie in a transform of
    n points split n1 x n / n1: the DFT over n1 and, unless ``bare``, the
    twiddle W_n^(k1*(col_base + j)). n1 = 1 is the block itself (its only
    twiddle is W^0); past the column kernels' 2048, ``long_columns``."""
    k = passes
    if n1 > MAX_N1:
        return long_columns(pair, n, n1, col_base, bare, f64, k)
    re, im = pair
    pair.clear()
    if n1 == 1:
        return re, im
    if f64:
        steps = dif_twiddles(n1, re.device)
        if bare:
            return k.col64_nocorr(re, im, n1, steps)
        tabs = col64_shard_tables(n, n1, int(re.shape[-1]), col_base, re.device)
        return k.col64(re, im, tabs, n1, steps)
    if bare:
        return k.colfft_nocorr(re, im, n1)
    return k.colfft(re, im, None, n1, n_total=n, col_base=col_base)


def level_exponents(n: int, n1: int, pp: int, c: int, col_base: int, bare: bool):
    """The twiddle exponents of the first pass of ``long_columns``, one a
    column (q, j) of its (pp, n1/pp * c) view: q*(n/n1), plus
    col_base + j unless ``bare``; output kp takes W_n^(kp * exponent)."""
    q = np.arange(n1 // pp, dtype=np.int64)[:, None] * (n // n1)
    j = np.zeros(c, np.int64) if bare else col_base + np.arange(c, dtype=np.int64)
    return (q + j[None, :]).reshape(-1)


@functools.lru_cache(maxsize=64)
def _level_tables(n: int, n1: int, pp: int, c: int, col_base: int, bare: bool, device):
    """``col64``'s tables of ``level_exponents``, one entry a chunk of the
    distributed column stage (64 hold eight chunks of several sizes)."""
    return col64_tables(n, pp, level_exponents(n, n1, pp, c, col_base, bare), device)


def long_split(n1: int) -> tuple[int, int]:
    """(P, Q) of a column factor n1 past 2048: P = 2^(log2 n1 // 2), at most
    2048 (the column kernels' largest factor), and Q = n1 / P >= P, which
    ``long_columns`` splits again past 2048."""
    pp = 1 << min((n1.bit_length() - 1) // 2, MAX_N1.bit_length() - 1)
    return pp, n1 // pp


def _reorder(z, batch, pp: int, qq: int, c: int, transpose):
    """Step 3: (..., P, Q, c) -> (..., Q, P, c) read as (..., n1, c), by two
    transposes (``transpose(*planes)``) of the planes in the list ``z``,
    which it empties."""
    view = batch + (pp, qq * c)
    t = [*transpose(*(x.view(view) for x in z))]  # (..., Q c, P)
    z.clear()
    out = transpose(*(x.view(batch + (qq, c, pp)) for x in t))  # (..., Q, P, c)
    t.clear()
    return tuple(x.view(batch + (pp * qq, c)) for x in out)


def long_columns(pair, n: int, n1: int, col_base: int, bare: bool, f64: bool,
                 passes=KERNELS):
    """``columns`` past the column kernels' 2048: two column passes and two
    transposes on the (..., n1, c) block handed over in ``pair`` (see the
    module docstring)."""
    k = passes
    batch = tuple(pair[0].shape[:-2])
    c = int(pair[0].shape[-1])
    dev = pair[0].device
    pp, qq = long_split(n1)
    view = batch + (pp, qq * c)
    re, im = (x.reshape(view) for x in pair)
    pair.clear()
    if f64:
        y = [*k.col64(re, im, _level_tables(n, n1, pp, c, col_base, bare, dev), pp,
                      dif_twiddles(pp, dev))]
    elif not bare and c == n // n1:
        y = [*k.colfft(re, im, None, pp, n_total=n, col_base=0)]
    else:
        y = [*k.colfft_nocorr(re, im, pp)]
        kp = torch.arange(pp, dtype=torch.int64, device=dev)
        exps = level_exponents(n, n1, pp, c, col_base, bare)
        twiddle_(y[0].view(-1, qq * c), y[1].view(-1, qq * c), n,
                 kp.repeat(y[0].numel() // (pp * qq * c)), torch.from_numpy(exps).to(dev))
    del re, im
    y = [x.view(batch + (pp, qq, c)) for x in y]
    z = [*columns(y, n // pp, qq, col_base, bare, f64, k)]
    return _reorder(z, batch, pp, qq, c, k.transpose2_64 if f64 else k.transpose2)


@functools.lru_cache(maxsize=32)
def _dd_tables(n1: int, n2: int, device):
    """``dd_col_tables_host(n1, n2)``'s (T1, T2) 4-tuples on ``device``: the
    split twiddle W_{n1 n2}^(k1*i2) in the dd column kernel's factoring."""
    _, t1, t2 = dd_col_tables_host(n1, n2)

    def put(arrays):
        return tuple(torch.from_numpy(a.copy()).to(device) for a in arrays)

    return put(t1), put(t2)


def transpose4(quad, passes=KERNELS):
    """(..., R, C) -> (..., C, R) of a dd quadruple: the paired transpose
    once per hi/lo pair of planes."""
    rh, ih = passes.transpose2(quad[0], quad[2])
    rl, il = passes.transpose2(quad[1], quad[3])
    return rh, rl, ih, il


def dd_columns(quad, n1: int, passes=KERNELS):
    """The dd column pass of a block (..., n1, c) of every column, handed
    over in the list ``quad`` (four planes): the DFT over n1 times
    W_{n1 c}^(k1*j). ``ddcol`` up to 2048; past it the long columns, each
    pass a ``ddcol`` on its view's split tables (the transform of n1 c
    points splits P x Q c, then each kp's Q x c)."""
    k = passes
    batch = tuple(quad[0].shape[:-2])
    c = int(quad[0].shape[-1])
    dev = quad[0].device
    if n1 <= MAX_N1:
        planes = tuple(quad)
        quad.clear()
        return k.ddcol(*planes, *_dd_tables(n1, c, dev), n1)
    pp, qq = long_split(n1)
    view = batch + (pp, qq * c)
    planes = tuple(x.reshape(view) for x in quad)
    quad.clear()
    y = k.ddcol(*planes, *_dd_tables(pp, qq * c, dev), pp)
    del planes
    z = [*dd_columns([x.view(batch + (pp, qq, c)) for x in y], qq, k)]
    del y
    return _reorder(z, batch, pp, qq, c, lambda *q: transpose4(q, k))
