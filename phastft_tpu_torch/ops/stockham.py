"""Lane width, the radix schedule, the leaf twiddle correction (host
side), and the f32 Stockham DFT along axis -2 in plain torch.

Counterpart of ``LANES``, ``radix_schedule``, ``leaf_correction_host`` and
``stockham_axis2`` in the JAX package's ``ops/stockham.py``. The radix schedule fixes the
steps, and so the table keys, of the dd Stockham DFT (``ops/df64.py``). Of
the correction only the numpy branch is carried: the JAX package hands
tables of n1 * lanes >= 2^16 to its C++ host runtime, and the port asks
for at most (256, 128) = 2^15 points (the leaf plans up to 2^15; the row
pass of the split plans needs A * 128 <= 2^14), so the numpy branch is
the one the JAX package takes there too. The one exception is the hybrid
leaf's (512, 128) table at 2^16, which the JAX package takes from C++;
the two are equal bit for bit (``tests/test_torch_tables.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["LANES", "DEFAULT_RADIX", "radix_schedule", "leaf_correction_host",
           "stockham_axis2"]

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


def stockham_axis2(re, im, m: int):
    """DFT along axis -2 of (..., m, L) planar f32 tensors, in the JAX
    package's arithmetic (``ops/stockham.stockham_axis2`` on the in-kernel
    ``_iota_tables``): radix-16 Stockham steps, natural order in and out,
    no scaling. The plain version of the Stockham passes inside
    ``leaf_fft_pallas_hybrid`` and ``colfft_pallas_nocorr``."""
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
