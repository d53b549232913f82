"""DFT matrices and leaf tables, host side.

Counterpart of ``dft_matrix_host``, ``mxu_leaf_tables_host`` and
``mxu_leaf_tables3_host`` in the JAX package's ``ops/mxu.py``, numpy only
and bit for bit. The port's kernels do not contract with DFT matrices;
the matrices feed the plain versions (dense Karatsuba products) and the
planner's tables, whose row 1 is the twiddle table W_m^k the kernels read.
"""

from __future__ import annotations

import functools

import numpy as np

from .stockham import LANES, leaf_correction_host

__all__ = ["dft_matrix_host", "mxu_leaf_tables_host", "mxu_leaf_tables3_host"]


@functools.lru_cache(maxsize=64)
def dft_matrix_host(m: int, dtype_name: str):
    """(re, im) of the m x m DFT matrix W_m^{jk}, exact f64 angles."""
    dtype = np.dtype(dtype_name)
    # reduce j*k mod m before the angle so every product is small and exact
    k = np.arange(m, dtype=np.int64)
    jk = (np.outer(k, k) % m).astype(np.float64)
    ang = -2.0 * np.pi * jk / m
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@functools.lru_cache(maxsize=64)
def mxu_leaf_tables_host(n1: int, dtype_name: str):
    """Host tables of the two-factor leaf of length n1 * LANES:
    ((f1r, f1i, f1s) of F(n1) or None at n1 = 1, (f2r, f2i, f2s) of
    F(128), the correction W_n^(k1*i2) in (i2, k1) layout or None at
    n1 = 1); f*s = f*r + f*i, the Karatsuba sums."""
    f1 = dft_matrix_host(n1, dtype_name) if n1 > 1 else None
    f2 = dft_matrix_host(LANES, dtype_name)
    if n1 > 1:
        f1 = (*f1, f1[0] + f1[1])
        cre, cim = leaf_correction_host(n1, LANES, dtype_name)
        corr = (np.ascontiguousarray(cre.T), np.ascontiguousarray(cim.T))
    else:
        corr = None
    f2 = (*f2, f2[0] + f2[1])
    return f1, f2, corr


@functools.lru_cache(maxsize=64)
def mxu_leaf_tables3_host(a: int, b: int, dtype_name: str):
    """Host tables of the three-factor leaf of length n = a * 4 * b, index
    split i = i_a*(4b) + i_p*b + i_b, output k = k_a + a*k_p + 4a*k_b:
    (f1r, f1i, f1s [a x a], f2r, f2i, f2s [b x b], c1r, c1i [(a, 4b)] =
    W_n^{k_a * i_r}, c2r, c2i [(4, b)] = W_{4b}^{k_p * i_b}); exact f64
    angles, single rounding."""
    n = a * 4 * b
    f1r, f1i = dft_matrix_host(a, dtype_name)
    f2r, f2i = dft_matrix_host(b, dtype_name)
    dtype = np.dtype(dtype_name)
    ka = np.arange(a, dtype=np.int64)[:, None]
    ir = np.arange(4 * b, dtype=np.int64)[None, :]
    ang1 = -2.0 * np.pi * ((ka * ir) % n).astype(np.float64) / n
    kp = np.arange(4, dtype=np.int64)[:, None]
    ib = np.arange(b, dtype=np.int64)[None, :]
    ang2 = -2.0 * np.pi * ((kp * ib) % (4 * b)).astype(np.float64) / (4 * b)
    return (
        f1r, f1i, f1r + f1i,
        f2r, f2i, f2r + f2i,
        np.cos(ang1).astype(dtype), np.sin(ang1).astype(dtype),
        np.cos(ang2).astype(dtype), np.sin(ang2).astype(dtype),
    )
