"""DFT matrices, host side.

Counterpart of ``dft_matrix_host`` in the JAX package's ``ops/mxu.py``.
The port's kernels do not contract with DFT matrices; the matrices feed
the plain versions (dense Karatsuba products) and the planner's row-pass
tables, whose row 1 is the twiddle table W_m^k the row kernel reads.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["dft_matrix_host"]


@functools.lru_cache(maxsize=64)
def dft_matrix_host(m: int, dtype_name: str):
    """(re, im) of the m x m DFT matrix W_m^{jk}, exact f64 angles."""
    dtype = np.dtype(dtype_name)
    # reduce j*k mod m before the angle so every product is small and exact
    k = np.arange(m, dtype=np.int64)
    jk = (np.outer(k, k) % m).astype(np.float64)
    ang = -2.0 * np.pi * jk / m
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)
