"""Lane width, the radix schedule and the leaf twiddle correction, host
side.

Counterpart of ``LANES``, ``radix_schedule`` and ``leaf_correction_host``
in the JAX package's ``ops/stockham.py``. The radix schedule fixes the
steps, and so the table keys, of the dd Stockham DFT (``ops/df64.py``). Of
the correction only the numpy branch is carried: the JAX
builder hands tables of n1 * lanes >= 2^16 to its C++ host runtime, and
the port asks for at most (256, 128) = 2^15 points (the leaf plans up to
2^15; the row pass of the split plans needs A * 128 <= 2^14), so the
numpy branch is the one the JAX builder takes there too.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["LANES", "DEFAULT_RADIX", "radix_schedule", "leaf_correction_host"]

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
