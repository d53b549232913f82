"""Bit-reversal permutation, for the staged strategy.

Counterpart of the JAX package's ``ops/bitrev.py``. With n = T * M * T
(T = 2^t), index i = hi*(M*T) + mid*T + lo reverses to
rev_t(lo)*(M*T) + rev_m(mid)*T + rev_t(hi), so the permutation is

    x.reshape(T, M, T)  -> gather the first axis by rev_t
                        -> gather the middle axis by rev_m
                        -> permute (2, 1, 0)
                        -> gather the first axis by rev_t
                        -> reshape(-1)

(the tiled form, every gather on a leading axis); the flat form is one
gather on the last axis. Both are plain torch on any device. The JAX
package's multithreaded host runtime for the index table is not ported
(``ROADMAP.md`` item 14): the table is numpy's doubling recurrence.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["bit_reverse_indices", "apply_bit_reversal", "naive_bit_reversal"]


@functools.lru_cache(maxsize=16)
def bit_reverse_indices(n: int) -> np.ndarray:
    """Host int32 table: ``idx[i]`` = i reversed in log2(n) bits. Each
    round of the doubling recurrence rev_{k+1} = [2 rev_k, 2 rev_k + 1]
    adds the next bit at the least-significant end of the reversed index."""
    idx = np.zeros(1, dtype=np.int64)
    for _ in range(n.bit_length() - 1):
        idx = np.concatenate([2 * idx, 2 * idx + 1])
    return idx.astype(np.int32)


def naive_bit_reversal(x: np.ndarray) -> np.ndarray:
    """The permutation by the recursive even/odd split (tests only)."""
    if len(x) <= 1:
        return x.copy()
    return np.concatenate([naive_bit_reversal(x[0::2]), naive_bit_reversal(x[1::2])])


def _tile_split(log_n: int) -> tuple[int, int, int]:
    """(t, m, t) with log_n = t + m + t, m >= 0 and t at most 7 (the JAX
    package's split: a tile axis of at most 128)."""
    t = min(7, log_n // 2)
    return t, log_n - 2 * t, t


@functools.lru_cache(maxsize=16)
def _indices(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bit_reverse_indices(n).astype(np.int64)).to(device)


def apply_bit_reversal(x: torch.Tensor, n: int, tiled: bool) -> torch.Tensor:
    """``x`` (..., n) with its last axis in bit-reversed order, as a new
    tensor: the tiled form when ``tiled`` and log2(n) >= 4, else one
    gather."""
    log_n = n.bit_length() - 1
    if not tiled or log_n < 4:
        return x.index_select(-1, _indices(n, x.device))
    t, m, _ = _tile_split(log_n)
    rev_t = _indices(1 << t, x.device)
    batch = tuple(x.shape[:-1])
    y = x.reshape(batch + (1 << t, 1 << m, 1 << t)).index_select(-3, rev_t)
    if m:
        y = y.index_select(-2, _indices(1 << m, x.device))
    nb = len(batch)
    y = y.permute(*range(nb), nb + 2, nb + 1, nb).index_select(-3, rev_t)
    return y.reshape(batch + (n,))
