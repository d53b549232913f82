"""Batch-sharded FFTs over a process group.

Counterpart of the JAX package's ``parallel/batch.py``: a batch of
independent transforms split over the ranks, the planner's tables held by
every rank, no communication. In the JAX package one call places a global
batch on a device mesh (``default_mesh``, which the port has no
counterpart for: a process group is the caller's, initialised with
``torch.distributed``); here every rank calls with its own shard of the
batch on its own device and gets its shard's spectra back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..errors import LengthMismatchError
from ..fft import _run

__all__ = ["batch_fft_sharded"]


def batch_fft_sharded(reals, imags, direction, planner):
    """FFT along the last axis of this rank's (..., batch, n) shard, on the
    planner's device, with the planner's options (the inverse scales by
    1/n, through the swap trick): its engine, and with ``use_pallas=False``
    the plain route; its ``strategy`` is not read, as the JAX package
    builds its fast path whatever the strategy. The transforms need no
    communication, so it takes no process group. Raises
    ``LengthMismatchError`` below 2 dims, as the JAX package does: the
    plain ``fft_*`` entries take single transforms."""
    ndim = reals.dim() if isinstance(reals, torch.Tensor) else np.ndim(reals)
    if ndim < 2:
        raise LengthMismatchError(
            "batch_fft_sharded expects at least 2 dims (batch, n); use the "
            "plain fft_* entry points for single transforms"
        )
    return _run(reals, imags, direction, planner,
                dataclasses.replace(planner.options, strategy="auto"))
