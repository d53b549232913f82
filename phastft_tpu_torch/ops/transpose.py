"""Paired transpose: the four-step's output reordering.

Counterpart of the JAX package's ``ops/pallas_transpose.py``
(``transpose2_pallas``). The classic split pipeline ends with the
(n1, n2) -> (n2, n1) transpose of both planes; this moves the two in one
launch.

``transpose2`` is the wrapper: on CUDA tensors it launches the
hand-written kernel ``csrc/transpose.cu``; on CPU tensors it runs
``transpose2_plain``. The two agree bit for bit: nothing is computed.
"""

from __future__ import annotations

import numpy as np
import torch

from ._build import library

__all__ = ["transpose2", "transpose2_plain"]


def _check(a, b):
    """Validate the arguments shared by the kernel and its plain version;
    return (batch shape, flat batch, rows, cols)."""
    for x in (a, b):
        if not isinstance(x, torch.Tensor):
            raise TypeError("transpose2 takes torch tensors")
        if x.dtype != torch.float32:
            raise TypeError(f"transpose2 is float32 only, got {x.dtype}")
    if a.device != b.device:
        raise ValueError("transpose2: both tensors must be on one device")
    if a.shape != b.shape or a.dim() < 2:
        raise ValueError(
            f"transpose2: expected two (..., R, C) tensors of one shape, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    rows, cols = int(a.shape[-2]), int(a.shape[-1])
    if rows < 1 or cols < 1 or rows & (rows - 1) or cols & (cols - 1):
        raise ValueError(
            f"transpose2: R and C must be powers of two, got {rows}, {cols}")
    batch = tuple(a.shape[:-2])
    return batch, int(np.prod(batch)) if batch else 1, rows, cols


def transpose2_plain(a, b):
    """Plain-torch paired transpose: same arguments and result as
    ``transpose2``."""
    _check(a, b)
    return (a.swapaxes(-1, -2).contiguous(), b.swapaxes(-1, -2).contiguous())


def transpose2(a, b):
    """(..., R, C) -> (..., C, R) for two f32 tensors of one shape, R and C
    powers of two, as new contiguous tensors.

    On CUDA it launches ``csrc/transpose.cu`` once for both tensors on the
    current stream; a CPU tensor runs ``transpose2_plain``. Inputs are
    read, never written. Each launch adds one to ``transpose2.launches``.

    Replaces ``phastft_tpu/ops/pallas_transpose.py`` ``transpose2_pallas``;
    unlike it, it takes leading batch dimensions and every power-of-two
    R, C >= 1. Bound by memory (8 B per float, read once and written
    once, no arithmetic); a block moves a tile of 4096 floats of each
    tensor through padded shared memory, and when R is below the tile's
    rows (the outer column factor of a nested plan) the tile covers all of
    R, so its output is one contiguous span."""
    batch, bs, rows, cols = _check(a, b)
    if a.device.type == "cpu":
        return transpose2_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"transpose2: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("transpose2: inputs must be contiguous")
    shape = batch + (cols, rows)
    oa = torch.empty(shape, dtype=torch.float32, device=a.device)
    ob = torch.empty(shape, dtype=torch.float32, device=a.device)
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.phastft_transpose2(
            a.data_ptr(), b.data_ptr(), oa.data_ptr(), ob.data_ptr(),
            bs, rows, cols, stream,
        )
    if err != 0:
        raise RuntimeError(f"transpose2: kernel launch failed, CUDA error {err}")
    transpose2.launches += 1
    return oa, ob


transpose2.launches = 0
