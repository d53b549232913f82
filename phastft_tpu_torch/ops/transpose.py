"""Paired transpose: the four-step's output reordering.

Counterpart of the JAX package's ``ops/pallas_transpose.py``
(``transpose2_pallas``). The classic split pipeline ends with the
(n1, n2) -> (n2, n1) transpose of both planes; this moves the two in one
launch.

``transpose2`` is the wrapper: on CUDA tensors it launches the
hand-written kernel ``csrc/transpose.cu``; on CPU tensors it runs
``transpose2_plain``. ``transpose2_64`` is the same on 64-bit words (the
native f64 engine's classic levels), on ``csrc/transpose64.cu``. Each takes
``out_scale`` (1.0 unless given), the factor of every output value: the
classic split level that ends an inverse hands its transpose the 1/n, and
the kernel multiplies each value on its way to the store. A kernel and the
plain version agree bit for bit: nothing else is computed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._build import call
from .leaf import scaled

__all__ = ["transpose2", "transpose2_64", "transpose2_plain", "transpose_args"]


def _check(a, b, dtypes=(torch.float32,), name="transpose2"):
    """Validate the arguments shared by the kernels and their plain
    version: two tensors of one of ``dtypes``; return (batch shape, flat
    batch, rows, cols)."""
    for x in (a, b):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} takes torch tensors")
        if x.dtype not in dtypes or x.dtype != a.dtype:
            raise TypeError(f"{name} takes two tensors of one dtype of "
                            f"{[str(d) for d in dtypes]}, got {x.dtype}")
    if a.device != b.device:
        raise ValueError(f"{name}: both tensors must be on one device")
    if a.shape != b.shape or a.dim() < 2:
        raise ValueError(
            f"{name}: expected two (..., R, C) tensors of one shape, got "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    rows, cols = int(a.shape[-2]), int(a.shape[-1])
    if rows < 1 or cols < 1 or rows & (rows - 1) or cols & (cols - 1):
        raise ValueError(
            f"{name}: R and C must be powers of two, got {rows}, {cols}")
    batch = tuple(a.shape[:-2])
    return batch, int(np.prod(batch)) if batch else 1, rows, cols


def transpose2_plain(a, b, out_scale: float = 1.0):
    """Plain-torch paired transpose: same arguments and result as
    ``transpose2`` (f32) and ``transpose2_64`` (f64)."""
    _check(a, b, (torch.float32, torch.float64), "transpose2_plain")
    return (scaled(a.swapaxes(-1, -2).contiguous(), out_scale),
            scaled(b.swapaxes(-1, -2).contiguous(), out_scale))


def transpose_args(shape, ptrs=(None,) * 4, stream=None, out_scale=1.0) -> tuple:
    """The arguments of ``phastft_transpose2`` and ``phastft_transpose2_64``
    for inputs of ``shape`` (..., R, C): the pointers ``ptrs`` (a, b, oa,
    ob), the flat batch, R, C, the output scale and the stream."""
    bs = math.prod(shape[:-2])
    return (*ptrs, bs, int(shape[-2]), int(shape[-1]), float(out_scale), stream)


def _launch(name, entry, a, b, batch, rows, cols, out_scale):
    """Launch the C entry ``entry`` (of ``phastft_transpose2``'s arguments)
    on CUDA tensors; return the two outputs."""
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    shape = batch + (cols, rows)
    oa = torch.empty(shape, dtype=a.dtype, device=a.device)
    ob = torch.empty(shape, dtype=a.dtype, device=a.device)
    ptrs = (a.data_ptr(), b.data_ptr(), oa.data_ptr(), ob.data_ptr())
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = call(entry, transpose_args(a.shape, ptrs, stream, out_scale),
                   kernel=name)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    return oa, ob


def transpose2_64(a, b, out_scale: float = 1.0):
    """(..., R, C) -> (..., C, R) for two f64 tensors of one shape, R and C
    powers of two, as new contiguous tensors: ``transpose2`` on 64-bit
    words, every value times ``out_scale``.

    On CUDA it launches ``csrc/transpose64.cu`` once for both tensors on
    the current stream; a CPU tensor runs ``transpose2_plain``. Inputs are
    read, never written.

    Stands for the JAX package's XLA transpose of the native engine's
    classic levels (``_out_transpose``, ``phastft_tpu/ops/fourstep.py:149``).
    Bound by memory (16 B per double, read once and written once); a block
    moves a tile of 2048 doubles of each tensor through shared memory
    padded for 8-byte words."""
    batch, _, rows, cols = _check(a, b, (torch.float64,), "transpose2_64")
    if a.device.type == "cpu":
        return transpose2_plain(a, b, out_scale)
    return _launch("transpose2_64", "phastft_transpose2_64", a, b, batch, rows, cols,
                   out_scale)


def transpose2(a, b, out_scale: float = 1.0):
    """(..., R, C) -> (..., C, R) for two f32 tensors of one shape, R and C
    powers of two, as new contiguous tensors, every value times
    ``out_scale``.

    On CUDA it launches ``csrc/transpose.cu`` once for both tensors on the
    current stream; a CPU tensor runs ``transpose2_plain``. Inputs are
    read, never written.

    Replaces ``phastft_tpu/ops/pallas_transpose.py`` ``transpose2_pallas``;
    unlike it, it takes leading batch dimensions and every power-of-two
    R, C >= 1. Bound by memory (8 B per float, read once and written
    once, no arithmetic); a block moves a tile of 4096 floats of each
    tensor through padded shared memory, and when R is below the tile's
    rows (the outer column factor of a nested plan) the tile covers all of
    R, so its output is one contiguous span."""
    batch, _, rows, cols = _check(a, b)
    if a.device.type == "cpu":
        return transpose2_plain(a, b, out_scale)
    return _launch("transpose2", "phastft_transpose2", a, b, batch, rows, cols, out_scale)
