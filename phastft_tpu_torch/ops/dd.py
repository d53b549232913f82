"""The dd (double-float) kernels of the df64 engine.

Counterpart of the JAX package's ``ops/pallas_dd.py``. A dd complex array
is four f32 planes (re_hi, re_lo, im_hi, im_lo); all arithmetic is the
paired-f32 arithmetic of ``ops/df64.py``.

* ``ddcol``: the dd DFT of size n1 along axis -2 of (..., n1, n2) planes,
  times W_n^(k1*i2) as two dd complex products T1[k1, i2 // t] *
  T2[k1, i2 % t] (``dd_col_tables_host``): the column pass of every split
  level, and pass 1 of the split leaf.
* ``ddcol_nocorr``: the same DFT with no correction: pass 2 of the split
  leaf.
* ``ddleaf``: the whole DFT of rows of n = n1 * 128 points: dd DFT over
  n1, the ``ddleaf{n1}`` correction, transpose, dd DFT over 128, natural
  order out.

Each is a wrapper: on CUDA tensors it launches the hand-written kernel
(``csrc/ddcol.cu``, ``csrc/ddleaf.cu``); on CPU tensors it runs its
``*_plain`` version, built from ``ops/df64.py``'s torch functions with the
JAX package's radix-16 Stockham schedule. The kernels run radix-4 DIF
trips and renormalise after every operation, so a kernel and its plain
version agree on the joined f64 values to ~1e-14, not bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._build import call
from .df64 import (
    dd_cmul,
    dd_radix_tables_host,
    leaf_fft_dd,
    split_hi_lo,
    stockham_axis2_dd,
)
from .stockham import LANES

__all__ = [
    "DD_COL_TILE",
    "dd_col_tables_host",
    "dd_shard_tables",
    "ddcol",
    "ddcol_plain",
    "ddcol_nocorr",
    "ddcol_nocorr_plain",
    "ddleaf",
    "ddleaf_plain",
]

#: Width t the split correction is factored on: T1 is (n1, n2 / t) and T2
#: (n1, t). The JAX kernel's slab width, kept as the tables' factoring; the
#: CUDA kernel's slab is its own.
DD_COL_TILE = 256

#: Column factors the column kernel takes, and leaf factors the leaf kernel
#: takes (powers of two).
MIN_N1, MAX_N1 = 2, 2048
MAX_LEAF_N1 = 512


@functools.lru_cache(maxsize=32)
def dd_col_tables_host(n1: int, n2: int):
    """dd split-correction tables factored on the width t:
    W_n^(k1*(j*t+c)) = T1[k1, j] * T2[k1, c]. Returns (t, T1 4-tuple
    (n1, n2/t), T2 4-tuple (n1, t))."""
    n = n1 * n2
    t = min(DD_COL_TILE, n2)
    k1 = np.arange(n1, dtype=np.float64)[:, None]
    j = np.arange(n2 // t, dtype=np.float64)[None, :]
    c = np.arange(t, dtype=np.float64)[None, :]
    ang1 = (-2.0 * np.pi / n) * (k1 * (j * t))
    ang2 = (-2.0 * np.pi / n) * (k1 * c)
    t1 = split_hi_lo(np.cos(ang1)) + split_hi_lo(np.sin(ang1))
    t2 = split_hi_lo(np.cos(ang2)) + split_hi_lo(np.sin(ang2))
    return (
        t,
        tuple(a.astype(np.float32) for a in t1),
        tuple(a.astype(np.float32) for a in t2),
    )


@functools.lru_cache(maxsize=64)
def dd_shard_tables(n: int, n1: int, ncols: int, col_base: int,
                    device: torch.device):
    """``ddcol``'s correction tables for the column block [col_base,
    col_base + ncols) of a length-n transform split n1 x n / n1, factored on
    the block's own width t = min(DD_COL_TILE, ncols):
    T1[k1, j] = W_n^(k1*(col_base + j*t)) and T2[k1, c] = W_n^(k1*c), so
    that T1[k1, i // t] * T2[k1, i % t] is the block's global twiddle
    W_n^(k1*(col_base + i)). Returns (T1 4-tuple (n1, ncols/t), T2 4-tuple
    (n1, t)) of dd planes on ``device``, from exact integer phases, built
    once per argument set, one entry a chunk of the distributed column
    stage (64 hold eight chunks of several sizes). (The JAX package slices
    its global T1 instead, ``phastft_tpu/parallel/fourstep_dist.py:465-472``,
    and synthesises the blocks that do not align with it in its graph,
    ``:490-494``.)"""
    if n % n1 or ncols < 1 or col_base + ncols > n // n1:
        raise ValueError(f"dd_shard_tables: columns [{col_base}, "
                         f"{col_base + ncols}) do not lie in {n1} x {n // n1}")
    t = min(DD_COL_TILE, ncols)
    k1 = np.arange(n1, dtype=np.int64)[:, None]

    def planes(i):
        ang = (-2.0 * np.pi / n) * ((k1 * i[None, :]) % n).astype(np.float64)
        quad = split_hi_lo(np.cos(ang)) + split_hi_lo(np.sin(ang))
        return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                     for a in quad)

    return (planes(col_base + t * np.arange(ncols // t, dtype=np.int64)),
            planes(np.arange(t, dtype=np.int64)))


@functools.lru_cache(maxsize=16)
def _radix_tables(max_m: int, device: torch.device):
    """``dd_radix_tables_host(max_m)`` as tensors on ``device``: the step
    twiddles of the plain versions."""
    return {
        key: tuple(
            tuple(torch.from_numpy(a.copy()).to(device) for a in digit)
            for digit in entry
        )
        for key, entry in dd_radix_tables_host(max_m).items()
    }


@functools.lru_cache(maxsize=32)
def _dif_twiddles(m: int, device: torch.device):
    """W_m^k for k < m/2 as a (4, m/2) f32 tensor (re_hi, re_lo, im_hi,
    im_lo) on ``device``: exact f64 angles, split on the host. The step
    twiddles of the kernels' DIF stages (``ddleaf``'s radix-4 stages read
    W_m^k for k >= m/2 as -W_m^(k - m/2), exact)."""
    ang = -2.0 * np.pi * np.arange(m // 2, dtype=np.float64) / m
    planes = np.stack(split_hi_lo(np.cos(ang)) + split_hi_lo(np.sin(ang)))
    return torch.from_numpy(np.ascontiguousarray(planes)).to(device)


def _check_planes(name, planes, tabs=()):
    """The four planes are f32 torch tensors of one shape on one device,
    and every table is f32 on that device."""
    if len(planes) != 4:
        raise ValueError(f"{name} takes four planes")
    first = planes[0]
    for x in (*planes, *tabs):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} takes torch tensors")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} is float32 only, got {x.dtype}")
        if x.device != first.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    if any(x.shape != first.shape for x in planes):
        raise ValueError(f"{name}: the four planes must have one shape")


def _check_col(name, planes, n1: int, min_n2: int, tabs=()):
    """Validate a column pass's arguments; return (batch shape, flat
    batch, n2)."""
    _check_planes(name, planes, tabs)
    first = planes[0]
    if first.dim() < 2 or first.shape[-2] != n1:
        raise ValueError(
            f"{name}: expected (..., {n1}, n2) planes, got {tuple(first.shape)}"
        )
    n2 = int(first.shape[-1])
    if (n1 < MIN_N1 or n1 > MAX_N1 or n1 & (n1 - 1) or n2 < min_n2
            or n2 & (n2 - 1)):
        raise ValueError(f"{name}: unsupported shape n1={n1}, n2={n2}")
    batch = tuple(first.shape[:-2])
    return batch, int(np.prod(batch)) if batch else 1, n2


def _check_corr(name, t1, t2, n1: int, n2: int):
    t = min(DD_COL_TILE, n2)
    if (len(t1) != 4 or len(t2) != 4
            or any(tuple(a.shape) != (n1, n2 // t) for a in t1)
            or any(tuple(a.shape) != (n1, t) for a in t2)):
        raise ValueError(
            f"{name}: correction tables must be 4 x ({n1}, {n2 // t}) and "
            f"4 x ({n1}, {t})"
        )
    return t


def _launch_ready(name, planes, tabs=()):
    """The launch-side checks: a CUDA device, contiguous 16-byte aligned
    planes, contiguous tables."""
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(x.is_contiguous() for x in (*planes, *tabs)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in planes):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _ptrs(tensors):
    return [x.data_ptr() for x in tensors]


# ---------------------------------------------------------------- ddcol
def ddcol_plain(rh, rl, ih, il, t1, t2, n1: int):
    """Plain-torch dd column pass: same arguments and result as
    ``ddcol``. The Stockham DFT of ``ops/df64.py`` along axis -2, then the
    two dd complex products of the correction, T1 first."""
    planes = (rh, rl, ih, il)
    batch, _, n2 = _check_col("ddcol", planes, n1, 1, (*t1, *t2))
    t = _check_corr("ddcol", t1, t2, n1, n2)
    tables = _radix_tables(n1, rh.device)
    out = stockham_axis2_dd(rh, rl, ih, il, tables, n1)
    view = batch + (n1, n2 // t, t)
    out = tuple(a.reshape(view) for a in out)
    out = dd_cmul(*out, *(a[:, :, None] for a in t1))
    out = dd_cmul(*out, *(a[:, None, :] for a in t2))
    return tuple(a.reshape(batch + (n1, n2)) for a in out)


def ddcol(rh, rl, ih, il, t1, t2, n1: int):
    """dd column DFT of size n1 = 2..2048 along axis -2 of four
    (..., n1, n2) f32 planes (n2 >= 1), fused with the dd split
    correction W_n^(k1*i2) = T1[k1, i2 // t] * T2[k1, i2 % t]. ``t1``,
    ``t2``: the 4-tuples of ``dd_col_tables_host(n1, n2)`` on the planes'
    device. Returns four new (..., n1, n2) planes.

    On CUDA it launches ``csrc/ddcol.cu`` on the current stream (a CPU
    tensor runs ``ddcol_plain``). Inputs are read, never written.

    Replaces ``phastft_tpu/ops/pallas_dd.py`` ``ddcol_pallas``; unlike it,
    it takes n1 = 2, 4 and 2048, every n2 >= 1 (under 128: the rows of a
    split planned with ``leaf_fft_size`` < 128, and a distributed shard's
    narrow block) and any batch. FP32
    instruction issue bounds it (a radix-4 dd DFT and two dd products per
    element against 32 B). Blocks of 4096 points, two per SM, run radix-4
    dd trips with the correction folded into the last one, so device
    memory is touched once each way: up to n1 = 512 a block holds a slab of
    4096 / n1 columns; at n1 = 1024 and 2048 a 32-column slab is split over
    a cluster of 8 or 16 blocks that trade through distributed shared
    memory (n1 = P * 128). A cluster shape that does not fit the device
    raises."""
    planes = (rh, rl, ih, il)
    batch, b, n2 = _check_col("ddcol", planes, n1, 1, (*t1, *t2))
    _check_corr("ddcol", t1, t2, n1, n2)
    if rh.device.type == "cpu":
        return ddcol_plain(rh, rl, ih, il, t1, t2, n1)
    _launch_ready("ddcol", planes, (*t1, *t2))
    out = tuple(torch.empty_like(rh) for _ in range(4))
    tw = _dif_twiddles(n1, rh.device)
    with torch.cuda.device(rh.device):
        stream = torch.cuda.current_stream(rh.device).cuda_stream
        err = call("phastft_ddcol", (
            *_ptrs(planes), tw.data_ptr(), *_ptrs(t1), *_ptrs(t2),
            *_ptrs(out), b, n1, n2, stream,
        ), kernel="ddcol")
    if err != 0:
        raise RuntimeError(f"ddcol: kernel launch failed, CUDA error {err}")
    return out


def ddcol_nocorr_plain(rh, rl, ih, il, n1: int):
    """Plain-torch bare dd column DFT: same arguments and result as
    ``ddcol_nocorr``."""
    _check_col("ddcol_nocorr", (rh, rl, ih, il), n1, 1)
    tables = _radix_tables(n1, rh.device)
    return tuple(stockham_axis2_dd(rh, rl, ih, il, tables, n1))


def ddcol_nocorr(rh, rl, ih, il, n1: int):
    """Bare dd column DFT of size n1 = 2..2048 along axis -2 of four
    (..., n1, n2) f32 planes, n2 >= 1: the second pass of the split dd
    leaf, whose rows are the leaf's n1 = 2..2048 points wide, and the long
    dd columns' passes (``ops/longcol.py``). Returns four new planes.

    On CUDA it launches ``csrc/ddcol.cu`` (the same kernel as ``ddcol``,
    compiled without the correction) on the current stream; a CPU tensor
    runs ``ddcol_nocorr_plain``. Inputs are read, never written.

    Replaces ``phastft_tpu/ops/pallas_dd.py`` ``ddcol_pallas_nocorr``;
    unlike it, it takes rows below 8 points and any batch. The blocks and
    clusters are ``ddcol``'s; when a whole (n1, n2) entry is smaller than a
    block's 4096 points, a block holds several entries."""
    planes = (rh, rl, ih, il)
    _, b, n2 = _check_col("ddcol_nocorr", planes, n1, 1)
    if rh.device.type == "cpu":
        return ddcol_nocorr_plain(rh, rl, ih, il, n1)
    _launch_ready("ddcol_nocorr", planes)
    out = tuple(torch.empty_like(rh) for _ in range(4))
    tw = _dif_twiddles(n1, rh.device)
    with torch.cuda.device(rh.device):
        stream = torch.cuda.current_stream(rh.device).cuda_stream
        err = call("phastft_ddcol_nocorr", (
            *_ptrs(planes), tw.data_ptr(), *_ptrs(out), b, n1, n2, stream,
        ), kernel="ddcol_nocorr")
    if err != 0:
        raise RuntimeError(
            f"ddcol_nocorr: kernel launch failed, CUDA error {err}")
    return out


# ---------------------------------------------------------------- ddleaf
def _check_leaf(name, planes, corr, n1: int):
    """Validate the leaf's arguments; return (batch shape, flat batch)."""
    if n1 < 1 or n1 > MAX_LEAF_N1 or n1 & (n1 - 1):
        raise ValueError(f"{name}: unsupported leaf factor n1={n1}")
    if n1 > 1 and corr is None:
        raise ValueError(f"{name}: n1 = {n1} needs the ddleaf{n1} correction")
    corr = tuple(corr) if n1 > 1 else ()
    _check_planes(name, planes, corr)
    first = planes[0]
    if first.dim() < 1 or first.shape[-1] != n1 * LANES:
        raise ValueError(
            f"{name}: expected (..., {n1 * LANES}) planes, got "
            f"{tuple(first.shape)}"
        )
    if n1 > 1 and (len(corr) != 4
                   or any(tuple(a.shape) != (n1, LANES) for a in corr)):
        raise ValueError(f"{name}: the correction must be 4 x ({n1}, {LANES})")
    batch = tuple(first.shape[:-1])
    return batch, int(np.prod(batch)) if batch else 1


def ddleaf_plain(rh, rl, ih, il, corr, n1: int):
    """Plain-torch dd leaf: same arguments and result as ``ddleaf``
    (``df64.leaf_fft_dd`` on the radix tables of the planes' device)."""
    _check_leaf("ddleaf", (rh, rl, ih, il), corr, n1)
    tables = _radix_tables(max(n1, LANES), rh.device)
    return leaf_fft_dd(rh, rl, ih, il, tables, corr if n1 > 1 else None, n1)


def ddleaf(rh, rl, ih, il, corr, n1: int):
    """dd DFT along the last axis of four (..., n) f32 planes, n = n1 * 128
    with n1 = 1..512, natural order in and out. ``corr``: the 4-tuple
    ``dd_leaf_correction_host(n1, 128)`` on the planes' device (ignored at
    n1 = 1). Returns four new planes.

    On CUDA it launches ``csrc/ddleaf.cu`` on the current stream (a CPU
    tensor runs ``ddleaf_plain``). Inputs are read, never written.

    Replaces ``phastft_tpu/ops/pallas_dd.py`` ``ddleaf_pallas``; unlike
    it, it takes n1 = 1..4 and any batch. Blocks of 4096 points, two per
    SM, run radix-4 dd stages with the correction folded into the last
    F(n1) trip. Up to 2^12 points a block holds whole rows; from 2^13 a
    cluster of 2, 4, 8 or 16 blocks holds one row and trades through
    distributed shared memory between the two factors, with no scratch in
    device memory."""
    planes = (rh, rl, ih, il)
    _, b = _check_leaf("ddleaf", planes, corr, n1)
    if rh.device.type == "cpu":
        return ddleaf_plain(rh, rl, ih, il, corr, n1)
    corr = tuple(corr) if n1 > 1 else ()
    _launch_ready("ddleaf", planes, corr)
    out = tuple(torch.empty_like(rh) for _ in range(4))
    dev = rh.device
    tw1 = _dif_twiddles(n1, dev).data_ptr() if n1 > 1 else None
    tw2 = _dif_twiddles(LANES, dev).data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = call("phastft_ddleaf", (
            *_ptrs(planes), tw1, tw2, *(_ptrs(corr) or [None] * 4),
            *_ptrs(out), b, n1, stream,
        ), kernel="ddleaf")
    if err != 0:
        raise RuntimeError(f"ddleaf: kernel launch failed, CUDA error {err}")
    return out
