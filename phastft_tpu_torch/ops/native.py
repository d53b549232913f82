"""The kernels of the native f64 engine, on the H100's FP64 units.

The JAX package's native engine is plain XLA (``ops/fourstep.py``'s classic
branch, ``ops/stockham.py``'s ``leaf_fft`` and ``tiny_fft``): no Pallas
kernel lies on its path. The port runs it on two hand-written kernels and
the 64-bit paired transpose (``ops/transpose.py``):

* ``col64``: the DFT of size n1 along axis -2 of (..., n1, n2) f64 planes,
  times the split twiddle W_n^(k1*i2) as two complex products
  T1[k1, i2 // s] * T2[k1, i2 % s] (the planner's ``split{n1}x{n2}``,
  ``ops/stockham.split_correction_host``): the column pass of every split
  level, n1 = 2..2048. Stands for the JAX package's ``stockham_axis2`` +
  split correction (``phastft_tpu/ops/fourstep.py:353-380``). On a
  distributed shard's column block the same kernel takes the tables of the
  block's global twiddle, ``col64_shard_tables``;
  ``col64_nocorr`` is its bare mode, the column DFT alone (the JAX
  package's ``stockham_axis2`` at ``phastft_tpu/parallel/
  fourstep_dist.py:203``).
* ``leaf64``: the whole DFT of rows of n = 2..2^16 points, natural order
  in and out; from n = 256 as F(n1) over the (n1, 128) view, the planner's
  ``leaf{n1}`` correction, F(128). Stands for ``leaf_fft`` and ``tiny_fft``
  (``phastft_tpu/ops/stockham.py:236``, ``:254``).

Each is a wrapper: on CUDA tensors it launches its kernel (``csrc/col64.cu``,
``csrc/leaf64.cu``) or raises; on CPU tensors it runs its ``*_plain``
version, the JAX package's radix-16 Stockham arithmetic in plain torch
(``ops/stockham.py``). The kernels run DIF trips of radix-4 butterflies
with FMA, so a kernel and its plain version agree to ~1e-16 relative, not
bit for bit. ``leaf64`` takes ``out_scale`` (1.0 unless given), the factor
of every output value: the leaf plan that ends an inverse hands it the 1/n,
and the kernel multiplies each value just before its store (the plain
version multiplies its result).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ._build import call
from .leaf import scaled
from .stockham import LANES, leaf_fft, stockham_axis2, tiny_fft

__all__ = ["col64", "col64_args", "col64_plain", "col64_nocorr", "col64_nocorr_plain",
           "col64_shard_tables", "col64_tables", "dif_twiddles", "dif_twiddles_host", "leaf64",
           "leaf64_args", "leaf64_plain", "MAX_COL_N1", "MAX_LEAF_N"]

#: Column factors of ``col64`` and row lengths of ``leaf64`` (powers of two).
MAX_COL_N1 = 2048
MAX_LEAF_N = 1 << 16


def dif_twiddles_host(m: int) -> np.ndarray:
    """W_m^k for k < m/2 as an (m/2, 2) f64 array of (re, im) pairs, from
    exact f64 angles: the step twiddles of the kernels' DIF trips
    (W_m^(k + m/2) = -W_m^k, exact). The planner holds it as ``dif{m}``."""
    ang = -2.0 * np.pi * np.arange(m // 2, dtype=np.float64) / m
    return np.ascontiguousarray(np.stack([np.cos(ang), np.sin(ang)], axis=-1))


@functools.lru_cache(maxsize=32)
def dif_twiddles(m: int, device: torch.device) -> torch.Tensor:
    """``dif_twiddles_host(m)`` on ``device``, built once: the ``dif{m}``
    step table of a column pass that no planner's plan holds (a
    distributed shard's)."""
    return torch.from_numpy(dif_twiddles_host(m)).to(device)


def _phase_tables(n: int, k: np.ndarray, i: np.ndarray):
    """(cos, sin) of W_n^(k*i) on the grid k[:, None] x i[None, :], from the
    exact integer phase k*i mod n (every product < 2^63)."""
    phase = (k[:, None] * i[None, :]) % n
    ang = (-2.0 * np.pi / n) * phase.astype(np.float64)
    return np.cos(ang), np.sin(ang)


def col64_tables(n: int, n1: int, exps: np.ndarray, device: torch.device):
    """``col64``'s tables for the twiddle W_n^(k1 * exps[i2]) of a
    (n1, ncols) block, ncols = len(exps) a power of two: (T1 re, T1 im,
    T2 re, T2 im) with s = 2^(log2(ncols) // 2), T1[k1, a] =
    W_n^(k1 * exps[s*a]) (n1, ncols / s) and T2[k1, b] =
    W_n^(k1 * (exps[b] - exps[0])) (n1, s). Exact f64 angles from integer
    phases. Raises unless the exponents split so, exps[s*a + b] =
    exps[s*a] + exps[b] - exps[0], as a block's global columns and the
    levels of a long column pass do."""
    exps = np.asarray(exps, dtype=np.int64)
    ncols = len(exps)
    if ncols < 1 or ncols & (ncols - 1):
        raise ValueError(f"col64_tables: {ncols} columns, not a power of two")
    s = 1 << ((ncols.bit_length() - 1) // 2)
    grid = exps.reshape(ncols // s, s)
    if not np.array_equal(grid, grid[:, :1] + (grid[:1] - exps[0])):
        raise ValueError("col64_tables: the exponents do not factor on the tables' width")
    k1 = np.arange(n1, dtype=np.int64)
    t1 = _phase_tables(n, k1, grid[:, 0])
    t2 = _phase_tables(n, k1, grid[0] - exps[0])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (*t1, *t2))


@functools.lru_cache(maxsize=64)
def col64_shard_tables(n: int, n1: int, ncols: int, col_base: int,
                       device: torch.device):
    """``col64``'s tables for the column block [col_base, col_base + ncols)
    of a length-n transform split n1 x n / n1 (``col64_tables`` of the
    exponents col_base + j): T1[k1, j // s] * T2[k1, j % s] =
    W_n^(k1*(col_base + j)), the block's global twiddle. Built on the host
    once per argument set, one entry a chunk of the distributed column
    stage (64 hold eight chunks of several sizes; the JAX package builds
    the angles inside its graph,
    ``phastft_tpu/parallel/fourstep_dist.py:113``)."""
    if ncols < 1 or n % n1 or col_base + ncols > n // n1:
        raise ValueError(f"col64_shard_tables: columns [{col_base}, "
                         f"{col_base + ncols}) do not lie in {n1} x {n // n1}")
    return col64_tables(n, n1, col_base + np.arange(ncols, dtype=np.int64), device)


def _check_steps(name, steps, m: int):
    """``steps`` is the (m/2, 2) ``dif{m}`` table; return it."""
    if not isinstance(steps, torch.Tensor) or tuple(steps.shape) != (m // 2, 2):
        raise ValueError(f"{name}: expected the ({m // 2}, 2) dif{m} step table")
    return steps


def _check_planes(name, re, im, tabs=()):
    """Both planes are f64 torch tensors of one shape on one device, and
    every table is f64 on that device."""
    for x in (re, im, *tabs):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} takes torch tensors")
        if x.dtype != torch.float64:
            raise TypeError(f"{name} is float64 only, got {x.dtype}")
        if x.device != re.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    if re.shape != im.shape:
        raise ValueError(f"{name}: both planes must have one shape")


def _launch_ready(name, planes, tabs=()):
    """The launch-side checks: a CUDA device, contiguous 16-byte aligned
    planes (the kernels move double2s), contiguous tables."""
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(x.is_contiguous() for x in (*planes, *tabs)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in planes):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")


# ---------------------------------------------------------------- col64
def col64_args(shape, n1: int, ptrs=(None,) * 9, stream=None) -> tuple:
    """``phastft_col64``'s arguments for planes of ``shape`` (..., n1, n2):
    the pointers ``ptrs`` (the planes, the steps, T1 and T2 re and im, the
    outputs), the flat batch, n1, n2 and the stream; with seven pointers
    (no tables), ``phastft_col64_nocorr``'s."""
    b = math.prod(shape[:-2])
    return (*ptrs, b, n1, int(shape[-1]), stream)


def _check_col(re, im, tabs, n1: int, steps, name="col64"):
    """Validate the column pass's arguments (``tabs`` None: the bare mode);
    return (flat batch, n2)."""
    tabs = () if tabs is None else tuple(tabs)
    _check_planes(name, re, im, (*tabs, _check_steps(name, steps, n1)))
    if re.dim() < 2 or re.shape[-2] != n1:
        raise ValueError(
            f"{name}: expected (..., {n1}, n2) planes, got {tuple(re.shape)}")
    n2 = int(re.shape[-1])
    if n1 < 2 or n1 > MAX_COL_N1 or n1 & (n1 - 1) or n2 < 1 or n2 & (n2 - 1):
        raise ValueError(f"{name}: unsupported shape n1={n1}, n2={n2}")
    s = 1 << ((n2.bit_length() - 1) // 2)
    shapes = [(n1, n2 // s)] * 2 + [(n1, s)] * 2
    if name == "col64" and (len(tabs) != 4 or [tuple(t.shape) for t in tabs] != shapes):
        raise ValueError(
            f"col64: the split tables must be 2 x ({n1}, {n2 // s}) and "
            f"2 x ({n1}, {s})")
    batch = tuple(re.shape[:-2])
    return int(np.prod(batch)) if batch else 1, n2


def col64_plain(re, im, tabs, n1: int, steps):
    """Plain-torch column pass: same arguments and result as ``col64``
    (the JAX package's ``stockham_axis2`` and its factored correction,
    ``ops/fourstep.py:353-374``, in torch; ``steps`` is checked, not
    read)."""
    _check_col(re, im, tabs, n1, steps)
    t1r, t1i, t2r, t2i = tabs
    n2 = int(re.shape[-1])
    s = int(t2r.shape[1])
    batch = tuple(re.shape[:-2])
    b_re, b_im = stockham_axis2(re, im, n1)
    shape = batch + (n1, n2 // s, s)
    br, bi = b_re.reshape(shape), b_im.reshape(shape)
    u_r = br * t1r[:, :, None] - bi * t1i[:, :, None]
    u_i = br * t1i[:, :, None] + bi * t1r[:, :, None]
    c_re = (u_r * t2r[:, None, :] - u_i * t2i[:, None, :]).reshape(batch + (n1, n2))
    c_im = (u_r * t2i[:, None, :] + u_i * t2r[:, None, :]).reshape(batch + (n1, n2))
    return c_re, c_im


def col64(re, im, tabs, n1: int, steps):
    """X[..., k1, i2] = W_n^(k1*i2) * sum_i1 x[..., i1, i2] W_n1^(i1*k1)
    on (..., n1, n2) f64 planes, n1 = 2..2048 and n2 >= 1 powers of two, n
    = n1 * n2; ``tabs`` = (T1 re, T1 im, T2 re, T2 im), the planner's
    ``split{n1}x{n2}``, and ``steps`` its ``dif{n1}`` table, on the planes'
    device. Returns two new planes, natural order, the classic (n1, n2)
    layout.

    On CUDA it launches ``csrc/col64.cu`` on the current stream, or raises
    (a shape no cluster of which fits the card among them); a CPU tensor
    runs ``col64_plain``. Inputs are read, never written.

    Stands for the JAX package's XLA column pass of the native engine
    (``stockham_axis2`` + ``split{n1}x{n2}``,
    ``phastft_tpu/ops/fourstep.py:353-380``). Bound by memory (32 B per
    element; its FP64 arithmetic takes less than that time). A block of
    4096 points (two per SM) holds min(4096 / n1, n2) neighbouring columns
    up to n1 = 512 (one column: a distributed shard's one-column block, the
    rows of a split planned with ``leaf_fft_size`` < 128), runs radix-4 DIF trips over them in shared memory with the two
    twiddle products in the last, and stores rows in natural order; at
    n1 = 1024 / 2048 (n2 >= 32) a 32-column slab spans a cluster of 8 / 16
    blocks: F(n1 / 128) in registers from the loads, an exchange through
    distributed shared memory, F(128) with the twiddle products in its last
    trip."""
    _check_col(re, im, tabs, n1, steps)
    if re.device.type == "cpu":
        return col64_plain(re, im, tabs, n1, steps)
    tabs = tuple(tabs)
    _launch_ready("col64", (re, im), (*tabs, steps))
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    dev = re.device
    ptrs = tuple(x.data_ptr() for x in (re, im, steps, *tabs, out_re, out_im))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = call("phastft_col64", col64_args(re.shape, n1, ptrs, stream),
                   kernel="col64")
    if err != 0:
        raise RuntimeError(f"col64: kernel launch failed, CUDA error {err}")
    return out_re, out_im


def col64_nocorr_plain(re, im, n1: int, steps):
    """Plain-torch bare column pass: same arguments and result as
    ``col64_nocorr`` (the JAX package's ``stockham_axis2`` in torch;
    ``steps`` is checked, not read)."""
    _check_col(re, im, None, n1, steps, "col64_nocorr")
    return stockham_axis2(re, im, n1)


def col64_nocorr(re, im, n1: int, steps):
    """X[..., k1, i2] = sum_i1 x[..., i1, i2] W_n1^(i1*k1) on (..., n1, n2)
    f64 planes, n1 = 2..2048 and n2 >= 1 powers of two: ``col64`` with no
    twiddle, the column pass of the distributed four-step's permuted-input
    branch. ``steps``: the ``dif{n1}`` table (``dif_twiddles``) on the
    planes' device. Returns two new planes.

    On CUDA it launches ``csrc/col64.cu``'s bare mode (the same designs,
    the twiddle products compiled out) on the current stream, or raises; a
    CPU tensor runs ``col64_nocorr_plain``. Inputs are read, never written.

    Stands for the JAX package's ``stockham_axis2`` on a shard's column
    block (``phastft_tpu/parallel/fourstep_dist.py:203``). Bound by memory
    (32 B per element)."""
    _check_col(re, im, None, n1, steps, "col64_nocorr")
    if re.device.type == "cpu":
        return col64_nocorr_plain(re, im, n1, steps)
    _launch_ready("col64_nocorr", (re, im), (steps,))
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    dev = re.device
    ptrs = tuple(x.data_ptr() for x in (re, im, steps, out_re, out_im))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = call("phastft_col64_nocorr", col64_args(re.shape, n1, ptrs, stream),
                   kernel="col64_nocorr")
    if err != 0:
        raise RuntimeError(f"col64_nocorr: kernel launch failed, CUDA error {err}")
    return out_re, out_im


# ---------------------------------------------------------------- leaf64
def leaf64_args(shape, ptrs=(None,) * 8, stream=None, out_scale=1.0) -> tuple:
    """``phastft_leaf64``'s arguments for rows of ``shape`` (..., n): the
    pointers ``ptrs`` (the planes, the two step tables, the correction re
    and im, the outputs; None where absent), the rows, n, the output scale
    and the stream."""
    b = math.prod(shape[:-1])
    return (*ptrs, b, int(shape[-1]), float(out_scale), stream)


def _check_leaf(re, im, corr, n: int, steps):
    """Validate the leaf's arguments; return (flat batch, n1, corr, steps)."""
    if n < 2 or n > MAX_LEAF_N or n & (n - 1):
        raise ValueError(f"leaf64: unsupported row length n={n}")
    n1 = max(1, n // LANES)
    corr = tuple(corr) if n1 > 1 and corr is not None else ()
    if not isinstance(steps, (tuple, list)) or len(steps) != 2:
        raise ValueError("leaf64: steps must be the pair (dif{n1} or None, dif{n2})")
    steps = ((_check_steps("leaf64", steps[0], n1),) if n1 > 1 else ()) + (
        _check_steps("leaf64", steps[1], min(n, LANES)),)
    _check_planes("leaf64", re, im, (*corr, *steps))
    if re.dim() < 1 or re.shape[-1] != n:
        raise ValueError(f"leaf64: expected (..., {n}) planes, got {tuple(re.shape)}")
    if n1 > 1 and (len(corr) != 2 or any(tuple(a.shape) != (n1, LANES) for a in corr)):
        raise ValueError(f"leaf64: n = {n} needs the 2 x ({n1}, {LANES}) "
                         f"leaf{n1} correction")
    batch = tuple(re.shape[:-1])
    return int(np.prod(batch)) if batch else 1, n1, corr, steps


def leaf64_plain(re, im, corr, n: int, steps, out_scale: float = 1.0):
    """Plain-torch leaf: same arguments and result as ``leaf64`` (the JAX
    package's ``leaf_fft`` from n = 128, ``tiny_fft`` below, in torch;
    ``steps`` is checked, not read)."""
    _, n1, corr, _ = _check_leaf(re, im, corr, n, steps)
    out = tiny_fft(re, im, n) if n < LANES else leaf_fft(re, im, corr, n1)
    return tuple(scaled(x, out_scale) for x in out)


def leaf64(re, im, corr, n: int, steps, out_scale: float = 1.0):
    """DFT along the last axis of (..., n) f64 planes, n = 2..2^16 a power
    of two, natural order in and out. ``corr``: from n = 256 the (re, im)
    pair of the planner's ``leaf{n1}``, W_n^(k1*i2) on (n1, 128), n1 =
    n / 128 (ignored below). ``steps``: the pair (``dif{n1}``, ``dif128``),
    (None, ``dif{n}``) below 256 points. All on the planes' device. Returns
    two new planes, every value times ``out_scale``.

    On CUDA it launches ``csrc/leaf64.cu`` on the current stream; a CPU
    tensor runs ``leaf64_plain``. Inputs are read, never written.

    Stands for the JAX package's XLA ``leaf_fft`` and ``tiny_fft``
    (``phastft_tpu/ops/stockham.py:236``, ``:254``). Bound by memory (32 B
    per element); blocks of 4096 points, two per SM, run radix-16 and
    radix-8 DIF trips in registers, the first straight from the loads and
    the last straight to the stores. Up to 2^12 points a block holds whole
    rows; from 2^13 a cluster of 2, 4, 8 or 16 blocks holds one row and
    trades through distributed shared memory between F(n1) and F(128)."""
    _, n1, corr, tw = _check_leaf(re, im, corr, n, steps)
    if re.device.type == "cpu":
        return leaf64_plain(re, im, corr, n, steps, out_scale)
    _launch_ready("leaf64", (re, im), (*corr, *tw))
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    dev = re.device
    tw1 = tw[0].data_ptr() if n1 > 1 else None
    tw2 = tw[-1].data_ptr()
    ptrs = (re.data_ptr(), im.data_ptr(), tw1, tw2,
            *((corr[0].data_ptr(), corr[1].data_ptr()) if corr else (None, None)),
            out_re.data_ptr(), out_im.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = call("phastft_leaf64", leaf64_args(re.shape, ptrs, stream, out_scale),
                   kernel="leaf64")
    if err != 0:
        raise RuntimeError(f"leaf64: kernel launch failed, CUDA error {err}")
    return out_re, out_im
