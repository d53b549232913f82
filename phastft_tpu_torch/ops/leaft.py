"""Row pass of the fused two-pass four-step FFT.

Counterpart of the JAX package's ``ops/pallas_leaft.py``
(``leaft_pallas``, dense A-stage). Over the column pass's (A, n1, 128)
relayout it runs, for every row k1, the length-n2 = A*128 DFT of
c[i2] = c3[..., i2 // 128, k1, i2 % 128] as F(A) over i_A, the twiddle
W_n2^(k_A*i_M), then F(128) over i_M, and writes the result in the final
natural order of the length-n transform: out[..., k1 + n1*(k_A + A*k_M)].
The four-step's output transpose is the store index.

``leaft`` is the wrapper: on CUDA tensors it launches the hand-written
kernel ``csrc/leaft.cu``; on CPU tensors it runs ``leaft_plain``, the same
function in plain torch that follows the JAX kernel's arithmetic (dense
Karatsuba products with F(A) and F(128)). Both take ``out_scale`` (1.0
unless given), the factor of every output value: the split level that ends
an inverse hands it the 1/n, and the kernel multiplies each value just
before its store (the plain version multiplies its result). The kernel is
bound by memory;
a cluster of its blocks owns 8 consecutive rows, so that each store writes
8 contiguous floats (see the note in its source).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ._build import call
from .leaf import full_f32_matmuls, scaled
from .mxu import dft_matrix_host
from .stockham import leaf_correction_host

__all__ = ["M_LANES", "leaft_tables_host", "leaft", "leaft_args", "leaft_plain"]

#: Second leaf factor (the lane axis of the column pass's 3-d output).
M_LANES = 128

#: Consecutive rows k1 a cluster of the kernel holds: on CUDA n1 must be a
#: multiple (every fused level has n1 = 128..2048).
KERNEL_ROWS = 8


@functools.lru_cache(maxsize=64)
def leaft_tables_host(n2: int, dtype_name: str = "float32"):
    """Host tables for the row pass of length n2 = A * 128:
    (f1r, f1i, f1s [A x A], f2r, f2i, f2s [128 x 128], cr, ci [A x 128])
    with Karatsuba sums precomputed and the inner twiddle correction
    W_n2^{k_A * i_M} in natural (k_A, i_M) layout. Exact f64 angles,
    single rounding."""
    a = n2 // M_LANES
    f1r, f1i = dft_matrix_host(a, dtype_name)
    f2r, f2i = dft_matrix_host(M_LANES, dtype_name)
    cr, ci = leaf_correction_host(a, M_LANES, dtype_name)
    return f1r, f1i, f1r + f1i, f2r, f2i, f2r + f2i, cr, ci


def _check(cre, cim, mats, n1: int):
    """Validate the arguments shared by the kernel and its plain version;
    return (batch shape, flat batch, A)."""
    if len(mats) != 8:
        raise ValueError("leaft: mats must be the 8 tables of leaft_tables_host")
    for x in (cre, cim, *mats):
        if not isinstance(x, torch.Tensor):
            raise TypeError("leaft takes torch tensors")
        if x.dtype != torch.float32:
            raise TypeError(f"leaft is float32 only, got {x.dtype}")
        if x.device != cre.device:
            raise ValueError("leaft: all tensors must be on one device")
    if (cre.shape != cim.shape or cre.dim() < 3 or cre.shape[-2] != n1
            or cre.shape[-1] != M_LANES):
        raise ValueError(
            f"leaft: expected (..., A, {n1}, {M_LANES}) planar pairs, got "
            f"{tuple(cre.shape)} and {tuple(cim.shape)}"
        )
    a = int(cre.shape[-3])
    if a < 8 or a > 128 or a & (a - 1) or n1 < 1:
        raise ValueError(f"leaft: unsupported shape A={a}, n1={n1}")
    want = [(a, a)] * 3 + [(M_LANES, M_LANES)] * 3 + [(a, M_LANES)] * 2
    if [tuple(x.shape) for x in mats] != want:
        raise ValueError(f"leaft: tables do not match A={a}")
    batch = tuple(cre.shape[:-3])
    return batch, int(np.prod(batch)) if batch else 1, a


@full_f32_matmuls()
def leaft_plain(cre, cim, mats, n1: int, out_scale: float = 1.0):
    """Plain-torch row pass: same arguments and result as ``leaft``. The
    products are full f32 (``leaf.full_f32_matmuls``)."""
    batch, b, a = _check(cre, cim, mats, n1)
    f1r, f1i, f1s, f2r, f2i, f2s, cr, ci = mats
    m = M_LANES
    xr = cre.reshape(b, a, n1 * m)
    xi = cim.reshape(b, a, n1 * m)
    p1 = torch.matmul(f1r, xr)
    p2 = torch.matmul(f1i, xi)
    p3 = torch.matmul(f1s, xr + xi)
    tr = (p1 - p2).view(b, a, n1, m)
    ti = (p3 - p1 - p2).view(b, a, n1, m)
    crv = cr.view(a, 1, m)
    civ = ci.view(a, 1, m)
    ur = (tr * crv - ti * civ).reshape(b, a * n1, m)
    ui = (tr * civ + ti * crv).reshape(b, a * n1, m)
    q1 = torch.matmul(ur, f2r.T)
    q2 = torch.matmul(ui, f2i.T)
    q3 = torch.matmul(ur + ui, f2s.T)
    n = a * m * n1

    def store(v):
        # v[b, kA, k1, kM] -> out[b, kM, kA, k1], the natural order
        return scaled(v.view(b, a, n1, m).permute(0, 3, 1, 2).reshape(batch + (n,)),
                      out_scale)

    return store(q1 - q2), store(q3 - q1 - q2)


def leaft_args(shape, ptrs=(None,) * 10, stream=None, out_scale=1.0) -> tuple:
    """``phastft_leaft``'s arguments for an input of ``shape`` (..., A, n1,
    128): the pointers ``ptrs`` (the two planes, F(A), F(128) and the
    correction, each re and im, and the two outputs), the flat batch, n1,
    A, the output scale and the stream."""
    b = math.prod(shape[:-3])
    return (*ptrs, b, int(shape[-2]), int(shape[-3]), float(out_scale), stream)


def leaft(cre, cim, mats, n1: int, out_scale: float = 1.0):
    """Row FFTs of length n2 = A * 128 over the column pass's
    (..., A, n1, 128) f32 output, written as (..., n) in the final natural
    order X[k1 + n1*k2]. ``mats``: the 8 tables of ``leaft_tables_host``
    on the tensors' device.

    On CUDA it launches ``csrc/leaft.cu`` on the current stream (the kernel
    reads row 1 of F(A) and F(128) as its twiddle tables, and the (A, 128)
    correction table); a CPU tensor runs ``leaft_plain``. Inputs are read,
    never written; the outputs are new tensors, every value times
    ``out_scale``.

    Replaces ``phastft_tpu/ops/pallas_leaft.py`` ``leaft_pallas``. Bound
    by memory (16 B per complex element, read once and written once); a
    cluster of A/8 blocks of 8192 points holds 8 consecutive rows (n1 must
    be a multiple of 8 on CUDA), reads them with float4 loads, trades the
    two factors through distributed shared memory and writes 8 contiguous
    floats per output run."""
    batch, _, a = _check(cre, cim, mats, n1)
    if cre.device.type == "cpu":
        return leaft_plain(cre, cim, mats, n1, out_scale)
    if cre.device.type != "cuda":
        raise ValueError(f"leaft: unsupported device {cre.device}")
    if not all(x.is_contiguous() for x in (cre, cim, *mats)):
        raise ValueError("leaft: inputs must be contiguous")
    if n1 % KERNEL_ROWS:
        raise ValueError(f"leaft: the kernel takes n1 a multiple of "
                         f"{KERNEL_ROWS}, got {n1}")
    if cre.data_ptr() % 16 or cim.data_ptr() % 16:
        raise ValueError("leaft: inputs must be 16-byte aligned")
    f1r, f1i, _, f2r, f2i, _, cr, ci = mats
    shape = batch + (a * M_LANES * n1,)
    ore = torch.empty(shape, dtype=torch.float32, device=cre.device)
    oim = torch.empty(shape, dtype=torch.float32, device=cre.device)
    ptrs = tuple(x.data_ptr() for x in (cre, cim, f1r, f1i, f2r, f2i, cr, ci, ore, oim))
    with torch.cuda.device(cre.device):
        stream = torch.cuda.current_stream(cre.device).cuda_stream
        err = call("phastft_leaft", leaft_args(cre.shape, ptrs, stream, out_scale),
                   kernel="leaft")
    if err != 0:
        raise RuntimeError(f"leaft: kernel launch failed, CUDA error {err}")
    return ore, oim
