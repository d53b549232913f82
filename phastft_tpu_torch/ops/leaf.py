"""Leaf transforms: the whole DFT of every row in one kernel.

Counterpart of the JAX package's ``ops/pallas_leaf.py`` (``leaf_fft_pallas``
and ``leaf_fft_pallas3``), of ``ops/mxu.leaf_fft_mxu`` at n1 = 1 and of
``ops/stockham.tiny_fft``. Rows are (..., n) f32 planar pairs; the result
is their length-n DFT in natural order, as new tensors.

``leaf(re, im, mats, n1)`` takes every n = 2..2^15:

* n = n1 * 128, n1 = 2..256, ``mats`` = the JAX planner's
  ``mxu{n1}[:6] + leaf{n1}``: t = F(n1) over i1, u = t * W_n^(k1*i2),
  v = u * F(128) over i2, out = X[k1 + n1*k2] (``leaf_fft_pallas``);
* n = 128 (n1 = 1), ``mats`` = ``mxu1`` (F(n1) and the correction are
  zero-size placeholders): one F(128) (``leaf_fft_mxu``);
* n = 2..64, ``mats = ()``, n1 = 1: one F(n) (``tiny_fft``; the kernel
  forms W_n^k from the exact phase, so this needs no table).

``leaf3(re, im, mats, a, b)`` takes n = a * 4 * b, ``mats`` = the JAX
planner's ``mxu3_{n1}``: F(a) over i_a, W_n^(k_a*i_r), a radix-4 of adds
over i_p, W_4b^(p*i_b), F(b) over i_b, out = X[k_a + a*k_p + 4a*k_b]
(``leaf_fft_pallas3``). The kernel takes b = 128 and a = 128 or 256
(n = 2^16, the default leaf rule's, and 2^17, ``leaf_fft_size = 2^17``'s).

``hybrid(re, im, mats, n1)`` takes n = n1 * 128, n1 = 2..1024, ``mats`` =
the JAX planner's ``mxu{n1}[3:6] + leaf{n1}`` (F(128) with its Karatsuba
sum, and the (n1, 128) correction): a Stockham F(n1) over i1, the
correction W_n^(k1*i2), then F(128) over i2 as Karatsuba's three
products, out = X[k1 + n1*k2] (``leaf_fft_pallas_hybrid``, the opt-in
``Options.leaf_kernel="hybrid"``).

Each takes ``out_scale`` (1.0 unless given), the factor of every output
value: the rows (``ops/fourstep``) pass an inverse's 1/n to the leaf that
ends it, and the kernels multiply each value by it just before its store
(the plain versions multiply their result), so the inverse makes no pass of
its own for its scale.

On CUDA tensors the wrappers launch the hand-written kernels
``csrc/leaf.cu``, ``csrc/leaf3.cu`` and ``csrc/hybrid.cu``; on CPU tensors
they run ``leaf_plain``, ``leaf3_plain`` and ``hybrid_plain``, the same
functions in plain torch that follow the JAX kernels' arithmetic (dense DFT
products, see ``_cmul``; the hybrid's Stockham steps and Karatsuba
products). All three are bound by memory (16 B per complex element, read
once and written once); the hybrid kernel runs its dense F(128)
contraction on the tensor cores as three TF32 passes per product
(3xTF32, see its source), 2304 flops per element. A block keeps whole rows
in shared memory (several rows below 2^13 points) and stages its stores
there, so loads and stores are contiguous float4 accesses; a row of 2^14,
2^15 or 2^16 points is held by a cluster of 2, 4 or 8 blocks of 2^13
points (the hybrid's 2^17 row by 16), which exchange the second factor's
data through distributed shared memory.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from ._build import call
from .mxu import dft_matrix_host
from .stockham import LANES, stockham_axis2

__all__ = ["leaf", "leaf_plain", "leaf3", "leaf3_plain", "hybrid",
           "hybrid_plain", "leaf_args", "leaf3_args", "hybrid_args"]

#: Largest n1 of ``leaf`` (n = 2^15, the largest two-factor leaf plan).
MAX_N1 = 256

#: Largest n1 of ``hybrid`` (n = 2^17, the JAX planner's largest hybrid
#: leaf: it builds ``mxu{n1}`` up to n1 = 1024).
HYBRID_MAX_N1 = 1024

#: First factors a of the rows ``leaf3``'s kernel takes (n = a * 512: 2^16,
#: 2^17).
LEAF3_AS = (128, 256)


def _check_pair(name, re, im, tables):
    for x in (re, im, *tables):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} takes torch tensors")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} is float32 only, got {x.dtype}")
        if x.device != re.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    if re.shape != im.shape or re.dim() < 1:
        raise ValueError(
            f"{name}: expected (..., n) planar pairs, got {tuple(re.shape)} "
            f"and {tuple(im.shape)}"
        )
    batch = tuple(re.shape[:-1])
    return batch, int(np.prod(batch)) if batch else 1, int(re.shape[-1])


def _check(re, im, mats, n1: int):
    """Validate ``leaf``'s arguments; return (batch shape, flat batch, n)."""
    mats = tuple(mats)
    batch, b, n = _check_pair("leaf", re, im, mats)
    if not mats:
        if n1 != 1 or n < 2 or n >= LANES or n & (n - 1):
            raise ValueError(f"leaf: a tiny row (no tables) needs 2 <= n < "
                             f"{LANES}, a power of 2, and n1 = 1; got n={n}, "
                             f"n1={n1}")
        return batch, b, n
    if n1 < 1 or n1 > MAX_N1 or n1 & (n1 - 1) or n != n1 * LANES:
        raise ValueError(f"leaf: unsupported shape n={n}, n1={n1}")
    if n1 == 1:
        want = [(0,)] * 3 + [(LANES, LANES)] * 3 + [(0,)] * 2
    else:
        want = [(n1, n1)] * 3 + [(LANES, LANES)] * 3 + [(n1, LANES)] * 2
    if [tuple(x.shape) for x in mats] != want:
        raise ValueError(f"leaf: tables do not match n1={n1}")
    return batch, b, n


def _check3(re, im, mats, a: int, b: int):
    """Validate ``leaf3``'s arguments; return (batch shape, flat batch, n)."""
    mats = tuple(mats)
    batch, bs, n = _check_pair("leaf3", re, im, mats)
    if a < 1 or b < 1 or a & (a - 1) or b & (b - 1) or n != a * 4 * b:
        raise ValueError(f"leaf3: unsupported shape n={n}, a={a}, b={b}")
    want = [(a, a)] * 3 + [(b, b)] * 3 + [(a, 4 * b)] * 2 + [(4, b)] * 2
    if [tuple(x.shape) for x in mats] != want:
        raise ValueError(f"leaf3: tables do not match a={a}, b={b}")
    return batch, bs, n


def _check_hybrid(re, im, mats, n1: int):
    """Validate ``hybrid``'s arguments; return (batch shape, flat batch, n)."""
    mats = tuple(mats)
    batch, b, n = _check_pair("hybrid", re, im, mats)
    if n1 < 2 or n1 > HYBRID_MAX_N1 or n1 & (n1 - 1) or n != n1 * LANES:
        raise ValueError(f"hybrid: unsupported shape n={n}, n1={n1}")
    want = [(LANES, LANES)] * 3 + [(n1, LANES)] * 2
    if [tuple(x.shape) for x in mats] != want:
        raise ValueError(f"hybrid: tables do not match n1={n1}")
    return batch, b, n


@contextlib.contextmanager
def full_f32_matmuls():
    """TF32 off for the matmuls inside (``torch.backends.cuda.matmul.
    allow_tf32 = False``), so the plain versions' products stay full f32 on
    the card, as the JAX package's HIGHEST precision does; the caller's
    setting comes back on the way out. Used as a decorator, it holds for
    each call."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _cmul(ar, ai, br, bi):
    """(ar + i ai) @ (br + i bi) as four real products. The JAX kernels'
    three-product Karatsuba form (p3 - p1 - p2, with the tables' sums f*s)
    adds rounding: at n = 2^15 it reads 5.0e-7 rel L2 from numpy's f64 FFT
    on the CPU, over the 5e-7 bound, where this form reads 3.5e-7."""
    return (torch.matmul(ar, br) - torch.matmul(ai, bi),
            torch.matmul(ar, bi) + torch.matmul(ai, br))


def scaled(x, out_scale: float):
    """``x * out_scale`` as a new tensor, or ``x`` itself at 1: a plain
    version's output scale. Never in place: a plain result can share the
    caller's memory (a transpose of a size-1 axis)."""
    return x if out_scale == 1.0 else x * out_scale


@functools.lru_cache(maxsize=16)
def _tiny_mats(n: int, device: torch.device):
    fr, fi = dft_matrix_host(n, "float32")
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (fr, fi))


@full_f32_matmuls()
def leaf_plain(re, im, mats, n1: int, out_scale: float = 1.0):
    """Plain-torch leaf: same arguments and result as ``leaf``. The
    products are dense, as the JAX kernels' are (see ``_cmul``); F(m) is
    symmetric, so x @ F(m) contracts the index of each row."""
    mats = tuple(mats)
    batch, b, n = _check(re, im, mats, n1)
    if not mats:
        xr, xi = re.reshape(b, n), im.reshape(b, n)
        vr, vi = _cmul(xr, xi, *_tiny_mats(n, re.device))
    elif n1 == 1:
        xr, xi = re.reshape(b, LANES), im.reshape(b, LANES)
        vr, vi = _cmul(xr, xi, mats[3], mats[4])
    else:
        f1r, f1i, _, f2r, f2i, _, cr, ci = mats
        xr = re.reshape(b, n1, LANES)
        xi = im.reshape(b, n1, LANES)
        # t = F(n1) @ x over i1, u = t * W_n^(k1*i2)
        tr, ti = _cmul(f1r, f1i, xr, xi)
        ur = tr * cr - ti * ci
        ui = tr * ci + ti * cr
        # v = u @ F(128) over i2; natural order X[k1 + n1*k2] = v^T
        vr, vi = _cmul(ur, ui, f2r, f2i)
        vr, vi = vr.transpose(1, 2), vi.transpose(1, 2)
    return (scaled(vr.reshape(batch + (n,)), out_scale),
            scaled(vi.reshape(batch + (n,)), out_scale))


@full_f32_matmuls()
def leaf3_plain(re, im, mats, a: int, b: int, out_scale: float = 1.0):
    """Plain-torch three-factor leaf: same arguments and result as
    ``leaf3``, in the JAX kernel's order (F(a), c1, radix-4 of adds, c2,
    F(b), lane-block concat), with ``_cmul``'s dense products."""
    mats = tuple(mats)
    batch, bs, n = _check3(re, im, mats, a, b)
    f1r, f1i, _, f2r, f2i, _, c1r, c1i, c2r, c2i = mats
    xr = re.reshape(bs, a, 4 * b)
    xi = im.reshape(bs, a, 4 * b)
    # t = F(a) @ x over i_a, u = t * W_n^(k_a*i_r)
    tr, ti = _cmul(f1r, f1i, xr, xi)
    ur = tr * c1r - ti * c1i
    ui = tr * c1i + ti * c1r
    # radix-4 over i_p: y_p = sum_j s_j W_4^(j*p), -i*h = (h_i, -h_r)
    sr = [ur[..., j * b:(j + 1) * b] for j in range(4)]
    si = [ui[..., j * b:(j + 1) * b] for j in range(4)]
    e_r, e_i = sr[0] + sr[2], si[0] + si[2]
    d_r, d_i = sr[0] - sr[2], si[0] - si[2]
    g_r, g_i = sr[1] + sr[3], si[1] + si[3]
    h_r, h_i = sr[1] - sr[3], si[1] - si[3]
    y = ((e_r + g_r, e_i + g_i), (d_r + h_i, d_i - h_r),
         (e_r - g_r, e_i - g_i), (d_r - h_i, d_i + h_r))
    outs_r, outs_i = [], []
    for p, (yr, yi) in enumerate(y):
        # w_p = y_p * W_4b^(p*i_b); o_p[k_b, k_a] = F(b) over i_b
        wr = (yr * c2r[p] - yi * c2i[p]).transpose(1, 2)
        wi = (yr * c2i[p] + yi * c2r[p]).transpose(1, 2)
        o_r, o_i = _cmul(f2r, f2i, wr, wi)
        outs_r.append(o_r)
        outs_i.append(o_i)
    # flat k_b*(4a) + p*a + k_a == k_a + a*k_p + 4a*k_b
    out_r = torch.cat(outs_r, dim=-1).reshape(batch + (n,))
    out_i = torch.cat(outs_i, dim=-1).reshape(batch + (n,))
    return scaled(out_r, out_scale), scaled(out_i, out_scale)


@full_f32_matmuls()
def hybrid_plain(re, im, mats, n1: int, out_scale: float = 1.0):
    """Plain-torch hybrid leaf: same arguments and result as ``hybrid``, in
    the JAX kernel's order: ``stockham_axis2`` over i1 (its in-kernel f32
    twiddles), the correction, and q1 = F_r u_r, q2 = F_i u_i,
    q3 = F_s (u_r + u_i) contracted over i2 into (k2, k1), with
    X = (q1 - q2, q3 - q1 - q2)."""
    mats = tuple(mats)
    batch, b, n = _check_hybrid(re, im, mats, n1)
    f2r, f2i, f2s, cr, ci = mats
    tr, ti = stockham_axis2(re.reshape(b, n1, LANES), im.reshape(b, n1, LANES),
                            n1)
    ur = (tr * cr - ti * ci).transpose(1, 2)
    ui = (tr * ci + ti * cr).transpose(1, 2)
    q1 = torch.matmul(f2r, ur)
    q2 = torch.matmul(f2i, ui)
    q3 = torch.matmul(f2s, ur + ui)
    return (scaled((q1 - q2).reshape(batch + (n,)), out_scale),
            scaled((q3 - q1 - q2).reshape(batch + (n,)), out_scale))


def _cuda_args(name, re, im, tables):
    """Check what the kernels need beyond the shapes; return the outputs."""
    if re.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {re.device}")
    if not all(x.is_contiguous() for x in (re, im, *tables)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if re.data_ptr() % 16 or im.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return torch.empty_like(re), torch.empty_like(im)


def leaf_args(shape, n1: int, ptrs=(None,) * 10, stream=None, out_scale=1.0) -> tuple:
    """``phastft_leaf``'s arguments for rows of ``shape`` (..., n): the
    pointers ``ptrs`` (the planes, rows 1 of F(n1) and F(128) and the
    correction, each re and im, where present, and the outputs), the rows,
    n1, n / n1, the output scale and the stream."""
    return (*ptrs, math.prod(shape[:-1]), n1, int(shape[-1]) // n1, float(out_scale), stream)


def leaf3_args(shape, ptrs=(None,) * 12, stream=None, out_scale=1.0) -> tuple:
    """``phastft_leaf3``'s arguments for rows of ``shape`` (..., a * 512):
    the pointers ``ptrs``, the rows, a, the output scale and the stream."""
    return (*ptrs, math.prod(shape[:-1]), int(shape[-1]) // (4 * LANES), float(out_scale),
            stream)


def hybrid_args(shape, n1: int, ptrs=(None,) * 8, stream=None, out_scale=1.0) -> tuple:
    """``phastft_hybrid``'s arguments for rows of ``shape`` (..., n): the
    pointers ``ptrs``, the rows, n1, the output scale and the stream. The
    kernel takes the cluster from n1: one block of 64 / n1 rows up to
    n1 = 64, n1 / 64 blocks a row above (16 at n1 = 1024, set at launch)."""
    return (*ptrs, math.prod(shape[:-1]), n1, float(out_scale), stream)


def leaf(re, im, mats, n1: int, out_scale: float = 1.0):
    """Length-n DFT of every row of (..., n) f32 planar tensors, n = 2..2^15,
    in natural order (see the module docstring for ``mats`` and ``n1``).

    On CUDA it launches ``csrc/leaf.cu`` on the current stream (the kernel
    reads row 1 of F(n1) and F(128) as its twiddle tables, and the
    (n1, 128) correction); a CPU tensor runs ``leaf_plain``. Inputs are
    read, never written; the outputs are new tensors, every value times
    ``out_scale``.

    Replaces ``phastft_tpu/ops/pallas_leaf.py`` ``leaf_fft_pallas`` (and
    the XLA leaves at n <= 128). Bound by memory; blocks of 8192 points,
    three per SM, hold whole rows up to 2^13 points and stage the
    transposed store in shared memory so it writes contiguous float4s; at
    2^14 and 2^15 a cluster of 2 or 4 blocks holds a row and trades through
    distributed shared memory. Radix passes of up to four stages, the
    correction folded into the last F(n1) pass. Any batch: rows go in
    ``gridDim.x``."""
    mats = tuple(mats)
    _check(re, im, mats, n1)
    if re.device.type == "cpu":
        return leaf_plain(re, im, mats, n1, out_scale)
    ore, oim = _cuda_args("leaf", re, im, mats)
    if not mats:
        ptrs = [None] * 6
    elif n1 == 1:
        ptrs = [None, None, mats[3].data_ptr(), mats[4].data_ptr(), None, None]
    else:
        ptrs = [mats[i].data_ptr() for i in (0, 1, 3, 4, 6, 7)]
    ptrs = (re.data_ptr(), im.data_ptr(), *ptrs, ore.data_ptr(), oim.data_ptr())
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        err = call("phastft_leaf", leaf_args(re.shape, n1, ptrs, stream, out_scale),
                   kernel="leaf")
    if err != 0:
        raise RuntimeError(f"leaf: kernel launch failed, CUDA error {err}")
    return ore, oim


def leaf3(re, im, mats, a: int, b: int, out_scale: float = 1.0):
    """Length-n DFT of every row of (..., n) f32 planar tensors, n = a*4*b,
    in natural order, through the three-factor split of the tables
    ``mats`` (``mxu_leaf_tables3_host(a, b)`` on the tensors' device).

    On CUDA it launches ``csrc/leaf3.cu`` on the current stream, for b = 128
    and a = 128 or 256 (n = 2^16, 2^17); a CPU tensor runs ``leaf3_plain``
    at any (a, b).
    Inputs are read, never written; the outputs are new tensors, every
    value times ``out_scale``.

    Replaces ``phastft_tpu/ops/pallas_leaf.py`` ``leaf_fft_pallas3``.
    Bound by memory; a row (512 KB, 1 MiB at a = 256) is held by a cluster
    of a / 16 blocks (8, or 16: a non-portable size) of 256 threads, three
    (a = 128) or two (a = 256) resident per SM: block c runs F(a) and c1 on
    its 8192 / a columns i_r,
    then reads k_a in [16c, 16c + 16) of every i_p straight from the blocks
    that hold them (distributed shared memory) into the radix-4 and c2, runs
    F(b) and stores 16 contiguous floats per (k_b, p). Any batch: rows go in
    ``gridDim.x``. A cluster shape that does not fit the device raises."""
    mats = tuple(mats)
    _check3(re, im, mats, a, b)
    if re.device.type == "cpu":
        return leaf3_plain(re, im, mats, a, b, out_scale)
    ore, oim = _cuda_args("leaf3", re, im, mats)
    if a not in LEAF3_AS or b != LANES:
        raise ValueError(f"leaf3: the kernel takes b = {LANES} and a in "
                         f"{LEAF3_AS}, got a={a}, b={b}")
    ptrs = (re.data_ptr(), im.data_ptr(),
            *(mats[i].data_ptr() for i in (0, 1, 3, 4, 6, 7, 8, 9)),
            ore.data_ptr(), oim.data_ptr())
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        err = call("phastft_leaf3", leaf3_args(re.shape, ptrs, stream, out_scale),
                   kernel="leaf3")
    if err != 0:
        raise RuntimeError(f"leaf3: kernel launch failed, CUDA error {err}")
    return ore, oim


def hybrid(re, im, mats, n1: int, out_scale: float = 1.0):
    """Length-n DFT of every row of (..., n) f32 planar tensors,
    n = n1 * 128 with n1 = 2..1024, in natural order, on the operands of the
    opt-in hybrid leaf (see the module docstring for ``mats``).

    On CUDA it launches ``csrc/hybrid.cu`` on the current stream (the kernel
    reads row 1 of F(128) as its root table and the (n1, 128) correction);
    a CPU tensor runs ``hybrid_plain``. Any batch: rows go in
    ``gridDim.x``. Inputs are read, never written; the outputs are new
    tensors, every value times ``out_scale``.

    Replaces ``phastft_tpu/ops/pallas_leaf.py`` ``leaf_fft_pallas_hybrid``;
    unlike it, it takes any batch and never declines. Bound by memory (16 B
    per element); the dense F(128) contraction runs on the tensor cores as
    ``wgmma`` TF32 in three passes per product (big*big + big*small +
    small*big), which holds the 1e-6 parity with ``hybrid_plain``. Every
    block holds 8192 points: 64 / n1 rows up to n1 = 64, and from n1 = 128 a
    row is spread over a cluster of n1 / 64 blocks that read each other's
    columns through distributed shared memory (16 blocks at n1 = 1024, a
    non-portable size set at launch; a cluster shape that does not fit the
    device raises)."""
    mats = tuple(mats)
    _check_hybrid(re, im, mats, n1)
    if re.device.type == "cpu":
        return hybrid_plain(re, im, mats, n1, out_scale)
    ore, oim = _cuda_args("hybrid", re, im, mats)
    ptrs = (re.data_ptr(), im.data_ptr(), mats[0].data_ptr(), mats[1].data_ptr(),
            mats[3].data_ptr(), mats[4].data_ptr(), ore.data_ptr(), oim.data_ptr())
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        err = call("phastft_hybrid", hybrid_args(re.shape, n1, ptrs, stream, out_scale),
                   kernel="hybrid")
    if err != 0:
        raise RuntimeError(f"hybrid: kernel launch failed, CUDA error {err}")
    return ore, oim
