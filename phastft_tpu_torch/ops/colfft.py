"""Column pass of the four-step FFT.

Counterpart of the JAX package's ``ops/pallas_col.py`` (``colfft_pallas``
in both of its output modes, and ``colfft_pallas_nocorr``). For x viewed (..., n1, n2) it computes, for
every column i2,

    y[..., k1, i2] = W_n^(k1*i2) * sum_i1 W_n1^(k1*i1) x[..., i1, i2]

i.e. the size-n1 column DFT and the four-step split twiddle, and lands it

* ``colfft``: as (..., n1, n2), the classic layout, for the outer level of
  a nested plan and every split the fused two-pass pipeline refuses;
* ``colfft_out3d``: as c3[..., i2 // 128, k1, i2 % 128], the (A, n1, 128)
  relayout (A = n2/128) that the row pass (``ops/leaft``) reads.

``colfft`` also takes a distributed shard's column block: with ``n_total``
and ``col_base`` the twiddle is W_{n_total}^(k1*(col_base + i2)), the
split twiddle of the length-n_total transform whose columns
[col_base, col_base + n2) the block holds. ``colfft_nocorr`` is the bare
column DFT, no twiddle, as (..., n1, n2): the column pass of the
distributed four-step's permuted-input branch.

All three are wrappers: on CUDA tensors they launch the hand-written
kernel ``csrc/colfft.cu`` (one kernel, the store index and the twiddle
chosen by mode; the split twiddle as T1 of the block's first column times
the T2 table, the in-block twiddles from a host-built table, no
trigonometry per element); on CPU tensors they run ``colfft_plain``,
``colfft_out3d_plain`` and ``colfft_nocorr_plain``. The bare pass's plain
version is the JAX kernel's Stockham (``ops/stockham.stockham_axis2``);
the other two follow the arithmetic of the JAX package's default column
engine per depth: one dense Karatsuba product with F(n1)
below n1 = 128 (``_kernel_mxu``), above it radix-R residues (R = 4 below
n1 = 1024, 16 from it) as Karatsuba products with F(n1/R), the phase
W_n1^(p*k_m) and F(R) across residues (``_kernel_r4``/``_kernel_rn``);
then the split twiddle as T1 (exact integer phase, 15-bit split) times the
T2 table (a shard's T2 from the exact f64 phase of its columns, as the
JAX package's ``parallel/fourstep_dist._pallas_col_chunk`` builds it). A
dense F(n1) product sums 2048 terms per output at n1 = 2048 and measured
1.2e-6 rel L2 from the kernel on the H100; the residue form sums at most
128. The kernel is bound by memory; see the note in its source.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ._build import call
from .leaf import full_f32_matmuls
from .mxu import dft_matrix_host
from .stockham import LANES, stockham_axis2

__all__ = [
    "colfft_args",
    "col_tile",
    "col_tile3d",
    "col_split_tables_host",
    "colfft",
    "colfft_plain",
    "colfft_out3d",
    "colfft_out3d_plain",
    "colfft_nocorr",
    "colfft_nocorr_plain",
]

#: Column factors the kernel takes (powers of two).
MIN_N1, MAX_N1 = 2, 2048


def col_tile(n1: int, n2: int) -> int:
    """Slab width T of the JAX kernel's classic mode: the width the
    ``pcol{n1}x{n2}`` T2 table is factored on."""
    t = max(128, min(512, (1 << 17) // max(n1, 1)))
    return min(t, n2)


def col_tile3d(n1: int, n2: int) -> int:
    """Slab width T of the JAX kernel's out3d mode: the width the
    ``pcolT{n1}x{n2}`` T2 table is factored on."""
    t = max(128, min(512, (1 << 20) // max(n1, 1)))
    return min(t, n2)


@functools.lru_cache(maxsize=64)
def col_split_tables_host(n1: int, n2: int, dtype_name: str,
                          t: int | None = None):
    """T2, the lane-local half of the split twiddle factored on the slab
    width T: W_n^(k1*(j*T+c)) = T1[k1, j] * T2[k1, c]. Exact f64 angles,
    one cast. ``t`` defaults to ``col_tile3d(n1, n2)``, the out3d width;
    the classic mode's tables pass ``t=col_tile(n1, n2)``."""
    dtype = np.dtype(dtype_name)
    n = n1 * n2
    if t is None:
        t = col_tile3d(n1, n2)
    k1 = np.arange(n1, dtype=np.float64)[:, None]
    c = np.arange(t, dtype=np.float64)[None, :]
    ang2 = (-2.0 * np.pi / n) * (k1 * c)
    return np.cos(ang2).astype(dtype), np.sin(ang2).astype(dtype)


def _radix(n1: int) -> int:
    """R of the JAX package's default column engine at n1: radix-16
    residues for n1 >= 1024 (r16mxu), radix-4 from 128 (r4mxu), and one
    dense product below (mxu)."""
    if n1 >= 1024:
        return 16
    return 4 if n1 >= 128 else 1


@functools.lru_cache(maxsize=8)
def _residue_mats(n1: int, device: torch.device):
    """F(m) with its Karatsuba sum, the phase W_n1^(p*k_m) as (R, m, 1),
    and F(R), for the radix-R residue form of the column DFT."""
    radix = _radix(n1)
    m = n1 // radix
    gr, gi = dft_matrix_host(m, "float32")
    km = np.arange(m, dtype=np.int64)[None, :]
    p = np.arange(radix, dtype=np.int64)[:, None]
    ang = -2.0 * np.pi * ((km * p) % n1).astype(np.float64) / n1
    hr, hi = dft_matrix_host(radix, "float32")
    out = [gr, gi, gr + gi,
           np.cos(ang).astype(np.float32)[:, :, None],
           np.sin(ang).astype(np.float32)[:, :, None], hr, hi]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in out)


@functools.lru_cache(maxsize=16)
def _steps(n1: int, device: torch.device):
    """W_n1^k, k < n1/2, as (n1/2, 2) f32 (re, im) pairs from exact f64
    angles rounded once: the kernel's in-block twiddles, built on the host
    once per (n1, device)."""
    ang = -2.0 * np.pi * np.arange(n1 // 2, dtype=np.float64) / n1
    pairs = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(pairs).to(device)


def _t1(n1: int, n: int, t: int, nblk: int, device: torch.device):
    """T1[k1, j] = W_n^(k1*j*T) as the JAX kernel forms it: the phase
    k1*j*T mod n in integers, split in 15-bit halves that convert to f32
    exactly, f32 cos/sin of each, joined by the angle-addition identity."""
    k1 = torch.arange(n1, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(nblk, dtype=torch.int64, device=device)[None, :]
    m = (k1 * (j * t)) & (n - 1)
    hi = (m >> 15).to(torch.float32)
    lo = (m & 0x7FFF).to(torch.float32)
    a = hi * float(np.float32(-2.0 * np.pi * (1 << 15) / n))
    b = lo * float(np.float32(-2.0 * np.pi / n))
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    return ca * cb - sa * sb, sa * cb + ca * sb


def _check(name, re, im, tabs, n1: int, tile, min_n2=LANES):
    """Validate the arguments shared by the kernel and its plain version;
    return (batch shape, flat batch, n2). ``tile`` is the mode's slab-width
    rule, ``col_tile`` or ``col_tile3d``, that the split tables ``tabs``
    are factored on; None takes no tables."""
    for x in (re, im, *(tabs or ())):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} takes torch tensors")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} is float32 only, got {x.dtype}")
        if x.device != re.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    if re.shape != im.shape or re.dim() < 2 or re.shape[-2] != n1:
        raise ValueError(
            f"{name}: expected (..., {n1}, n2) planar pairs, got "
            f"{tuple(re.shape)} and {tuple(im.shape)}"
        )
    n2 = int(re.shape[-1])
    if (n1 < MIN_N1 or n1 > MAX_N1 or n1 & (n1 - 1) or n2 < min_n2
            or n2 & (n2 - 1)):
        raise ValueError(f"{name}: unsupported shape n1={n1}, n2={n2}")
    if tile is not None:
        t = tile(n1, n2)
        if (tabs is None or len(tabs) != 2
                or any(tuple(x.shape) != (n1, t) for x in tabs)):
            raise ValueError(f"{name}: split tables must be ({n1}, {t})")
    batch = tuple(re.shape[:-2])
    return batch, int(np.prod(batch)) if batch else 1, n2


def _check_any(name, re, im, tabs, n1: int, n_total, col_base: int):
    """``_check`` for ``colfft``: a whole transform's (..., n1, n2) with its
    split tables, or with ``n_total`` a shard's column block (any n2, no
    tables) whose columns [col_base, col_base + n2) lie in a transform of
    n_total points."""
    if n_total is None:
        if col_base:
            raise ValueError(f"{name}: col_base needs n_total")
        return _check(name, re, im, tabs, n1, col_tile, 1)
    out = _check(name, re, im, None, n1, None, 1)
    n2 = out[2]
    if (n_total < 1 or n_total & (n_total - 1) or col_base < 0
            or n_total < n1 * (col_base + n2)):
        raise ValueError(
            f"{name}: columns [{col_base}, {col_base + n2}) of n1 = {n1} do "
            f"not lie in a transform of n_total = {n_total}")
    return out


@functools.lru_cache(maxsize=64)
def _shard_t2(n1: int, t: int, n_total: int, col_base: int, device):
    """T2 of a shard's column block: W_{n_total}^(k1*(col_base + c)),
    c < t, from exact f64 angles cast once, as the JAX package's
    ``_pallas_col_chunk`` builds it; built once per argument set."""
    k1 = torch.arange(n1, dtype=torch.float64, device=device)[:, None]
    i2 = torch.arange(t, dtype=torch.float64, device=device)[None, :] + col_base
    ang = (-2.0 * np.pi) * ((k1 * i2) * (1.0 / float(n_total)))
    return torch.cos(ang).float(), torch.sin(ang).float()


@full_f32_matmuls()
def _column_plain(re, im, tabs, n1: int, b: int, n2: int, n_total=None):
    """The column DFT and the split twiddle in plain torch, as (b, n1, n2);
    ``n_total`` (default n1 * n2) is the length whose phase T1 spans. The
    products are full f32 (``leaf.full_f32_matmuls``), as the JAX package's
    HIGHEST precision."""
    t2r, t2i = tabs
    t = int(t2r.shape[1])
    n = n_total or n1 * n2
    radix = _radix(n1)
    m = n1 // radix
    gr, gi, gs, pr, pi, hr, hi = _residue_mats(n1, re.device)
    # i1 = R*i_m + i_p: T_p = F(m) @ x[i_p::R] (Karatsuba), (b, R, m, n2)
    xr = re.reshape(b, m, radix, n2).transpose(1, 2)
    xi = im.reshape(b, m, radix, n2).transpose(1, 2)
    p1 = torch.matmul(gr, xr)
    p2 = torch.matmul(gi, xi)
    p3 = torch.matmul(gs, xr + xi)
    br = p1 - p2
    bi = p3 - p1 - p2
    del xr, xi, p1, p2, p3  # at 2^30 points every plane is 4 GiB
    if radix > 1:
        # phase W_n1^(p*k_m), then F(R) across residues: X[k_m + m*k_p]
        ur = (br * pr - bi * pi).reshape(b, radix, m * n2)
        ui = (br * pi + bi * pr).reshape(b, radix, m * n2)
        br = torch.matmul(hr, ur) - torch.matmul(hi, ui)
        bi = torch.matmul(hr, ui) + torch.matmul(hi, ur)
        del ur, ui
    view = (b, n1, n2 // t, t)
    br, bi = br.reshape(view), bi.reshape(view)
    t1r, t1i = _t1(n1, n, t, n2 // t, re.device)
    t1r, t1i = t1r[:, :, None], t1i[:, :, None]
    ur = br * t1r - bi * t1i
    ui = br * t1i + bi * t1r
    del br, bi
    t2r, t2i = t2r[:, None, :], t2i[:, None, :]
    vr = ur * t2r - ui * t2i
    vi = ur * t2i + ui * t2r
    return vr.reshape(b, n1, n2), vi.reshape(b, n1, n2)


def colfft_plain(re, im, tabs, n1: int, *, n_total=None, col_base: int = 0):
    """Plain-torch column pass, classic layout: same arguments and result
    as ``colfft``."""
    batch, b, n2 = _check_any("colfft", re, im, tabs, n1, n_total, col_base)
    if n_total is not None:
        tabs = _shard_t2(n1, col_tile(n1, n2), n_total, col_base, re.device)
    vr, vi = _column_plain(re, im, tabs, n1, b, n2, n_total)
    shape = batch + (n1, n2)
    return vr.reshape(shape), vi.reshape(shape)


def colfft_out3d_plain(re, im, tabs, n1: int):
    """Plain-torch column pass, (A, n1, 128) relayout: same arguments and
    result as ``colfft_out3d``."""
    batch, b, n2 = _check("colfft_out3d", re, im, tabs, n1, col_tile3d)
    vr, vi = _column_plain(re, im, tabs, n1, b, n2)
    a = n2 // LANES
    shape = batch + (a, n1, LANES)

    def relayout(v):
        v = v.reshape(b, n1, a, LANES).permute(0, 2, 1, 3)
        return v.contiguous().reshape(shape)

    return relayout(vr), relayout(vi)


def colfft_nocorr_plain(re, im, n1: int):
    """Plain-torch bare column DFT: same arguments and result as
    ``colfft_nocorr``, in the JAX kernel's Stockham arithmetic."""
    batch, b, n2 = _check("colfft_nocorr", re, im, None, n1, None, 1)
    vr, vi = stockham_axis2(re.reshape(b, n1, n2), im.reshape(b, n1, n2), n1)
    shape = batch + (n1, n2)
    return vr.reshape(shape), vi.reshape(shape)


#: The kernel's modes (``csrc/colfft.cu``).
_CLASSIC, _OUT3D, _NOCORR = 0, 1, 2


def colfft_args(shape, n1: int, mode: int, n_total=None, col_base: int = 0,
                ptrs=(None,) * 7, stream=None) -> tuple:
    """``phastft_colfft``'s arguments for an input of ``shape`` (..., n1,
    n2) in ``mode``: the pointers ``ptrs`` (re, im, steps, t2r, t2i, ore,
    oim), the width of the mode's T2 table (``col_tile`` in the classic
    mode and a shard's, ``col_tile3d`` in out3d, none bare), the flat
    batch, n1, n2, the mode, ``n_total`` (default n1 * n2), ``col_base``
    and the stream."""
    n2 = int(shape[-1])
    b = math.prod(shape[:-2])
    ldt = (0 if mode == _NOCORR else col_tile3d(n1, n2) if mode == _OUT3D
           else col_tile(n1, n2))
    re, im, steps, t2r, t2i, ore, oim = ptrs
    return (re, im, steps, t2r, t2i, ldt, ore, oim, b, n1, n2, mode,
            n_total or n1 * n2, col_base, stream)


def _launch(name, re, im, n1: int, shape, mode: int, n_total=None,
            col_base: int = 0, t2=None):
    """Launch ``csrc/colfft.cu`` in ``mode`` on the current stream into new
    tensors of ``shape``; ``t2`` is the (n1, t) T2 pair of the split
    twiddle (None in the bare mode)."""
    if re.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {re.device}")
    tabs = tuple(t2) if t2 is not None else ()
    if not all(x.is_contiguous() for x in (re, im, *tabs)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if re.data_ptr() % 16 or im.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    steps = _steps(n1, re.device)
    ore = torch.empty(shape, dtype=torch.float32, device=re.device)
    oim = torch.empty(shape, dtype=torch.float32, device=re.device)
    ptrs = (re.data_ptr(), im.data_ptr(), steps.data_ptr(),
            *((tabs[0].data_ptr(), tabs[1].data_ptr()) if tabs else (None, None)),
            ore.data_ptr(), oim.data_ptr())
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream(re.device).cuda_stream
        err = call("phastft_colfft", colfft_args(re.shape, n1, mode, n_total,
                                                 col_base, ptrs, stream),
                   kernel=name)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")
    return ore, oim


def colfft(re, im, tabs, n1: int, *, n_total=None, col_base: int = 0):
    """Column DFT of size n1 = 2..2048 along axis -2 of (..., n1, n2) f32
    planar tensors, fused with the split twiddle W_n^(k1*i2), as
    (..., n1, n2), for any power of two n2 >= 1. ``tabs`` = (t2r, t2i) from
    ``col_split_tables_host(..., t=col_tile(n1, n2))`` on the tensors'
    device (n2 columns wide below n2 = 128: the rows of a split planned
    with ``leaf_fft_size`` < 128).

    A distributed shard's column block passes ``n_total`` (the length of
    its transform, a power of two) and ``col_base`` (its first column) with
    ``tabs=None``: the twiddle is W_{n_total}^(k1*(col_base + i2)), any
    n2 >= 1 (one- and two-column blocks included).

    On CUDA it launches ``csrc/colfft.cu`` on the current stream (a CPU
    tensor runs ``colfft_plain``). The kernel takes the split twiddle as
    T1 * T2: T1 of the block's first column from the exact phase, once a
    block, and T2 from ``tabs`` (a shard block's T2 is built here, as
    ``colfft_plain`` builds it). Inputs are read, never written; the
    outputs are new tensors.

    Replaces ``phastft_tpu/ops/pallas_col.py`` ``colfft_pallas(...,
    out3d=False)``, with ``n_total`` as its distributed callers use it;
    unlike it, it takes n1 = 2 and 4 and every n2. Bound by memory (16 B
    per complex element, read once and written once); the kernel touches
    device memory once each way: at n1 = 1024 and 2048 (n2 >= 32) a
    32-column slab split over a cluster of n1/256 blocks of 8192 points,
    which trade through distributed shared memory; otherwise a slab of up
    to 8192 points in one block (512 columns at n1 <= 16 down to 16 at
    n1 = 512, never more than n2: one or two columns a block at n2 = 1, 2),
    F(n1) in register trips, the first from the loads and the last to the
    stores."""
    batch, _, n2 = _check_any("colfft", re, im, tabs, n1, n_total, col_base)
    if re.device.type == "cpu":
        return colfft_plain(re, im, tabs, n1, n_total=n_total,
                            col_base=col_base)
    t2 = tabs if n_total is None else _shard_t2(
        n1, col_tile(n1, n2), n_total, col_base, re.device)
    out = _launch("colfft", re, im, n1, batch + (n1, n2), _CLASSIC, n_total,
                  col_base, t2)
    return out


def colfft_out3d(re, im, tabs, n1: int):
    """As ``colfft``, landed as (..., n2/128, n1, 128). ``tabs`` = (t2r,
    t2i) from ``col_split_tables_host`` on the tensors' device.

    On CUDA it launches ``csrc/colfft.cu`` on the current stream (a CPU
    tensor runs ``colfft_out3d_plain``). Inputs are read, never written;
    the outputs are new tensors.

    Replaces ``phastft_tpu/ops/pallas_col.py`` ``colfft_pallas(...,
    out3d=True)``. Bound by memory as ``colfft`` is, with the same slabs:
    32 columns on a cluster of n1/256 blocks at n1 = 1024 and 2048, else
    8192 / n1 columns in one block (64 at n1 = 128, 16 at 512)."""
    batch, _, n2 = _check("colfft_out3d", re, im, tabs, n1, col_tile3d)
    if re.device.type == "cpu":
        return colfft_out3d_plain(re, im, tabs, n1)
    shape = batch + (n2 // LANES, n1, LANES)
    out = _launch("colfft_out3d", re, im, n1, shape, _OUT3D, t2=tabs)
    return out


def colfft_nocorr(re, im, n1: int):
    """Bare column DFT of size n1 = 2..2048 along axis -2 of (..., n1, n2)
    f32 planar tensors, no twiddle, as (..., n1, n2), for any n2 >= 1: the
    column pass of the distributed four-step's permuted-input branch, whose
    twiddle came before its all_to_all (and of long columns past 2048 whose
    twiddle ``colfft`` cannot express, ``ops/longcol.py``).

    On CUDA it launches ``csrc/colfft.cu`` in its bare mode on the current
    stream; a CPU tensor runs ``colfft_nocorr_plain``. Inputs are read,
    never written; the outputs are new tensors.

    Replaces ``phastft_tpu/ops/pallas_col.py`` ``colfft_pallas_nocorr``;
    unlike it, it takes n1 = 2 and 4. Bound by memory as ``colfft`` is,
    with the same slabs."""
    batch, _, n2 = _check("colfft_nocorr", re, im, None, n1, None, 1)
    if re.device.type == "cpu":
        return colfft_nocorr_plain(re, im, n1)
    out = _launch("colfft_nocorr", re, im, n1, batch + (n1, n2), _NOCORR)
    return out
