"""The dd kernels of the Ozaki engine (``f64_engine="df64-oz"``).

Counterpart of the JAX package's ``ops/pallas_ozdd.py``, named as
``ops/dd.py`` is after ``pallas_dd.py``. One split level n = n1 * n2 of
an f64 transform runs as two passes through device memory, every
contraction an error-free bf16-slice product (``ops/ozaki.py``):

* ``ozcol``: the dd column DFT over n1 as one radix-4 DIF step: per digit
  p the F(n1/4) contraction of rows i_m * 4 + p, the dd phase
  W_n1^(p*k_m), the dd DFT over the four digits (``df64._dft_regs_dd``),
  then the split correction T1[k1, i2 // 256] * T2[k1, i2 % 256]; stored
  in the (..., n2/128, n1, 128) relayout.
* ``ozleaft``: over that relayout, for every row k1 the dd DFT of length
  n2 = A * 128: F(A) over i_A, the dd correction W_n2^(k_A*i_M), F(128)
  over i_M, stored in the final natural order X[k1 + n1*(k_A + A*k_M)].

``oz_window`` is the planner's gate: the shapes both kernels take. Each
wrapper launches its hand-written kernel on CUDA tensors
(``csrc/ozcol.cu``, ``csrc/ozleaft.cu``) and runs its ``*_plain``
version on CPU tensors. The plain versions are the JAX kernel bodies over
whole tensors, their slice products exact float64 matmuls. Kernel and
plain version compute the same slice integers and repeat each other's dd
arithmetic operation for operation (``csrc/oz.cuh``), so they agree bit
for bit: the slicing rounds at its last slice, where a difference of one
unit in the last place of an input would move a result by ~1e-13.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch

from ._build import call
from .dd import _check_planes as check_dd_planes
from .df64 import _dft_regs_dd, dd_cmul, split_hi_lo
from .ozaki import NSLICES, oz_cmatmul_dd, oz_slice_matrix_host
from .stockham import LANES

__all__ = [
    "OZ_COL_TILE",
    "ozcol_radix",
    "oz_window",
    "ozcol_tables_host",
    "ozleaft_tables_host",
    "slice_count",
    "ozcol_card",
    "ozleaft_card",
    "ozcol",
    "ozcol_plain",
    "ozleaft",
    "ozleaft_plain",
]

#: Width t the split correction is factored on (T1 (n1, n2/t), T2 (n1, t)):
#: the JAX kernel's slab width, kept as the tables' layout.
OZ_COL_TILE = 256

#: Slice arrays per table set: F(m) for ozcol, F(A) and F(128) for ozleaft.
OZCOL_SLICES = 3 * NSLICES
OZLEAFT_SLICES = 6 * NSLICES


def ozcol_radix(n1: int) -> int:
    """Digit radix of the column pass: 4, as in the JAX package."""
    return 4


def oz_window(n1: int, plan2, n2: int) -> bool:
    """Whether the split level n1 x n2 over ``plan2`` runs the oz kernels
    (when the planner's engine is "df64-oz"): the JAX planner's gate (the
    inner plan a leaf, 128 <= n1 <= 2048, n2 = A * 128 with 8 <= A <= 64)."""
    return (
        plan2[0] == "leaf"
        and n1 % LANES == 0
        and LANES <= n1 <= 2048
        and n2 % LANES == 0
        and 8 <= n2 // LANES <= 64
    )


def _dft_slices_host(m: int):
    """Ozaki slice sets (fr, fi, fs) of the m x m DFT matrix."""
    k = np.arange(m, dtype=np.int64)
    ang = -2.0 * np.pi * ((np.outer(k, k) % m).astype(np.float64)) / m
    fr = np.cos(ang)
    fi = np.sin(ang)
    return (
        oz_slice_matrix_host(fr),
        oz_slice_matrix_host(fi),
        oz_slice_matrix_host(fr + fi, bound=2.0),
    )


@functools.lru_cache(maxsize=16)
def ozcol_tables_host(n1: int, n2: int):
    """Host tables of the column pass, flat in operand order: the F(n1/4)
    slice sets (15 integer-valued f32 (m, m) arrays), the dd DIF phase
    W_n1^(p*k_m) as an (m, 4) 4-tuple, and the dd split correction T1
    (n1, n2/t) and T2 (n1, t) 4-tuples. Exact f64 angles, split once."""
    r = ozcol_radix(n1)
    m = n1 // r
    fa = _dft_slices_host(m)
    km = np.arange(m, dtype=np.int64)[:, None]
    p = np.arange(r, dtype=np.int64)[None, :]
    ang = -2.0 * np.pi * ((km * p) % n1).astype(np.float64) / n1
    phase = split_hi_lo(np.cos(ang)) + split_hi_lo(np.sin(ang))
    n = n1 * n2
    t = min(OZ_COL_TILE, n2)
    k1 = np.arange(n1, dtype=np.float64)[:, None]
    j = np.arange(n2 // t, dtype=np.float64)[None, :]
    c = np.arange(t, dtype=np.float64)[None, :]
    ang1 = (-2.0 * np.pi / n) * (k1 * (j * t))
    ang2 = (-2.0 * np.pi / n) * (k1 * c)
    t1 = split_hi_lo(np.cos(ang1)) + split_hi_lo(np.sin(ang1))
    t2 = split_hi_lo(np.cos(ang2)) + split_hi_lo(np.sin(ang2))
    return (
        fa[0] + fa[1] + fa[2]
        + tuple(np.float32(a) for a in phase)
        + tuple(np.float32(a) for a in t1)
        + tuple(np.float32(a) for a in t2)
    )


@functools.lru_cache(maxsize=16)
def ozleaft_tables_host(n2: int):
    """Host tables of the row pass, flat in operand order: the F(A) and
    F(128) slice sets (30 integer-valued f32 arrays) and the inner
    correction W_n2^(k_A*i_M) as an (A, 128) dd 4-tuple."""
    a = n2 // LANES
    fa = _dft_slices_host(a)
    fm = _dft_slices_host(LANES)
    k1 = np.arange(a, dtype=np.float64)[:, None]
    i2 = np.arange(LANES, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * (k1 * i2) / float(n2)
    corr = split_hi_lo(np.cos(ang)) + split_hi_lo(np.sin(ang))
    return (
        fa[0] + fa[1] + fa[2] + fm[0] + fm[1] + fm[2]
        + tuple(np.float32(c) for c in corr)
    )


def slice_count(key: str) -> int:
    """How many leading arrays of the oz table set under the JAX planner's
    ``key`` (``ozcol{n1}x{n2}`` or ``ozleafT{n2}``) are slice arrays."""
    return OZCOL_SLICES if key.startswith("ozcol") else OZLEAFT_SLICES


# ------------------------------------------------------- card-layout tables
#: The kernels' slice tiles: 16 depths of ``rows`` rows of each of the 15
#: slice arrays, in wgmma's K-major layout without swizzle (csrc/oz.cuh
#: tile_word): cores of 8 rows x 8 depths, the two depth halves 64
#: half-words apart, groups of 8 rows 128 apart.
TILE_DEPTH = 16
OZCOL_TILE_ROWS = 32      # rows k_m of ozcol's block tile
OZLEAFT_PASS_ROWS = 32    # rows k_M of F(128) in an ozleaft stage-2 pass


def _tile_positions(rows: int):
    """(rows, 16) half-word positions of a tile slice array."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(TILE_DEPTH)[None, :]
    j = k >> 1
    word = (r >> 3) * 64 + (j >> 2) * 32 + (r & 7) * 4 + (j & 3)
    return (2 * word + (k & 1)).reshape(-1)


def _tiles(slices, rows: int, depth: int):
    """The tiles of a slice set (15 arrays (R, D)) for row blocks of
    ``rows`` and depth chunks of ``depth`` (16, or 8: the upper half zero),
    as one flat bf16 tensor: tile (row block, chunk) after tile, each 15
    slice arrays of rows x 16 half-words."""
    f = torch.stack([t.to(torch.bfloat16) for t in slices])
    sets, big_r, big_d = f.shape
    nb, nc = big_r // rows, big_d // depth
    v = f.reshape(sets, nb, rows, nc, depth).permute(1, 3, 0, 2, 4)
    if depth < TILE_DEPTH:
        v = torch.nn.functional.pad(v, (0, TILE_DEPTH - depth))
    out = torch.empty((nb, nc, sets, rows * TILE_DEPTH), dtype=torch.bfloat16,
                      device=f.device)
    out[..., _tile_positions(rows).to(f.device)] = v.reshape(nb, nc, sets, -1)
    return out.reshape(-1)


def ozcol_card(tabs, n1: int):
    """The F(n1/4) slice tiles of ``ozcol``'s blocks, one contiguous 15 KB
    tile for each (k_m tile of 32 rows, 16-deep chunk): what csrc/ozcol.cu
    copies into shared memory with one bulk copy. Built from ``tabs``
    (``ozcol_tables_host``'s arrays on the device): 15 m^2 bf16."""
    return _tiles(tabs[:OZCOL_SLICES], OZCOL_TILE_ROWS, TILE_DEPTH)


def ozleaft_card(tabs, a: int):
    """``ozleaft``'s slice tiles, stage 1's then stage 2's: F(A) in tiles of
    min(A, 32) rows k_A by min(A, 16) depths (zero-padded to 16), and
    F(128) in tiles of 32 rows k_M by 16 depths."""
    kb = min(a, 32)
    return torch.cat([_tiles(tabs[:3 * NSLICES], kb, min(a, TILE_DEPTH)),
                      _tiles(tabs[3 * NSLICES:OZLEAFT_SLICES], OZLEAFT_PASS_ROWS,
                             TILE_DEPTH)])


#: A card table for each table set the kernels meet (a planner's), built on
#: first use and dropped with the set: {id(first slice array): (weak
#: reference to it, card)}.
_CARDS = {}


def _card(tabs, build):
    key = id(tabs[0])
    hit = _CARDS.get(key)
    if hit is not None and hit[0]() is tabs[0]:
        return hit[1]
    card = build()
    _CARDS[key] = (weakref.ref(tabs[0]), card)
    weakref.finalize(tabs[0], _CARDS.pop, key, None)
    return card


def _exact_dot(f, x):
    """f @ x of integer slices in float64 (exact), back to f32 (exact:
    every sum here is an integer below 2^24)."""
    return torch.matmul(f.double(), x.double()).float()


def _exact_dot_nt(f, x):
    """x @ f^T: the contraction over x's last axis."""
    return torch.matmul(x.double(), f.double().transpose(0, 1)).float()


def _check_tabs(name, tabs, shapes, n_slices, device):
    if len(tabs) != len(shapes):
        raise ValueError(f"{name}: expected {len(shapes)} tables, got {len(tabs)}")
    for i, (x, shape) in enumerate(zip(tabs, shapes)):
        want = torch.bfloat16 if i < n_slices else torch.float32
        if not isinstance(x, torch.Tensor) or x.dtype != want:
            raise TypeError(f"{name}: table {i} must be a {want} tensor")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: table {i} must be {shape}, got "
                             f"{tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name}: all tensors must be on one device")


def _check_planes(name, planes):
    """Four contiguous f32 tensors of one shape on one device."""
    check_dd_planes(name, planes)
    if not all(x.is_contiguous() for x in planes):
        raise ValueError(f"{name}: the planes must be contiguous")


def _check_ozcol(planes, tabs, n1: int):
    """Validate ``ozcol``'s arguments; return (batch shape, flat batch,
    n2)."""
    _check_planes("ozcol", planes)
    first = planes[0]
    if first.dim() < 2 or first.shape[-2] != n1:
        raise ValueError(
            f"ozcol: expected (..., {n1}, n2) planes, got {tuple(first.shape)}")
    n2 = int(first.shape[-1])
    if (n1 & (n1 - 1) or n2 & (n2 - 1)
            or not oz_window(n1, ("leaf",), n2)):
        raise ValueError(f"ozcol: unsupported shape n1={n1}, n2={n2}")
    m, t = n1 // ozcol_radix(n1), min(OZ_COL_TILE, n2)
    shapes = ([(m, m)] * OZCOL_SLICES + [(m, 4)] * 4 + [(n1, n2 // t)] * 4
              + [(n1, t)] * 4)
    _check_tabs("ozcol", tabs, shapes, OZCOL_SLICES, first.device)
    batch = tuple(first.shape[:-2])
    return batch, int(np.prod(batch)) if batch else 1, n2


def _check_ozleaft(planes, tabs, n1: int):
    """Validate ``ozleaft``'s arguments; return (batch shape, flat batch,
    A)."""
    _check_planes("ozleaft", planes)
    first = planes[0]
    if first.dim() < 3 or first.shape[-2] != n1 or first.shape[-1] != LANES:
        raise ValueError(
            f"ozleaft: expected (..., A, {n1}, {LANES}) planes, got "
            f"{tuple(first.shape)}")
    a = int(first.shape[-3])
    if (a & (a - 1) or n1 & (n1 - 1)
            or not oz_window(n1, ("leaf",), a * LANES)):
        raise ValueError(f"ozleaft: unsupported shape A={a}, n1={n1}")
    shapes = ([(a, a)] * (3 * NSLICES) + [(LANES, LANES)] * (3 * NSLICES)
              + [(a, LANES)] * 4)
    _check_tabs("ozleaft", tabs, shapes, OZLEAFT_SLICES, first.device)
    batch = tuple(first.shape[:-3])
    return batch, int(np.prod(batch)) if batch else 1, a


def _launch(name, entry, tensors, *sizes):
    """Call the C entry ``entry`` with a host array of the tensors' pointers
    on the current stream of their device; raise on a CUDA error."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: the tables must be contiguous")
    ptrs = (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = call(entry, (ptrs, *sizes, stream), kernel=name)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")


# ---------------------------------------------------------------- ozcol
def ozcol_plain(rh, rl, ih, il, tabs, n1: int):
    """Plain-torch column pass: same arguments and result as ``ozcol``
    (the JAX kernel ``_ozcol_kernel`` over whole tensors)."""
    planes = (rh, rl, ih, il)
    batch, _, n2 = _check_ozcol(planes, tabs, n1)
    nf = NSLICES
    fr, fi, fs = tabs[:nf], tabs[nf:2 * nf], tabs[2 * nf:3 * nf]
    phase = tabs[3 * nf:3 * nf + 4]
    t1 = tabs[3 * nf + 4:3 * nf + 8]
    t2 = tabs[3 * nf + 8:3 * nf + 12]
    r = ozcol_radix(n1)
    m = n1 // r
    x3 = [a.reshape(batch + (m, r, n2)) for a in planes]
    us = []
    for p in range(r):
        tdd = oz_cmatmul_dd(
            fr, fi, fs,
            (x3[0][..., p, :], x3[1][..., p, :]),
            (x3[2][..., p, :], x3[3][..., p, :]),
            _exact_dot, axis=-2, nslices=nf,
        )
        us.append(dd_cmul(*tdd, *(a[:, p:p + 1] for a in phase)))
    ys = _dft_regs_dd(us)
    # k1 = k_r * m + k_m
    b4 = [torch.cat([y[c] for y in ys], dim=-2) for c in range(4)]
    t = min(OZ_COL_TILE, n2)
    view = batch + (n1, n2 // t, t)
    v = dd_cmul(*(a.reshape(view) for a in b4), *(a[:, :, None] for a in t1))
    v = dd_cmul(*v, *(a[:, None, :] for a in t2))
    rel = batch + (n1, n2 // LANES, LANES)
    return tuple(a.reshape(rel).transpose(-3, -2).contiguous() for a in v)


def ozcol(rh, rl, ih, il, tabs, n1: int):
    """dd column DFT of size n1 = 128..2048 along axis -2 of four
    (..., n1, n2) f32 planes (n2 = 1024..8192), fused with the dd split
    correction, by error-free bf16-slice contractions. ``tabs``: the flat
    tuple of ``ozcol_tables_host(n1, n2)`` on the planes' device, the 15
    slice arrays as bfloat16. Returns four new (..., n2/128, n1, 128)
    planes: element [k1, i2] at [i2 // 128, k1, i2 % 128].

    On CUDA it launches ``csrc/ozcol.cu`` on the current stream (a CPU
    tensor runs ``ozcol_plain``); shapes outside the window raise. Inputs
    are read, never written.
    The kernel copies its F(n1/4) tiles from ``ozcol_card(tabs, n1)``,
    built on the first call with a table set and kept while the set lives.

    Replaces ``phastft_tpu/ops/pallas_ozdd.py`` ``ozcol_pallas``. The
    bf16 tensor-core products bound it (45 slice products of depth n1/4
    per element); a block computes a 32 (k_m) x 64 (column) tile of every
    digit from shared-memory tiles of 16-deep chunks (each F(n1/4) slice
    serves 64 columns), and writes each digit's phased contraction into
    its own output rows, where the radix-4 combine reads it back: no
    scratch beyond the output."""
    planes = (rh, rl, ih, il)
    batch, b, n2 = _check_ozcol(planes, tabs, n1)
    if rh.device.type == "cpu":
        return ozcol_plain(rh, rl, ih, il, tabs, n1)
    # the kernel reads the planes with 16-byte bulk copies and float4 loads
    planes = tuple(p if p.data_ptr() % 16 == 0 else p.clone() for p in planes)
    shape = batch + (n2 // LANES, n1, LANES)
    out = tuple(torch.empty(shape, dtype=torch.float32, device=rh.device)
                for _ in range(4))
    card = _card(tabs, lambda: ozcol_card(tabs, n1))
    _launch("ozcol", "phastft_ozcol", (*planes, *tabs, *out, card), b, n1,
            n2)
    return out


# ---------------------------------------------------------------- ozleaft
def ozleaft_plain(crh, crl, cih, cil, tabs, n1: int):
    """Plain-torch row pass: same arguments and result as ``ozleaft``
    (the JAX kernel ``_ozleaft_kernel`` over whole tensors)."""
    planes = (crh, crl, cih, cil)
    batch, _, a = _check_ozleaft(planes, tabs, n1)
    nf = NSLICES
    fa = (tabs[:nf], tabs[nf:2 * nf], tabs[2 * nf:3 * nf])
    fm = (tabs[3 * nf:4 * nf], tabs[4 * nf:5 * nf], tabs[5 * nf:6 * nf])
    corr = tabs[6 * nf:6 * nf + 4]
    # stage 1: F(A) over i_A for every column (k1, i_M), then the correction
    x = [p.reshape(batch + (a, n1 * LANES)) for p in planes]
    tdd = oz_cmatmul_dd(*fa, (x[0], x[1]), (x[2], x[3]), _exact_dot,
                        axis=-2, nslices=nf)
    sh3 = batch + (a, n1, LANES)
    v = dd_cmul(*(t.reshape(sh3) for t in tdd), *(c[:, None, :] for c in corr))
    # stage 2: F(128) over i_M for every row (k_A, k1), one sigma per row
    w = oz_cmatmul_dd(*fm, (v[0], v[1]), (v[2], v[3]), _exact_dot_nt,
                      axis=-1, nslices=nf)
    d = len(batch)
    flat = batch + (n1 * a * LANES,)
    # (k_A, k1, k_M) -> (k_M, k_A, k1): the four-step transpose
    return tuple(y.permute(*range(d), d + 2, d, d + 1).reshape(flat) for y in w)


def ozleaft(crh, crl, cih, cil, tabs, n1: int):
    """dd DFTs of length n2 = A * 128 (8 <= A <= 64) over ``ozcol``'s
    (..., A, n1, 128) relayout (n1 = 128..2048), by error-free bf16-slice
    contractions, written in the final natural order: four new (..., n)
    planes, n = n1 * n2. ``tabs``: the flat tuple of
    ``ozleaft_tables_host(n2)`` on the planes' device, the 30 slice arrays
    as bfloat16.

    On CUDA it launches ``csrc/ozleaft.cu`` on the current stream (a CPU
    tensor runs ``ozleaft_plain``); shapes outside the window raise.
    Inputs are read, never written. The kernel copies its F(A) and F(128)
    tiles from ``ozleaft_card(tabs, A)``, built on the first call with a table set and
    kept while the set lives.

    Replaces ``phastft_tpu/ops/pallas_ozdd.py`` ``ozleaft_pallas``. The
    bf16 tensor-core products bound it (45 slice products of depth A and
    45 of depth 128 per element); a block holds 64 / A whole rows in
    shared memory, a cluster of A / 8 blocks 8 consecutive rows, and each
    F(128) slice tile serves the block's 64 rows (k1, k_A); the cluster
    stores runs of 8 consecutive floats (32-byte sectors)."""
    planes = (crh, crl, cih, cil)
    batch, b, a = _check_ozleaft(planes, tabs, n1)
    if crh.device.type == "cpu":
        return ozleaft_plain(crh, crl, cih, cil, tabs, n1)
    shape = batch + (n1 * a * LANES,)
    out = tuple(torch.empty(shape, dtype=torch.float32, device=crh.device)
                for _ in range(4))
    card = _card(tabs, lambda: ozleaft_card(tabs, a))
    _launch("ozleaft", "phastft_ozleaft", (*planes, *tabs, *out, card),
            b, a, n1)
    return out
