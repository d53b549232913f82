"""Error-free bf16-slice contractions (the Ozaki scheme) for the dd engine.

Counterpart of the JAX package's ``ops/ozaki.py``, with the same
functions, arguments and order of f32 operations. Each operand of a
complex dd contraction is cut into 8-bit fixed-point slices on
power-of-two grids shared along the contraction axis: every slice is an
integer |s| <= 128, so a product of two slices is an integer below 2^14,
and a sum of at most 512 such products (the depths here) stays below
2^24: exact in an f32 accumulator. The tiers of slice pairs (i + j <= 4)
are folded back into a dd result whose only error is the slice
truncation, ~1e-12 of the column's scale.

* The constant matrix (a DFT matrix) is sliced on the host in f64 against
  its global bound (``oz_slice_matrix_host``): integer-valued float32
  arrays (numpy has no bf16; the planner puts them on the device as
  ``torch.bfloat16``, which holds every integer |s| <= 256 exactly).
* The data operand is sliced against one power-of-two scale sigma per
  contraction column, read from the f32 exponent bits (``oz_sigma``).

These are plain functions on torch tensors: the body of the plain
versions of ``ops/ozdd.py``. ``dot`` stays a callable, so a caller can
run the slice products as exact matmuls. Like ``ops/df64.py`` they must
run eagerly: the TwoSum of the fold needs every f32 operation rounded on
its own. The CUDA kernels repeat the slicing and the fold
(``csrc/oz.cuh``) and take the slice products from the tensor cores.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "NSLICES",
    "MAXTIER",
    "oz_slice_matrix_host",
    "oz_sigma",
    "oz_slice_data",
    "oz_slice_complex",
    "oz_contract_sliced",
    "oz_cmatmul_dd",
]

#: Slices per operand: 5 x 8 bits, ~40 significant bits per slice set.
NSLICES = 5

#: Highest slice-pair tier kept (i + j <= MAXTIER): 15 of the 25 pairs.
MAXTIER = 4


def oz_slice_matrix_host(m, nslices: int = NSLICES, bound: float = 1.0):
    """Slice a constant matrix (|entries| <= bound, a power of two) into
    ``nslices`` integer-valued float32 arrays on fixed grids:

        m = bound * sum_j s_j * 2^-(7 + 8j),  |s_j| <= 128 integers.

    Done in f64, so the slicing is exact; the residual past the last slice
    is < bound * 2^-(8*nslices + 6)."""
    out = []
    r = np.asarray(m, np.float64) / bound
    for j in range(nslices):
        k = 7 + 8 * j
        s = np.rint(r * (1 << k))
        r = r - s * (2.0 ** -k)
        out.append(s.astype(np.float32))
    return tuple(out)


def oz_sigma(maxabs: torch.Tensor):
    """(sigma, inv_sigma): exact powers of two with sigma > maxabs >= 0 and
    sigma * inv_sigma == 1, from the f32 exponent bits (zero maps to a tiny
    sigma whose slices are all zero)."""
    bits = maxabs.to(torch.float32).contiguous().view(torch.int32)
    e = torch.clamp((bits >> 23) & 0xFF, 1, 252) + 1
    sigma = (e << 23).view(torch.float32)
    inv = ((254 - e) << 23).view(torch.float32)
    return sigma, inv


def oz_slice_data(vh, vl, inv, nslices: int = NSLICES):
    """Slice a dd value (vh, vl) pre-scaled by the exact power of two
    ``inv`` (|vh * inv| <= 1) into integer-valued bf16 slices on grids
    2^-(7+8j). Every step is exact f32 arithmetic; the low component
    folds in once its grid is reached."""
    u = vh * inv
    out = []
    r = u
    for j in range(nslices):
        k = float(1 << (7 + 8 * j))
        s = torch.round(r * k)
        out.append(s.to(torch.bfloat16))
        r = r - s * (1.0 / k)
        if j == 2:
            r = r + vl * inv
    return out


def _tier_dots(f_slices, x_slices, dot, maxtier: int, only=None):
    """T_s = sum_{i+j=s} dot(f_i, x_j) for s <= maxtier (or just s ==
    only), each dot exact in f32 and the adds exact on one grid."""
    tiers = []
    for s in range(maxtier + 1):
        if only is not None and s != only:
            continue
        acc = None
        for i in range(min(s, len(f_slices) - 1) + 1):
            j = s - i
            if j >= len(x_slices):
                continue
            d = dot(f_slices[i], x_slices[j])
            acc = d if acc is None else acc + d
        tiers.append(acc)
    return tiers


def oz_slice_complex(xr, xi, axis, nslices: int = NSLICES):
    """Slice the dd complex operand (xr, xi dd pairs) and its exact dd sum
    xr + xi (on the doubled grid) against one sigma per contraction column
    (the max of |re_hi| and |im_hi| along ``axis``). Returns (sr, si, ss,
    sigma)."""
    xrh, xrl = xr
    xih, xil = xi
    m = torch.maximum(
        torch.amax(torch.abs(xrh), dim=axis, keepdim=True),
        torch.amax(torch.abs(xih), dim=axis, keepdim=True),
    )
    sigma, inv = oz_sigma(m)
    sr = oz_slice_data(xrh, xrl, inv, nslices)
    si = oz_slice_data(xih, xil, inv, nslices)
    sh = xrh + xih
    b = sh - xrh
    sl = ((xrh - (sh - b)) + (xih - b)) + (xrl + xil)
    ss = oz_slice_data(sh, sl, inv * 0.5, nslices)
    return sr, si, ss, sigma


def oz_contract_sliced(fr_slices, fi_slices, fs_slices, sr, si, ss,
                       sigma, dot, maxtier: int = MAXTIER, sigma_map=None):
    """Contraction on pre-sliced operands (``oz_slice_complex``): the
    Karatsuba products re = P1 - P2, im = P3 - P1 - P2 per tier, folded
    as they come (tiers 0 and 1 by TwoSum, tiers >= 2 summed in f32 into
    the low word), then renormalised. Returns (re_hi, re_lo, im_hi,
    im_lo). ``sigma_map`` re-aligns sigma to the dot output's axes."""
    if sigma_map is not None:
        sigma = sigma_map(sigma)
    scale = sigma * float(2.0 ** -14)
    reh = rel = imh = iml = None
    re_rest = im_rest = None
    for s in range(maxtier + 1):
        a = _tier_dots(fr_slices, sr, dot, s, only=s)[0]
        b2 = _tier_dots(fi_slices, si, dot, s, only=s)[0]
        c = _tier_dots(fs_slices, ss, dot, s, only=s)[0]
        k = scale * float(2.0 ** (-8 * s))
        re_v = (a - b2) * k
        im_v = (4.0 * c - a - b2) * k
        if s == 0:
            reh, imh = re_v, im_v
            rel = torch.zeros_like(re_v)
            iml = torch.zeros_like(im_v)
        elif s == 1:
            t = reh + re_v
            b = t - reh
            rel = (reh - (t - b)) + (re_v - b)
            reh = t
            t = imh + im_v
            b = t - imh
            iml = (imh - (t - b)) + (im_v - b)
            imh = t
        else:
            re_rest = re_v if re_rest is None else re_rest + re_v
            im_rest = im_v if im_rest is None else im_rest + im_v
    if re_rest is not None:
        rel = rel + re_rest
        iml = iml + im_rest
    h2 = reh + rel
    rel = rel - (h2 - reh)
    reh = h2
    h2 = imh + iml
    iml = iml - (h2 - imh)
    imh = h2
    return reh, rel, imh, iml


def oz_cmatmul_dd(fr_slices, fi_slices, fs_slices, xr, xi, dot, axis,
                  nslices: int = NSLICES, maxtier: int = MAXTIER,
                  sigma_map=None):
    """Complex dd contraction (Fr + i*Fi) @ (xr + i*xi) by Karatsuba on
    sliced operands. ``fr_slices``/``fi_slices``/``fs_slices``: slice
    tuples of Fr, Fi and Fr + Fi (the last sliced with bound=2). ``xr``,
    ``xi``: dd pairs (hi, lo). ``dot(f, x)``: the f32 slice contraction,
    exact on integers. ``axis``: the contraction axis of x. Returns
    (re_hi, re_lo, im_hi, im_lo)."""
    sr, si, ss, sigma = oz_slice_complex(xr, xi, axis, nslices)
    return oz_contract_sliced(
        fr_slices, fi_slices, fs_slices, sr, si, ss, sigma, dot,
        maxtier, sigma_map,
    )
