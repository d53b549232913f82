"""Plain PyTorch reference of the complex DFT, for judging the port.

X[k] = sum_j x[j] W_n^(jk), W_n = exp(-2 pi i / n), on planar (re, im)
tensors along the last axis; the inverse is (1/n) sum_k X[k] W_n^(-jk).
A forward's imaginary plane may be given as None, a real input: its
products with zero are left out, never its size made, and the result is
the one a plane of zeros gives.

It is a recursive four-step factorisation: n = n1 * n2 with n1 <= 256, a
DFT-matrix product over the n1 axis, the twiddle W_n^(k1 i2), the n2-point
transforms of the rows, and X[k1 + n1 k2] = Z[k1, k2]. Every level is a
matrix product and an elementwise product in the dtype asked for: float64
for the reference, float32 (TF32 off) or bfloat16 for the controls, which
put this reference in the port's place one precision lower. Every table
entry comes from an exact integer phase (j * k mod n) and a float64 angle,
rounded once to the dtype.

A signal too large to transform whole beside the port's outputs is taken
in blocks of k1 (``DFT.blocks``), each block over every row of the (n1, n2)
view; where the rows lie on several processes, ``reduce`` sums each
block's partial product over them, so every process gets the same block.

Imports neither jax, phastft_tpu nor phastft_tpu_torch, and takes nothing
the port made except the outputs it judges.
"""

from __future__ import annotations

import contextlib
import math

import torch

#: Largest factor transformed by one DFT-matrix product.
MAX_FACTOR_LOG = 8
#: Points of a block of work (per plane) in ``DFT.rows`` and ``DFT.blocks``.
BLOCK_POINTS = 1 << 26


def first_factor_log(log_n: int) -> int:
    """log2 of the first factor n1 of n = 2^log_n: log_n split into the
    fewest parts of at most MAX_FACTOR_LOG bits, the first the largest."""
    parts = max(1, -(-log_n // MAX_FACTOR_LOG))
    return -(-log_n // parts)


def log2_exact(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"the reference takes powers of two, got {n}")
    return n.bit_length() - 1


def _view(t, *shape, dtype=None):
    """``t`` reshaped (and cast to ``dtype``), None kept as None."""
    if t is None:
        return None
    t = t.reshape(*shape)
    return t if dtype is None else t.to(dtype)


def _forward_if_real(xi, inverse: bool) -> None:
    if xi is None and inverse:
        raise ValueError("a real input (xi None) takes the forward DFT only")


@contextlib.contextmanager
def full_float32():
    """float32 matrix products in float32 (TF32 off) inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class DFT:
    """The reference transform in ``dtype`` on ``device``; keeps its tables
    (DFT matrices and twiddles) for the life of the object."""

    def __init__(self, dtype: torch.dtype, device):
        self.dtype = dtype
        self.device = torch.device(device)
        self._tables = {}

    # -- tables ------------------------------------------------------------

    def _phase(self, rows, cols, n: int):
        """(cos, sin) of -2 pi (k j mod n) / n for k in ``rows`` and j in
        ``cols`` (int64 ranges), in self.dtype."""
        k = rows.to(self.device, torch.int64)[:, None]
        j = cols.to(self.device, torch.int64)[None, :]
        ang = ((k * j) % n).to(torch.float64) * (-2.0 * math.pi / n)
        return torch.cos(ang).to(self.dtype), torch.sin(ang).to(self.dtype)

    def _table(self, key, make):
        if key not in self._tables:
            self._tables[key] = make()
        return self._tables[key]

    def _matrix(self, n: int):
        ar = torch.arange(n)
        return self._table(("dft", n), lambda: self._phase(ar, ar, n))

    def _twiddle(self, n1: int, n2: int):
        return self._table(("tw", n1, n2), lambda: self._phase(
            torch.arange(n1), torch.arange(n2), n1 * n2))

    # -- transforms --------------------------------------------------------

    def _mm(self, fr, fi, xr, xi):
        """(fr + i fi) @ (xr + i xi); ``xi`` None: zero."""
        with full_float32():
            if xi is None:
                return fr @ xr, fi @ xr
            return fr @ xr - fi @ xi, fr @ xi + fi @ xr

    def _rows(self, xr, xi):
        """Forward DFT of each row of (R, n) planes in self.dtype."""
        r, n = xr.shape
        log_n = log2_exact(n)
        n1 = 1 << first_factor_log(log_n)
        if n1 == n:
            fr, fi = self._matrix(n)  # symmetric: x @ F is F applied to each row
            return self._mm_right(xr, xi, fr, fi)
        n2 = n // n1
        fr, fi = self._matrix(n1)
        ar, ai = self._mm(fr, fi, xr.view(r, n1, n2), _view(xi, r, n1, n2))
        tr, ti = self._twiddle(n1, n2)
        ar, ai = ar * tr - ai * ti, ar * ti + ai * tr
        zr, zi = self._rows(ar.view(r * n1, n2), ai.view(r * n1, n2))
        return (zr.view(r, n1, n2).transpose(1, 2).reshape(r, n),
                zi.view(r, n1, n2).transpose(1, 2).reshape(r, n))

    def _mm_right(self, xr, xi, fr, fi):
        with full_float32():
            if xi is None:
                return xr @ fr, xr @ fi
            return xr @ fr - xi @ fi, xr @ fi + xi @ fr

    def rows(self, xr, xi, inverse: bool = False):
        """The DFT (``inverse``: the inverse DFT, scaled by 1/n) of each row
        of (..., n) planes, in self.dtype, as new (..., n) planes; ``xi``
        None: a real input (forward only)."""
        _forward_if_real(xi, inverse)
        shape = xr.shape
        n = shape[-1]
        xr = xr.reshape(-1, n).to(self.dtype)
        xi = _view(xi, -1, n, dtype=self.dtype)
        if inverse:  # swap(IDFT(z)) = (1/n) DFT(swap(z))
            xr, xi = xi, xr
        step = max(1, BLOCK_POINTS // n)
        outs_r, outs_i = [], []
        for r0 in range(0, xr.shape[0], step):
            yr, yi = self._rows(xr[r0:r0 + step], None if xi is None else xi[r0:r0 + step])
            outs_r.append(yr)
            outs_i.append(yi)
        yr, yi = torch.cat(outs_r), torch.cat(outs_i)
        if inverse:
            yr, yi = yi / n, yr / n
        return yr.reshape(shape), yi.reshape(shape)

    def blocks(self, xr, xi, n: int, first_row: int = 0, reduce=None,
               inverse: bool = False):
        """The n-point DFT (``inverse``: inverse DFT / n) of one signal, by
        blocks of k1. This process holds rows [first_row, first_row + R) of
        its (n1, n2) view, x[i1 * n2 + i2] (``xr``/``xi`` flat, R * n2
        points); ``reduce`` sums a tensor in place over the processes that
        hold the other rows (None: this one holds them all). Yields
        (k1_lo, k1_hi, zr, zi), Z[k1 - k1_lo, k2] = X[k1 + n1 * k2] for
        every k2, in self.dtype, the same on every process. ``xi`` None: a
        real input (forward only)."""
        _forward_if_real(xi, inverse)
        n1 = 1 << first_factor_log(log2_exact(n))
        n2 = n // n1
        rows = xr.numel() // n2
        if rows * n2 != xr.numel() or not 0 <= first_row <= n1 - rows:
            raise ValueError(f"{xr.numel()} points are not whole rows of ({n1}, {n2})")
        if inverse:
            xr, xi = xi, xr
        xr = xr.reshape(rows, n2).to(self.dtype)
        xi = _view(xi, rows, n2, dtype=self.dtype)
        width = max(1, min(n1, BLOCK_POINTS // n2))
        i1 = torch.arange(first_row, first_row + rows)
        for lo in range(0, n1, width):
            hi = min(n1, lo + width)
            fr, fi = self._phase(torch.arange(lo, hi), i1, n1)
            ar, ai = self._mm(fr, fi, xr, xi)
            if reduce is not None:
                reduce(ar)
                reduce(ai)
            tr, ti = self._phase(torch.arange(lo, hi), torch.arange(n2), n)
            ar, ai = ar * tr - ai * ti, ar * ti + ai * tr
            del tr, ti
            zr, zi = self._rows(ar, ai)
            del ar, ai
            if inverse:
                zr, zi = zi / n, zr / n
            yield lo, hi, zr, zi

    def signal(self, xr, xi, n: int, first_row: int = 0, reduce=None,
               inverse: bool = False, out_dtype=None, real_part: bool = False):
        """``blocks`` assembled into this process's contiguous share of the
        output, bins [first_row * n2, (first_row + R) * n2) of X, as planes
        of ``out_dtype`` (default self.dtype), (re, im) or with
        ``real_part`` (re,) alone, the imaginary plane never made: how a
        control puts the reference in the port's place."""
        n1 = 1 << first_factor_log(log2_exact(n))
        n2 = n // n1
        count = xr.numel()
        k2_lo = first_row * n2 // n1
        out_dtype = out_dtype or self.dtype
        ys = tuple(torch.empty(count, dtype=out_dtype, device=xr.device)
                   for _ in range(1 if real_part else 2))
        views = [y.view(count // n1, n1) for y in ys]
        for lo, hi, *zs in self.blocks(xr, xi, n, first_row, reduce, inverse):
            for v, z in zip(views, zs):
                v[:, lo:hi] = z[:, k2_lo:k2_lo + count // n1].T
        return ys
