"""Distributed four-step FFT: one length-n transform split over the ranks of
a ``torch.distributed`` process group, in f32 and in f64 (the native engine,
and the df64 and df64-oz engines).

Counterpart of the JAX package's ``parallel/fourstep_dist.py``, with the
same factorizations and layouts, so that its permuted layout D[k1, k2]
matches the JAX package's element for element. Layout algebra (d ranks,
n = n1 * n2, d | n1, d | n2):

  x split by rows of A[i1, i2] = x[i1*n2 + i2]     (rank r holds rows
                                                    [r*n1/d, (r+1)*n1/d))
  1. all_to_all row -> column shard: local (n1, n2/d)
  2+3. the column DFT over i1 and the twiddle W_n^(k1*i2) (i2 the global
       column) in one kernel
  4. all_to_all column -> row shard, (n1/d, n2)
  5. the row DFTs over i2
  6. natural order: all_to_all to (n1, n2/d) and the local transpose; with
     ``permuted_output`` the rank returns its rows of D[k1, k2] instead.

``permuted_input`` consumes that D layout and returns natural order: the
row DFTs over k2, the twiddle W_n^(k1*m2), an all_to_all, the bare column
DFT over k1 and an all_to_all back.

The branches, and the JAX lines each stands for (``_build_distributed``
``:139-342``, the engine dispatch ``:596-623``):

* f32 (``local_step`` ``:236-330``, ``local_step_permuted_in``
  ``:153-234``): the column pass on ``colfft`` with ``n_total`` and
  ``col_base`` (``_pallas_col_chunk`` ``:113``) or ``colfft_nocorr``
  (``:199-201``), the rows on ``ops/fourstep.fft_rows`` (the planner's leaf
  kernels), the transposes on ``transpose2``.
* f64 on the native engine (an engine-less planner, ``"native"``, and a
  df64 planner with a permuted flag, as ``:596-605`` sends it): the column
  pass on ``col64`` with the tables of the block's global twiddle
  (``ops/native.col64_shard_tables``; the JAX package's XLA
  ``stockham_axis2`` + ``_local_correction_cols``, ``:266-274``) or
  ``col64_nocorr`` (``:203``), the rows on ``fft_rows_native``, the
  transposes on ``transpose2_64``, the 1/n scale in f64. Each intermediate
  is dropped as soon as the next pass has read it; the caller's input stays
  alive, as in the f32 branch.
* column factors n1 > 2048, f32 and native f64 (the JAX package's XLA
  column pass there, ``:103-110`` and ``:266-274``, where its column kernel
  declines the shape): ``_long_columns``, n1 = P * Q as two column passes
  with the twiddles folded into their tables and two transposes (nested
  again past 2048^2). It won the H100 timing against the other route, the
  block transposed to (c, n1), the row plan of length n1, the twiddle in
  torch and the transpose back (``PERF.md``).
* df64 and df64-oz, natural order only (``_build_distributed_dd``
  ``:412-550``): n1 = max(``DD_DIST_MIN_COL``, d) (``_factor_dd`` ``:345``),
  the input split into hi/lo f32 planes (``_dd_split4`` ``:386``), the
  column pass on ``ddcol`` with dd tables of the block's own width
  (``ops/dd.dd_shard_tables``; a block under 128 columns, which ``ddcol``
  does not take: ``ddcol_nocorr`` and the dd products of the same tables in
  torch, where the JAX package synthesises its ``_dd_corr_trig``), the rows
  on ``fft_rows_dd`` of a cached row planner (``_dd_dist_state`` ``:363``:
  on a "df64-oz" planner its oz tables arm ``ozcol`` + ``ozleaft`` where the
  JAX package's do), ``transpose2`` per hi/lo pair, the join and the 1/n
  scale in f64.

The permuted-input twiddle W_n^(k1*m2), and in f32 the first long-column
pass's where ``colfft``'s own twiddle cannot express it, are plain torch,
as the JAX package computes them in XLA (``:181-191``): exact integer
phases and f64 angles, in slabs of rows (an f64 angle array of the whole
block is 8 GiB at 2^30).

A collective is ``all_to_all_single`` on a contiguous copy permuted so that
the block for rank j is the j-th; every rank makes the same calls in the
same order. The JAX package splits the column block into chunks (4 from
8 MiB) so that XLA overlaps one chunk's all_to_all with the next chunk's
compute; the layout is the same for any chunk count. The port runs one
chunk: its collectives do not overlap its kernels yet, and chunks without
overlap only add launches and copies (ROADMAP.md Queue 1 item 19).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..errors import NonPowerOfTwoError, ensure_power_of_two, not_ported
from ..fft import _as_tensor, _coerce_direction
from ..options import Options
from ..ops.colfft import MAX_N1, MIN_KERNEL_N2, colfft, colfft_nocorr
from ..ops.dd import dd_shard_tables, ddcol, ddcol_nocorr
from ..ops.df64 import dd_cmul, split_f64
from ..ops.fourstep import (
    _transpose4,
    plan_rows,
    rows_dd,
    rows_f32,
    rows_native,
)
from ..ops.native import (
    col64,
    col64_nocorr,
    col64_shard_tables,
    col64_tables,
    dif_twiddles,
)
from ..ops.stockham import LANES
from ..ops.transpose import transpose2, transpose2_64
from ..planner import Direction, PlannerDit64

__all__ = ["fft_distributed", "DD_DIST_MIN_COL"]

#: Smallest column factor of the dd factorization (the JAX package's): the
#: dd column pass stays shallow and the rows carry the log-n work.
DD_DIST_MIN_COL = 8

#: Points of one slab of the plain-torch twiddle.
_TWIDDLE_SLAB = 1 << 22


def _factor(n: int, d: int, leaf_limit: int) -> tuple[int, int]:
    """n = n1 * n2 with d | n1, d | n2, n2 at most the leaf limit and n1 as
    small as possible (the JAX package's ``_factor``)."""
    log_n = n.bit_length() - 1
    log_d = d.bit_length() - 1
    log_leaf = leaf_limit.bit_length() - 1
    log_n2 = min(log_leaf, log_n - log_d)
    log_n1 = log_n - log_n2
    if log_n1 < log_d or log_n2 < log_d:
        raise NonPowerOfTwoError(
            f"n=2^{log_n} too small to shard over {d} devices "
            f"(need n >= {d * d})"
        )
    return 1 << log_n1, 1 << log_n2


def _factor_dd(n: int, d: int) -> tuple[int, int]:
    """The dd factorization (the JAX package's ``_factor_dd``): n1 =
    max(DD_DIST_MIN_COL, d), n2 = n / n1, with d | n2 and n2 >= n1."""
    n1 = max(DD_DIST_MIN_COL, d)
    n2 = n // n1
    if n1 * n2 != n or n2 % d != 0 or n2 < n1:
        raise NonPowerOfTwoError(
            f"n=2^{n.bit_length() - 1} too small to dd-shard over {d} "
            f"devices (need n >= {2 * n1 * max(n1, d)})"
        )
    return n1, n2


def _all_to_all(blocks, group):
    """Block j of ``blocks`` (d, ...) to rank j; returns (d, ...) with
    block s from rank s."""
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=group)
    return out


def _row_to_col(x, n1: int, cols: int, d: int, group):
    """(n1/d, cols) row shard -> (n1, cols/d) column shard: row
    s*n1/d + r is rank s's row r, the columns this rank's block."""
    blocks = x.reshape(n1 // d, d, cols // d).transpose(0, 1).contiguous()
    return _all_to_all(blocks, group).reshape(n1, cols // d)


def _col_to_row(x, n1: int, d: int, group):
    """(n1, c) column shard -> (d, n1/d, c): block s is this rank's rows
    of rank s's c columns."""
    return _all_to_all(x.reshape(d, n1 // d, x.shape[-1]), group)


def _twiddle_(re, im, n: int, rows, cols) -> None:
    """(R, C) planes times W_n^(rows[r] * cols[c]), in place, in slabs of
    rows (``rows``, ``cols``: int64 exponents on the planes' device): the
    phase as an exact integer mod n, the angle in f64, the product in the
    planes' precision (complex64 for f32, as the JAX package casts its cos
    and sin to f32)."""
    cdt = torch.complex128 if re.dtype == torch.float64 else torch.complex64
    step = max(1, _TWIDDLE_SLAB // len(cols))
    for r0 in range(0, len(rows), step):
        r1 = min(len(rows), r0 + step)
        ang = ((rows[r0:r1, None] * cols[None, :]) % n).double() * (-2.0 * np.pi / n)
        w = torch.polar(torch.ones_like(ang), ang).to(cdt)
        del ang
        z = torch.complex(re[r0:r1], im[r0:r1]) * w
        re[r0:r1] = z.real
        im[r0:r1] = z.imag


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What one rank runs: the sizes, the group, and the dtype's passes."""

    n: int
    n1: int
    n2: int
    d: int
    rank: int
    group: object
    f64: bool
    #: [re, im] -> the row DFTs of length n2 (the list is emptied)
    rows: Callable
    transpose: Callable


def _row_pass(planner, plan, leaf_kernel) -> Callable:
    """The row DFTs of ``plan`` on the planner's kernels, as a function of
    a list [re, im] that it empties: ``rows_native`` on an f64 planner's
    native tables, ``rows_f32`` on an f32 planner's; each drops the planes
    once its first kernel has read them."""
    if planner.dtype == np.float64:
        corrs = planner.native_tables_for(plan)
        return lambda pair: rows_native(pair, plan, corrs)
    corrs = planner.tables_for(plan, leaf_kernel)
    return lambda pair: rows_f32(pair, plan, corrs, leaf_kernel)


def _columns(pair, p: _Plan, n: int, n1: int, col_base: int, bare: bool):
    """The column pass of a block (..., n1, c) handed over in the list
    ``pair``, whose columns [col_base, col_base + c) lie in a transform of
    n points split n1 x n / n1: the DFT over n1 and, unless ``bare``, the
    twiddle W_n^(k1*(col_base + j)). n1 = 1 is the block itself (its only
    twiddle is W^0); past the column kernels' 2048, ``_long_columns``."""
    if n1 > MAX_N1:
        return _long_columns(pair, p, n, n1, col_base, bare)
    re, im = pair
    pair.clear()
    if n1 == 1:
        return re, im
    if p.f64:
        steps = dif_twiddles(n1, re.device)
        if bare:
            return col64_nocorr(re, im, n1, steps)
        tabs = col64_shard_tables(n, n1, int(re.shape[-1]), col_base, re.device)
        return col64(re, im, tabs, n1, steps)
    if bare:
        return colfft_nocorr(re, im, n1)
    return colfft(re, im, None, n1, n_total=n, col_base=col_base)


def _level_exponents(n: int, n1: int, pp: int, c: int, col_base: int, bare: bool):
    """The twiddle exponents of the first pass of ``_long_columns``, one a
    column (q, j) of its (pp, n1/pp * c) view: q*(n/n1), plus
    col_base + j unless ``bare``; output kp takes W_n^(kp * exponent)."""
    q = np.arange(n1 // pp, dtype=np.int64)[:, None] * (n // n1)
    j = np.zeros(c, np.int64) if bare else col_base + np.arange(c, dtype=np.int64)
    return (q + j[None, :]).reshape(-1)


@functools.lru_cache(maxsize=16)
def _level_tables(n: int, n1: int, pp: int, c: int, col_base: int, bare: bool, device):
    """``col64``'s tables of ``_level_exponents``."""
    return col64_tables(n, pp, _level_exponents(n, n1, pp, c, col_base, bare), device)


def _long_split(n1: int) -> tuple[int, int]:
    """(P, Q) of a column factor n1 past 2048: P = 2^(log2 n1 // 2), at most
    2048 (the column kernels' largest factor), and Q = n1 / P >= P, which
    ``_long_columns`` splits again past 2048."""
    pp = 1 << min((n1.bit_length() - 1) // 2, MAX_N1.bit_length() - 1)
    return pp, n1 // pp


def _long_columns(pair, p: _Plan, n: int, n1: int, col_base: int, bare: bool):
    """A column factor past the column kernels' 2048 (the JAX package's XLA
    column pass there), as two column passes and two transposes on the
    (..., n1, c) block handed over in ``pair``. With n1 = P * Q
    (``_long_split``), i1 = Q p + q and k1 = kp + P kq:

      1. the DFT over p on the (P, Q c) view, times W_n1^(kp q) and the
         block's twiddle's share W_n^(kp (col_base + j)): ``col64`` on
         ``_level_tables``; in f32, ``colfft`` where that is its own shard
         twiddle (a block of every column, c = n / n1, not bare), else
         ``colfft_nocorr`` and the twiddle in plain torch (``_twiddle_``);
      2. the DFT over q of the (Q, c) blocks, a batch of P, times the rest
         W_{n/P}^(kq (col_base + j)): this function once more, on a
         transform of n / P points;
      3. (P, Q, c) -> (Q, P, c), rows k1 in natural order: two transposes.

    Each intermediate is dropped once the next pass has read it."""
    batch = tuple(pair[0].shape[:-2])
    c = int(pair[0].shape[-1])
    dev = pair[0].device
    pp, qq = _long_split(n1)
    view = batch + (pp, qq * c)
    re, im = (x.reshape(view) for x in pair)
    pair.clear()
    if p.f64:
        y = [*col64(re, im, _level_tables(n, n1, pp, c, col_base, bare, dev), pp,
                    dif_twiddles(pp, dev))]
    elif not bare and c == n // n1:
        y = [*colfft(re, im, None, pp, n_total=n, col_base=0)]
    else:
        y = [*colfft_nocorr(re, im, pp)]
        kp = torch.arange(pp, dtype=torch.int64, device=dev)
        exps = _level_exponents(n, n1, pp, c, col_base, bare)
        _twiddle_(y[0].view(-1, qq * c), y[1].view(-1, qq * c), n,
                  kp.repeat(y[0].numel() // (pp * qq * c)), torch.from_numpy(exps).to(dev))
    del re, im
    y = [x.view(batch + (pp, qq, c)) for x in y]
    z = [*_columns(y, p, n // pp, qq, col_base, bare)]
    t = [*p.transpose(*(x.view(view) for x in z))]  # (..., Q c, P)
    z.clear()
    out = p.transpose(*(x.view(batch + (qq, c, pp)) for x in t))  # (..., Q, P, c)
    t.clear()
    return tuple(x.view(batch + (n1, c)) for x in out)


def _to_rows(pair, p: _Plan):
    """The column -> row all_to_all of the (n1, n2/d) pair handed over in
    ``pair``: this rank's (n1/d, n2) rows, global column s*n2/d + j."""
    out = []
    while pair:
        blocks = _col_to_row(pair.pop(0), p.n1, p.d, p.group)
        out.append(blocks.transpose(0, 1).reshape(p.n1 // p.d, p.n2))
    return out


def _natural(re_l, im_l, p: _Plan, permuted_output: bool):
    """Steps 1-6 on this rank's (n1/d, n2) rows; returns its flat shard."""
    cols = [_row_to_col(x, p.n1, p.n2, p.d, p.group) for x in (re_l, im_l)]
    t = list(_columns(cols, p, p.n, p.n1, p.rank * (p.n2 // p.d), False))
    d_re, d_im = p.rows(_to_rows(t, p))
    if permuted_output:
        return d_re.reshape(-1), d_im.reshape(-1)
    # D[k1, k2] -> (n1, n2/d) holding this rank's k2 block -> (n2/d, n1)
    o_re = _row_to_col(d_re, p.n1, p.n2, p.d, p.group)
    del d_re
    o_im = _row_to_col(d_im, p.n1, p.n2, p.d, p.group)
    del d_im
    o_re, o_im = p.transpose(o_re, o_im)
    return o_re.reshape(-1), o_im.reshape(-1)


def _permuted_in(re_l, im_l, p: _Plan):
    """The mirrored pipeline on this rank's rows of D[k1, k2]; returns its
    flat shard in natural order."""
    r_re, r_im = p.rows([re_l, im_l])
    rows = p.n1 // p.d
    dev = r_re.device
    _twiddle_(r_re, r_im, p.n,
              torch.arange(p.rank * rows, (p.rank + 1) * rows, dtype=torch.int64, device=dev),
              torch.arange(p.n2, dtype=torch.int64, device=dev))
    cols = [_row_to_col(r_re, p.n1, p.n2, p.d, p.group)]
    del r_re
    cols.append(_row_to_col(r_im, p.n1, p.n2, p.d, p.group))
    del r_im
    z = list(_columns(cols, p, p.n, p.n1, 0, True))
    # block s holds this rank's rows of columns [s*n2/d, (s+1)*n2/d)
    out = []
    while z:
        out.append(_col_to_row(z.pop(0), p.n1, p.d, p.group)
                   .transpose(0, 1).reshape(-1))
    return out


@functools.lru_cache(maxsize=16)
def _dd_row_planner(n2: int, leaf_limit: int, engine: str, device):
    """The row transforms' planner of the dd pipeline, as the JAX package's
    ``_dd_dist_state`` builds it: ``PlannerDit64(n2)`` on the leaf
    min(leaf_limit, n2) and the caller's engine, whose ``dd_state`` holds the
    dd (and, for "df64-oz", the oz) tables of ``plan_rows(n2)``."""
    opts = Options(leaf_fft_size=min(leaf_limit, n2), f64_engine=engine)
    return PlannerDit64(n2, options=opts, device=device)


def _dd_columns(quad, n: int, n1: int, col_base: int):
    """The dd column pass of this rank's (n1, c) quadruple: ``ddcol`` with
    the block's tables, or for c < 128 (``ddcol``'s floor) ``ddcol_nocorr``
    and the two dd products of the same tables."""
    cols = int(quad[0].shape[-1])
    t1, t2 = dd_shard_tables(n, n1, cols, col_base, quad[0].device)
    if cols >= LANES:
        return ddcol(*quad, t1, t2, n1)
    z = ddcol_nocorr(*quad, n1)
    return dd_cmul(*dd_cmul(*z, *t1), *t2)  # T1 is (n1, 1): one column


def _natural_dd(re_l, im_l, p: _Plan, rp: PlannerDit64, dd_leaf):
    """The dd pipeline on this rank's (n1/d, n2) f64 rows; returns its flat
    f64 shard in natural order."""
    quad = [*split_f64(re_l), *split_f64(im_l)]
    cols = []
    while quad:
        cols.append(_row_to_col(quad.pop(0), p.n1, p.n2, p.d, p.group))
    z = list(_dd_columns(cols, p.n, p.n1, p.rank * (p.n2 // p.d)))
    del cols
    rows = []
    while z:
        rows += _to_rows([z.pop(0)], p)
    tables, corrs = rp.dd_state
    out = list(rows_dd(rows, rp.plan, tables, corrs, dd_leaf))
    cols = []
    while out:
        cols.append(_row_to_col(out.pop(0), p.n1, p.n2, p.d, p.group))
    flat = _transpose4(cols)
    del cols
    out_re = flat[0].double() + flat[1].double()
    out_im = flat[2].double() + flat[3].double()
    return out_re.reshape(-1), out_im.reshape(-1)


def _layout(n: int, d: int, planner, cuda: bool, permuted: bool):
    """(f64, engine, dd, n1, n2) of a length-n transform over d ranks on
    ``planner`` (``permuted``: a permuted flag is set), raising what
    ``fft_distributed`` raises for its shape before any collective: too
    small for d ranks, or column blocks under the column kernel's floor."""
    f64 = planner.dtype == np.float64
    engine = (planner.options.f64_engine or "native") if f64 else None
    dd = f64 and engine.startswith("df64") and not permuted
    n1, n2 = (_factor_dd(n, d) if dd
              else _factor(n, d, planner.options.leaf_fft_size))
    local = n2 // d
    if n1 > 1 and local < (MIN_KERNEL_N2 if not f64 else 2) and (f64 or cuda):
        raise not_ported(
            f"fft_distributed with column blocks of {local} "
            f"columns (n = 2^{n.bit_length() - 1} over {d} ranks)", "dist_col")
    return f64, engine, dd, n1, n2


def fft_distributed(reals, imags, direction, planner, *, group=None,
                    permuted_output: bool = False,
                    permuted_input: bool = False):
    """Distributed C2C FFT of one length-n transform split over the ranks
    of ``group`` (the default process group when None), n = d times the
    local length. Every rank calls it with its contiguous shard of n/d
    points (1-D, numpy or a tensor on the planner's device) and gets its
    shard of the result: natural order, or with ``permuted_output`` its
    rows of the digit-permuted D[k1, k2] (one all_to_all fewer);
    ``permuted_input`` consumes that layout from a permuted forward on the
    same group and planner and returns natural order. The flags are
    mutually exclusive. The inverse scales by 1/n, through the swap trick.

    ``planner``: a ``PlannerDit32`` or ``PlannerDit64`` for n. Its
    ``leaf_fft_size`` fixes the factorization, an f32 planner's
    ``leaf_kernel`` the row kernels. On a ``PlannerDit64`` the engine is the
    planner's ``f64_engine`` (None: "native"), as in the JAX package: one
    that starts with "df64" runs the dd pipeline in natural order (n1 =
    max(8, d); "df64-split" runs the split dd leaf, and a "df64-oz"
    planner's rows run the oz kernels inside their window), and with a
    permuted flag, like every other engine, the native pipeline.

    Raises ``NonPowerOfTwoError`` when n is not a power of two, differs from
    the planner's or is too small for d ranks (the JAX package's classes),
    and ``NotImplementedError`` naming ROADMAP.md Queue 1 item 18 for a
    column block under its column kernel's floor: below 4 columns in f32 on
    the GPU (n < 4 d^2), below 2 in f64 (``col64``, ``ddcol_nocorr``). Every
    check precedes the first collective and fails alike on every rank."""
    direction = _coerce_direction(direction)
    if permuted_input and permuted_output:
        raise ValueError(
            "permuted_input and permuted_output are mutually exclusive"
        )
    d = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if d & (d - 1):
        raise NonPowerOfTwoError(
            f"the group must have a power-of-2 size, got {d} ranks")
    re_l = _as_tensor(reals, planner)
    im_l = _as_tensor(imags, planner)
    if re_l.dim() != 1 or re_l.shape != im_l.shape:
        raise ValueError(
            f"fft_distributed takes this rank's 1-D shard of reals and "
            f"imags, got {tuple(re_l.shape)} and {tuple(im_l.shape)}")
    n = int(re_l.shape[0]) * d
    ensure_power_of_two(n)
    if planner.n != n:
        raise NonPowerOfTwoError(
            f"planner is for size {planner.n} but input has size {n}"
        )
    f64, engine, dd, n1, n2 = _layout(n, d, planner, re_l.is_cuda,
                                      permuted_input or permuted_output)
    leaf_limit = planner.options.leaf_fft_size
    scale = direction is Direction.Reverse
    if scale:  # IFFT swap trick: swap(IDFT(z)) = (1/N) DFT(swap(z))
        re_l, im_l = im_l, re_l
    view = (n1 // d, n2)
    leaf_kernel = planner.options.leaf_kernel
    p = _Plan(
        n, n1, n2, d, rank, group, f64,
        rows=None if dd else _row_pass(planner, plan_rows(n2, leaf_limit),
                                       leaf_kernel),
        transpose=transpose2_64 if f64 else transpose2,
    )
    if dd:
        dd_leaf = engine.split("-", 1)[1] if "-" in engine else None
        rp = _dd_row_planner(n2, leaf_limit, engine, planner.device)
        out_re, out_im = _natural_dd(re_l.view(view), im_l.view(view), p, rp,
                                     dd_leaf)
    elif permuted_input:
        out_re, out_im = _permuted_in(re_l.view(view), im_l.view(view), p)
    else:
        out_re, out_im = _natural(re_l.view(view), im_l.view(view), p,
                                  permuted_output)
    if scale:
        out_re.mul_(1.0 / n)
        out_im.mul_(1.0 / n)
        return out_im, out_re
    return out_re, out_im
