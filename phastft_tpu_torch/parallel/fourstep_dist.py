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
  declines the shape): ``ops/longcol.long_columns``, n1 = P * Q as two
  column passes with the twiddles folded into their tables and two
  transposes (nested again past 2048^2).
* column blocks of any width, one and two columns included (n = d^2 in
  f64, n < 4 d^2 in f32; the JAX package's XLA ``stockham_axis2``,
  ``:203``, ``:255``): the same kernels, which take every n2 >= 1.
* df64 and df64-oz, natural order only (``_build_distributed_dd``
  ``:412-550``): n1 = max(``DD_DIST_MIN_COL``, d) (``_factor_dd`` ``:345``),
  the input split into hi/lo f32 planes (``_dd_split4`` ``:386``), the
  column pass on ``ddcol`` with dd tables of the block's own width
  (``ops/dd.dd_shard_tables``, at any width; the JAX package synthesises
  the twiddle of a block under its kernel's slab, ``_dd_corr_trig``), the rows
  on ``fft_rows_dd`` of a cached row planner (``_dd_dist_state`` ``:363``:
  on a "df64-oz" planner its oz tables arm ``ozcol`` + ``ozleaft`` where the
  JAX package's do), ``transpose2`` per hi/lo pair, the join and the 1/n
  scale in f64.

A planner built on ``Options(use_pallas=False)`` runs every one of these
passes on its plain version (``ops/route.PLAIN``), as the JAX package's
branches follow its ``use_pallas``: the oracle route, which launches no
kernel.

The permuted-input twiddle W_n^(k1*m2), and in f32 the first long-column
pass's where ``colfft``'s own twiddle cannot express it, are plain torch
(``ops/longcol.twiddle_``), as the JAX package computes them in XLA
(``:181-191``): exact integer phases and f64 angles, in slabs of rows (an
f64 angle array of the whole block is 8 GiB at 2^30).

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

from ..errors import NonPowerOfTwoError, ensure_power_of_two
from ..fft import _as_tensor, _coerce_direction
from ..options import Options
from ..ops.dd import dd_shard_tables
from ..ops.df64 import split_f64
from ..ops.fourstep import plan_rows, rows_dd, rows_f32, rows_native
from ..ops.longcol import columns, transpose4, twiddle_
from ..ops.route import KERNELS, passes_for
from ..planner import Direction, PlannerDit64

__all__ = ["fft_distributed", "DD_DIST_MIN_COL"]

#: Smallest column factor of the dd factorization (the JAX package's): the
#: dd column pass stays shallow and the rows carry the log-n work.
DD_DIST_MIN_COL = 8


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
    #: ``ops/route.KERNELS``, or ``PLAIN`` on a ``use_pallas=False`` planner
    passes: object


def _row_pass(planner, plan, leaf_kernel, passes=KERNELS) -> Callable:
    """The row DFTs of ``plan`` on the planner's kernels (``passes``), as a
    function of a list [re, im] that it empties: ``rows_native`` on an f64
    planner's native tables, ``rows_f32`` on an f32 planner's; each drops
    the planes once its first kernel has read them."""
    if planner.dtype == np.float64:
        corrs = planner.native_tables_for(plan)
        return lambda pair: rows_native(pair, plan, corrs, passes)
    corrs = planner.tables_for(plan, leaf_kernel)
    return lambda pair: rows_f32(pair, plan, corrs, leaf_kernel, passes)


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
    t = list(columns(cols, p.n, p.n1, p.rank * (p.n2 // p.d), False, p.f64, p.passes))
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
    twiddle_(r_re, r_im, p.n,
              torch.arange(p.rank * rows, (p.rank + 1) * rows, dtype=torch.int64, device=dev),
              torch.arange(p.n2, dtype=torch.int64, device=dev))
    cols = [_row_to_col(r_re, p.n1, p.n2, p.d, p.group)]
    del r_re
    cols.append(_row_to_col(r_im, p.n1, p.n2, p.d, p.group))
    del r_im
    z = list(columns(cols, p.n, p.n1, 0, True, p.f64, p.passes))
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


def _dd_columns(quad, n: int, n1: int, col_base: int, passes):
    """The dd column pass of this rank's (n1, c) quadruple, any width:
    ``ddcol`` with the block's tables."""
    cols = int(quad[0].shape[-1])
    t1, t2 = dd_shard_tables(n, n1, cols, col_base, quad[0].device)
    return passes.ddcol(*quad, t1, t2, n1)


def _natural_dd(re_l, im_l, p: _Plan, rp: PlannerDit64, dd_leaf):
    """The dd pipeline on this rank's (n1/d, n2) f64 rows; returns its flat
    f64 shard in natural order."""
    quad = [*split_f64(re_l), *split_f64(im_l)]
    cols = []
    while quad:
        cols.append(_row_to_col(quad.pop(0), p.n1, p.n2, p.d, p.group))
    z = list(_dd_columns(cols, p.n, p.n1, p.rank * (p.n2 // p.d), p.passes))
    del cols
    rows = []
    while z:
        rows += _to_rows([z.pop(0)], p)
    tables, corrs = rp.dd_state
    out = list(rows_dd(rows, rp.plan, tables, corrs, dd_leaf, p.passes))
    cols = []
    while out:
        cols.append(_row_to_col(out.pop(0), p.n1, p.n2, p.d, p.group))
    flat = transpose4(cols, p.passes)
    del cols
    out_re = flat[0].double() + flat[1].double()
    out_im = flat[2].double() + flat[3].double()
    return out_re.reshape(-1), out_im.reshape(-1)


def _layout(n: int, d: int, planner, permuted: bool):
    """(f64, engine, dd, n1, n2) of a length-n transform over d ranks on
    ``planner`` (``permuted``: a permuted flag is set), raising what
    ``fft_distributed`` raises for its shape before any collective: too
    small for d ranks."""
    f64 = planner.dtype == np.float64
    engine = (planner.options.f64_engine or "native") if f64 else None
    dd = f64 and engine.startswith("df64") and not permuted
    n1, n2 = (_factor_dd(n, d) if dd
              else _factor(n, d, planner.options.leaf_fft_size))
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

    Every shape the JAX package shards runs, column blocks of one and two
    columns included. Raises ``NonPowerOfTwoError`` when n is not a power
    of two, differs from the planner's or is too small for d ranks (the JAX
    package's classes). Every check precedes the first collective and fails
    alike on every rank."""
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
    f64, engine, dd, n1, n2 = _layout(n, d, planner, permuted_input or permuted_output)
    leaf_limit = planner.options.leaf_fft_size
    scale = direction is Direction.Reverse
    if scale:  # IFFT swap trick: swap(IDFT(z)) = (1/N) DFT(swap(z))
        re_l, im_l = im_l, re_l
    view = (n1 // d, n2)
    leaf_kernel = planner.options.leaf_kernel
    passes = passes_for(planner.options.use_pallas is False)
    p = _Plan(
        n, n1, n2, d, rank, group, f64,
        rows=None if dd else _row_pass(planner, plan_rows(n2, leaf_limit),
                                       leaf_kernel, passes),
        transpose=passes.transpose2_64 if f64 else passes.transpose2,
        passes=passes,
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
