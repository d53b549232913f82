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
  transposes on ``transpose2_64``. Each intermediate
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

The inverse's 1/n (the swap trick) is folded into the stores of the pass
that writes the rank's output, as on one device: the last ``transpose2`` /
``transpose2_64`` of natural order, or the rows' last kernel with
``permuted_output``. Where the output comes from a copy (``permuted_input``)
or the dd join, it is a multiply of its own (``ops/dit.scale_``).

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
same order.

The column stage runs as the JAX package's chunked pipeline (natural order
``local_step`` ``:229-300``, permuted input ``local_step_permuted_in``
``:172-220``, df64 ``_build_distributed_dd`` ``:441-515``): the rank's
column block is split into ``_chunk_count`` chunks of columns (permuted
input: of the global m2 axis), and each chunk has its own send copy (and
twiddle), row -> column all_to_all, column pass and column -> row
all_to_all, whose output is copied into the row buffer. The count is one
unless PHASTFT_TPU_DIST_CHUNKS sets another: the JAX package's default of 4
from 8 MiB a block read slower on the H100 on one card and over four
(``_chunk_count``). Chunked, the collectives are started with
``async_op=True`` and waited on where the compute stream first reads their
output (with NCCL a wait of the stream, not of the host), in the order that
lets each run beside a column pass: chunk c+1's send copy and row -> column
collective before chunk c's column pass, and chunk c+1's column pass before
the wait on chunk c's column -> row collective (``_pipeline``). One chunk is
in flight each way, and every buffer a collective reads or writes stays
referenced until its wait (``_Flight``). The layout is the same for every
chunk count. The row DFTs and the last collective of natural order are not
chunked, as in the JAX package. One chunk is the unchunked pipeline, its
collectives on the current stream, with no copy that it did not make before.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..errors import NonPowerOfTwoError, ensure_power_of_two
from ..fft import _as_tensor, _coerce_direction
from ..options import Options
from ..ops.dd import dd_shard_tables
from ..ops.df64 import split_f64
from ..ops.dit import scale_
from ..ops.fourstep import plan_rows, rows_dd, rows_f32, rows_native
from ..ops.longcol import columns, transpose4, twiddle_
from ..ops.route import KERNELS, passes_for
from ..planner import Direction, PlannerDit64
from ..tracing import fold, span, traced

__all__ = ["fft_distributed", "column_chunks", "DD_DIST_MIN_COL"]

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


def _chunk_count(cols: int) -> int:
    """Chunks of a rank's column block of ``cols`` columns in the column
    stage. PHASTFT_TPU_DIST_CHUNKS, a digit string >= 1, sets the count c (1
    where c does not divide ``cols``), parsed as the JAX package parses it
    (``_chunk_count``, ``fourstep_dist.py:54-68``); else one chunk, at every
    world size. The JAX package's default, 4 chunks from 8 MiB a block where
    4 divides the width, was slower wherever the H100 timed it: 1.34x /
    1.24x one chunk in device time on one card (f32 2^25 / native 2^27),
    1.11-1.98x over four cards on NVLink (f32 2^27 and 2^29, native 2^29;
    ``PERF.md``). Not ported: the JAX dd pipeline's raise of the
    count until a chunk fits its Pallas kernel's slab (``:447-449``);
    ``ddcol`` takes any width."""
    v = os.environ.get("PHASTFT_TPU_DIST_CHUNKS", "")
    if v.isdigit() and int(v) >= 1:
        c = int(v)
        return c if cols % c == 0 else 1
    return 1


def column_chunks(n: int, d: int, planner, permuted: bool = False) -> int:
    """The chunks of ``fft_distributed``'s column stage for a length-n
    transform over d ranks on ``planner`` (``permuted``: a permuted flag is
    set): ``_chunk_count`` of the rank's n2/d columns, in each of the three
    pipelines the width the JAX package's counts (``:247-248``,
    ``:177-178``, ``:444-445``)."""
    return _chunk_count(_layout(n, d, planner, permuted)[4] // d)


def _all_to_all(blocks, group, overlap: bool):
    """The all_to_all of the contiguous ``blocks`` (d, ...): block j to rank
    j. Returns (out, work): out (d, ...) holds block s from rank s. With
    ``overlap`` the collective is started on NCCL's own stream and ``out``
    is ready once ``work.wait()`` has been called, which makes the current
    stream wait on it, not the host; the caller keeps ``blocks`` and ``out``
    referenced until then. Without, it runs on the current stream (work
    None): no stream to cross, which on the H100 saved 17 us of a 1.45 ms
    call at f32 2^25 on one rank (``PERF.md``)."""
    out = torch.empty_like(blocks)
    with span("phastft.dist.a2a"):
        return out, dist.all_to_all_single(out, blocks, group=group, async_op=overlap)


class _Flight:
    """The all_to_alls of contiguous (d, ...) planes (``_all_to_all``), in
    flight with ``overlap``: each plane's collective is started as ``sends``
    yields it (the next plane's send copy runs beside it), and every send
    and receive buffer stays referenced until ``land`` has waited on its
    work (the collective reads and writes them on its own stream until then;
    no ``record_stream``)."""

    def __init__(self, sends, group, overlap: bool):
        self.sends, self.recvs, self.works = [], [], []
        for x in sends:
            out, work = _all_to_all(x, group, overlap)
            self.sends.append(x)
            self.recvs.append(out)
            self.works.append(work)

    def land(self):
        """Yield each received plane once its work has been waited on (the
        caller's copy of one plane runs beside the next one's collective),
        then drop the buffers."""
        for work, out in zip(self.works, self.recvs):
            if work is not None:
                with span("phastft.dist.wait"):
                    work.wait()
            yield out
        self.sends = self.recvs = self.works = None


def _row_to_col(x, n1: int, cols: int, d: int, group):
    """(n1/d, cols) row shard -> (n1, cols/d) column shard: row
    s*n1/d + r is rank s's row r, the columns this rank's block."""
    with span("phastft.dist.send"):
        blocks = x.reshape(n1 // d, d, cols // d).transpose(0, 1).contiguous()
    return _all_to_all(blocks, group, False)[0].reshape(n1, cols // d)


def _pipeline(chunks: int, d: int, group, send, column, land) -> None:
    """The chunked column stage: for each chunk c, ``send(c)`` yields its
    contiguous (d, ...) send planes, each one's row -> column all_to_all
    started as it comes, ``column(c, planes)`` its column pass on the
    received planes (a list it empties) returning the output planes (n1, w),
    their column -> row all_to_alls as (d, n1/d, w), and ``land(c, planes)``
    on what they received, each plane as its wait returns. Chunk c+1's send and row -> column collectives are started
    before chunk c's column pass, and chunk c+1's column pass before the
    wait on chunk c's column -> row collectives: one chunk of lookahead each
    way, so at most six chunks' planes are held at once. One chunk has
    nothing to overlap: its collectives run on the current stream."""
    overlap = chunks > 1
    ahead = _Flight(send(0), group, overlap)
    behind = None
    for c in range(chunks):
        here = ahead
        ahead = _Flight(send(c + 1), group, overlap) if c + 1 < chunks else None
        got = list(here.land())
        with span("phastft.dist.column"):
            out = column(c, got)
        del here
        flight = _Flight([x.view(d, -1, x.shape[-1]) for x in out], group, overlap)
        del out
        if behind is not None:
            land(c - 1, behind.land())
        behind = flight
    land(chunks - 1, behind.land())


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
    #: ([re, im], out_scale) -> the row DFTs of length n2, every value times
    #: out_scale (the list is emptied)
    rows: Callable
    transpose: Callable
    #: ``ops/route.KERNELS``, or ``PLAIN`` on a ``use_pallas=False`` planner
    passes: object
    #: chunks of the column stage (``column_chunks``)
    chunks: int


def _row_pass(planner, plan, leaf_kernel, passes=KERNELS) -> Callable:
    """The row DFTs of ``plan`` on the planner's kernels (``passes``), as a
    function of a list [re, im] that it empties and of the output scale:
    ``rows_native`` on an f64 planner's native tables, ``rows_f32`` on an
    f32 planner's; each drops the planes once its first kernel has read
    them."""
    if planner.dtype == np.float64:
        corrs = planner.native_tables_for(plan)
        return lambda pair, out_scale=1.0: rows_native(pair, plan, corrs, passes, out_scale)
    corrs = planner.tables_for(plan, leaf_kernel)
    return lambda pair, out_scale=1.0: rows_f32(pair, plan, corrs, leaf_kernel, passes,
                                                out_scale)


def _land_rows(out, got, chunks: int, region) -> None:
    """A chunk's received (d, n1/d, w) planes ``got`` into the (n1/d, n2)
    row planes ``out`` (made on the first chunk): block s of each to
    ``region(o)[:, s]``, the chunk's (n1/d, d, w) columns of the row plane
    o. One chunk: the received planes themselves, a view at d = 1."""
    for i, x in enumerate(got):
        with span("phastft.dist.land"):
            if chunks == 1:
                out.append(x.transpose(0, 1).reshape(x.shape[1], -1))
                continue
            if i == len(out):
                out.append(torch.empty(x.shape[1], chunks * x.shape[0] * x.shape[2],
                                       dtype=x.dtype, device=x.device))
            region(out[i]).copy_(x.transpose(0, 1))


def _column_stage(planes, p: _Plan, column):
    """Steps 1-4 of natural order on this rank's (n1/d, n2) row planes, the
    list ``planes`` (emptied once the last chunk is sent), in ``p.chunks``
    chunks of its n2/d columns: chunk c's send copy of the columns [c*w,
    (c+1)*w) of every rank's block (w = n2/(d*chunks)), the received
    (n1, w) planes through ``column(planes, col_base)`` (a list it empties;
    col_base the chunk's first global column), and the received rows copied
    into the columns s*n2/d + c*w + j of the (n1/d, n2) row planes it
    returns (one chunk: the received planes themselves, a view at d = 1)."""
    d, rows, local, chunks = p.d, p.n1 // p.d, p.n2 // p.d, p.chunks
    w = local // chunks
    out = []

    def send(c):
        for x in planes:
            with span("phastft.dist.send"):
                block = x.view(rows, d, chunks, w)[:, :, c].transpose(0, 1).contiguous()
            yield block
        if c == chunks - 1:
            planes.clear()

    def col(c, got):
        pair = [x.view(p.n1, w) for x in got]
        got.clear()
        return column(pair, p.rank * local + c * w)

    def land(c, got):
        _land_rows(out, got, chunks, lambda o: o.view(rows, d, chunks, w)[:, :, c])

    _pipeline(chunks, d, p.group, send, col, land)
    return out


def _natural(re_l, im_l, p: _Plan, permuted_output: bool, out_scale: float):
    """Steps 1-6 on this rank's (n1/d, n2) rows; returns its flat shard,
    every value times ``out_scale`` in the stores of its last pass."""
    rows = _column_stage(
        [re_l, im_l], p,
        lambda pair, base: columns(pair, p.n, p.n1, base, False, p.f64, p.passes))
    if permuted_output:
        d_re, d_im = p.rows(rows, out_scale)
        return d_re.reshape(-1), d_im.reshape(-1)
    d_re, d_im = p.rows(rows)
    # D[k1, k2] -> (n1, n2/d) holding this rank's k2 block -> (n2/d, n1)
    o_re = _row_to_col(d_re, p.n1, p.n2, p.d, p.group)
    del d_re
    o_im = _row_to_col(d_im, p.n1, p.n2, p.d, p.group)
    del d_im
    o_re, o_im = p.transpose(
        o_re, o_im, fold("transpose2_64" if p.f64 else "transpose2", out_scale))
    return o_re.reshape(-1), o_im.reshape(-1)


def _permuted_in(re_l, im_l, p: _Plan):
    """The mirrored pipeline on this rank's rows of D[k1, k2]; returns its
    flat shard in natural order. After the row DFTs, chunk c of the m2 axis
    (w = n2/(d*chunks) columns of each rank) takes the twiddle
    W_n^(k1*m2) on its columns [c*d*w, (c+1)*d*w), the row -> column
    collective, the bare column pass and the column -> row collective;
    block s of what it receives holds this rank's rows of the columns
    c*d*w + s*w + j."""
    r = list(p.rows([re_l, im_l]))
    d, rows = p.d, p.n1 // p.d
    chunks = p.chunks
    w = p.n2 // (d * chunks)
    dev = r[0].device
    k1 = torch.arange(p.rank * rows, (p.rank + 1) * rows, dtype=torch.int64, device=dev)
    out = []

    def send(c):
        m2 = torch.arange(c * d * w, (c + 1) * d * w, dtype=torch.int64, device=dev)
        part = [x.view(rows, chunks, d * w)[:, c] for x in r]
        twiddle_(*part, p.n, k1, m2)
        for x in part:
            with span("phastft.dist.send"):
                block = x.view(rows, d, w).transpose(0, 1).contiguous()
            yield block
        if c == chunks - 1:
            r.clear()

    def col(c, got):
        pair = [x.view(p.n1, w) for x in got]
        got.clear()
        return columns(pair, p.n, p.n1, 0, True, p.f64, p.passes)

    def land(c, got):
        _land_rows(out, got, chunks, lambda o: o.view(rows, chunks, d, w)[:, c])

    _pipeline(chunks, d, p.group, send, col, land)
    return [o.reshape(-1) for o in out]


@functools.lru_cache(maxsize=16)
def _dd_row_planner(n2: int, leaf_limit: int, engine: str, device):
    """The row transforms' planner of the dd pipeline, as the JAX package's
    ``_dd_dist_state`` builds it: ``PlannerDit64(n2)`` on the leaf
    min(leaf_limit, n2) and the caller's engine, whose ``dd_state`` holds the
    dd (and, for "df64-oz", the oz) tables of ``plan_rows(n2)``."""
    opts = Options(leaf_fft_size=min(leaf_limit, n2), f64_engine=engine)
    return PlannerDit64(n2, options=opts, device=device)


def _dd_columns(quad, n: int, n1: int, col_base: int, passes):
    """The dd column pass of this rank's (n1, c) quadruple handed over in
    the list ``quad``, any width: ``ddcol`` with the block's tables."""
    cols = int(quad[0].shape[-1])
    t1, t2 = dd_shard_tables(n, n1, cols, col_base, quad[0].device)
    planes = tuple(quad)
    quad.clear()
    return passes.ddcol(*planes, t1, t2, n1)


def _natural_dd(re_l, im_l, p: _Plan, rp: PlannerDit64, dd_leaf):
    """The dd pipeline on this rank's (n1/d, n2) f64 rows; returns its flat
    f64 shard in natural order."""
    rows = _column_stage(
        [*split_f64(re_l), *split_f64(im_l)], p,
        lambda quad, base: _dd_columns(quad, p.n, p.n1, base, p.passes))
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


@traced("phastft.dist")
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

    The column stage runs in one chunk unless PHASTFT_TPU_DIST_CHUNKS sets
    a count >= 1 that divides the rank's block width (``_chunk_count``; the
    JAX package's default of 4 read slower on the H100, on one card and on
    four). Chunked, each chunk's all_to_alls are in flight while the next
    chunk's column pass runs (on NCCL, on its own stream beside the
    kernels); one chunk runs its collectives on the current stream. The
    result's layout does not depend on the count.

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
        chunks=column_chunks(n, d, planner, permuted_input or permuted_output),
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
                                  permuted_output, 1.0 / n if scale else 1.0)
    if not scale:
        return out_re, out_im
    if dd or permuted_input:
        scale_(out_re, out_im, n)
    return out_im, out_re
