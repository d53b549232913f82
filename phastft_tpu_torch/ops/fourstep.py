"""Four-step (Bailey) decomposition driver.

Counterpart of the JAX package's ``ops/fourstep.py``. ``plan_rows`` is
carried verbatim, so both packages plan every size the same way.
``fft_rows`` runs

* the ``tiny`` and ``leaf`` plans up to 2^17 points: one trip through
  device memory, ``leaf3`` when the planner holds the three-factor tables
  ``mxu3_{n1}`` (n = 2^16, 2^17), else ``leaf`` (n = 2..2^15), or with
  ``leaf_kernel="hybrid"`` and n1 = 2..1024 the opt-in ``hybrid``; n = 1 is
  a copy;
* a leaf past the leaf kernels (n1 > 1024, ``Options.leaf_fft_size`` past
  2^17; the JAX package's XLA ``leaf_fft``, ``phastft_tpu/ops/
  stockham.py:236``) as that function's own steps on the port's kernels,
  ``leaf_columns``:

    columns       F(n1) over the (n1, 128) view times the leaf correction
                  W_n^(k1*i2): ``colfft`` up to n1 = 2048, past it the long
                  columns' two passes and two transposes (``ops/longcol``)
    leaf          F(128) of the n1 rows
    transpose2    (n1, 128) -> (128, n1), the natural order;
* the fused two-pass branch: one split level n = n1 * n2 whose inner plan
  is a leaf, under the JAX package's gates (``fused_two_pass``),

    colfft_out3d   column DFT of size n1 + split twiddle -> (A, n1, 128)
    leaft          row DFTs of size n2 = A * 128, stored in natural order

  two trips through device memory in all;
* the classic branch, every other split level (the outer level of the
  nested plans of n >= 2^26, and the splits the fused gates refuse),

    colfft         column DFT of size n1 + split twiddle -> (n1, n2)
    fft_rows       the inner plan on the n1 rows, as one more batch dim
    transpose2     (n1, n2) -> (n2, n1), the natural order

  two trips more than its inner plan makes.

``fft_rows_dd`` runs the same plans on dd (double-float) quadruples of f32
planes, the df64 engine: ``tiny_fft_dd`` below 128 points, ``ddleaf`` for a
leaf up to 2^16 points (or the split leaf: ``ddcol``, a transpose,
``ddcol_nocorr``; past 2^16 points always the split leaf, its first pass
the long dd columns past n1 = 2048, ``ops/longcol.dd_columns``), and
for every split level ``ddcol``, the inner plan, and ``transpose2`` twice
(once per hi/lo pair of planes); a split level for which the planner built
the Ozaki tables runs ``ozcol`` + ``ozleaft`` instead, two trips through
device memory whose output is already in natural order.

``fft_rows_native`` runs the same plans in f64 on two planes, the native
engine, as the JAX package's f64 ``fft_rows`` runs them: every split level
on the classic branch (``col64`` with the split twiddle, the inner plan,
``transpose2_64``) and every leaf on ``leaf64`` (n = 2..2^16, the tiny
plans included; past 2^16 points ``leaf_columns`` on ``col64``,
``leaf64`` and ``transpose2_64``); n = 1 is a copy.

``rows_f32`` and ``rows_native`` take ``out_scale``, the factor of every
output value (an inverse's 1/n, else 1), and hand it to the one pass that
writes the transform's output: the leaf kernel of a leaf plan, ``leaft`` of
a fused split level, the outer ``transpose2`` / ``transpose2_64`` of a
classic split level or of ``leaf_columns``. That kernel multiplies each
value before its store (``tracing.fold`` counts it), so an inverse makes no
pass over memory for its scale. Every inner pass stores unscaled.

In all three engines each pass drops its input as soon as its kernel has
read it, unless the input is the caller's: a split level hands its column
output over to the inner plan, whose first kernel reads it and lets it go.
So a transform holds at most three pairs at once (dd: quadruples), the
caller's input included, whatever the depth of its plan: 48 GiB for an f32
transform of 2^31 points. The caller's planes are read, never written.
"""

from __future__ import annotations

from .dd import MAX_LEAF_N1 as DD_MAX_LEAF_N1
from .df64 import tiny_fft_dd
from .leaf import HYBRID_MAX_N1, LEAF3_AS
from .longcol import columns, dd_columns, transpose4
from .native import MAX_LEAF_N
from .route import KERNELS
from .stockham import LANES
from ..tracing import fold, span, traced

__all__ = [
    "plan_rows",
    "split_levels",
    "fused_two_pass",
    "fft_rows",
    "fft_rows_dd",
    "fft_rows_native",
    "rows_f32",
    "rows_dd",
    "rows_native",
    "leaf_columns",
    "LEAF_KERNEL_N1",
]

# Largest row transform executed as a single leaf.
DEFAULT_LEAF_LIMIT = 1 << 16

# Largest column factor a single split level may take; past it the plan
# nests another split level.
_MAX_COL_N1 = 2048

# Column factor of the outer level(s) of a deeply nested split.
_NESTED_COL_N1 = 256

#: Largest leaf factor n1 a single f32 leaf kernel takes (``leaf3`` at
#: n = 2^17: a = 256); a larger leaf runs ``leaf_columns``.
LEAF_KERNEL_N1 = 4 * max(LEAF3_AS)


def plan_rows(n: int, leaf_limit: int = DEFAULT_LEAF_LIMIT):
    """Static decomposition plan for a length-n row FFT: ("tiny", n),
    ("leaf", n / 128) or ("split", n1, inner plan, n2). Past the column
    factor ceiling (_MAX_COL_N1) the plan nests another split level sized
    so the inner transform is leaf_limit * 128."""
    if n < LANES:
        return ("tiny", n)
    if n <= leaf_limit:
        return ("leaf", n // LANES)
    n1 = n // leaf_limit
    if n1 > _MAX_COL_N1:
        # nested split: cap the column factor and recurse on a larger
        # inner transform (which splits again)
        n1 = n // (leaf_limit << 7)
        if n1 > _MAX_COL_N1:
            n1 = _NESTED_COL_N1
    n2 = n // n1
    return ("split", n1, plan_rows(n2, leaf_limit), n2)


def split_levels(plan):
    """(n1, inner plan, n2) of every split level of ``plan``, outermost
    first."""
    while plan[0] == "split":
        _, n1, plan, n2 = plan
        yield n1, plan, n2


def fused_two_pass(n1: int, plan2, n2: int) -> bool:
    """Whether the split level n1 x n2 over ``plan2`` runs the fused
    two-pass pipeline: the JAX package's gates (the inner plan a leaf,
    128 <= n1 <= 2048, n2 = A * 128 with 8 <= A <= 128)."""
    return (
        plan2[0] == "leaf"
        and n1 % LANES == 0
        and LANES <= n1 <= 2048
        and n2 % LANES == 0
        and 8 <= n2 // LANES <= 128
    )


def fft_rows(re, im, plan, corrs, leaf_kernel=None):
    """DFT along the last axis of (..., n) f32 tensors following ``plan``.

    ``corrs``: the planner's tables under the JAX planner's keys. A leaf
    plan with n1 = 2..1024 (``HYBRID_MAX_N1``, the 2^17 leaf included) runs
    ``hybrid`` on ``mxu{n1}[3:6] + leaf{n1}`` when
    ``leaf_kernel`` is "hybrid" (the resolved ``Options.leaf_kernel``; any
    other value keeps the default kernels, as the JAX package's
    ``_resolve_leaf_kernel`` ignores an unknown one); else ``leaf3`` on
    ``mxu3_{n1}`` when present, else ``leaf`` on ``mxu{n1}[:6] + leaf{n1}``
    (all of ``mxu1`` at n1 = 1); a tiny plan needs no table. A split level
    runs the fused two-pass branch on
    ``pcolT{n1}x{n2}`` and ``leafT{n2}`` when ``fused_two_pass`` holds,
    else the classic branch on ``pcol{n1}x{n2}``. Every branch returns new
    tensors; ``re`` and ``im`` are read, never written, and stay the
    caller's."""
    return rows_f32([re, im], plan, corrs, leaf_kernel)


def rows_f32(pair, plan, corrs, leaf_kernel=None, passes=KERNELS, out_scale=1.0):
    """``fft_rows`` on the planes in the list ``pair``, which it empties:
    the caller hands its references over. Each pass drops its input as soon
    as its kernel has read it, so a split level's column output is freed
    when the inner plan's first kernel returns (where the caller still
    holds the planes, they stay alive). ``passes``: ``ops/route.KERNELS``,
    or ``PLAIN`` for the plain versions on any device. ``out_scale``: the
    factor of every output value, folded into the last pass's stores (a
    plan of one point takes none: its 1/n is 1)."""
    k = passes
    re, im = pair
    pair.clear()
    kind = plan[0]
    if kind != "split":
        with span("phastft.pass.leaf"):
            if kind == "tiny":
                if plan[1] == 1:
                    return re.clone(), im.clone()
                return k.leaf(re, im, (), 1, fold("leaf", out_scale))
            n1 = plan[1]
            if n1 > LEAF_KERNEL_N1:
                mats1 = corrs["mxu1"]
                return leaf_columns([re, im], n1, lambda r, i: k.leaf(r, i, mats1, 1),
                                    False, k, out_scale)
            if 1 < n1 <= HYBRID_MAX_N1 and leaf_kernel == "hybrid":
                mats = corrs[f"mxu{n1}"][3:6] + tuple(corrs[f"leaf{n1}"])
                return k.hybrid(re, im, mats, n1, fold("hybrid", out_scale))
            mats3 = corrs.get(f"mxu3_{n1}")
            if mats3 is not None:
                return k.leaf3(re, im, mats3, mats3[0].shape[0], mats3[3].shape[0],
                               fold("leaf3", out_scale))
            mats = corrs[f"mxu{n1}"]
            if n1 > 1:
                mats = mats[:6] + tuple(corrs[f"leaf{n1}"])
            return k.leaf(re, im, mats, n1, fold("leaf", out_scale))
    _, n1, plan2, n2 = plan
    batch = tuple(re.shape[:-1])
    view = batch + (n1, n2)
    if fused_two_pass(n1, plan2, n2):
        with span("phastft.pass.fused"):
            c3re, c3im = k.colfft_out3d(re.reshape(view), im.reshape(view),
                                        corrs[f"pcolT{n1}x{n2}"], n1)
            del re, im
            return k.leaft(c3re, c3im, corrs[f"leafT{n2}"], n1, fold("leaft", out_scale))
    with span("phastft.pass.split"):
        col = list(k.colfft(re.reshape(view), im.reshape(view),
                            corrs[f"pcol{n1}x{n2}"], n1))
        del re, im
        d_re, d_im = rows_f32(col, plan2, corrs, leaf_kernel, k)
        o_re, o_im = k.transpose2(d_re, d_im, fold("transpose2", out_scale))
        del d_re, d_im
        flat = batch + (n1 * n2,)
        return o_re.reshape(flat), o_im.reshape(flat)


@traced("phastft.pass.columns")
def leaf_columns(pair, n1: int, rows, f64: bool, passes=KERNELS, out_scale=1.0):
    """A leaf of n1 * 128 points on the planes in the list ``pair`` (which
    it empties; f64 planes for the native engine), as the JAX package's XLA
    ``leaf_fft`` runs it: F(n1) over the (..., n1, 128) view times the
    correction W_n^(k1*i2) (``ops/longcol.columns`` on the block of every
    column: the column kernel up to n1 = 2048, the long columns past it),
    ``rows(re, im)``, F(128) of the n1 rows, and the paired transpose to the
    natural order X[k1 + n1*k2], all on ``passes``; the transpose stores
    every value times ``out_scale``."""
    batch = tuple(pair[0].shape[:-1])
    n = n1 * LANES
    view = batch + (n1, LANES)
    col = [x.reshape(view) for x in pair]
    pair.clear()
    col = [*columns(col, n, n1, 0, False, f64, passes)]
    d_re, d_im = rows(*col)
    col.clear()
    name = "transpose2_64" if f64 else "transpose2"
    o_re, o_im = getattr(passes, name)(d_re, d_im, fold(name, out_scale))
    del d_re, d_im
    return o_re.reshape(batch + (n,)), o_im.reshape(batch + (n,))


# --------------------------------------------------------------------------
# Double-float (df64) row transforms: the same plan shapes as fft_rows, dd
# arithmetic on quadruples of f32 planes, dd tables from the planner.
# --------------------------------------------------------------------------


def _ddleaf_split(rh, rl, ih, il, n1: int, passes=KERNELS):
    """dd leaf as two dd column passes with a transpose between. Pass 1:
    ``ddcol`` over the n1 factor with the leaf correction folded in
    (``dd_col_tables_host(n1, 128)`` is the factored W_{n1*128}^(k1*i2)
    table; past n1 = 2048 the long dd columns, ``ops/longcol.dd_columns``).
    Pass 2, after the transpose: the bare dd column DFT over the 128-point
    factor. The output (128, n1) read flat is the natural order
    X[k1 + k2*n1]."""
    batch = tuple(rh.shape[:-1])
    view = batch + (n1, LANES)
    quad = dd_columns([a.reshape(view) for a in (rh, rl, ih, il)], n1, passes)
    quad = transpose4(quad, passes)
    quad = passes.ddcol_nocorr(*quad, LANES)
    flat = batch + (n1 * LANES,)
    return tuple(a.reshape(flat) for a in quad)


def _out_transpose_dd(quad, batch, n1: int, n2: int, passes=KERNELS):
    """Four-step output reordering of a dd quadruple of (..., n1, n2)."""
    view = batch + (n1, n2)
    out = transpose4(tuple(a.reshape(view) for a in quad), passes)
    flat = batch + (n1 * n2,)
    return tuple(a.reshape(flat) for a in out)


def fft_rows_dd(rh, rl, ih, il, plan, tables, corrs, dd_leaf=None):
    """DFT along the last axis of four (..., n) f32 planes in dd arithmetic
    following ``plan``.

    ``tables``: the dd radix tables (``df64.dd_radix_tables_host``, on the
    device), read by the tiny plans. ``corrs``: the planner's dd tables
    under the JAX planner's keys: ``ddleaf{n1}``, ``ddpcol{n1}x{n2}`` and,
    for the levels of a "df64-oz" planner inside ``ozdd.oz_window``,
    ``ozcol{n1}x{n2}`` and ``ozleafT{n2}``. The presence of the oz tables
    arms the oz branch, as in the JAX package, whatever the per-call
    engine. ``dd_leaf`` = "split" runs a leaf with n1 > 1 as
    ``_ddleaf_split``; anything else runs ``ddleaf`` up to n1 = 512 and
    ``_ddleaf_split`` past it, where ``ddleaf`` ends. Every branch returns
    new tensors; the four planes are read, never written, and stay the
    caller's."""
    return rows_dd([rh, rl, ih, il], plan, tables, corrs, dd_leaf)


def rows_dd(quad, plan, tables, corrs, dd_leaf=None, passes=KERNELS):
    """``fft_rows_dd`` on the four planes in the list ``quad``, which it
    empties: the caller hands its references over, and a split level's
    column output is freed when the inner plan's first kernel returns.
    ``passes``: as for ``rows_f32``."""
    k = passes
    rh, rl, ih, il = quad
    quad.clear()
    kind = plan[0]
    if kind != "split":
        with span("phastft.pass.leaf"):
            if kind == "tiny":
                return tiny_fft_dd(rh, rl, ih, il, tables, plan[1])
            n1 = plan[1]
            if n1 > DD_MAX_LEAF_N1 or (n1 > 1 and dd_leaf == "split"):
                return _ddleaf_split(rh, rl, ih, il, n1, k)
            tabs = corrs[f"ddleaf{n1}"] if n1 > 1 else None
            return k.ddleaf(rh, rl, ih, il, tabs, n1)
    _, n1, plan2, n2 = plan
    batch = tuple(rh.shape[:-1])
    view = batch + (n1, n2)
    oztabs = corrs.get(f"ozcol{n1}x{n2}")
    if oztabs is not None:
        with span("phastft.pass.fused"):
            col = k.ozcol(*(a.reshape(view) for a in (rh, rl, ih, il)), oztabs, n1)
            del rh, rl, ih, il
            return k.ozleaft(*col, corrs[f"ozleafT{n2}"], n1)
    with span("phastft.pass.split"):
        t1, t2 = corrs[f"ddpcol{n1}x{n2}"]
        col = list(k.ddcol(*(a.reshape(view) for a in (rh, rl, ih, il)), t1, t2, n1))
        del rh, rl, ih, il
        rows = rows_dd(col, plan2, tables, corrs, dd_leaf, k)
        return _out_transpose_dd(rows, batch, n1, n2, k)


# --------------------------------------------------------------------------
# Native f64 row transforms: the same plan shapes, f64 arithmetic on two
# planes, the classic branch at every split level.
# --------------------------------------------------------------------------


def fft_rows_native(re, im, plan, corrs):
    """DFT along the last axis of (..., n) f64 planes following ``plan``.

    ``corrs``: the planner's native tables under the JAX planner's keys,
    ``split{n1}x{n2}`` (T1 re, T1 im, T2 re, T2 im) of every split level
    and ``leaf{n1}`` (re, im) of the plan's leaf (n1 = 2..512), and the step
    tables ``dif{m}`` of every DFT size the kernels run. A tiny or leaf
    plan runs ``leaf64`` (n = 1 is a copy; past 2^16 points
    ``leaf_columns``); a split level runs ``col64``,
    the inner plan on its n1 rows as one more batch dim, and
    ``transpose2_64``. Every branch returns new tensors; ``re`` and ``im``
    are read, never written, and stay the caller's."""
    return rows_native([re, im], plan, corrs)


def rows_native(pair, plan, corrs, passes=KERNELS, out_scale=1.0):
    """``fft_rows_native`` on the planes in the list ``pair``, which it
    empties: the caller hands its references over. Each pass drops its
    input as soon as its kernel has read it, so the column output of a
    split level is freed when the inner plan's first kernel returns, not
    when the inner plan ends (where the caller still holds the planes, as
    ``fft_rows_native``'s caller does, they stay alive). ``passes`` and
    ``out_scale``: as for ``rows_f32``."""
    k = passes

    def steps(m):
        return corrs[f"dif{m}"][0] if m > 1 else None

    re, im = pair
    pair.clear()
    kind = plan[0]
    if kind != "split":
        with span("phastft.pass.leaf"):
            if kind == "tiny":
                if plan[1] == 1:
                    return re.clone(), im.clone()
                return k.leaf64(re, im, None, plan[1], (None, steps(plan[1])),
                                fold("leaf64", out_scale))
            n1 = plan[1]
            if n1 * LANES > MAX_LEAF_N:
                tw = (None, steps(LANES))
                return leaf_columns([re, im], n1,
                                    lambda r, i: k.leaf64(r, i, None, LANES, tw),
                                    True, k, out_scale)
            return k.leaf64(re, im, corrs.get(f"leaf{n1}"), n1 * LANES,
                            (steps(n1), steps(LANES)), fold("leaf64", out_scale))
    _, n1, plan2, n2 = plan
    batch = tuple(re.shape[:-1])
    view = batch + (n1, n2)
    with span("phastft.pass.split"):
        col = list(k.col64(re.reshape(view), im.reshape(view),
                           corrs[f"split{n1}x{n2}"], n1, steps(n1)))
        del re, im
        d_re, d_im = rows_native(col, plan2, corrs, k)
        o_re, o_im = k.transpose2_64(d_re, d_im, fold("transpose2_64", out_scale))
        del d_re, d_im
        flat = batch + (n1 * n2,)
        return o_re.reshape(flat), o_im.reshape(flat)
