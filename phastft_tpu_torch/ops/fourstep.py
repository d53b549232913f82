"""Four-step (Bailey) decomposition driver.

Counterpart of the JAX package's ``ops/fourstep.py``. ``plan_rows`` is
carried verbatim, so both packages plan every size the same way.
``fft_rows`` runs

* the ``tiny`` and ``leaf`` plans (n <= 2^16): one trip through device
  memory, ``leaf3`` when the planner holds the three-factor tables
  ``mxu3_{n1}`` (n = 2^16), else ``leaf`` (n = 2..2^15); n = 1 is a copy;
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
"""

from __future__ import annotations

from .colfft import colfft, colfft_out3d
from .leaf import leaf, leaf3
from .leaft import leaft
from .stockham import LANES
from .transpose import transpose2

__all__ = ["plan_rows", "split_levels", "fused_two_pass", "fft_rows"]

# Largest row transform executed as a single leaf.
DEFAULT_LEAF_LIMIT = 1 << 16

# Largest column factor a single split level may take; past it the plan
# nests another split level.
_MAX_COL_N1 = 2048

# Column factor of the outer level(s) of a deeply nested split.
_NESTED_COL_N1 = 256


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


def fft_rows(re, im, plan, corrs):
    """DFT along the last axis of (..., n) f32 tensors following ``plan``.

    ``corrs``: the planner's tables under the JAX planner's keys. A leaf
    plan runs ``leaf3`` on ``mxu3_{n1}`` when present, else ``leaf`` on
    ``mxu{n1}[:6] + leaf{n1}`` (all of ``mxu1`` at n1 = 1); a tiny plan
    needs no table. A split level runs the fused two-pass branch on
    ``pcolT{n1}x{n2}`` and ``leafT{n2}`` when ``fused_two_pass`` holds,
    else the classic branch on ``pcol{n1}x{n2}``, which frees each
    intermediate pair as soon as the next pass has read it. Every branch
    returns new tensors."""
    kind = plan[0]
    if kind == "tiny":
        if plan[1] == 1:
            return re.clone(), im.clone()
        return leaf(re, im, (), 1)
    if kind == "leaf":
        n1 = plan[1]
        mats3 = corrs.get(f"mxu3_{n1}")
        if mats3 is not None:
            return leaf3(re, im, mats3, mats3[0].shape[0], mats3[3].shape[0])
        mats = corrs[f"mxu{n1}"]
        if n1 > 1:
            mats = mats[:6] + tuple(corrs[f"leaf{n1}"])
        return leaf(re, im, mats, n1)
    _, n1, plan2, n2 = plan
    batch = tuple(re.shape[:-1])
    view = batch + (n1, n2)
    if fused_two_pass(n1, plan2, n2):
        c3re, c3im = colfft_out3d(re.reshape(view), im.reshape(view),
                                  corrs[f"pcolT{n1}x{n2}"], n1)
        return leaft(c3re, c3im, corrs[f"leafT{n2}"], n1)
    c_re, c_im = colfft(re.reshape(view), im.reshape(view),
                        corrs[f"pcol{n1}x{n2}"], n1)
    d_re, d_im = fft_rows(c_re, c_im, plan2, corrs)
    del c_re, c_im
    o_re, o_im = transpose2(d_re, d_im)
    del d_re, d_im
    flat = batch + (n1 * n2,)
    return o_re.reshape(flat), o_im.reshape(flat)
