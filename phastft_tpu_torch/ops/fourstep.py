"""Four-step (Bailey) decomposition driver.

Counterpart of the JAX package's ``ops/fourstep.py``. ``plan_rows`` is
carried verbatim, so both packages plan every size the same way. Of
``fft_rows`` the port has

* the ``tiny`` and ``leaf`` plans (n <= 2^16): one trip through device
  memory, ``leaf3`` when the planner holds the three-factor tables
  ``mxu3_{n1}`` (n = 2^16), else ``leaf`` (n = 2..2^15); n = 1 is a copy;
* the fused two-pass branch: one split level n = n1 * n2 whose inner plan
  is a leaf,

    colfft_out3d   column DFT of size n1 + split twiddle -> (A, n1, 128)
    leaft          row DFTs of size n2 = A * 128, stored in natural order

  two trips through device memory in all.

Every other branch raises ``NotImplementedError`` naming the
``ROADMAP.md`` item that brings it.
"""

from __future__ import annotations

from ..errors import not_ported
from .colfft import colfft_out3d
from .leaf import leaf, leaf3
from .leaft import leaft
from .stockham import LANES

__all__ = ["plan_rows", "fft_rows"]

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


def fft_rows(re, im, plan, corrs):
    """DFT along the last axis of (..., n) f32 tensors following ``plan``.

    ``corrs``: the planner's tables under the JAX planner's keys. A leaf
    plan runs ``leaf3`` on ``mxu3_{n1}`` when present, else ``leaf`` on
    ``mxu{n1}[:6] + leaf{n1}`` (all of ``mxu1`` at n1 = 1); a tiny plan
    needs no table. The fused two-pass branch runs when ``pcolT{n1}x{n2}``
    and ``leafT{n2}`` are present, the inner plan is a leaf and
    128 <= n1 <= 2048 with n1 % 128 == 0 (the JAX package's gates).
    Every branch returns new tensors."""
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
    if plan2[0] != "leaf":
        raise not_ported(f"the nested split plan {plan}", "nested")
    pcolt = corrs.get(f"pcolT{n1}x{n2}")
    leaft_tabs = corrs.get(f"leafT{n2}")
    if (
        pcolt is None
        or leaft_tabs is None
        or n1 % 128 != 0
        or not 128 <= n1 <= 2048
    ):
        raise not_ported(
            f"the classic split pipeline (n1 = {n1}, n2 = {n2})", "classic"
        )
    batch = tuple(re.shape[:-1])
    view = batch + (n1, n2)
    c3re, c3im = colfft_out3d(re.reshape(view), im.reshape(view), pcolt, n1)
    return leaft(c3re, c3im, leaft_tabs, n1)
