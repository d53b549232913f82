"""Four-step (Bailey) decomposition driver.

Counterpart of the JAX package's ``ops/fourstep.py``. ``plan_rows`` is
carried verbatim, so both packages plan every size the same way. Of
``fft_rows`` the port has the fused two-pass branch: one split level
n = n1 * n2 whose inner plan is a leaf,

    colfft_out3d   column DFT of size n1 + split twiddle -> (A, n1, 128)
    leaft          row DFTs of size n2 = A * 128, stored in natural order

two trips through device memory in all. Every other branch raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings it.
"""

from __future__ import annotations

from ..errors import not_ported
from .colfft import colfft_out3d
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

    ``corrs``: the planner's tables; the fused two-pass branch runs when
    ``pcolT{n1}x{n2}`` and ``leafT{n2}`` are present, the inner plan is a
    leaf and 128 <= n1 <= 2048 with n1 % 128 == 0 (the JAX package's
    gates)."""
    kind = plan[0]
    if kind == "tiny":
        raise not_ported(f"the tiny plan (n = {plan[1]})", "leaf")
    if kind == "leaf":
        raise not_ported(f"the leaf plan (n = {plan[1] * LANES})", "leaf")
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
