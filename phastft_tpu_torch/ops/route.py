"""The passes a transform runs: the hand-written kernels, or their plain
torch versions.

``KERNELS`` holds the kernels' wrappers (``leaf``, ``colfft``, ...): on a
CUDA tensor each launches its kernel (counted in ``tracing.launches``) or
raises, and on a CPU tensor it runs its plain version. ``PLAIN`` holds those
plain versions themselves, under the same names: they run on any device
and launch nothing. ``PLAIN`` is the port's ``Options(use_pallas=False)``
route, its counterpart of the JAX package's XLA lowering
(``phastft_tpu/ops/fourstep.py:351-380``, ``:552-566``): an oracle that
only an explicit ``use_pallas=False``, per call or on the planner, selects.

The drivers (``ops/fourstep``, ``ops/longcol``, the builders of
``ops/dit`` and ``ops/r2c``, ``parallel/``) take one of the two as
``passes`` and call every kernel through it; ``passes_for(plain)`` picks it.
"""

from __future__ import annotations

from types import SimpleNamespace

from .colfft import (
    colfft, colfft_nocorr, colfft_nocorr_plain, colfft_out3d, colfft_out3d_plain,
    colfft_plain,
)
from .dd import ddcol, ddcol_nocorr, ddcol_nocorr_plain, ddcol_plain, ddleaf, ddleaf_plain
from .leaf import hybrid, hybrid_plain, leaf, leaf3, leaf3_plain, leaf_plain
from .leaft import leaft, leaft_plain
from .native import col64, col64_nocorr, col64_nocorr_plain, col64_plain, leaf64, leaf64_plain
from .ozdd import ozcol, ozcol_plain, ozleaft, ozleaft_plain
from .r2c import (
    deinterleave, deinterleave_plain, interleave_scale, interleave_scale_plain,
    pre_untangle, pre_untangle_plain, untangle, untangle_plain,
)
from .transpose import transpose2, transpose2_64, transpose2_plain

__all__ = ["KERNELS", "PLAIN", "passes_for"]

#: The wrappers: each kernel on a CUDA tensor, its plain version on a CPU one.
KERNELS = SimpleNamespace(
    leaf=leaf, leaf3=leaf3, hybrid=hybrid,
    colfft=colfft, colfft_out3d=colfft_out3d, colfft_nocorr=colfft_nocorr,
    leaft=leaft, transpose2=transpose2, transpose2_64=transpose2_64,
    ddcol=ddcol, ddcol_nocorr=ddcol_nocorr, ddleaf=ddleaf,
    ozcol=ozcol, ozleaft=ozleaft,
    col64=col64, col64_nocorr=col64_nocorr, leaf64=leaf64,
    deinterleave=deinterleave, interleave_scale=interleave_scale,
    untangle=untangle, pre_untangle=pre_untangle,
)

#: The plain versions, on any device; they launch nothing.
PLAIN = SimpleNamespace(
    leaf=leaf_plain, leaf3=leaf3_plain, hybrid=hybrid_plain,
    colfft=colfft_plain, colfft_out3d=colfft_out3d_plain,
    colfft_nocorr=colfft_nocorr_plain,
    leaft=leaft_plain, transpose2=transpose2_plain, transpose2_64=transpose2_plain,
    ddcol=ddcol_plain, ddcol_nocorr=ddcol_nocorr_plain, ddleaf=ddleaf_plain,
    ozcol=ozcol_plain, ozleaft=ozleaft_plain,
    col64=col64_plain, col64_nocorr=col64_nocorr_plain, leaf64=leaf64_plain,
    deinterleave=deinterleave_plain, interleave_scale=interleave_scale_plain,
    untangle=untangle_plain, pre_untangle=pre_untangle_plain,
)


def passes_for(plain: bool) -> SimpleNamespace:
    """``PLAIN`` when ``plain`` (a resolved ``use_pallas`` of False), else
    ``KERNELS``."""
    return PLAIN if plain else KERNELS
