"""Execution options and size-based heuristics.

Counterpart of the JAX package's ``options.py``: the same ``Options``
dataclass and field names, so one value can describe a call to either
package. ``guess_options`` keeps both leaf rules of the JAX package,
which fix the plan shapes (``ops/fourstep.plan_rows``). The f64 engine
windows of the JAX package were measured on a TPU and are not carried
over: the port's f64 default comes from a race on the H100 (``PERF.md``):
the native engine (``f64_engine=None``) at every power of two n; ``"df64"``
and the Ozaki engine ``"df64-oz"`` are opt-in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["Options"]

#: Largest row transform executed as a single leaf.
DEFAULT_LEAF_SIZE = 1 << 16

#: log2(n) from which the staged strategy's bit reversal is tiled.
TILED_BITREV_MIN_LOGN = 14


@dataclasses.dataclass(frozen=True)
class Options:
    """Per-call tuning knobs. ``None`` fields mean "auto-select by size".

    The port reads ``leaf_fft_size`` (through the planner), ``strategy``,
    ``use_pallas``, ``tiled_bit_reversal``, ``leaf_kernel`` and
    ``f64_engine``. Every power-of-two ``leaf_fft_size`` runs, planned as
    the JAX package plans it. ``strategy="staged"`` (per call) runs the
    reference-parity radix-2 path in plain torch, its bit reversal tiled
    when ``tiled_bit_reversal`` is True (None: from log2 n =
    ``TILED_BITREV_MIN_LOGN``). ``use_pallas=False`` (per call, or on the
    planner, where the C2C, real, batch and distributed entries read it)
    runs every pass's plain torch version instead of its kernel, on any
    device; None and True run the kernels. Both are oracles: far slower than
    the kernels, and launching none.

    ``leaf_kernel`` (f32; the per-call value, when not None, overrides the
    planner's): ``"hybrid"`` runs every leaf of n = 2^8..2^17 points (a
    leaf plan, the inner leaf of a classic level, a distributed shard's
    rows; a leaf past 2^17 keeps the default route, as the JAX planner
    builds the hybrid's tables up to n1 = 1024) on the hybrid kernel:
    a Stockham F(n1) and a dense F(128)
    contraction, bound by operations and slower than the default leaf
    kernels on the H100 (``PERF.md``), so opt-in. A tiny plan and the
    128-point leaf keep ``leaf``, as in the JAX package; ``None``,
    ``"mxu2"``, ``"mxu3"`` and any value the JAX package does not know keep
    the default kernels (``leaf``, and ``leaf3`` at 2^16 and 2^17). The JAX
    package's ``PHASTFT_TPU_LEAF_KERNEL`` variable, a TPU tuning knob, is
    not read. The other fields (``leaf_engine``, ``col_engine``, ...)
    select TPU engines and are accepted and ignored: the port has one
    kernel per plan shape, and its leaf kernels take any batch.

    ``f64_engine`` (f64 planners only; the per-call value, when not None,
    overrides the planner's, and None on both means ``"native"``):
    ``"native"`` (and any value that does not start with ``"df64"``, as in
    the JAX package) runs planar f64 on the H100's FP64 units, at every n
    and on every plan the planner takes. ``"df64"`` and ``"df64-fused"``
    run the paired-f32 engine with one dd leaf kernel per leaf,
    ``"df64-split"`` runs each leaf as two dd column passes with a
    transpose between. A planner built with ``"df64-oz"``
    runs every split level whose inner plan is a leaf, with
    128 <= n1 <= 2048 and rows of A * 128 points, 8 <= A <= 64, on the
    Ozaki bf16-slice kernels (rel L2 ~1e-11 against ~1e-14), whatever the
    per-call engine; pair it with ``leaf_fft_size=2^13`` (n = 2^20..2^24,
    and the inner level of larger plans), as the JAX package asks. Other
    levels and leaves run the df64 kernels.
    """

    tiled_bit_reversal: Optional[bool] = None
    leaf_fft_size: int = DEFAULT_LEAF_SIZE
    #: None or True: the hand-written kernels (on CUDA tensors); False:
    #: their plain torch versions.
    use_pallas: Optional[bool] = None
    leaf_engine: str = "auto"
    strategy: str = "auto"
    leaf_kernel: Optional[str] = None
    col_engine: Optional[str] = None
    f64_engine: Optional[str] = None

    @staticmethod
    def guess_options(n: int, dtype=None) -> "Options":
        """Heuristic options for a transform of size ``n`` (and optionally
        element ``dtype``).

        The leaf rules are the JAX package's. f32: one leaf up to 2^16,
        and past it a leaf of min(2^14, n/128), so the split's column
        factor is at least 128 and the row length n2 = A * 128 has
        A <= 128. Any other dtype, and None, takes the f64 rule: a leaf of
        2^13 up to n = 2^21 and 2^16 past it, clamped to [256, n], with
        ``f64_engine=None``: the native engine, which won the H100 race
        against ``"df64"`` at every size from 2^10 to 2^28 (and against
        ``"df64-oz"`` where it runs), and is the one engine raced at 2^29
        and 2^30 (``PERF.md``'s race table).
        """
        log_n = max(n, 1).bit_length() - 1
        if dtype is not None and np.dtype(dtype) == np.float32:
            if n <= DEFAULT_LEAF_SIZE:
                leaf = min(max(n, 256), DEFAULT_LEAF_SIZE)
            else:
                leaf = min(1 << 14, n >> 7)
        else:
            leaf = (1 << 13) if log_n <= 21 else DEFAULT_LEAF_SIZE
            leaf = min(max(n, 256), leaf)
        return Options(
            tiled_bit_reversal=log_n >= TILED_BITREV_MIN_LOGN,
            leaf_fft_size=leaf,
        )
