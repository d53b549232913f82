"""Execution options and size-based heuristics.

Counterpart of the JAX package's ``options.py``: the same ``Options``
dataclass and field names, so one value can describe a call to either
package. ``guess_options`` keeps the f32 leaf rule, which fixes the plan
shape (``ops/fourstep.plan_rows``); the f64 rules of the JAX package are
left out, because f64 is not in the port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .errors import not_ported

__all__ = ["Options"]

#: Largest row transform executed as a single leaf.
DEFAULT_LEAF_SIZE = 1 << 16

#: log2(n) from which the staged strategy's bit reversal is tiled.
TILED_BITREV_MIN_LOGN = 14


@dataclasses.dataclass(frozen=True)
class Options:
    """Per-call tuning knobs. ``None`` fields mean "auto-select by size".

    The port reads ``leaf_fft_size`` (through the planner), ``strategy``
    and ``use_pallas``: ``strategy="staged"`` and ``use_pallas=False``
    name pipelines it does not run yet and raise ``NotImplementedError``,
    as does a ``leaf_fft_size`` outside 128..2^16 that the plan reaches.
    The other fields (``leaf_kernel``, ``leaf_engine``, ``col_engine``,
    ...) select TPU engines and are accepted and ignored: the port has one
    kernel per plan shape, and its leaf kernels take any batch.
    """

    tiled_bit_reversal: Optional[bool] = None
    leaf_fft_size: int = DEFAULT_LEAF_SIZE
    #: None or True: the hand-written kernels (on CUDA tensors).
    use_pallas: Optional[bool] = None
    leaf_engine: str = "auto"
    strategy: str = "auto"
    leaf_kernel: Optional[str] = None
    col_engine: Optional[str] = None
    f64_engine: Optional[str] = None

    @staticmethod
    def guess_options(n: int, dtype=np.float32) -> "Options":
        """Heuristic options for an f32 transform of size ``n``.

        The leaf rule is the JAX package's f32 rule: one leaf up to 2^16,
        and past it a leaf of min(2^14, n/128), so the split's column
        factor is at least 128 and the row length n2 = A * 128 has
        A <= 128. Other dtypes raise: f64 is not ported yet.
        """
        if np.dtype(dtype) != np.float32:
            raise not_ported(f"{np.dtype(dtype)} options", "f64")
        log_n = max(n, 1).bit_length() - 1
        if n <= DEFAULT_LEAF_SIZE:
            leaf = min(max(n, 256), DEFAULT_LEAF_SIZE)
        else:
            leaf = min(1 << 14, n >> 7)
        return Options(
            tiled_bit_reversal=log_n >= TILED_BITREV_MIN_LOGN,
            leaf_fft_size=leaf,
        )
