"""Transform builder.

Counterpart of ``build_fast_fft`` in the JAX package's ``ops/dit.py``,
without ``jit``: PyTorch runs eagerly, so a "build" is the plan and a
closure over it, cached per (n, leaf, scale).
"""

from __future__ import annotations

import functools

__all__ = ["build_fast_fft"]


@functools.lru_cache(maxsize=256)
def build_fast_fft(n: int, leaf_limit: int, scale: bool):
    """Callable (re, im, corrs) -> (re, im) running the plan of a length-n
    transform with the planner's tables ``corrs``; ``scale`` multiplies
    the result by 1/n (the inverse). The scale is applied in place to the
    freshly allocated outputs, never to the caller's tensors."""
    from .fourstep import fft_rows, plan_rows

    plan = plan_rows(n, leaf_limit)

    def run(re, im, corrs):
        out_re, out_im = fft_rows(re, im, plan, corrs)
        if scale:
            inv_n = 1.0 / n
            out_re.mul_(inv_n)
            out_im.mul_(inv_n)
        return out_re, out_im

    return run
