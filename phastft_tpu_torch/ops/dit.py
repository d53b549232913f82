"""Transform builder.

Counterpart of ``build_fast_fft`` (f32, and f64 on the native engine) and
``build_dd_fft`` in the JAX package's ``ops/dit.py``, without ``jit``: PyTorch runs eagerly, so a
"build" is the plan and a closure over it, cached per configuration.
"""

from __future__ import annotations

import functools

__all__ = ["build_fast_fft", "build_dd_fft", "build_native_fft"]


@functools.lru_cache(maxsize=256)
def build_fast_fft(n: int, leaf_limit: int, scale: bool, leaf_kernel=None):
    """Callable (re, im, corrs) -> (re, im) running the plan of a length-n
    transform with the planner's tables ``corrs``; ``scale`` multiplies
    the result by 1/n (the inverse). The scale is applied in place to the
    freshly allocated outputs, never to the caller's tensors.
    ``leaf_kernel`` is the resolved ``Options.leaf_kernel`` ("hybrid" runs
    the leaves on the hybrid kernel)."""
    from .fourstep import fft_rows, plan_rows

    plan = plan_rows(n, leaf_limit)

    def run(re, im, corrs):
        out_re, out_im = fft_rows(re, im, plan, corrs, leaf_kernel)
        if scale:
            inv_n = 1.0 / n
            out_re.mul_(inv_n)
            out_im.mul_(inv_n)
        return out_re, out_im

    return run


@functools.lru_cache(maxsize=64)
def build_dd_fft(n: int, leaf_limit: int, scale: bool, dd_leaf=None):
    """Callable (re, im, tables, corrs) -> (re, im) for the df64 engine:
    f64 tensors in, f64 out, all arithmetic between on four f32 planes
    (``ops/fourstep.fft_rows_dd``) with the planner's ``dd_state``. The
    hi/lo split and join are plain elementwise passes at the two ends;
    ``scale`` multiplies the joined result by 1/n in f64, a power of two
    and so exact. ``dd_leaf`` pins the leaf lowering ("split"; anything
    else is the one-kernel leaf). The caller's tensors are never written."""
    from .df64 import split_f64
    from .fourstep import fft_rows_dd, plan_rows

    plan = plan_rows(n, leaf_limit)

    def run(re, im, tables, corrs):
        quad = fft_rows_dd(*split_f64(re), *split_f64(im), plan, tables,
                           corrs, dd_leaf)
        rh, rl, ih, il = quad
        del quad
        out_re = rh.double()
        out_re += rl
        del rh, rl
        out_im = ih.double()
        out_im += il
        del ih, il
        if scale:
            inv_n = 1.0 / n
            out_re.mul_(inv_n)
            out_im.mul_(inv_n)
        return out_re, out_im

    return run


@functools.lru_cache(maxsize=64)
def build_native_fft(n: int, leaf_limit: int, scale: bool):
    """Callable (re, im, corrs) -> (re, im) for the native f64 engine: f64
    planes through ``ops/fourstep.fft_rows_native`` with the planner's
    ``native_state``, the JAX package's f64 use of its ``build_fast_fft``.
    ``scale`` multiplies the result by 1/n in f64 after the rows, in place
    on the freshly allocated outputs; the caller's tensors are never
    written."""
    from .fourstep import fft_rows_native, plan_rows

    plan = plan_rows(n, leaf_limit)

    def run(re, im, corrs):
        out_re, out_im = fft_rows_native(re, im, plan, corrs)
        if scale:
            inv_n = 1.0 / n
            out_re.mul_(inv_n)
            out_im.mul_(inv_n)
        return out_re, out_im

    return run
