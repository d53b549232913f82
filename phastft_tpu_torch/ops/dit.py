"""Transform builder.

Counterpart of ``build_fast_fft`` (f32, and f64 on the native engine) and
``build_dd_fft`` in the JAX package's ``ops/dit.py``, without ``jit``: PyTorch runs eagerly, so a
"build" is the plan and a closure over it, cached per configuration.

Each closure ``run(re, im, *state)`` reads the caller's planes and never
writes them. ``run.take(pair, *state)`` is the same transform on planes
handed over in the list ``pair``, which it empties: its first kernel reads
them and lets them go, so a caller that made the planes itself (the real
transforms' deinterleaved pair, or a conversion of the caller's input)
does not hold them through the transform.
"""

from __future__ import annotations

import functools

__all__ = ["build_fast_fft", "build_dd_fft", "build_native_fft"]


def _closure(take):
    """``run(re, im, *state) = take([re, im], *state)``, with ``run.take``."""

    def run(re, im, *state):
        return take([re, im], *state)

    run.take = take
    return run


def _scaled(out_re, out_im, n: int, scale: bool):
    """The outputs times 1/n in place when ``scale`` (the inverse): they are
    freshly allocated, never the caller's."""
    if scale:
        inv_n = 1.0 / n
        out_re.mul_(inv_n)
        out_im.mul_(inv_n)
    return out_re, out_im


@functools.lru_cache(maxsize=256)
def build_fast_fft(n: int, leaf_limit: int, scale: bool, leaf_kernel=None):
    """Callable (re, im, corrs) -> (re, im) running the plan of a length-n
    transform with the planner's tables ``corrs``; ``scale`` multiplies
    the result by 1/n (the inverse). ``leaf_kernel`` is the resolved
    ``Options.leaf_kernel`` ("hybrid" runs the leaves on the hybrid
    kernel)."""
    from .fourstep import plan_rows, rows_f32

    plan = plan_rows(n, leaf_limit)

    def take(pair, corrs):
        return _scaled(*rows_f32(pair, plan, corrs, leaf_kernel), n, scale)

    return _closure(take)


@functools.lru_cache(maxsize=64)
def build_dd_fft(n: int, leaf_limit: int, scale: bool, dd_leaf=None):
    """Callable (re, im, tables, corrs) -> (re, im) for the df64 engine:
    f64 tensors in, f64 out, all arithmetic between on four f32 planes
    (``ops/fourstep.fft_rows_dd``) with the planner's ``dd_state``. The
    hi/lo split and join are plain elementwise passes at the two ends;
    ``scale`` multiplies the joined result by 1/n in f64, a power of two
    and so exact. ``dd_leaf`` pins the leaf lowering ("split"; anything
    else is the one-kernel leaf)."""
    from .df64 import split_f64
    from .fourstep import plan_rows, rows_dd

    plan = plan_rows(n, leaf_limit)

    def take(pair, tables, corrs):
        re, im = pair
        pair.clear()
        hi_lo = split_f64(re)
        del re
        quad = [*hi_lo, *split_f64(im)]
        del hi_lo, im
        rh, rl, ih, il = rows_dd(quad, plan, tables, corrs, dd_leaf)
        out_re = rh.double()
        out_re += rl
        del rh, rl
        out_im = ih.double()
        out_im += il
        del ih, il
        return _scaled(out_re, out_im, n, scale)

    return _closure(take)


@functools.lru_cache(maxsize=64)
def build_native_fft(n: int, leaf_limit: int, scale: bool):
    """Callable (re, im, corrs) -> (re, im) for the native f64 engine: f64
    planes through ``ops/fourstep.fft_rows_native`` with the planner's
    ``native_state``, the JAX package's f64 use of its ``build_fast_fft``.
    ``scale`` multiplies the result by 1/n in f64 after the rows."""
    from .fourstep import plan_rows, rows_native

    plan = plan_rows(n, leaf_limit)

    def take(pair, corrs):
        return _scaled(*rows_native(pair, plan, corrs), n, scale)

    return _closure(take)
