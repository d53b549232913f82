"""Transform builders, and the staged radix-2 strategy.

Counterpart of ``build_fast_fft`` (f32, and f64 on the native engine),
``build_dd_fft`` and ``build_staged_fft`` in the JAX package's
``ops/dit.py``, without ``jit``: PyTorch runs eagerly, so a "build" is the
plan and a closure over it, cached per configuration. ``plain`` (a resolved
``Options.use_pallas`` of False, part of the cache key as the JAX package's
``use_pallas`` is) runs every pass on its plain version
(``ops/route.PLAIN``) on any device: the oracle route, which launches no
kernel.

The staged strategy (``butterfly_stage``, ``staged_fft``) is the JAX
package's reference-parity path: a bit reversal (``ops/bitrev.py``) and
log2(n) radix-2 butterfly stages,

    stage s:   view (..., n) as (..., n/2h, 2, h),  h = 2^s
               a = x[..., 0, :], b = x[..., 1, :], t = w_s * b
               out = [a + t, a - t] restacked

in plain torch on any device, as the JAX package runs it in XLA and not
in Pallas. It is an oracle, far slower than the default engine, and runs
no kernel.

The inverse's 1/n: the fast f32 and native f64 builders hand it to the
rows (``out_scale``), whose last kernel multiplies each value before its
store, so it costs no pass of its own; the df64 and Ozaki engines (the scale
follows the f64 join) and the staged oracle multiply after their last
operation (``scale_``, the ``phastft.scale`` span).

Each closure ``run(re, im, *state)`` reads the caller's planes and never
writes them. ``run.take(pair, *state)`` is the same transform on planes
handed over in the list ``pair``, which it empties: its first kernel reads
them and lets them go, so a caller that made the planes itself (the real
transforms' deinterleaved pair, or a conversion of the caller's input)
does not hold them through the transform.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from .. import tracing
from ..tracing import span
from .bitrev import apply_bit_reversal
from .route import passes_for

__all__ = ["build_fast_fft", "build_dd_fft", "build_native_fft", "build_staged_fft",
           "butterfly_stage", "scale_", "staged_fft"]


def _closure(take):
    """``run(re, im, *state) = take([re, im], *state)``, with ``run.take``."""

    def run(re, im, *state):
        return take([re, im], *state)

    run.take = take
    return run


def scale_(out_re, out_im, n: int):
    """The outputs times 1/n in place, a pass of its own (the
    ``phastft.scale`` span, counted as ``tracing.scales["torch"]``): they
    are freshly allocated, never the caller's."""
    inv_n = 1.0 / n
    with span("phastft.scale"):
        out_re.mul_(inv_n)
        out_im.mul_(inv_n)
    tracing.scales["torch"] += 1
    return out_re, out_im


@functools.lru_cache(maxsize=256)
def build_fast_fft(n: int, leaf_limit: int, scale: bool, leaf_kernel=None,
                   plain: bool = False):
    """Callable (re, im, corrs) -> (re, im) running the plan of a length-n
    transform with the planner's tables ``corrs``; ``scale`` multiplies
    the result by 1/n (the inverse) in the last kernel's stores.
    ``leaf_kernel`` is the resolved
    ``Options.leaf_kernel`` ("hybrid" runs the leaves on the hybrid
    kernel); ``plain`` runs the passes' plain versions."""
    from .fourstep import plan_rows, rows_f32

    with span("phastft.plan"):
        plan = plan_rows(n, leaf_limit)
        passes = passes_for(plain)

    out_scale = 1.0 / n if scale else 1.0

    def take(pair, corrs):
        return rows_f32(pair, plan, corrs, leaf_kernel, passes, out_scale)

    return _closure(take)


@functools.lru_cache(maxsize=64)
def build_dd_fft(n: int, leaf_limit: int, scale: bool, dd_leaf=None, plain: bool = False):
    """Callable (re, im, tables, corrs) -> (re, im) for the df64 engine:
    f64 tensors in, f64 out, all arithmetic between on four f32 planes
    (``ops/fourstep.fft_rows_dd``) with the planner's ``dd_state``. The
    hi/lo split and join are plain elementwise passes at the two ends;
    ``scale`` multiplies the joined result by 1/n in f64, a power of two
    and so exact. ``dd_leaf`` pins the leaf lowering ("split"; anything
    else is the one-kernel leaf); ``plain`` runs the passes' plain
    versions."""
    from .df64 import split_f64
    from .fourstep import plan_rows, rows_dd

    with span("phastft.plan"):
        plan = plan_rows(n, leaf_limit)
        passes = passes_for(plain)

    def take(pair, tables, corrs):
        re, im = pair
        pair.clear()
        hi_lo = split_f64(re)
        del re
        quad = [*hi_lo, *split_f64(im)]
        del hi_lo, im
        rh, rl, ih, il = rows_dd(quad, plan, tables, corrs, dd_leaf, passes)
        out_re = rh.double()
        out_re += rl
        del rh, rl
        out_im = ih.double()
        out_im += il
        del ih, il
        return scale_(out_re, out_im, n) if scale else (out_re, out_im)

    return _closure(take)


@functools.lru_cache(maxsize=64)
def build_native_fft(n: int, leaf_limit: int, scale: bool, plain: bool = False):
    """Callable (re, im, corrs) -> (re, im) for the native f64 engine: f64
    planes through ``ops/fourstep.fft_rows_native`` with the planner's
    ``native_state``, the JAX package's f64 use of its ``build_fast_fft``.
    ``scale`` multiplies the result by 1/n in f64 in the last kernel's
    stores; ``plain`` runs the passes' plain versions."""
    from .fourstep import plan_rows, rows_native

    with span("phastft.plan"):
        plan = plan_rows(n, leaf_limit)
        passes = passes_for(plain)

    out_scale = 1.0 / n if scale else 1.0

    def take(pair, corrs):
        return rows_native(pair, plan, corrs, passes, out_scale)

    return _closure(take)


def butterfly_stage(re, im, wre, wim, stage: int):
    """DIT butterfly stage ``stage`` (pair distance h = 2^stage) along the
    last axis of ``re``/``im`` (any batch shape), with the stage's twiddles
    ``wre``/``wim`` of length h; returns new planes."""
    n = re.shape[-1]
    h = 1 << stage
    batch = tuple(re.shape[:-1])
    shape3 = batch + (n // (2 * h), 2, h)
    re3, im3 = re.reshape(shape3), im.reshape(shape3)
    ar, br = re3[..., 0, :], re3[..., 1, :]
    ai, bi = im3[..., 0, :], im3[..., 1, :]
    tr = br * wre - bi * wim
    ti = br * wim + bi * wre
    out_re = torch.stack((ar + tr, ar - tr), dim=-2).reshape(batch + (n,))
    out_im = torch.stack((ai + ti, ai - ti), dim=-2).reshape(batch + (n,))
    return out_re, out_im


def staged_fft(re, im, stage_twiddles: Sequence, *, tiled_bitrev: bool, scale: bool):
    """Forward DFT along the last axis: the bit reversal, then every stage
    on ``stage_twiddles`` (stage s: (wre, wim) of length 2^s, the planner's
    ``stage_twiddles``); ``scale`` multiplies the result by 1/n after the
    last stage (the inverse)."""
    n = re.shape[-1]
    re = apply_bit_reversal(re, n, tiled_bitrev)
    im = apply_bit_reversal(im, n, tiled_bitrev)
    for s in range(n.bit_length() - 1):
        wre, wim = stage_twiddles[s]
        re, im = butterfly_stage(re, im, wre, wim, s)
    if scale:
        with span("phastft.scale"):
            re = re * (1.0 / n)
            im = im * (1.0 / n)
        tracing.scales["torch"] += 1
    return re, im


@functools.lru_cache(maxsize=256)
def build_staged_fft(n: int, tiled_bitrev: bool, scale: bool):
    """Callable (re, im, stage_twiddles) -> (re, im): ``staged_fft`` of a
    length-n transform, the planner's stage tables passed in."""

    def take(pair, stage_twiddles):
        re, im = pair
        pair.clear()
        return staged_fft(re, im, stage_twiddles, tiled_bitrev=tiled_bitrev, scale=scale)

    with span("phastft.plan"):
        return _closure(take)
