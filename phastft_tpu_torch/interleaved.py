"""Interleaved-complex public API.

Counterpart of the JAX package's ``interleaved.py`` (the reference's
``fft_{32,64}_interleaved`` wrappers): deinterleave, the planar FFT,
recombine. A copying convenience; planar is the fast format.

The signal is a complex array or tensor, or a real one of interleaved
(re, im) pairs (a trailing unpaired scalar dropped). The result is a
complex64 (f32) or complex128 (f64) tensor on the planner's device: the
card holds complex128, so the JAX package's combine on the host does not
carry over. The auto-planned entries plan for the number of complex points,
so the flat form runs there too.
"""

from __future__ import annotations

import torch

from .errors import ensure_power_of_two
from .fft import (
    _cached_planner,
    _coerce_direction,
    _length,
    fft_32_dit_with_planner_and_opts,
    fft_64_dit_with_planner_and_opts,
)
from .options import Options
from .ops.complex_interop import deinterleave
from .planner import resolve_device

__all__ = [
    "fft_64_interleaved",
    "fft_32_interleaved",
    "fft_64_interleaved_with_planner",
    "fft_32_interleaved_with_planner",
    "fft_64_interleaved_with_planner_and_opts",
    "fft_32_interleaved_with_planner_and_opts",
]


def _run_interleaved(signal, direction, planner, opts, bits):
    direction = _coerce_direction(direction)
    re, im = deinterleave(signal)
    run = (
        fft_64_dit_with_planner_and_opts
        if bits == 64
        else fft_32_dit_with_planner_and_opts
    )
    out_re, out_im = run(re, im, direction, planner, opts)
    return torch.complex(out_re, out_im)


def fft_64_interleaved_with_planner_and_opts(signal, direction, planner, opts):
    """Interleaved complex128 FFT with an explicit ``PlannerDit64`` and
    options."""
    return _run_interleaved(signal, direction, planner, opts, 64)


def fft_32_interleaved_with_planner_and_opts(signal, direction, planner, opts):
    """Interleaved complex64 FFT with an explicit ``PlannerDit32`` and
    options."""
    return _run_interleaved(signal, direction, planner, opts, 32)


def fft_64_interleaved_with_planner(signal, direction, planner):
    """Interleaved complex128 FFT with a reusable planner, on per-call
    ``Options.guess_options(n)`` (as the planar entries)."""
    return _run_interleaved(signal, direction, planner,
                            Options.guess_options(planner.n), 64)


def fft_32_interleaved_with_planner(signal, direction, planner):
    """Interleaved complex64 FFT with a reusable planner."""
    return _run_interleaved(signal, direction, planner,
                            Options.guess_options(planner.n), 32)


def _points(signal) -> int:
    """Complex points of an interleaved signal (a power of two)."""
    n = _length(deinterleave(signal)[0])
    ensure_power_of_two(max(n, 1))
    return n


def fft_64_interleaved(signal, direction, device=None):
    """Interleaved complex128 FFT, auto-planned, on ``device`` (None =
    "cuda")."""
    n = _points(signal)
    return fft_64_interleaved_with_planner(
        signal, direction, _cached_planner(n, 64, resolve_device(device)))


def fft_32_interleaved(signal, direction, device=None):
    """Interleaved complex64 FFT, auto-planned, on ``device`` (None =
    "cuda")."""
    n = _points(signal)
    return fft_32_interleaved_with_planner(
        signal, direction, _cached_planner(n, 32, resolve_device(device)))
