"""Public R2C / C2R API: compact-spectrum real transforms.

Counterpart of the JAX package's ``real_fft.py``, with its ten entries,
checks, error classes and messages. The forward returns the compact
``N/2 + 1`` spectrum (bins k in (N/2, N) are ``conj(X[N - k])``; the DC and
Nyquist bins are real); the inverse takes it and returns the N reals, scaled
so that C2R(R2C(x)) == x.

Numpy arrays or torch tensors go in (leading batch dimensions allowed);
tensors on the planner's device come out, and the caller's inputs are never
written. The half-length transform inside runs the port's own C2C path on
the inner planner's engine, picked by ``fft.engine_of`` as for the C2C
entries: f32 on the planner's leaf kernel, f64 on the native engine unless
the inner planner's ``f64_engine`` starts with "df64" (then the df64
engine, whose "df64-oz" tables arm the Ozaki kernels). The untangles run in the planner's dtype on
the joined spectrum (``ops/r2c.py``). An inner planner built on
``Options(use_pallas=False)`` (``inner_options``) runs the whole transform,
the four passes and the half-length C2C, on the plain versions, as the JAX
package passes its ``use_pallas`` on: an oracle that launches no kernel. ``*_with_planner_and_scratch`` takes
``scratch`` and ignores it, as the JAX package does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .errors import (
    LengthMismatchError,
    NonPowerOfTwoError,
    PlannerSizeMismatchError,
    ensure_power_of_two,
)
from .fft import _as_tensor, engine_of
from .planner import PlannerR2c32, PlannerR2c64, resolve_device
from .ops.r2c import build_c2r_fft, build_r2c_fft
from .tracing import span, traced

__all__ = [
    "r2c_fft_f64",
    "r2c_fft_f32",
    "r2c_fft_f64_with_planner",
    "r2c_fft_f32_with_planner",
    "c2r_fft_f64",
    "c2r_fft_f32",
    "c2r_fft_f64_with_planner",
    "c2r_fft_f32_with_planner",
    "c2r_fft_f64_with_planner_and_scratch",
    "c2r_fft_f32_with_planner_and_scratch",
]


@functools.lru_cache(maxsize=64)
@traced("phastft.plan")
def _cached_planner(n: int, bits: int, device: torch.device):
    cls = PlannerR2c64 if bits == 64 else PlannerR2c32
    return cls(n, device=device)


def _shape(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(np.shape(x))


@traced("phastft.real")
def _r2c(signal, planner):
    n = _shape(signal)[-1] if _shape(signal) else 0
    ensure_power_of_two(n)
    if n < 4:
        raise NonPowerOfTwoError(
            f"R2C requires n to be a power of 2 and n >= 4, got {n}"
        )
    if planner.n != n:
        raise PlannerSizeMismatchError(
            f"planner is for size {planner.n} but input has size {n}; "
            "planner size must match the input size"
        )
    build, variant, args = engine_of(planner.dit_planner)
    run = build_r2c_fft(n, planner.dit_planner.options.leaf_fft_size, build, variant)
    return run(_as_tensor(signal, planner), args, planner.twiddles_re,
               planner.twiddles_im)


@traced("phastft.real")
def _c2r(spec_re, spec_im, planner):
    shape, other = _shape(spec_re), _shape(spec_im)
    if shape != other:
        raise LengthMismatchError(
            f"spec_re and spec_im must be of equal length, got "
            f"{shape} and {other}"
        )
    np1 = shape[-1] if shape else 0
    n = planner.n
    if np1 != n // 2 + 1:
        raise LengthMismatchError(
            f"spec_re must have length N/2 + 1 = {n // 2 + 1}, got {np1}"
        )
    build, variant, args = engine_of(planner.dit_planner)
    run = build_c2r_fft(n, planner.dit_planner.options.leaf_fft_size, build, variant)
    return run(_as_tensor(spec_re, planner), _as_tensor(spec_im, planner), args,
               planner.twiddles_re, planner.twiddles_im)


def _signal_length(signal) -> int:
    shape = _shape(signal)
    n = shape[-1] if shape else 0
    ensure_power_of_two(max(n, 1))
    return n


def _spectrum_length(spec_re) -> int:
    shape = _shape(spec_re)
    n = 2 * ((shape[-1] if shape else 0) - 1)
    ensure_power_of_two(max(n, 1))
    return n


def r2c_fft_f64_with_planner(signal, planner):
    """Forward R2C with a reusable ``PlannerR2c64``. Returns (spec_re,
    spec_im) of length N/2 + 1 on the planner's device."""
    return _r2c(signal, planner)


def r2c_fft_f32_with_planner(signal, planner):
    """f32 forward R2C with a reusable ``PlannerR2c32``."""
    return _r2c(signal, planner)


def r2c_fft_f64(signal, device=None):
    """Forward R2C, auto-planned, on ``device`` (None = "cuda"): about half
    the work of a zero-imaginary C2C of the same length (the inner complex
    FFT is half-length)."""
    n = _signal_length(signal)
    return _r2c(signal, _cached_planner(n, 64, resolve_device(device)))


def r2c_fft_f32(signal, device=None):
    """f32 forward R2C, auto-planned, on ``device`` (None = "cuda")."""
    n = _signal_length(signal)
    return _r2c(signal, _cached_planner(n, 32, resolve_device(device)))


def c2r_fft_f64_with_planner(spec_re, spec_im, planner):
    """Inverse C2R with a reusable ``PlannerR2c64``. Returns the length-N
    real signal on the planner's device."""
    return _c2r(spec_re, spec_im, planner)


def c2r_fft_f32_with_planner(spec_re, spec_im, planner):
    """f32 inverse C2R with a reusable ``PlannerR2c32``."""
    return _c2r(spec_re, spec_im, planner)


def c2r_fft_f64(spec_re, spec_im, device=None):
    """Inverse C2R, auto-planned (N = 2 * (len - 1)), on ``device`` (None =
    "cuda")."""
    n = _spectrum_length(spec_re)
    return _c2r(spec_re, spec_im, _cached_planner(n, 64, resolve_device(device)))


def c2r_fft_f32(spec_re, spec_im, device=None):
    """f32 inverse C2R, auto-planned, on ``device`` (None = "cuda")."""
    n = _spectrum_length(spec_re)
    return _c2r(spec_re, spec_im, _cached_planner(n, 32, resolve_device(device)))


def c2r_fft_f64_with_planner_and_scratch(spec_re, spec_im, planner, scratch=None):
    """``c2r_fft_f64_with_planner`` with the reference's scratch argument,
    accepted for call-site parity and ignored (as in the JAX package): the
    port allocates its intermediates and frees each once it is read."""
    del scratch
    return _c2r(spec_re, spec_im, planner)


def c2r_fft_f32_with_planner_and_scratch(spec_re, spec_im, planner, scratch=None):
    """f32 variant of :func:`c2r_fft_f64_with_planner_and_scratch`."""
    del scratch
    return _c2r(spec_re, spec_im, planner)
