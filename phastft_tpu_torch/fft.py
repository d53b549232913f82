"""Public C2C API: validation, direction handling, dispatch.

Counterpart of the JAX package's ``fft.py``. Contracts kept:

* normal-order input, normal-order output;
* only the inverse scales, by 1/N;
* errors on non-power-of-2 length, length mismatch, planner-size mismatch,
  with the JAX package's classes and messages;
* leading batch dimensions; the transform runs along the last axis.

Numpy arrays or torch tensors go in; torch tensors on the planner's device
come out. An input of another dtype is converted to the planner's, as the
JAX package converts it; a tensor must lie on the planner's device. Unlike
the JAX package, which donates its input buffers, the port never writes the
caller's tensors: every result is a new tensor.

The port plans planar f32 for every power of two n, one H100 holding C2C
to 2^31 (one leaf kernel up to 2^16, the fused two-pass pipeline to 2^25,
a classic outer level around it above, and classic levels wherever
``Options.leaf_fft_size`` forces a split the fused pipeline refuses;
``leaf_kernel="hybrid"``, per call or on the planner, runs the leaves on
the opt-in hybrid kernel), and planar f64 for every power of two, one
H100 holding 2^30, ``f64_engine`` resolved as the JAX package resolves it
(a per-call value that is not None, else the planner's, else
``"native"``): the native engine on the FP64 units (every split level
classic), or the df64 (paired-f32) engine, ``"df64"``, ``"df64-fused"``,
``"df64-split"`` or ``"df64-oz"``. A planner built with ``"df64-oz"`` runs
its split levels inside the Ozaki kernels' window on them, whatever the
per-call engine; the leaves and other levels run the df64 kernels. The
``*_with_planner`` entries pass ``Options.guess_options(n)`` per call, as
the JAX package does: its ``f64_engine`` is None at every n, so the
planner's engine decides.

Two oracles run as in the JAX package, on the card or the CPU, launching
no kernel. ``Options(strategy="staged")`` (per call: the per-call
``guess_options`` of the ``*_with_planner`` entries has "auto") runs the
reference-parity radix-2 path on the planner's ``stage_twiddles``, its bit
reversal tiled from ``TILED_BITREV_MIN_LOGN`` unless
``tiled_bit_reversal`` says otherwise (``ops/dit.staged_fft``).
``Options(use_pallas=False)``, per call or on the planner (the per-call
value, when not None, wins), runs the planner's engine on every pass's
plain torch version (``ops/route.PLAIN``), the port's counterpart of the
JAX package's XLA lowering. Nothing else selects either.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .errors import (
    LengthMismatchError,
    PhastftError,
    PlannerSizeMismatchError,
    ensure_power_of_two,
)
from .options import TILED_BITREV_MIN_LOGN, Options
from .planner import Direction, PlannerDit32, PlannerDit64, resolve_device
from .ops.dit import build_dd_fft, build_fast_fft, build_native_fft, build_staged_fft
from .tracing import span, traced

__all__ = [
    "fft_64_dit",
    "fft_32_dit",
    "fft_64_dit_with_planner",
    "fft_32_dit_with_planner",
    "fft_64_dit_with_planner_and_opts",
    "fft_32_dit_with_planner_and_opts",
]


def _validate(reals, imags, planner):
    """Shape/size validation shared by all entries, on the shapes alone
    (numpy arrays, tensors or nested lists), before any data is read."""
    shape, other = tuple(np.shape(reals)), tuple(np.shape(imags))
    if shape != other:
        raise LengthMismatchError(
            f"reals and imags must be of equal length, got {shape} "
            f"and {other}"
        )
    n = int(shape[-1]) if shape else 0
    log_n = ensure_power_of_two(n)
    if planner.n != n:
        raise PlannerSizeMismatchError(
            f"planner is for size {planner.n} but input has size {n}; "
            "planner size must match the input size"
        )
    return n, log_n


def _coerce_direction(direction) -> Direction:
    """Accept the Direction enum or the 'f'/'r' chars of the reference's
    Python bindings; reject anything else."""
    if isinstance(direction, Direction):
        return direction
    if direction in ("f", "forward"):
        return Direction.Forward
    if direction in ("r", "reverse", "i", "inverse"):
        return Direction.Reverse
    raise PhastftError(
        f"direction must be Direction.Forward/Reverse or 'f'/'r', got "
        f"{direction!r}"
    )


def _as_tensor(x, planner) -> torch.Tensor:
    """``x`` as a contiguous, 16-byte aligned tensor of the planner's dtype
    on its device (converted from another dtype, as the JAX package
    converts it). The kernels load float4s, so a view that starts off a
    16-byte boundary (``buf[1:1 + n]``) is copied; an aligned contiguous
    tensor of the right dtype is returned as it is."""
    device = planner.device
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise PhastftError(
                f"input is on {x.device} but the planner is on {device}"
            )
        want = torch.float64 if planner.dtype == np.float64 else torch.float32
        if x.dtype == want and x.is_contiguous() and x.data_ptr() % 16 == 0:
            return x
    with span("phastft.convert"):
        if isinstance(x, torch.Tensor):
            out = x.to(want).contiguous()
        else:
            arr = np.ascontiguousarray(np.asarray(x, dtype=planner.dtype))
            if not arr.flags.writeable:  # torch tensors cannot wrap read-only memory
                arr = arr.copy()
            out = torch.from_numpy(arr).to(device)
        if out.data_ptr() % 16:
            out = out.clone()
        return out


def _length(x) -> int:
    if isinstance(x, torch.Tensor):
        return int(x.shape[-1]) if x.dim() else 0
    return int(np.shape(x)[-1]) if np.ndim(x) else 0


def engine_of(planner, f64_engine=None, leaf_kernel=None, use_pallas=None):
    """(build, variant, args) of the planner's C2C engine: the closure
    builder of ``ops/dit.py``, called as ``build(n, leaf, scale,
    *variant)``, and the planner state its closure takes after the two
    planes, ``run(re, im, *args)``.

    An explicit ``f64_engine`` / ``leaf_kernel`` / ``use_pallas`` (per-call
    options) wins over the planner's; None defers. A resolved
    ``use_pallas`` of False puts the plain route in ``variant``, its last
    element. f64 runs the native engine, as the JAX
    package runs every value that does not start with "df64"; "df64-split" /
    "df64-fused" pin the dd leaf lowering, and an unknown suffix ("oz" among
    them) falls to the default, the one-kernel leaf. The Ozaki kernels run
    where the planner built their tables. f32 runs the leaf kernel on its
    tables."""
    plain = (use_pallas if use_pallas is not None
             else planner.options.use_pallas) is False
    if planner.dtype == np.float64:
        engine = (f64_engine if f64_engine is not None
                  else (planner.options.f64_engine or "native"))
        if not engine.startswith("df64"):
            return build_native_fft, (plain,), (planner.native_state,)
        dd_leaf = engine.split("-", 1)[1] if "-" in engine else None
        return build_dd_fft, (dd_leaf, plain), planner.dd_state
    kernel = leaf_kernel if leaf_kernel is not None else planner.options.leaf_kernel
    return build_fast_fft, (kernel, plain), (planner.tables_for(planner.plan, kernel),)


@traced("phastft.fft")
def _run(reals, imags, direction, planner, opts: Options):
    direction = _coerce_direction(direction)
    n, log_n = _validate(reals, imags, planner)
    scale = direction is Direction.Reverse
    if opts.strategy == "staged":
        tiled = opts.tiled_bit_reversal
        if tiled is None:
            tiled = log_n >= TILED_BITREV_MIN_LOGN
        run = build_staged_fft(n, bool(tiled), scale)
        args = (planner.stage_twiddles,)
    else:
        # The leaf size must match the planner's tables, so it comes from
        # the planner's own options, not the per-call opts.
        build, variant, args = engine_of(planner, opts.f64_engine, opts.leaf_kernel,
                                         opts.use_pallas)
        run = build(n, planner.options.leaf_fft_size, scale, *variant)
    # handed over: a conversion made here is dropped once the first kernel
    # has read it (a tensor of the caller's stays the caller's)
    pair = [_as_tensor(reals, planner), _as_tensor(imags, planner)]
    if direction is Direction.Forward:
        return run.take(pair, *args)
    # IFFT swap trick: swap(IDFT(z)) = (1/N) DFT(swap(z)); feed (im, re)
    # and swap the outputs back.
    pair.reverse()
    out_re, out_im = run.take(pair, *args)
    return out_im, out_re


@functools.lru_cache(maxsize=64)
@traced("phastft.plan")
def _cached_planner(n: int, bits: int, device: torch.device):
    cls = PlannerDit64 if bits == 64 else PlannerDit32
    return cls(n, device=device)


def fft_32_dit_with_planner_and_opts(reals, imags, direction, planner, opts):
    """f32 planar C2C FFT with explicit planner and options."""
    return _run(reals, imags, direction, planner, opts)


def fft_32_dit_with_planner(reals, imags, direction, planner):
    """f32 planar C2C FFT with a reusable planner, on per-call
    ``Options.guess_options(n)`` as in the JAX package: its fields are
    None or "auto", so the planner's ``leaf_kernel`` and tables decide."""
    return _run(reals, imags, direction, planner,
                Options.guess_options(_length(reals)))


def fft_32_dit(reals, imags, direction, device=None):
    """f32 planar C2C FFT, auto-planned, on ``device`` (None = "cuda").

    Returns (reals, imags) as new f32 tensors on that device."""
    n = _length(reals)
    ensure_power_of_two(n)
    planner = _cached_planner(n, 32, resolve_device(device))
    return fft_32_dit_with_planner(reals, imags, direction, planner)


def fft_64_dit_with_planner_and_opts(reals, imags, direction, planner, opts):
    """f64 planar C2C FFT with explicit planner and options.
    ``opts.f64_engine``, when not None, overrides the planner's, and None
    on both runs the native engine; the Ozaki kernels run wherever the
    planner built their tables."""
    return _run(reals, imags, direction, planner, opts)


def fft_64_dit_with_planner(reals, imags, direction, planner):
    """f64 planar C2C FFT with a reusable planner, on per-call
    ``Options.guess_options(n)`` as in the JAX package: its ``f64_engine``
    is None, so the planner's engine runs."""
    return _run(reals, imags, direction, planner,
                Options.guess_options(_length(reals)))


def fft_64_dit(reals, imags, direction, device=None):
    """f64 planar C2C FFT, auto-planned, on ``device`` (None = "cuda").

    Returns (reals, imags) as new f64 tensors on that device."""
    n = _length(reals)
    ensure_power_of_two(n)
    planner = _cached_planner(n, 64, resolve_device(device))
    return fft_64_dit_with_planner(reals, imags, direction, planner)
