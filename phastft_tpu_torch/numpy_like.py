"""numpy.fft-compatible convenience layer.

Counterpart of the JAX package's ``numpy_like.py``: ``fft`` / ``ifft`` /
``rfft`` / ``irfft`` / ``hfft`` / ``ihfft``, their n-dimensional forms and
the helper family, with numpy's ``axis`` and ``norm`` semantics on
power-of-two lengths (the engine's contract; ``n`` / ``s`` must match the
input, nothing is padded), and the JAX package's ``PhastftError`` messages.

Numpy in, numpy out, as ``numpy.fft`` behaves: complex64 for float32 /
complex64 input, else complex128 (f64). The transforms run on the planar
entries of the port on ``device`` (a keyword-only argument; None = "cuda",
``"cpu"`` runs the plain torch versions); the n-dimensional complex forms
keep the planes on the device between axes and also take a tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import PhastftError
from .fft import _cached_planner, fft_32_dit_with_planner, fft_64_dit_with_planner
from .planner import Direction, resolve_device
from .real_fft import (
    _cached_planner as _cached_r2c_planner,
    c2r_fft_f32_with_planner,
    c2r_fft_f64_with_planner,
    r2c_fft_f32_with_planner,
    r2c_fft_f64_with_planner,
)

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "irfft", "rfft2", "irfft2", "rfftn", "irfftn",
    "hfft", "ihfft",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]


def _norm_scale(norm, n: int, forward: bool) -> float:
    """Extra scale on top of the engine's contract (forward unscaled,
    inverse 1/N) for numpy's norm conventions."""
    if norm is None or norm == "backward":
        return 1.0
    if norm == "ortho":
        return (1.0 / np.sqrt(n)) if forward else np.sqrt(n)
    if norm == "forward":
        return (1.0 / n) if forward else float(n)
    raise PhastftError(f"invalid norm: {norm!r}")


def _axis_last(a, axis):
    a = np.asarray(a)
    if axis not in (-1, a.ndim - 1):
        a = np.moveaxis(a, axis, -1)
    return a


def _axis_back(a, axis, ndim):
    if axis not in (-1, ndim - 1):
        return np.moveaxis(a, -1, axis)
    return a


def _complex(re, im, single: bool):
    """numpy complex64 / complex128 of two planes (tensors or arrays)."""
    if isinstance(re, torch.Tensor):
        re, im = re.cpu().numpy(), im.cpu().numpy()
    out = np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)
    return out.astype(np.complex64) if single else out


def _c2c(a, n, axis, norm, forward: bool, device):
    a = _axis_last(np.asarray(a), axis)
    if n is not None and n != a.shape[-1]:
        raise PhastftError(
            "n must equal the input length (power-of-2 engine; pad first)"
        )
    m = a.shape[-1]
    single = a.dtype in (np.complex64, np.float32)
    dt = np.float32 if single else np.float64
    re = np.ascontiguousarray(a.real, dt)
    im = (np.ascontiguousarray(a.imag, dt) if np.iscomplexobj(a)
          else np.zeros_like(re))
    run = fft_32_dit_with_planner if single else fft_64_dit_with_planner
    direction = Direction.Forward if forward else Direction.Reverse
    fre, fim = run(re, im, direction,
                   _cached_planner(m, 32 if single else 64, resolve_device(device)))
    out = _complex(fre, fim, single)
    s = _norm_scale(norm, m, forward=forward)
    if s != 1.0:
        out = out * s
    return _axis_back(out, axis, out.ndim)


def fft(a, n=None, axis=-1, norm=None, *, device=None):
    """Forward complex DFT, numpy.fft.fft semantics (power-of-2 n)."""
    return _c2c(a, n, axis, norm, True, device)


def ifft(a, n=None, axis=-1, norm=None, *, device=None):
    """Inverse complex DFT, numpy.fft.ifft semantics (1/N scaling)."""
    return _c2c(a, n, axis, norm, False, device)


def _fftn_planar(a, s, axes, norm, forward: bool, device):
    """The n-dimensional forms: the input split into planar tensors on the
    device once, every axis transformed there (moved last, the planar
    entry, moved back), the complex result assembled at the end."""
    shape = np.shape(a)
    ndim = len(shape)
    if axes is None:
        axes = tuple(range(ndim))
    if s is not None and tuple(s) != tuple(shape[ax] for ax in axes):
        raise PhastftError(
            "s must match the input shape (power-of-2 engine; pad first)"
        )
    dev = resolve_device(device)
    if isinstance(a, torch.Tensor):
        single = a.dtype in (torch.complex64, torch.float32)
        dt = torch.float32 if single else torch.float64
        a = a.to(dev)
        re = (a.real if a.is_complex() else a).to(dt)
        im = a.imag.to(dt) if a.is_complex() else torch.zeros_like(re)
    else:
        a = np.asarray(a)
        single = a.dtype in (np.complex64, np.float32)
        dt = np.float32 if single else np.float64
        re = torch.from_numpy(np.ascontiguousarray(a.real, dt)).to(dev)
        im = (torch.from_numpy(np.ascontiguousarray(a.imag, dt)).to(dev)
              if np.iscomplexobj(a) else torch.zeros_like(re))
    run = fft_32_dit_with_planner if single else fft_64_dit_with_planner
    bits = 32 if single else 64
    direction = Direction.Forward if forward else Direction.Reverse
    scale = 1.0
    for ax in axes:
        m = shape[ax]
        last = ax in (-1, ndim - 1)
        if not last:
            re = re.movedim(ax, -1)
            im = im.movedim(ax, -1)
        re, im = run(re, im, direction, _cached_planner(m, bits, dev))
        if not last:
            re = re.movedim(-1, ax)
            im = im.movedim(-1, ax)
        scale *= _norm_scale(norm, m, forward=forward)
    out = _complex(re, im, single)
    if scale != 1.0:
        out = out * scale
    return out


def fftn(a, s=None, axes=None, norm=None, *, device=None):
    """N-dimensional DFT as a separable sequence of 1-D transforms
    (numpy.fft.fftn semantics; every transformed length a power of 2)."""
    return _fftn_planar(a, s, axes, norm, True, device)


def ifftn(a, s=None, axes=None, norm=None, *, device=None):
    """N-dimensional inverse DFT (numpy.fft.ifftn semantics)."""
    return _fftn_planar(a, s, axes, norm, False, device)


def fft2(a, s=None, axes=(-2, -1), norm=None, *, device=None):
    """2-D DFT over the last two axes (numpy.fft.fft2 semantics)."""
    return fftn(a, s=s, axes=axes, norm=norm, device=device)


def ifft2(a, s=None, axes=(-2, -1), norm=None, *, device=None):
    """2-D inverse DFT over the last two axes."""
    return ifftn(a, s=s, axes=axes, norm=norm, device=device)


def rfft(a, n=None, axis=-1, norm=None, *, device=None):
    """Real-input DFT -> compact N/2+1 spectrum, numpy.fft.rfft semantics."""
    a = _axis_last(np.asarray(a), axis)
    if n is not None and n != a.shape[-1]:
        raise PhastftError(
            "n must equal the input length (power-of-2 engine; pad first)"
        )
    m = a.shape[-1]
    single = a.dtype == np.float32
    dev = resolve_device(device)
    if single:
        sre, sim = r2c_fft_f32_with_planner(
            np.ascontiguousarray(a, np.float32), _cached_r2c_planner(m, 32, dev))
    else:
        sre, sim = r2c_fft_f64_with_planner(
            np.ascontiguousarray(a, np.float64), _cached_r2c_planner(m, 64, dev))
    out = _complex(sre, sim, single)
    s = _norm_scale(norm, m, forward=True)
    if s != 1.0:
        out = out * s
    return _axis_back(out, axis, out.ndim)


def irfft(a, n=None, axis=-1, norm=None, *, device=None):
    """Inverse of rfft -> real signal of length n = 2*(m-1)."""
    a = _axis_last(np.asarray(a), axis)
    m = a.shape[-1]
    full = 2 * (m - 1)
    if n is not None and n != full:
        raise PhastftError(
            f"n must equal 2*(len-1) = {full} (power-of-2 engine)"
        )
    single = a.dtype == np.complex64
    dt = np.float32 if single else np.float64
    sre = np.ascontiguousarray(a.real, dt)
    sim = np.ascontiguousarray(a.imag, dt)
    dev = resolve_device(device)
    if single:
        sig = c2r_fft_f32_with_planner(sre, sim, _cached_r2c_planner(full, 32, dev))
    else:
        sig = c2r_fft_f64_with_planner(sre, sim, _cached_r2c_planner(full, 64, dev))
    out = sig.cpu().numpy()
    s = _norm_scale(norm, full, forward=False)
    if s != 1.0:
        out = out * s
    return _axis_back(out, axis, out.ndim)


def rfftn(a, s=None, axes=None, norm=None, *, device=None):
    """N-dimensional real-input DFT (numpy.fft.rfftn semantics): a real
    transform over the last of ``axes``, complex transforms over the
    rest."""
    a = np.asarray(a)
    if axes is None:
        axes = tuple(range(a.ndim))
    if s is not None and tuple(s) != tuple(a.shape[ax] for ax in axes):
        raise PhastftError(
            "s must match the input shape (power-of-2 engine; pad first)"
        )
    out = rfft(a, axis=axes[-1], norm=norm, device=device)
    if len(axes) > 1:
        out = fftn(out, axes=axes[:-1], norm=norm, device=device)
    return out


def irfftn(a, s=None, axes=None, norm=None, *, device=None):
    """Inverse of rfftn -> real output (numpy.fft.irfftn semantics)."""
    a = np.asarray(a)
    if axes is None:
        axes = tuple(range(a.ndim))
    if s is not None:
        full = 2 * (a.shape[axes[-1]] - 1)
        want = tuple(
            full if ax == axes[-1] else a.shape[ax] for ax in axes
        )
        if tuple(s) != want:
            raise PhastftError(
                "s must match the transform shape (power-of-2 engine)"
            )
    if len(axes) > 1:
        a = ifftn(a, axes=axes[:-1], norm=norm, device=device)
    return irfft(a, axis=axes[-1], norm=norm, device=device)


def rfft2(a, s=None, axes=(-2, -1), norm=None, *, device=None):
    """2-D real-input DFT (numpy.fft.rfft2 semantics)."""
    return rfftn(a, s=s, axes=axes, norm=norm, device=device)


def irfft2(a, s=None, axes=(-2, -1), norm=None, *, device=None):
    """Inverse of rfft2 (numpy.fft.irfft2 semantics)."""
    return irfftn(a, s=s, axes=axes, norm=norm, device=device)


def hfft(a, n=None, axis=-1, norm=None, *, device=None):
    """DFT of a signal with Hermitian symmetry -> real spectrum
    (numpy.fft.hfft semantics): irfft(conj(a)) * n, on the C2R path."""
    a = np.asarray(a)
    m = np.shape(a)[axis]
    full = 2 * (m - 1)
    if n is not None and n != full:
        raise PhastftError(
            f"n must equal 2*(len-1) = {full} (power-of-2 engine)"
        )
    out = irfft(np.conj(a), axis=axis, norm=None, device=device) * full
    s = _norm_scale(norm, full, forward=True)
    if s != 1.0:
        out = out * s
    return out


def ihfft(a, n=None, axis=-1, norm=None, *, device=None):
    """Inverse of hfft (numpy.fft.ihfft semantics): conj(rfft(a)) / n."""
    a = np.asarray(a)
    m = np.shape(a)[axis]
    if n is not None and n != m:
        raise PhastftError(
            "n must equal the input length (power-of-2 engine; pad first)"
        )
    out = np.conj(rfft(a, axis=axis, norm=None, device=device)) / m
    s = _norm_scale(norm, m, forward=False)
    if s != 1.0:
        out = out * s
    return out


# -- the helper family: host index / frequency utilities (numpy parity) --

def fftfreq(n, d=1.0):
    """numpy.fft.fftfreq: DFT sample frequencies."""
    return np.fft.fftfreq(n, d)


def rfftfreq(n, d=1.0):
    """numpy.fft.rfftfreq: sample frequencies of the compact spectrum."""
    return np.fft.rfftfreq(n, d)


def fftshift(x, axes=None):
    """numpy.fft.fftshift: move the zero-frequency bin to the center."""
    return np.fft.fftshift(x, axes)


def ifftshift(x, axes=None):
    """numpy.fft.ifftshift: undo fftshift."""
    return np.fft.ifftshift(x, axes)
