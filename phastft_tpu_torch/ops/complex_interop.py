"""Interleaved-complex <-> planar interop helpers.

Counterpart of the JAX package's ``ops/complex_interop.py`` (the
reference's ``complex_nums.rs``): ``deinterleave``, ``combine_re_im`` and
``interleave``. Planar stays the fast format; these copy.

Tensors stay on their device: complex128 exists on the card, so the JAX
package's host-side f64 combine (a TPU limit) is not carried over. Numpy
arrays (and nested lists) stay numpy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["deinterleave", "combine_re_im", "interleave"]


def deinterleave(signal):
    """Split an interleaved sequence into (re, im).

    Takes a complex array or tensor, or a real one of interleaved (re, im)
    scalar pairs along its last axis. In the flat form a trailing unpaired
    scalar is dropped (the reference's ``chunks_exact(2)``)."""
    if isinstance(signal, torch.Tensor):
        if signal.is_complex():
            return signal.real, signal.imag
        pairs = int(signal.shape[-1]) // 2
        flat = signal[..., : 2 * pairs]
        return flat[..., 0::2], flat[..., 1::2]
    if np.iscomplexobj(signal):
        signal = np.asarray(signal)
        return signal.real, signal.imag
    signal = np.asarray(signal)
    pairs = signal.shape[-1] // 2
    flat = signal[..., : 2 * pairs]
    return flat[..., 0::2], flat[..., 1::2]


def combine_re_im(re, im):
    """Combine planar (re, im) into one complex array: a complex64 or
    complex128 tensor on the planes' device for tensors (by their dtype),
    else a numpy array (complex64 from float32, else complex128)."""
    if isinstance(re, torch.Tensor):
        im = torch.as_tensor(im, device=re.device)
        if re.dtype == torch.float32 and im.dtype == torch.float32:
            return torch.complex(re, im)
        return torch.complex(re.double(), im.double())
    re = np.asarray(re)
    im = np.asarray(im)
    if re.dtype == np.float32:
        return (re + 1j * im).astype(np.complex64)
    return re.astype(np.float64) + 1j * im.astype(np.float64)


def interleave(re, im):
    """Planar -> flat interleaved scalars along the last axis (the inverse
    of the flat form of ``deinterleave``), a tensor for tensors."""
    if isinstance(re, torch.Tensor):
        stacked = torch.stack((re, torch.as_tensor(im, device=re.device)), dim=-1)
        return stacked.reshape(tuple(stacked.shape[:-2]) + (-1,))
    stacked = np.stack([re, im], axis=-1)
    return stacked.reshape(stacked.shape[:-2] + (-1,))
