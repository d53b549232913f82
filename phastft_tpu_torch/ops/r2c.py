"""Real-input (R2C) and real-output (C2R) transforms via the half-length
complex trick: the compact N/2 + 1 spectrum.

Counterpart of the JAX package's ``ops/r2c.py``. The math is its own (the
reference's r2c.rs): pack the N reals into an N/2-point complex FFT, then a
conjugate-symmetric untangle with mirrored pairs:

  forward   z = FFT_{N/2}(even + i odd)
            X[k] = s/2 - i tw[k] d,  s = z[k] + conj(z[N/2-k]),
            d = z[k] - conj(z[N/2-k]), tw = 0.5 W_N^k; X[N/2] = Re z0 - Im z0
  inverse   z[k] = s/2 + i conj(tw[k]) d,  s = X[k] + conj(X[N/2-k]),
            d = X[k] - conj(X[N/2-k])
            x = interleave(IFFT_{N/2}(z)) (the swap trick, 2/N folded into
            the interleave)

The four streaming passes are hand-written kernels (``csrc/r2c.cu``), each
beside its plain torch version, which a CPU tensor runs:

* ``deinterleave``: N reals -> even / odd planes of N/2 (stands for
  ``_deinterleave``, ``phastft_tpu/ops/r2c.py:302``);
* ``untangle``: z -> the bins (``_untangle``, ``:65``);
* ``pre_untangle``: the bins -> z (``_pre_untangle``, ``:96``);
* ``interleave_scale``: the two planes x 2/N -> N reals
  (``_scale_interleave``, ``:451``).

On one device the untangles run the paired kernel: a thread reads z[k],
z[N/2 - k] and tw[k] once and writes both bins, so z, the table and the
bins each cross device memory once. The distributed real transforms
(``parallel/real_dist.py``) run the mirror form, one bin a thread, with the
partner rank's shard as the mirror. Both directions read the planner's
quarter table (0.5 W_N^k, k = 0..N/4) and the symmetry
tw[N/2 - k] = -conj(tw[k]). For every k each computes the JAX package's
first-half formula, which for k > N/4 gives the same products and sums as
its second half, X[N/2 - k] = conj(s)/2 - i conj(u). The JAX package's
``_pre_untangle`` reads a full-length table instead, a workaround for
XLA:TPU's compile times that the port does not carry over.

What is not carried over (XLA:TPU workarounds): the three-executable C2R
composite and its ``C2R_COMPOSITE_MIN_N`` switch, ``_scale_interleave_sel``
and the pad-based interleave, the wide-row deinterleave, and the lazy-dd
untangle with ``PHASTFT_TPU_R2C_POST``. Every f64 engine runs the untangles
in f64 on the joined half-length spectrum (the JAX package's ``"f64"`` post
branch): the H100 has FP64 units.

Each kernel is bound by memory: it reads its inputs once and writes its
output once. Products are rounded as written (no FMA), so a kernel and its
plain version agree bit for bit.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..tracing import span
from ._build import call

__all__ = [
    "deinterleave_args",
    "interleave_args",
    "untangle_args",
    "untangle_pair_args",
    "pair_schedule",
    "r2c_twiddles",
    "r2c_twiddles_host",
    "r2c_twiddles_torch",
    "deinterleave",
    "deinterleave_plain",
    "interleave_scale",
    "interleave_scale_plain",
    "untangle",
    "untangle_plain",
    "pre_untangle",
    "pre_untangle_plain",
    "build_r2c_fft",
    "build_c2r_fft",
]

#: Twiddles are made in chunks of this many angles (bounds the host's f64
#: temporaries at the largest sizes).
_TW_CHUNK = 1 << 24


def r2c_twiddles_host(n: int, count: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) of 0.5 * W_n^k for k in [0, count), from exact f64 angles
    (-2 pi k / n, the JAX planner's expression) rounded once to ``dtype``:
    the untangles' quarter table (``count`` = n/4 + 1), or the full-length
    table of the JAX package's C2R (``count`` = n/2)."""
    dtype = np.dtype(dtype)
    out_re = np.empty(count, dtype)
    out_im = np.empty(count, dtype)
    for s in range(0, count, _TW_CHUNK):
        k = np.arange(s, min(count, s + _TW_CHUNK), dtype=np.float64)
        ang = -2.0 * np.pi * k / float(n)
        out_re[s:s + len(k)] = 0.5 * np.cos(ang)
        out_im[s:s + len(k)] = 0.5 * np.sin(ang)
    return out_re, out_im


def r2c_twiddles_torch(n: int, count: int, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``r2c_twiddles_host``'s tables built by torch on ``device``, in slabs
    of _TW_CHUNK angles: the same f64 expression (-2 pi k / n) and one
    rounding to ``dtype``; cos and sin are the device's own f64 functions,
    so an entry may differ from the host's in its last place."""
    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    out_re = torch.empty(count, dtype=tdt, device=device)
    out_im = torch.empty(count, dtype=tdt, device=device)
    for s in range(0, count, _TW_CHUNK):
        e = min(count, s + _TW_CHUNK)
        ang = -2.0 * np.pi * torch.arange(s, e, dtype=torch.float64, device=device) / float(n)
        out_re[s:e] = 0.5 * torch.cos(ang)
        out_im[s:e] = 0.5 * torch.sin(ang)
    return out_re, out_im


def r2c_twiddles(n: int, count: int, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The untangle table of ``count`` entries as tensors on ``device``:
    ``r2c_twiddles_host`` on the CPU, ``r2c_twiddles_torch`` on a GPU (at
    n = 2^32 the host's numpy takes tens of seconds for the 2^30 + 1 entries
    of the quarter table: ``chip_smoke.py``'s ``giant_tables``)."""
    if torch.device(device).type == "cpu":
        return tuple(torch.from_numpy(a) for a in r2c_twiddles_host(n, count, dtype))
    return r2c_twiddles_torch(n, count, dtype, device)


_DTYPES = (torch.float32, torch.float64)


def _check_tensors(name, *xs):
    """Every argument is a torch tensor of one float dtype on one device."""
    for x in xs:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} takes torch tensors")
        if x.dtype not in _DTYPES or x.dtype != xs[0].dtype:
            raise TypeError(f"{name} takes float32 or float64 tensors of one dtype, "
                            f"got {x.dtype}")
        if x.device != xs[0].device:
            raise ValueError(f"{name}: all tensors must be on one device")


def _cuda(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def deinterleave_args(shape, f64: bool, ptrs=(None,) * 3, stream=None) -> tuple:
    """``phastft_r2c_deinterleave``'s arguments for reals of ``shape``: the
    f64 flag, the pointers ``ptrs`` (x, even, odd), the count of four-real
    groups and the stream."""
    return (int(f64), *ptrs, math.prod(shape) // 4, stream)


def interleave_args(shape, f64: bool, scale: float, ptrs=(None,) * 3,
                    stream=None) -> tuple:
    """``phastft_r2c_interleave``'s arguments for planes of ``shape``: the
    f64 flag, the pointers ``ptrs`` (re, im, x), the count of pairs of
    values a plane, the scale and the stream."""
    return (int(f64), *ptrs, math.prod(shape) // 2, float(scale), stream)


def untangle_args(f64: bool, inverse: bool, shape, p_len: int, w_stride: int,
                  length: int, k0: int, half: int, nyquist: bool,
                  ptrs=(None,) * 10, stream=None) -> tuple:
    """``phastft_r2c_untangle``'s arguments for input planes of ``shape``
    (..., row stride): the flags, the pointers ``ptrs`` (a, the mirror p,
    the wrap elements w, the table, the outputs; each re and im) with the
    row strides of a, p and w (``p_len``, ``w_stride``), the output's row
    stride, the rows, L = ``length``, ``k0``, ``half`` and the Nyquist
    flag, and the stream."""
    a_re, a_im, p_re, p_im, w_re, w_im, tw_re, tw_im, o_re, o_im = ptrs
    rows = math.prod(shape[:-1])
    return (int(f64), int(inverse), a_re, a_im, int(shape[-1]), p_re, p_im, p_len,
            w_re, w_im, w_stride, tw_re, tw_im, o_re, o_im, length + int(nyquist), rows,
            length, k0, half, int(nyquist), stream)


def pair_schedule(rows: int) -> int:
    """The paired kernel's schedule for ``rows`` rows (``csrc/r2c.cu``):
    1, vector, on one row, whose rows of H and of H + 1 both start 16-byte
    aligned; 0, scalar, on a batch, whose rows of H + 1 start aligned only
    every V-th row and elsewhere store element by element (on the H100 the
    forward's vector schedule then loses to the scalar one: ``chip_smoke.py``'s
    ``times_r2c`` times both on one row and on a batch). The kernel takes the
    scalar schedule where a shape or pointer allows no vectors."""
    return 1 if rows == 1 else 0


def untangle_pair_args(f64: bool, inverse: bool, rows: int, half: int, schedule: int,
                       ptrs=(None,) * 6, stream=None) -> tuple:
    """``phastft_r2c_untangle_pair``'s arguments: the flags, the pointers
    ``ptrs`` (the input, the table, the output; each re and im), the rows,
    the half length H (rows of H elements and of H + 1 bins), the schedule
    and the stream."""
    return (int(f64), int(inverse), *ptrs, rows, half, int(schedule), stream)


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {err}")


def _rows(batch) -> int:
    return int(np.prod(batch)) if batch else 1


# ----------------------------------------------------------- deinterleave
def _check_deinterleave(x):
    _check_tensors("deinterleave", x)
    n = int(x.shape[-1]) if x.dim() else 0
    if n < 4 or n & (n - 1):
        raise ValueError(f"deinterleave: rows of a power-of-two length >= 4, got {n}")
    return n


def deinterleave_plain(x):
    """Plain-torch deinterleave: same arguments and result as
    ``deinterleave``."""
    _check_deinterleave(x)
    return x[..., 0::2].contiguous(), x[..., 1::2].contiguous()


def deinterleave(x):
    """(even, odd) = (x[..., 0::2], x[..., 1::2]) of (..., N) f32 or f64
    reals, N >= 4 a power of two, as two new contiguous tensors: the
    packing of the real signal into the half-length complex transform's
    input.

    On CUDA it launches ``csrc/r2c.cu``'s deinterleave on the current stream
    (``x`` contiguous and 16-byte aligned), or raises; a CPU tensor runs
    ``deinterleave_plain``. The input is read, never written.

    Stands for the JAX package's ``_deinterleave``
    (``phastft_tpu/ops/r2c.py:302``). Bound by memory (each real read once
    and written once)."""
    n = _check_deinterleave(x)
    if x.device.type == "cpu":
        return deinterleave_plain(x)
    _cuda("deinterleave", x)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("deinterleave: the input must be contiguous and 16-byte aligned")
    shape = tuple(x.shape[:-1]) + (n // 2,)
    even = torch.empty(shape, dtype=x.dtype, device=x.device)
    odd = torch.empty(shape, dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), even.data_ptr(), odd.data_ptr())
    with torch.cuda.device(x.device):
        err = call("phastft_r2c_deinterleave", deinterleave_args(
            x.shape, x.dtype == torch.float64, ptrs, _stream(x.device)),
            kernel="deinterleave")
    _raise_on("deinterleave", err)
    return even, odd


# ------------------------------------------------------- interleave_scale
def _check_interleave(re, im):
    _check_tensors("interleave_scale", re, im)
    if re.shape != im.shape or re.dim() < 1:
        raise ValueError("interleave_scale: two planes of one shape")
    h = int(re.shape[-1])
    if h < 2 or h & (h - 1):
        raise ValueError(f"interleave_scale: rows of a power-of-two length >= 2, got {h}")
    return h


def interleave_scale_plain(re, im, scale: float):
    """Plain-torch interleave: same arguments and result as
    ``interleave_scale``."""
    h = _check_interleave(re, im)
    out = torch.stack((re * scale, im * scale), dim=-1)
    return out.reshape(tuple(re.shape[:-1]) + (2 * h,))


def interleave_scale(re, im, scale: float):
    """x[..., 2i] = re[..., i] * scale, x[..., 2i + 1] = im[..., i] * scale
    for two (..., H) f32 or f64 planes, H >= 2 a power of two: a new
    (..., 2H) tensor. The C2R's last pass, with its 2/N scale folded in.

    On CUDA it launches ``csrc/r2c.cu``'s interleave on the current stream,
    or raises; a CPU tensor runs ``interleave_scale_plain``. Inputs are
    read, never written.

    Stands for the JAX package's ``_scale_interleave``
    (``phastft_tpu/ops/r2c.py:451``). Bound by memory."""
    h = _check_interleave(re, im)
    if re.device.type == "cpu":
        return interleave_scale_plain(re, im, scale)
    _cuda("interleave_scale", re)
    if not (re.is_contiguous() and im.is_contiguous()) or (re.data_ptr() | im.data_ptr()) % 16:
        raise ValueError("interleave_scale: the planes must be contiguous and 16-byte aligned")
    out = torch.empty(tuple(re.shape[:-1]) + (2 * h,), dtype=re.dtype, device=re.device)
    ptrs = (re.data_ptr(), im.data_ptr(), out.data_ptr())
    with torch.cuda.device(re.device):
        err = call("phastft_r2c_interleave", interleave_args(
            re.shape, re.dtype == torch.float64, scale, ptrs, _stream(re.device)),
            kernel="interleave_scale")
    _raise_on("interleave_scale", err)
    return out


# ------------------------------------------------------------- untangles
def _check_untangle(name, a_re, a_im, tw_re, tw_im, mirror, k0, half, inverse):
    """Validate an untangle's arguments; return (L, half, k0, p_re, p_im,
    w_re, w_im), the mirror resolved (None: the input itself)."""
    _check_tensors(name, a_re, a_im, tw_re, tw_im,
                   *(() if mirror is None else tuple(mirror)))
    if a_re.shape != a_im.shape or a_re.dim() < 1:
        raise ValueError(f"{name}: two planes of one shape")
    batch = tuple(a_re.shape[:-1])
    la = int(a_re.shape[-1])
    if mirror is None:
        length = la - 1 if inverse else la
        half = length
        k0 = 0
        p_re, p_im = a_re, a_im
        w_re = a_re[..., length] if inverse else a_re[..., 0]
        w_im = a_im[..., length] if inverse else a_im[..., 0]
    else:
        p_re, p_im, w_re, w_im = mirror
        if half is None:
            raise ValueError(f"{name}: a mirror needs the half length")
        length = la
        if tuple(p_re.shape[:-1]) != batch or p_re.shape != p_im.shape or \
                int(p_re.shape[-1]) < length:
            raise ValueError(f"{name}: the mirror's planes must be (..., >= {length})")
        if tuple(w_re.shape) != batch or w_re.shape != w_im.shape:
            raise ValueError(f"{name}: the mirror's wrap element must be of shape {batch}")
    if length < 1 or length & (length - 1):
        raise ValueError(f"{name}: unsupported row length {la}")
    if half < 2 or half & (half - 1) or k0 < 0 or k0 + length > half:
        raise ValueError(f"{name}: bins [{k0}, {k0 + length}) do not lie in a "
                         f"half length of {half}")
    want = half // 2 + 1
    if tw_re.dim() != 1 or tw_re.shape != tw_im.shape or int(tw_re.shape[0]) != want:
        raise ValueError(f"{name}: the twiddle table must hold {want} entries")
    return length, half, k0, p_re, p_im, w_re, w_im


def _mirror_plain(length, p_re, p_im, w_re, w_im):
    """(re, im) of the mirror element of every j: w at j = 0, p[L - j]
    else."""
    return (torch.cat((w_re[..., None], p_re[..., 1:length].flip(-1)), dim=-1),
            torch.cat((w_im[..., None], p_im[..., 1:length].flip(-1)), dim=-1))


def _sums(a_re, a_im, m_re, m_im):
    """s = a + conj(m), d = a - conj(m)."""
    return a_re + m_re, a_im - m_im, a_re - m_re, a_im + m_im


def _nyquist(mirror, nyquist) -> bool:
    """Whether the forward appends X[H]: always on one device, with a
    mirror when ``nyquist`` asks."""
    if mirror is None:
        if nyquist is not None and not nyquist:
            raise ValueError("untangle: on one device the bins end with X[H]")
        return True
    return bool(nyquist)


def _twiddles_plain(tw_re, tw_im, k0, length, half):
    """(re, im) of tw[k] for k = k0 .. k0 + L - 1 from the quarter table:
    tw[k] for k <= H/2, -conj(tw[H - k]) past it."""
    k = k0 + torch.arange(length, device=tw_re.device)
    low = k <= half // 2
    idx = torch.where(low, k, half - k)
    t_re = tw_re[idx]
    return torch.where(low, t_re, -t_re), tw_im[idx]


def untangle_plain(z_re, z_im, tw_re, tw_im, mirror=None, *, k0=0, half=None,
                   nyquist=None):
    """Plain-torch forward untangle: same arguments and result as
    ``untangle``."""
    length, half, k0, p_re, p_im, w_re, w_im = _check_untangle(
        "untangle", z_re, z_im, tw_re, tw_im, mirror, k0, half, False)
    nyquist = _nyquist(mirror, nyquist)
    a_re, a_im = z_re[..., :length], z_im[..., :length]
    s_re, s_im, d_re, d_im = _sums(a_re, a_im, *_mirror_plain(length, p_re, p_im, w_re, w_im))
    t_re, t_im = _twiddles_plain(tw_re, tw_im, k0, length, half)
    u_re = t_re * d_re - t_im * d_im
    u_im = t_re * d_im + t_im * d_re
    x_re = 0.5 * s_re + u_im
    x_im = 0.5 * s_im - u_re
    if nyquist:
        ny = (p_re[..., 0] - p_im[..., 0])[..., None]
        x_re = torch.cat((x_re, ny), dim=-1)
        x_im = torch.cat((x_im, torch.zeros_like(ny)), dim=-1)
    return x_re, x_im


def pre_untangle_plain(x_re, x_im, tw_re, tw_im, mirror=None, *, k0=0, half=None):
    """Plain-torch C2R preprocess: same arguments and result as
    ``pre_untangle``."""
    length, half, k0, p_re, p_im, w_re, w_im = _check_untangle(
        "pre_untangle", x_re, x_im, tw_re, tw_im, mirror, k0, half, True)
    a_re, a_im = x_re[..., :length], x_im[..., :length]
    s_re, s_im, d_re, d_im = _sums(a_re, a_im, *_mirror_plain(length, p_re, p_im, w_re, w_im))
    t_re, t_im = _twiddles_plain(tw_re, tw_im, k0, length, half)
    p_r = t_re * d_re + t_im * d_im
    p_i = t_re * d_im - t_im * d_re
    return 0.5 * s_re - p_i, 0.5 * s_im + p_r


def _launch_untangle(name, inverse, a_re, a_im, tw_re, tw_im, length, half, k0,
                     p_re, p_im, w_re, w_im, nyquist):
    """Launch ``phastft_r2c_untangle`` (the mirror form) on CUDA tensors;
    return the output planes (..., L + nyquist)."""
    _cuda(name, a_re)
    batch = tuple(a_re.shape[:-1])
    rows = _rows(batch)
    planes = (a_re, a_im, p_re, p_im)
    if not all(x.is_contiguous() for x in (*planes, tw_re, tw_im)):
        raise ValueError(f"{name}: inputs must be contiguous")
    w_re, w_im = w_re.reshape(rows), w_im.reshape(rows)
    if w_re.stride() != w_im.stride():
        raise ValueError(f"{name}: the wrap elements must share one stride")
    shape = batch + (length + int(nyquist),)
    o_re = torch.empty(shape, dtype=a_re.dtype, device=a_re.device)
    o_im = torch.empty(shape, dtype=a_re.dtype, device=a_re.device)
    ptrs = tuple(x.data_ptr() for x in (a_re, a_im, p_re, p_im, w_re, w_im, tw_re,
                                        tw_im, o_re, o_im))
    with torch.cuda.device(a_re.device):
        err = call("phastft_r2c_untangle", untangle_args(
            a_re.dtype == torch.float64, inverse, a_re.shape, int(p_re.shape[-1]),
            int(w_re.stride(0)) if rows > 1 else 0, length, k0, half, nyquist, ptrs,
            _stream(a_re.device)), kernel=name)
    _raise_on(name, err)
    return o_re, o_im


def _launch_untangle_pair(name, inverse, a_re, a_im, tw_re, tw_im, half, schedule=None):
    """Launch ``phastft_r2c_untangle_pair`` (one device) on CUDA tensors in
    ``schedule`` (None: ``pair_schedule``); return the output planes
    (..., H + 1) (the forward) or (..., H)."""
    _cuda(name, a_re)
    if not all(x.is_contiguous() for x in (a_re, a_im, tw_re, tw_im)):
        raise ValueError(f"{name}: inputs must be contiguous")
    batch = tuple(a_re.shape[:-1])
    shape = batch + (half if inverse else half + 1,)
    o_re = torch.empty(shape, dtype=a_re.dtype, device=a_re.device)
    o_im = torch.empty(shape, dtype=a_re.dtype, device=a_re.device)
    ptrs = tuple(x.data_ptr() for x in (a_re, a_im, tw_re, tw_im, o_re, o_im))
    rows = _rows(batch)
    schedule = pair_schedule(rows) if schedule is None else schedule
    with torch.cuda.device(a_re.device):
        err = call("phastft_r2c_untangle_pair", untangle_pair_args(
            a_re.dtype == torch.float64, inverse, rows, half, schedule, ptrs,
            _stream(a_re.device)), kernel=name)
    _raise_on(name, err)
    return o_re, o_im


def untangle(z_re, z_im, tw_re, tw_im, mirror=None, *, k0=0, half=None, nyquist=None):
    """The compact spectrum's bins from the half-length transform z of a
    real signal: X[k] = s/2 - i tw[k] d for k = k0 .. k0 + L - 1, with
    s = z[k] + conj(z[H - k]), d = z[k] - conj(z[H - k]), H the half length
    and tw the quarter table ``tw_re``/``tw_im`` (0.5 W_N^k, k = 0..H/2,
    the planner's ``twiddles``), tw[k] = -conj(tw[H - k]) past it.

    ``z``: (..., L) f32 or f64 planes. ``mirror`` = None: one device, z is
    the whole half-length spectrum (L = H), its own mirror, and the result
    is (..., H + 1) with X[H] = Re z0 - Im z0 (``nyquist`` None or True).
    Else ``mirror`` = (p_re, p_im, w_re, w_im): z[(H - k) mod H] is p[L - j]
    for j = k - k0 >= 1 and w for j = 0 (p (..., >= L), w (...,)), with
    ``k0`` and ``half`` given; ``nyquist`` appends X[H] = Re p0 - Im p0.
    Returns two new planes.

    On CUDA it launches ``csrc/r2c.cu``'s untangle on the current stream, or
    raises: with no mirror the paired kernel (a thread reads z[k], z[H - k]
    and tw[k] and writes X[k] and X[H - k]), with one the mirror form. A
    CPU tensor runs ``untangle_plain``, bit for bit the same. Inputs are
    read, never written.

    Stands for the JAX package's ``_untangle``
    (``phastft_tpu/ops/r2c.py:65``). Bound by memory: the input (with a
    mirror, the mirror too) and the quarter table read once, the output
    written once."""
    length, half, k0, p_re, p_im, w_re, w_im = _check_untangle(
        "untangle", z_re, z_im, tw_re, tw_im, mirror, k0, half, False)
    if z_re.device.type == "cpu":
        return untangle_plain(z_re, z_im, tw_re, tw_im, mirror, k0=k0, half=half,
                              nyquist=nyquist)
    nyquist = _nyquist(mirror, nyquist)
    if mirror is None:
        out = _launch_untangle_pair("untangle", False, z_re, z_im, tw_re, tw_im, half)
    else:
        out = _launch_untangle("untangle", False, z_re, z_im, tw_re, tw_im, length, half,
                               k0, p_re, p_im, w_re, w_im, nyquist)
    return out


def pre_untangle(x_re, x_im, tw_re, tw_im, mirror=None, *, k0=0, half=None):
    """The inverse real transform's first pass, the compact spectrum's bins
    -> the half-length complex input z: z[k] = s/2 + i conj(tw[k]) d for
    k = k0 .. k0 + L - 1, with s = X[k] + conj(X[H - k]),
    d = X[k] - conj(X[H - k]) and tw the quarter table ``tw_re``/``tw_im``
    (0.5 W_N^k, k = 0..H/2, the planner's ``twiddles``),
    tw[k] = -conj(tw[H - k]) past it.

    ``x``: (..., H + 1) f32 or f64 planes with ``mirror`` = None (one
    device: X is its own mirror). Else (..., L) planes (the distributed last
    shard passes its first L bins; its bin H is read only as a mirror) with
    ``mirror`` = (p_re, p_im, w_re, w_im): X[H - k] is p[L - j] for
    j = k - k0 >= 1 and w for j = 0, and ``k0`` and ``half`` given. Returns
    two new (..., L) planes.

    On CUDA it launches ``csrc/r2c.cu``'s pre-untangle on the current
    stream, or raises: with no mirror the paired kernel, with one the mirror
    form. A CPU tensor runs ``pre_untangle_plain``, bit for bit the same.
    Inputs are read, never written.

    Stands for the JAX package's ``_pre_untangle``
    (``phastft_tpu/ops/r2c.py:96``), which reads a full-length table: the
    same function, up to that table's last-place roundings. Bound by memory:
    the bins and the quarter table read once, z written once."""
    length, half, k0, p_re, p_im, w_re, w_im = _check_untangle(
        "pre_untangle", x_re, x_im, tw_re, tw_im, mirror, k0, half, True)
    if x_re.device.type == "cpu":
        return pre_untangle_plain(x_re, x_im, tw_re, tw_im, mirror, k0=k0, half=half)
    if mirror is None:
        out = _launch_untangle_pair("pre_untangle", True, x_re, x_im, tw_re, tw_im, half)
    else:
        out = _launch_untangle("pre_untangle", True, x_re, x_im, tw_re, tw_im, length, half,
                               k0, p_re, p_im, w_re, w_im, False)
    return out


# ------------------------------------------------------- whole transforms
def _passes(plain: bool):
    from .route import passes_for  # route imports this module

    return passes_for(plain)


@functools.lru_cache(maxsize=128)
def build_r2c_fft(n: int, leaf_limit: int, build, variant):
    """Callable (signal, args, tw_re, tw_im) -> (spec_re, spec_im) of length
    n/2 + 1: ``deinterleave``, the half-length transform, and ``untangle``
    on the planner's quarter table. ``build``, ``variant`` and ``args`` are
    the inner planner's engine as ``fft.engine_of`` gives it: the port's own
    C2C closure is ``build(n // 2, leaf_limit, False, *variant)`` (unscaled),
    called on the planner state ``args``. Each intermediate is dropped once
    the next pass has read it (the deinterleaved pair is handed over to the
    inner transform, ``take``); the caller's signal stays. The plain flag,
    ``variant``'s last element, runs the two passes' plain versions too."""
    with span("phastft.plan"):
        inner = build(n // 2, leaf_limit, False, *variant)
        passes = _passes(variant[-1])

    def run(signal, args, tw_re, tw_im):
        z_re, z_im = inner.take([*passes.deinterleave(signal)], *args)
        return passes.untangle(z_re, z_im, tw_re, tw_im)

    return run


@functools.lru_cache(maxsize=128)
def build_c2r_fft(n: int, leaf_limit: int, build, variant):
    """Callable (spec_re, spec_im, args, tw_re, tw_im) -> the length-n real
    signal: ``pre_untangle`` on the planner's quarter table, the
    half-length inverse by the swap trick (unscaled, the inner closure as in
    ``build_r2c_fft``, z handed over to it), and ``interleave_scale`` with
    the 2/n scale, so that C2R(R2C(x)) == x; the plain flag as for
    ``build_r2c_fft``."""
    with span("phastft.plan"):
        inner = build(n // 2, leaf_limit, False, *variant)
        passes = _passes(variant[-1])
    scale = 2.0 / n

    def run(spec_re, spec_im, args, tw_re, tw_im):
        z = [*passes.pre_untangle(spec_re, spec_im, tw_re, tw_im)]
        # swap trick: swap(IDFT(z)) = DFT(swap(z)) / H, the 1/H in `scale`
        z.reverse()
        o_im, o_re = inner.take(z, *args)
        return passes.interleave_scale(o_re, o_im, scale)

    return run
