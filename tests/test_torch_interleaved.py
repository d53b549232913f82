"""The port's interleaved-complex surface on the CPU: ``ops/complex_interop``,
the six ``*_interleaved`` entries and ``numpy_like``, against the JAX
package's counterparts and numpy.

Mirrors tests/test_interleaved.py and tests/test_numpy_like.py case by case
(each test names the one it mirrors). Tolerances: f64 rel L2 <= 1e-12
against the JAX package and numpy, round trips max abs <= 1e-10 (the JAX
tests' bounds); f32 <= 2e-6 against the JAX package and <= 1e-5 against
numpy's f64 transforms.
"""

import numpy as np
import pytest
import torch

import phastft_tpu
import phastft_tpu_torch as pt
from phastft_tpu import numpy_like as jfft
from phastft_tpu_torch import numpy_like as pfft
from phastft_tpu_torch.ops.complex_interop import combine_re_im, deinterleave, interleave


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = {"device": "cpu"}


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# -- complex_interop ---------------------------------------------------------

# mirrors tests/test_interleaved.py::test_deinterleave_complex
def test_deinterleave_complex_numpy_and_tensor():
    sig = np.array([1 + 2j, 3 + 4j, 5 + 6j])
    re, im = deinterleave(sig)
    np.testing.assert_array_equal(re, [1, 3, 5])
    np.testing.assert_array_equal(im, [2, 4, 6])
    re, im = deinterleave(torch.from_numpy(sig))
    assert isinstance(re, torch.Tensor) and re.dtype == torch.float64
    np.testing.assert_array_equal(re.numpy(), [1, 3, 5])
    np.testing.assert_array_equal(im.numpy(), [2, 4, 6])


# mirrors tests/test_interleaved.py::test_deinterleave_flat_odd_lengths
@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 100, 100500])
def test_deinterleave_flat_odd_lengths(n):
    x = np.arange(n, dtype=np.float64)
    pairs = n // 2
    for sig, conv in ((x, np.asarray), (torch.from_numpy(x), lambda t: t.numpy())):
        re, im = deinterleave(sig)
        np.testing.assert_array_equal(conv(re), x[: 2 * pairs: 2])
        np.testing.assert_array_equal(conv(im), x[1: 2 * pairs: 2])


# mirrors tests/test_interleaved.py::test_interleave_combine_roundtrip
def test_interleave_combine_roundtrip_matches_jax():
    from phastft_tpu.ops import complex_interop as jci

    rng = np.random.default_rng(3)
    re = rng.standard_normal((2, 64))
    im = rng.standard_normal((2, 64))
    flat = interleave(re, im)
    np.testing.assert_array_equal(flat, jci.interleave(re, im))
    r2, i2 = deinterleave(flat)
    np.testing.assert_array_equal(r2, re)
    np.testing.assert_array_equal(i2, im)
    c = combine_re_im(re, im)
    np.testing.assert_array_equal(c, jci.combine_re_im(re, im))
    c32 = combine_re_im(re.astype(np.float32), im.astype(np.float32))
    assert c32.dtype == np.complex64
    # tensors stay tensors on their device, complex128 included
    tre, tim = torch.from_numpy(re), torch.from_numpy(im)
    t = combine_re_im(tre, tim)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.complex128
    np.testing.assert_array_equal(t.numpy(), c)
    assert combine_re_im(tre.float(), tim.float()).dtype == torch.complex64
    tflat = interleave(tre, tim)
    assert isinstance(tflat, torch.Tensor)
    np.testing.assert_array_equal(tflat.numpy(), flat)


# -- the interleaved entries -------------------------------------------------

# mirrors tests/test_interleaved.py::test_interleaved_matches_planar_f64,
# test_interleaved_roundtrip_f64 and test_interleaved_f32
@pytest.mark.parametrize("bits", [32, 64])
def test_interleaved_entries_match_jax_planar_and_numpy(bits):
    n = 1 << 10
    sig = _complex((2, n), bits)
    if bits == 32:
        sig = sig.astype(np.complex64)
    fwd, inv = pt.Direction.Forward, pt.Direction.Reverse
    auto = pt.fft_64_interleaved if bits == 64 else pt.fft_32_interleaved
    with_p = pt.fft_64_interleaved_with_planner if bits == 64 else pt.fft_32_interleaved_with_planner
    with_o = (pt.fft_64_interleaved_with_planner_and_opts if bits == 64
              else pt.fft_32_interleaved_with_planner_and_opts)
    jauto = (phastft_tpu.fft_64_interleaved if bits == 64
             else phastft_tpu.fft_32_interleaved)
    planar = pt.fft_64_dit if bits == 64 else pt.fft_32_dit
    planner = (pt.PlannerDit64 if bits == 64 else pt.PlannerDit32)(n, device="cpu")
    got = auto(sig, fwd, **CPU)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == (torch.complex128 if bits == 64 else torch.complex64)
    assert torch.equal(with_p(sig, fwd, planner), got)
    assert torch.equal(with_o(sig, "f", planner, pt.Options()), got)
    pre, pim = planar(sig.real.copy(), sig.imag.copy(), fwd, **CPU)
    assert torch.equal(got, torch.complex(pre, pim))
    want = np.fft.fft(sig.astype(np.complex128), axis=-1)
    g = got.numpy().astype(np.complex128)
    assert _rel(g, want) <= (1e-12 if bits == 64 else 1e-5)
    assert _rel(g, np.asarray(jauto(sig, phastft_tpu.Direction.Forward), np.complex128)) <= (
        1e-12 if bits == 64 else 2e-6)
    back = auto(got, inv, **CPU).numpy()
    assert np.abs(back - sig).max() < (1e-10 if bits == 64 else 1e-5)
    # the flat form: interleaved scalars, planned on the complex length
    flat = interleave(sig.real, sig.imag)
    assert torch.equal(auto(flat, fwd, **CPU), got)


# mirrors tests/test_interleaved.py::test_interleaved_nonpow2_raises
def test_interleaved_nonpow2_raises():
    with pytest.raises(pt.NonPowerOfTwoError):
        pt.fft_64_interleaved(np.zeros(100, dtype=complex), pt.Direction.Forward, **CPU)
    with pytest.raises(pt.PhastftError, match="direction"):
        pt.fft_32_interleaved(np.zeros(8, dtype=complex), "x", **CPU)


# -- numpy_like ----------------------------------------------------------------

# mirrors tests/test_numpy_like.py::test_fft_ifft_match_numpy
@pytest.mark.parametrize("norm", [None, "ortho", "forward", "backward"])
def test_fft_ifft_match_jax_and_numpy(norm):
    x = _complex(1 << 10, 0)
    got = pfft.fft(x, norm=norm, **CPU)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex128
    assert _rel(got, np.fft.fft(x, norm=norm)) < 1e-12
    assert _rel(got, jfft.fft(x, norm=norm)) < 1e-12
    back = pfft.ifft(got, norm=norm, **CPU)
    assert np.abs(back - x).max() < 1e-10


# mirrors tests/test_numpy_like.py::test_fft_real_input_and_axis and
# test_fft_complex64_single_precision
def test_fft_axis_real_input_and_complex64():
    x = np.random.default_rng(1).standard_normal((4, 256, 3))
    got = pfft.fft(x, axis=1, **CPU)
    assert _rel(got, np.fft.fft(x, axis=1)) < 1e-12
    x = _complex(1 << 12, 2)
    x32 = x.astype(np.complex64)
    got = pfft.fft(x32, **CPU)
    assert got.dtype == np.complex64
    assert _rel(got, np.fft.fft(x)) < 1e-5
    assert _rel(got, jfft.fft(x32)) < 2e-6


# mirrors tests/test_numpy_like.py::test_rfft_irfft_match_numpy
@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_rfft_irfft_match_jax_and_numpy(norm):
    x = np.random.default_rng(3).standard_normal(1 << 11)
    got = pfft.rfft(x, norm=norm, **CPU)
    want = np.fft.rfft(x, norm=norm)
    assert got.shape == want.shape == ((1 << 10) + 1,)
    assert _rel(got, want) < 1e-12
    assert _rel(got, jfft.rfft(x, norm=norm)) < 1e-12
    back = pfft.irfft(got, norm=norm, **CPU)
    assert np.abs(back - x).max() < 1e-10
    assert _rel(back, jfft.irfft(got, norm=norm)) < 1e-12


def test_rfft_irfft_single_precision():
    x = np.random.default_rng(4).standard_normal((2, 1 << 10)).astype(np.float32)
    got = pfft.rfft(x, **CPU)
    assert got.dtype == np.complex64
    assert _rel(got, np.fft.rfft(x.astype(np.float64))) < 1e-5
    assert _rel(got, jfft.rfft(x)) < 2e-6
    back = pfft.irfft(got, **CPU)
    assert back.dtype == np.float32
    assert _rel(back, x) < 1e-5


# mirrors tests/test_numpy_like.py::test_padding_rejected
def test_padding_and_norm_rejected():
    for call, words in (
            (lambda: pfft.fft(np.zeros(8), n=16, **CPU), "n must equal the input length"),
            (lambda: pfft.irfft(np.zeros(9, np.complex128), n=32, **CPU),
             "n must equal 2\\*\\(len-1\\) = 16"),
            (lambda: pfft.fft(np.zeros(8), norm="bogus", **CPU), "invalid norm"),
            (lambda: pfft.rfft(np.zeros(8), n=4, **CPU), "pad first"),
            (lambda: pfft.fftn(np.zeros((4, 4)), s=(8, 4), **CPU), "s must match"),
            (lambda: pfft.irfftn(np.zeros((4, 5)), s=(4, 4), **CPU),
             "s must match the transform shape"),
            (lambda: pfft.hfft(np.zeros(9), n=8, **CPU), "2\\*\\(len-1\\)"),
            (lambda: pfft.ihfft(np.zeros(8), n=16, **CPU), "pad first")):
        with pytest.raises(pt.PhastftError, match=words):
            call()


# mirrors tests/test_numpy_like.py::test_fft2_matches_numpy,
# test_fftn_axes_and_norm and test_fftn_accepts_device_arrays_and_complex_roundtrip
def test_fft2_fftn_match_numpy():
    x = _complex((64, 128), 4)
    got = pfft.fft2(x, **CPU)
    assert _rel(got, np.fft.fft2(x)) < 1e-12
    assert np.abs(pfft.ifft2(got, **CPU) - x).max() < 1e-10
    x = np.random.default_rng(5).standard_normal((8, 32, 16))
    got = pfft.fftn(x, axes=(0, 2), norm="ortho", **CPU)
    assert _rel(got, np.fft.fftn(x, axes=(0, 2), norm="ortho")) < 1e-12
    x = np.random.default_rng(11).standard_normal((8, 16, 32))
    got = pfft.fftn(torch.from_numpy(x), **CPU)
    assert _rel(got, np.fft.fftn(x)) < 1e-12
    assert _rel(got, jfft.fftn(x)) < 1e-12
    assert np.max(np.abs(pfft.ifftn(got, **CPU) - x)) < 1e-10


# mirrors tests/test_numpy_like.py::test_batched_rfft_leading_dims
def test_batched_rfft_leading_dims():
    x = np.random.default_rng(6).standard_normal((3, 5, 1 << 10))
    got = pfft.rfft(x, **CPU)
    want = np.fft.rfft(x, axis=-1)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-12


# mirrors tests/test_numpy_like.py::test_rfftn_irfftn_match_numpy and
# test_rfft2_matches_numpy
@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_rfftn_irfftn_rfft2_match_numpy(norm):
    x = np.random.default_rng(21).standard_normal((8, 16, 64))
    got = pfft.rfftn(x, norm=norm, **CPU)
    want = np.fft.rfftn(x, norm=norm)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-12
    assert np.max(np.abs(pfft.irfftn(got, norm=norm, **CPU) - x)) < 1e-10
    y = x[0, :, :]
    got = pfft.rfft2(y, norm=norm, **CPU)
    assert _rel(got, np.fft.rfft2(y, norm=norm)) < 1e-12
    assert np.max(np.abs(pfft.irfft2(got, norm=norm, **CPU) - y)) < 1e-10


# mirrors tests/test_numpy_like.py::test_hfft_ihfft_match_numpy
@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
def test_hfft_ihfft_match_jax_and_numpy(norm):
    rng = np.random.default_rng(23)
    m = 129
    a = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    a[0] = a[0].real
    a[-1] = a[-1].real
    got = pfft.hfft(a, norm=norm, **CPU)
    want = np.fft.hfft(a, norm=norm)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-12
    assert _rel(got, jfft.hfft(a, norm=norm)) < 1e-12
    gi = pfft.ihfft(got, norm=norm, **CPU)
    assert _rel(gi, np.fft.ihfft(got, norm=norm)) < 1e-12


# mirrors tests/test_numpy_like.py::test_helper_family_matches_numpy
def test_helper_family_matches_numpy():
    np.testing.assert_array_equal(pfft.fftfreq(16, 0.5), np.fft.fftfreq(16, 0.5))
    np.testing.assert_array_equal(pfft.rfftfreq(16, 2.0), np.fft.rfftfreq(16, 2.0))
    x = np.arange(24).reshape(4, 6)
    np.testing.assert_array_equal(pfft.fftshift(x), np.fft.fftshift(x))
    np.testing.assert_array_equal(pfft.ifftshift(pfft.fftshift(x, axes=1), axes=1), x)


def test_numpy_like_device_rule():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfft.fft(np.zeros(8))
