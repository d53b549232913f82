"""The port's staged strategy on the CPU (phastft_tpu_torch/ops/bitrev.py,
ops/dit.py's staged path, the planners' staged tables), against the JAX
package's.

The bit reversal is a permutation: equal bit for bit. The butterflies and
the staged transform: f32 within 1e-6 rel L2 of the JAX package's, f64
within 1e-13, and each within its bound of numpy's f64 FFT. The stage
tables agree with the JAX planner's to 1 ulp.
"""

import numpy as np
import pytest
import torch

import phastft_tpu
import phastft_tpu_torch as pt
from phastft_tpu.ops import bitrev as jax_bitrev
from phastft_tpu.ops import dit as jax_dit
from phastft_tpu_torch.ops import bitrev
from phastft_tpu_torch.ops.dit import butterfly_stage, staged_fft


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = {np.float32: 1e-6, np.float64: 1e-13}
#: Each against numpy's f64 FFT (the repo's f32 bound at these sizes).
NUMPY_TOL = {np.float32: 5e-7, np.float64: 1e-13}


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _c(pair):
    return np.asarray(pair[0], np.float64) + 1j * np.asarray(pair[1], np.float64)


@pytest.mark.parametrize("log_n", range(19))
def test_bit_reverse_indices(log_n):
    n = 1 << log_n
    got = bitrev.bit_reverse_indices(n)
    assert got.dtype == np.int32 and got.shape == (n,)
    assert np.array_equal(got, jax_bitrev.bit_reverse_indices(n))
    assert np.array_equal(got, bitrev.naive_bit_reversal(np.arange(n)))
    assert np.array_equal(got, jax_bitrev.naive_bit_reversal(np.arange(n)))


@pytest.mark.parametrize("batch", [(), (3,), (2, 1)], ids=str)
@pytest.mark.parametrize("tiled", [False, True])
def test_apply_bit_reversal_matches_jax(batch, tiled):
    rng = np.random.default_rng(len(batch))
    for log_n in (0, 1, 3, 4, 7, 9, 14, 16):
        n = 1 << log_n
        x = rng.standard_normal(batch + (n,)).astype(np.float32)
        got = bitrev.apply_bit_reversal(torch.from_numpy(x), n, tiled)
        want = np.asarray(jax_bitrev.apply_bit_reversal(x, n, tiled))
        assert got.shape == batch + (n,)
        assert np.array_equal(got.numpy(), want), log_n
        assert np.array_equal(got.numpy(), x[..., bitrev.bit_reverse_indices(n)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: d.__name__)
def test_butterfly_stage_matches_jax(dtype):
    n = 1 << 10
    rng = np.random.default_rng(3)
    re, im = rng.standard_normal((2, 2, n)).astype(dtype)
    jax_planner = (phastft_tpu.PlannerDit64 if dtype == np.float64
                   else phastft_tpu.PlannerDit32)(n)
    planner = (pt.PlannerDit64 if dtype == np.float64 else pt.PlannerDit32)(n, device="cpu")
    for s in (0, 1, 5, 9):
        wre, wim = planner.stage_twiddles[s]
        got = butterfly_stage(torch.from_numpy(re), torch.from_numpy(im), wre, wim, s)
        jre, jim = jax_planner.stage_twiddles[s]
        want = jax_dit.butterfly_stage(re, im, jre, jim, s)
        assert _rel(_c(got), _c(want)) <= TOL[dtype]
        # by hand: pairs h apart, the second times W_{2h}^k
        h = 1 << s
        z = (re + 1j * im).reshape(2, n // (2 * h), 2, h).astype(np.complex128)
        w = np.exp(-2j * np.pi * np.arange(h) / (2 * h))
        ref = np.stack((z[:, :, 0] + w * z[:, :, 1], z[:, :, 0] - w * z[:, :, 1]), axis=2)
        assert _rel(_c(got), ref.reshape(2, n)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=lambda d: d.__name__)
@pytest.mark.parametrize("tiled", [False, True])
def test_staged_fft_matches_jax_and_numpy(dtype, tiled):
    rng = np.random.default_rng(5)
    for log_n in (0, 1, 6, 12, 15):
        n = 1 << log_n
        re, im = rng.standard_normal((2, 3, n)).astype(dtype)
        planner = (pt.PlannerDit64 if dtype == np.float64 else pt.PlannerDit32)(
            n, device="cpu")
        jax_planner = (phastft_tpu.PlannerDit64 if dtype == np.float64
                       else phastft_tpu.PlannerDit32)(n)
        for scale in (False, True):
            got = staged_fft(torch.from_numpy(re), torch.from_numpy(im),
                             planner.stage_twiddles, tiled_bitrev=tiled, scale=scale)
            want = jax_dit.build_staged_fft(n, tiled, scale)(re, im,
                                                             jax_planner.stage_twiddles)
            assert got[0].dtype == torch.from_numpy(re).dtype
            assert _rel(_c(got), _c(want)) <= TOL[dtype], (log_n, scale)
            ref = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1) / (n if scale else 1)
            assert _rel(_c(got), ref) <= NUMPY_TOL[dtype], (log_n, scale)


@pytest.mark.parametrize("cls", ["PlannerDit32", "PlannerDit64"])
def test_stage_tables_match_jax(cls):
    for log_n in (0, 1, 5, 13, 17):
        n = 1 << log_n
        planner = getattr(pt, cls)(n, device="cpu")
        jax_planner = getattr(phastft_tpu, cls)(n)
        assert planner._stage_twiddles is None  # built on first use
        ours, theirs = planner.stage_twiddles, jax_planner.stage_twiddles
        assert len(ours) == len(theirs) == log_n
        for s, ((wre, wim), (jre, jim)) in enumerate(zip(ours, theirs)):
            assert wre.shape == (1 << s,) and wre.dtype == torch.from_numpy(
                np.zeros(0, planner.dtype)).dtype
            for a, b in ((wre, jre), (wim, jim)):
                a, b = a.numpy(), np.asarray(b)
                assert np.all(np.abs(a - b) <= np.spacing(np.maximum(np.abs(a), np.abs(b))))
        assert planner.num_twiddles() == jax_planner.num_twiddles() == n - 1
        assert planner.num_twiddles() == sum(int(w.shape[0]) for w, _ in ours)
        assert planner.bitrev.dtype == torch.int32
        assert np.array_equal(planner.bitrev.numpy(), np.asarray(jax_planner.bitrev))


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("direction", ["Forward", "Reverse"])
def test_staged_entries_match_jax(bits, direction):
    """The staged entries (tiled from TILED_BITREV_MIN_LOGN = 14, or as
    ``tiled_bit_reversal`` says) against the JAX package's staged path."""
    dt = np.float32 if bits == 32 else np.float64
    entry = (pt.fft_32_dit_with_planner_and_opts if bits == 32
             else pt.fft_64_dit_with_planner_and_opts)
    jax_entry = (phastft_tpu.fft_32_dit_with_planner_and_opts if bits == 32
                 else phastft_tpu.fft_64_dit_with_planner_and_opts)
    rng = np.random.default_rng(bits)
    for log_n, tiled in ((3, None), (13, None), (14, None), (14, False), (10, True)):
        n = 1 << log_n
        re, im = rng.standard_normal((2, 2, n)).astype(dt)
        planner = (pt.PlannerDit32 if bits == 32 else pt.PlannerDit64)(n, device="cpu")
        jax_planner = (phastft_tpu.PlannerDit32 if bits == 32 else phastft_tpu.PlannerDit64)(n)
        got = entry(re, im, getattr(pt.Direction, direction), planner,
                    pt.Options(strategy="staged", tiled_bit_reversal=tiled))
        want = jax_entry(re, im, getattr(phastft_tpu.Direction, direction), jax_planner,
                         phastft_tpu.Options(strategy="staged", tiled_bit_reversal=tiled))
        assert got[0].dtype == (torch.float32 if bits == 32 else torch.float64)
        assert _rel(_c(got), _c(want)) <= TOL[dt], log_n
        z = re.astype(np.float64) + 1j * im
        ref = np.fft.fft(z, axis=-1) if direction == "Forward" else np.fft.ifft(z, axis=-1)
        assert _rel(_c(got), ref) <= NUMPY_TOL[dt], log_n
