"""The plain reference against numpy.fft, whole and by blocks, and the
controls' precisions."""

import numpy as np
import pytest
import torch

from portbench import reference
from portbench.reference import DFT


def rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def signal(shape, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.standard_normal(shape)


@pytest.mark.parametrize("log_n", [1, 3, 8, 9, 12, 17])
@pytest.mark.parametrize("inverse", [False, True])
def test_rows_match_numpy(log_n, inverse):
    xr, xi = signal((3, 1 << log_n))
    x = xr + 1j * xi
    want = np.fft.ifft(x) if inverse else np.fft.fft(x)
    yr, yi = DFT(torch.float64, "cpu").rows(torch.from_numpy(xr), torch.from_numpy(xi), inverse)
    assert rel(yr.numpy() + 1j * yi.numpy(), want) < 1e-14


@pytest.mark.parametrize("log_n", [10, 13, 18])
@pytest.mark.parametrize("inverse", [False, True])
def test_signal_by_blocks_matches_numpy(log_n, inverse, monkeypatch):
    monkeypatch.setattr(reference, "BLOCK_POINTS", 1 << 9)  # several k1 blocks
    n = 1 << log_n
    xr, xi = signal(n)
    x = xr + 1j * xi
    want = np.fft.ifft(x) if inverse else np.fft.fft(x)
    yr, yi = DFT(torch.float64, "cpu").signal(torch.from_numpy(xr), torch.from_numpy(xi), n,
                                              inverse=inverse)
    assert rel(yr.numpy() + 1j * yi.numpy(), want) < 1e-14


def test_blocks_over_ranks_sum_to_the_whole():
    """Each rank's rows give a partial product; summed over ranks (what
    ``reduce`` does) the blocks are the whole signal's."""
    n, d = 1 << 12, 4
    xr, xi = signal(n)
    want = np.fft.fft(xr + 1j * xi)
    dft = DFT(torch.float64, "cpu")
    n1 = 1 << reference.first_factor_log(12)
    n2 = n // n1
    rows = n1 // d
    partial = []
    for r in range(d):
        sl = slice(r * rows * n2, (r + 1) * rows * n2)
        sums = []
        for _ in dft.blocks(torch.from_numpy(xr[sl]), torch.from_numpy(xi[sl]), n, r * rows,
                            reduce=lambda t, acc=sums: acc.append(t.clone())):
            pass
        partial.append(sums)
    totals = [sum(p[i] for p in partial) for i in range(len(partial[0]))]
    it = iter(totals)
    full = DFT(torch.float64, "cpu").signal(
        torch.from_numpy(xr[:rows * n2]), torch.from_numpy(xi[:rows * n2]), n, 0,
        reduce=lambda t: t.copy_(next(it)))
    got = full[0].numpy() + 1j * full[1].numpy()
    assert rel(got, want[:rows * n2]) < 1e-14


@pytest.mark.parametrize("dtype,low,high", [(torch.float32, 1e-8, 1e-5),
                                            (torch.bfloat16, 1e-4, 1e-1)])
def test_control_precision(dtype, low, high):
    """The controls' errors sit at their precision, far above float64's."""
    n = 1 << 14
    xr, xi = signal(n)
    want = np.fft.fft(xr + 1j * xi)
    yr, yi = DFT(dtype, "cpu").signal(torch.from_numpy(xr), torch.from_numpy(xi), n,
                                      out_dtype=torch.float64)
    assert low < rel(yr.numpy() + 1j * yi.numpy(), want) < high


def test_first_factor():
    assert [reference.first_factor_log(k) for k in (1, 8, 9, 12, 24, 30, 31)] == \
        [1, 8, 5, 6, 8, 8, 8]
