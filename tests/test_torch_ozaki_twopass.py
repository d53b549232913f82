"""The port's plain Ozaki two-pass (``ozcol`` -> ``ozleaft``) on the CPU,
against the JAX package's fused two-pass kernels (``ops/pallas_ozdd.py``)
and numpy.

The JAX kernels run under the Pallas interpreter, which breaks TwoSum (see
tests/test_ozaki.py), so the port's plain versions are held to those runs at
that test's own 1e-6, and to numpy's f64 FFT at 1e-10 (the contract bound;
~1e-11 is the slice truncation). The interpreter's runs take minutes, so
this test lives apart from tests/test_torch_ozaki.py: a file runs on one
worker.
"""

import numpy as np
import pytest
import torch

from phastft_tpu_torch.ops import ozdd
from phastft_tpu_torch.ops.df64 import split_hi_lo


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


OZ_TOL = 1e-10        # the f64 contract; the slice truncation is ~1e-11
INTERPRET_TOL = 1e-6  # tests/test_ozaki.py's gate for interpret-mode runs


def _f32(x):
    """A JAX or torch array (bf16 included) as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _joined(quad):
    return (_f32(quad[0]).astype(np.float64) + _f32(quad[1])
            + 1j * (_f32(quad[2]).astype(np.float64) + _f32(quad[3])))


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _tabs_torch(arrays, n_slices):
    return tuple(torch.from_numpy(a).to(torch.bfloat16 if i < n_slices
                                        else torch.float32)
                 for i, a in enumerate(arrays))


SHAPES = [(128, 1024), (256, 1024)]


@pytest.fixture(scope="module")
def jax_two_pass():
    """The JAX package's ozcol_pallas -> ozleaft_pallas in interpret mode,
    once per shape for the module: {(n1, n2): (x, relayout, output)}."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from phastft_tpu.ops.pallas_ozdd import (
        ozcol_pallas, ozcol_tables_host, ozleaft_pallas, ozleaft_tables_host,
    )

    runs = {}
    for n1, n2 in SHAPES:
        rng = np.random.default_rng(n1)
        n = n1 * n2
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        arrs = [jnp.asarray(a).reshape(n1, n2)
                for pair in (split_hi_lo(x.real), split_hi_lo(x.imag))
                for a in pair]
        ctabs = tuple(jnp.asarray(a) for a in ozcol_tables_host(n1, n2))
        ltabs = tuple(jnp.asarray(a) for a in ozleaft_tables_host(n2))
        with pltpu.force_tpu_interpret_mode():
            c = ozcol_pallas(*arrs, ctabs, n1)
            out = ozleaft_pallas(*c, ltabs, n1)
        runs[(n1, n2)] = (x, c, out)
    return runs


@pytest.mark.parametrize("n1,n2", SHAPES)
def test_two_pass_plain_matches_pallas_and_numpy(jax_two_pass, n1, n2):
    x, jc, jout = jax_two_pass[(n1, n2)]
    planes = [torch.from_numpy(a).reshape(n1, n2)
              for pair in (split_hi_lo(x.real), split_hi_lo(x.imag)) for a in pair]
    ctabs = _tabs_torch(ozdd.ozcol_tables_host(n1, n2), ozdd.OZCOL_SLICES)
    ltabs = _tabs_torch(ozdd.ozleaft_tables_host(n2), ozdd.OZLEAFT_SLICES)
    c = ozdd.ozcol(*planes, ctabs, n1)  # CPU tensors: the plain version
    assert tuple(c[0].shape) == (n2 // 128, n1, 128) == tuple(jc[0].shape)
    assert _rel(_joined(c), _joined(jc)) <= INTERPRET_TOL
    out = ozdd.ozleaft(*c, ltabs, n1)
    assert tuple(out[0].shape) == (n1 * n2,)
    got = _joined(out)
    assert _rel(got, _joined(jout)) <= INTERPRET_TOL
    assert _rel(got, np.fft.fft(x)) <= OZ_TOL
