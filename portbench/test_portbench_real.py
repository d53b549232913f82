"""The real entry (R2C forward, C2R inverse) on the CPU at small sizes:
the cell checks, the reference's bins against ``torch.fft.rfft``, the
check by blocks of k1 that a row larger than a block takes, and the
fingerprints, which stay the complex cells' own."""

import json
import time

import numpy as np
import pytest
import torch

from portbench import harness, judge, reference, spec, systems
from portbench import traffic as tr

SEED = 2 ** 33 + 29
BENCH = spec.load_bench()


def real_cell(config: str, n: int, batch: int, step=("forward", "inverse")) -> spec.Cell:
    """A cell of the real entry on ``config``'s precision and limits."""
    with open(spec.ROOT / f"portbench/configs/{config}.json") as f:
        conf = dict(json.load(f), entry="real")
    traffic = {"config": config, "n": n, "batch": batch, "step": list(step), "ranks": 1,
               "input": "normal", "fingerprint": 64}
    return spec.Cell(f"real.{config}", 1, config, conf, traffic, [], [])


def checked(cell, system="port", seconds=0.05):
    t0 = time.time()
    parts = harness.run_rank(cell, [SEED], seconds, False, "cpu", system=system)
    out, _ = harness.result(cell, parts, t0, False, "cpu")
    return out


def rfft_rows(x, n):
    return torch.fft.rfft(x.double().reshape(-1, n))


@pytest.mark.parametrize("config", ["reuse-f32", "qsim30-f64"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("log_n", range(4, 13))
def test_real_entry_is_correct(config, batch, log_n):
    out = checked(real_cell(config, 1 << log_n, batch))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out["checks"]) == ["fwd_rel_l2", "roundtrip_rel_l2"]


def test_forward_alone_is_correct():
    out = checked(real_cell("qsim30-f64", 1 << 10, 2, step=("forward",)))
    assert out["correct"] and list(out["checks"]) == ["fwd_rel_l2"]


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("log_n", range(4, 13))
def test_reference_bins_are_rfft(batch, log_n):
    """The reference's wanted bins, 0..n/2 of the complex DFT of (x, 0),
    against ``torch.fft.rfft`` in float64."""
    n = 1 << log_n
    x = torch.randn(batch, n, dtype=torch.float64, generator=torch.Generator().manual_seed(log_n))
    yr, yi = reference.DFT(torch.float64, "cpu").rows(x, None)
    want = rfft_rows(x, n)
    got = torch.complex(yr[:, :n // 2 + 1], yi[:, :n // 2 + 1])
    assert float((got - want).norm() / want.norm()) < 1e-12


def test_real_reference_is_the_zero_plane_reference():
    """xi None gives the bits that a plane of zeros gives."""
    x = torch.randn(3, 1 << 10, dtype=torch.float64)
    dft = reference.DFT(torch.float64, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(dft.rows(x, None),
                                                  dft.rows(x, torch.zeros_like(x))))
    with pytest.raises(ValueError):
        dft.rows(x, None, inverse=True)


@pytest.mark.parametrize("block_points", [1 << 9, 1 << 20])
@pytest.mark.parametrize("batch", [1, 2])
def test_judge_reads_rfft_as_exact(monkeypatch, block_points, batch):
    """``judge._real_forward`` by whole rows and, a row larger than a block,
    by blocks of k1 (the Nyquist bin apart): rfft's bins read an error of
    nought to rounding, and the fingerprint's wants are rfft's bins."""
    monkeypatch.setattr(reference, "BLOCK_POINTS", block_points)
    monkeypatch.setattr(judge, "CHUNK", block_points)
    n = 1 << 12
    x = torch.randn(batch, n, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    want = rfft_rows(x, n)
    h = n // 2 + 1
    fp = torch.tensor([0, 1, h // 2, h - 2, h - 1] + ([h, 2 * h - 1] if batch > 1 else []))
    want_r = torch.empty(fp.numel(), dtype=torch.float64)
    want_i = torch.empty_like(want_r)
    num, den = judge._real_forward(reference.DFT(torch.float64, "cpu"), x,
                                   (want.real.contiguous(), want.imag.contiguous()), fp,
                                   want_r, want_i, n)
    assert (num / den) ** 0.5 < 1e-12
    assert den == pytest.approx(float(want.abs().square().sum()), rel=1e-12)
    flat = want.reshape(-1)[fp]
    assert torch.allclose(torch.complex(want_r, want_i), flat, rtol=0, atol=1e-9)


@pytest.mark.parametrize("system,correct", [("port", True), ("control", False),
                                            ("fault:conjugate", False)])
@pytest.mark.parametrize("batch", [1, 2])
def test_by_blocks_of_k1(monkeypatch, system, correct, batch):
    """The check and the control as they run a row larger than a block
    (f64 2^31 on the card), at 2^12 with blocks of 2^9 points."""
    monkeypatch.setattr(reference, "BLOCK_POINTS", 1 << 9)
    monkeypatch.setattr(judge, "CHUNK", 1 << 9)
    out = checked(real_cell("qsim30-f64", 1 << 12, batch), system)
    assert out["correct"] is correct


@pytest.mark.parametrize("batch", [1, 3])
def test_control_is_rfft_in_float32(batch):
    """The f64 cell's control: its R2C the bins of rfft and its C2R the
    signal again, to float32's rounding and no closer."""
    n = 1 << 12
    cell = real_cell("qsim30-f64", n, batch)
    shape = (n,) if batch == 1 else (batch, n)
    x = torch.randn(shape, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    control = systems.Control(cell.config, cell.traffic, "cpu")
    spec_ = control.forward(x)
    for p in spec_:  # contiguous bins of their own, not a view of the whole spectrum
        assert p.shape == (*shape[:-1], n // 2 + 1) and p.dtype == torch.float64
        assert p.is_contiguous() and p.untyped_storage().nbytes() == 8 * p.numel()
    want = rfft_rows(x, n)
    got = torch.complex(*spec_).reshape(want.shape)
    assert 1e-9 < float((got - want).norm() / want.norm()) < 1e-5
    (back,) = control.inverse(*spec_)
    assert back.shape == x.shape and 1e-9 < float((back - x).norm() / x.norm()) < 1e-5


def real_conf(precision="f64"):
    return {"source": "s", "deployment": "d", "precision": precision, "entry": "real",
            "limits": {}, "assumed": []}


def traffic(step=("forward", "inverse"), ranks=1, batch=1):
    return {"config": "c", "n": 1 << 10, "batch": batch, "step": list(step), "ranks": ranks,
            "input": "normal", "fingerprint": 8}


def test_spec_takes_the_real_entry():
    for precision in ("f32", "f64"):
        spec.check_config(real_conf(precision), "c")
    for step in (("forward",), ("forward", "inverse")):
        spec.check_pair(real_conf(), traffic(step), 1, "w")
    with pytest.raises(ValueError):
        spec.check_config(dict(real_conf(), entry="reals"), "c")


@pytest.mark.parametrize("step,ranks,chips", [
    (("inverse",), 1, 1),          # an inverse first needs a Hermitian input
    (("forward", "inverse"), 2, 2),  # the real entry is one rank
    (("forward", "inverse"), 4, 1),
    (("forward", "inverse"), 1, 4),
])
def test_spec_refuses(step, ranks, chips):
    with pytest.raises(ValueError):
        spec.check_pair(real_conf(), traffic(step, ranks), chips, "w")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_fingerprints_of_the_cells_stay(name):
    """Every call of a complex cell keeps the points that the one draw over
    the input's size has always given, for seeds 0-3 and every rank."""
    cell = spec.cell(name, BENCH)
    size = int(np.prod(tr.local_shape(cell.traffic)))
    for seed in range(4):
        for rank in range(cell.traffic["ranks"]):
            rng = np.random.default_rng([seed, rank, 1])
            want = np.sort(rng.choice(size, size=min(cell.traffic["fingerprint"], size),
                                      replace=False))
            got = tr.fingerprint_index(cell.traffic, seed, rank, "cpu")
            assert len(got) == len(cell.traffic["step"])
            for idx in got:
                assert idx.dtype == torch.int64 and np.array_equal(idx.numpy(), want)


def test_real_fingerprints_fit_each_output():
    t = dict(traffic(batch=3), n=16, fingerprint=64)
    fwd, inv = tr.fingerprint_index(t, SEED, 0, "cpu", real=True)
    assert tr.output_sizes(t, real=True) == [27, 48]
    assert fwd.numel() == inv.numel() == 27
    assert int(fwd.max()) < 27 and int(inv.max()) < 48
    assert len(set(inv.tolist())) == 27
    x, = tr.make_input(t, SEED, 0, torch.float64, "cpu", real=True)
    xr, _ = tr.make_input(t, SEED, 0, torch.float64, "cpu")
    assert torch.equal(x, xr)
