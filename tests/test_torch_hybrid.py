"""The opt-in hybrid leaf (``Options.leaf_kernel="hybrid"``) on the CPU.

``hybrid_plain`` against the Pallas kernel it replaces,
``phastft_tpu.ops.pallas_leaf.leaf_fft_pallas_hybrid`` in interpret mode
(as tests/test_pallas_leaf.py runs it), on the JAX planner's operands
carried into the port's planner by ``from_numpy_tables``: the same
Stockham steps and Karatsuba products in the same order, so rel L2 <= 1e-6.
The public entries with the hybrid leaf against the JAX package's same
call and numpy's f64 FFT, and the dispatch rules of ``leaf_kernel``.
"""

import numpy as np
import pytest
import torch

import phastft_tpu
import phastft_tpu_torch as pt
from phastft_tpu_torch.ops.route import KERNELS
from phastft_tpu_torch.ops.leaf import hybrid, hybrid_plain, leaf3
from phastft_tpu_torch.tracing import launch_count


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-6


def _bound(n):
    # the leaf plans' bound (tests/test_torch_fft.py)
    return 5e-7 * max(1.0, (n.bit_length() - 1) / 18.0)


def _pair(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _c(pair):
    return np.asarray(pair[0], np.float64) + 1j * np.asarray(pair[1], np.float64)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _carried(n, **opts):
    """A port planner on the JAX planner's tables, and the JAX planner."""
    jp = phastft_tpu.PlannerDit32(n, options=phastft_tpu.Options(**opts))
    tables = {k: tuple(np.asarray(a) for a in v) for k, v in jp.leaf_corrs.items()}
    mine = pt.PlannerDit32.from_numpy_tables(n, tables, device="cpu",
                                             options=pt.Options(**opts))
    return mine, jp


def _carried_leaf(n1):
    """``_carried`` for the leaf plan of n1 * 128 points (the 2^17 leaf
    needs ``leaf_fft_size=2^17``)."""
    n = n1 * 128
    return _carried(n, **({"leaf_fft_size": n} if n > 1 << 16 else {}))


def _hybrid_mats(planner, n1):
    corrs = planner.tables_for(planner.plan, "hybrid")
    return corrs[f"mxu{n1}"][3:6] + corrs[f"leaf{n1}"]


@pytest.fixture
def hybrid_calls(monkeypatch):
    """Counts the dispatcher's calls of ``hybrid`` (on the CPU the wrapper
    runs its plain version and launches nothing)."""
    calls = []

    def counted(*args):
        calls.append(args[3])
        return hybrid(*args)

    monkeypatch.setattr(KERNELS, "hybrid", counted)
    return calls


@pytest.mark.parametrize("n1,rows", [(8, 2), (16, 8), (512, 8), (1024, 2)])
def test_hybrid_plain_matches_pallas(n1, rows):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from phastft_tpu.ops.pallas_leaf import leaf_fft_pallas_hybrid

    n = n1 * 128
    mine, jp = _carried_leaf(n1)
    rng = np.random.default_rng(n1 + rows)
    re, im = _pair(rng, (rows, n))
    jmats = jp.leaf_corrs[f"mxu{n1}"][3:6] + jp.leaf_corrs[f"leaf{n1}"]
    with pltpu.force_tpu_interpret_mode():
        want = leaf_fft_pallas_hybrid(jnp.asarray(re), jnp.asarray(im), jmats, n1)
    before = launch_count("hybrid")
    got = hybrid(torch.from_numpy(re), torch.from_numpy(im),
                 _hybrid_mats(mine, n1), n1)
    assert launch_count("hybrid") == before  # CPU: no kernel launch
    assert all(tuple(g.shape) == (rows, n) for g in got)
    assert _rel(_c(got), _c(want)) <= TOL
    x = re.astype(np.float64) + 1j * im
    assert _rel(_c(got), np.fft.fft(x, axis=-1)) <= _bound(n)


@pytest.mark.parametrize("log_n", [8, 12, 16])
@pytest.mark.parametrize("where", ["per_call", "planner"])
def test_entries_with_hybrid_match_jax_and_numpy(log_n, where, hybrid_calls):
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    re, im = _pair(rng, (3, n))
    opts = pt.Options(leaf_kernel="hybrid")
    if where == "per_call":
        got = pt.fft_32_dit_with_planner_and_opts(
            re, im, pt.Direction.Forward, pt.PlannerDit32(n, device="cpu"), opts)
    else:
        got = pt.fft_32_dit_with_planner(
            re, im, pt.Direction.Forward,
            pt.PlannerDit32(n, options=opts, device="cpu"))
    assert hybrid_calls == [n // 128]
    ref = phastft_tpu.fft_32_dit_with_planner_and_opts(
        re, im, phastft_tpu.Direction.Forward, phastft_tpu.PlannerDit32(n),
        phastft_tpu.Options(leaf_kernel="hybrid"))
    g = _c(got)
    assert _rel(g, np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1)) <= _bound(n)
    assert _rel(g, _c(ref)) <= TOL


@pytest.mark.parametrize("direction", ["Forward", "Reverse"])
def test_classic_plan_with_hybrid_inner_leaf(direction, hybrid_calls):
    """2^20 on a 2^16 leaf: one classic level (n1 = 16) over hybrid rows."""
    n = 1 << 20
    opts = dict(leaf_fft_size=1 << 16, leaf_kernel="hybrid")
    mine, jp = _carried(n, **opts)
    assert mine.plan == jp.plan == ("split", 16, ("leaf", 512), 1 << 16)
    rng = np.random.default_rng(20)
    re, im = _pair(rng, (n,))
    got = pt.fft_32_dit_with_planner(re, im, getattr(pt.Direction, direction), mine)
    assert hybrid_calls == [512]
    ref = phastft_tpu.fft_32_dit_with_planner(
        re, im, getattr(phastft_tpu.Direction, direction), jp)
    x = re.astype(np.float64) + 1j * im
    want = np.fft.fft(x) if direction == "Forward" else np.fft.ifft(x)
    g = _c(got)
    assert _rel(g, want) <= _bound(n)
    assert _rel(g, _c(ref)) <= TOL


def test_hybrid_roundtrip_and_batch_dims(hybrid_calls):
    n = 1 << 16
    planner = pt.PlannerDit32(n, options=pt.Options(leaf_kernel="hybrid"),
                              device="cpu")
    rng = np.random.default_rng(16)
    re, im = _pair(rng, (2, 2, n))
    fwd = pt.fft_32_dit_with_planner(re, im, pt.Direction.Forward, planner)
    back = pt.fft_32_dit_with_planner(fwd[0], fwd[1], pt.Direction.Reverse, planner)
    assert hybrid_calls == [512, 512]
    assert all(tuple(x.shape) == (2, 2, n) for x in back)
    assert _rel(_c(back), re.astype(np.float64) + 1j * im) <= 1e-6


def test_planner_2_16_builds_the_hybrid_tables_on_demand():
    """The default 2^16 planner holds only leaf3's mxu3_512; the first
    hybrid dispatch builds mxu512 and leaf512 under the JAX planner's keys,
    equal to its tables bit for bit, and keeps them. A planner carried
    over from the JAX planner's tables takes them from there."""
    n = 1 << 16
    mine = pt.PlannerDit32(n, device="cpu")
    ref = phastft_tpu.PlannerDit32(n).leaf_corrs
    assert set(mine.leaf_corrs) == {"mxu3_512"}
    assert mine.tables_for(mine.plan) is mine.leaf_corrs
    corrs = mine.tables_for(mine.plan, "hybrid")
    assert set(corrs) == {"mxu512", "leaf512"}
    assert mine.tables_for(mine.plan, "hybrid") is corrs
    assert set(mine.leaf_corrs) == {"mxu3_512"}
    for key in ("mxu512", "leaf512"):
        for a, b in zip(corrs[key], ref[key]):
            assert np.array_equal(a.numpy(), np.asarray(b))
    carried, _ = _carried(n)
    assert set(carried.leaf_corrs) == {"mxu3_512"}
    assert set(carried.tables_for(carried.plan, "hybrid")) == {"mxu512", "leaf512"}


@pytest.mark.parametrize("log_n,kernel,want", [
    (16, None, []), (16, "mxu3", []), (12, "mxu2", []), (12, "bogus", []),
    (7, "hybrid", []), (6, "hybrid", []), (9, "hybrid", [4]),
])
def test_leaf_kernel_dispatch(log_n, kernel, want, hybrid_calls):
    """Only "hybrid" with n1 > 1 runs the hybrid; the 128-point leaf, tiny
    plans and every other value keep the default kernels."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    re, im = _pair(rng, (2, n))
    got = pt.fft_32_dit_with_planner_and_opts(
        re, im, pt.Direction.Forward, pt.PlannerDit32(n, device="cpu"),
        pt.Options(leaf_kernel=kernel))
    assert hybrid_calls == want
    x = re.astype(np.float64) + 1j * im
    assert _rel(_c(got), np.fft.fft(x, axis=-1)) <= _bound(n)


# -- the 2^17 leaf: n1 = 1024, the JAX planner's largest hybrid leaf ---------

LEAF17 = dict(leaf_fft_size=1 << 17, leaf_kernel="hybrid")


@pytest.mark.parametrize("where", ["per_call", "planner"])
def test_2_17_leaf_with_hybrid_matches_jax_and_numpy(where, hybrid_calls):
    """The ("leaf", 1024) plan runs the hybrid at n1 = 1024, not leaf3."""
    n = 1 << 17
    rng = np.random.default_rng(17)
    re, im = _pair(rng, (2, n))
    mine, jp = _carried(n, **LEAF17)
    assert mine.plan == jp.plan == ("leaf", 1024)
    if where == "per_call":
        planner = pt.PlannerDit32(n, options=pt.Options(leaf_fft_size=1 << 17),
                                  device="cpu")
        got = pt.fft_32_dit_with_planner_and_opts(
            re, im, pt.Direction.Forward, planner, pt.Options(leaf_kernel="hybrid"))
    else:
        got = pt.fft_32_dit_with_planner(re, im, pt.Direction.Forward, mine)
    assert hybrid_calls == [1024]
    ref = phastft_tpu.fft_32_dit_with_planner(re, im, phastft_tpu.Direction.Forward, jp)
    g = _c(got)
    assert _rel(g, np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1)) <= _bound(n)
    assert _rel(g, _c(ref)) <= TOL


@pytest.mark.parametrize("direction", ["Forward", "Reverse"])
def test_classic_2_18_plan_over_hybrid_2_17_leaf(direction, hybrid_calls):
    """2^18 on a 2^17 leaf: one classic level (n1 = 2) over hybrid rows."""
    n = 1 << 18
    mine, jp = _carried(n, **LEAF17)
    assert mine.plan == jp.plan == ("split", 2, ("leaf", 1024), 1 << 17)
    rng = np.random.default_rng(18)
    re, im = _pair(rng, (n,))
    got = pt.fft_32_dit_with_planner(re, im, getattr(pt.Direction, direction), mine)
    assert hybrid_calls == [1024]
    ref = phastft_tpu.fft_32_dit_with_planner(
        re, im, getattr(phastft_tpu.Direction, direction), jp)
    x = re.astype(np.float64) + 1j * im
    want = np.fft.fft(x) if direction == "Forward" else np.fft.ifft(x)
    g = _c(got)
    assert _rel(g, want) <= _bound(n)
    assert _rel(g, _c(ref)) <= TOL


def test_r2c_2_18_over_hybrid_2_17_leaf(hybrid_calls):
    """An f32 R2C of 2^18 reals: its 2^17-point C2C on the hybrid leaf."""
    n = 1 << 18
    x = np.random.default_rng(181).standard_normal((n,)).astype(np.float32)
    mine = pt.PlannerR2c32(n, inner_options=pt.Options(**LEAF17), device="cpu")
    jp = phastft_tpu.PlannerR2c32(n, inner_options=phastft_tpu.Options(**LEAF17))
    assert mine.dit_planner.plan == ("leaf", 1024)
    got = pt.r2c_fft_f32_with_planner(x, mine)
    assert hybrid_calls == [1024]
    want = phastft_tpu.r2c_fft_f32_with_planner(x, jp)
    g = _c(got)
    assert g.shape == (n // 2 + 1,)
    assert _rel(g, _c(want)) <= TOL
    assert _rel(g, np.fft.rfft(x.astype(np.float64))) <= _bound(n)


def test_planner_2_17_builds_the_hybrid_tables_on_demand():
    """The 2^17 leaf planner holds only leaf3's mxu3_1024; the hybrid's
    mxu1024 and leaf1024 are built on demand, equal to the JAX planner's
    bit for bit, and carried over from them by from_numpy_tables."""
    n = 1 << 17
    mine = pt.PlannerDit32(n, options=pt.Options(leaf_fft_size=n), device="cpu")
    ref = phastft_tpu.PlannerDit32(
        n, options=phastft_tpu.Options(leaf_fft_size=n)).leaf_corrs
    assert set(mine.leaf_corrs) == {"mxu3_1024"}
    corrs = mine.tables_for(mine.plan, "hybrid")
    assert set(corrs) == {"mxu1024", "leaf1024"}
    assert mine.tables_for(mine.plan, "hybrid") is corrs
    assert set(mine.leaf_corrs) == {"mxu3_1024"}
    for key in ("mxu1024", "leaf1024"):
        for a, b in zip(corrs[key], ref[key], strict=True):
            assert np.array_equal(a.numpy(), np.asarray(b))
    carried, _ = _carried(n, **LEAF17)
    assert set(carried.leaf_corrs) == {"mxu3_1024"}
    assert set(carried.tables_for(carried.plan, "hybrid")) == {"mxu1024", "leaf1024"}


def test_2_17_leaf_without_hybrid_runs_leaf3(hybrid_calls, monkeypatch):
    """Without "hybrid" the 2^17 leaf keeps leaf3 at a = 256."""
    calls3 = []

    def counted(*args):
        calls3.append(args[3])
        return leaf3(*args)

    monkeypatch.setattr(KERNELS, "leaf3", counted)
    n = 1 << 17
    rng = np.random.default_rng(171)
    re, im = _pair(rng, (1, n))
    planner = pt.PlannerDit32(n, options=pt.Options(leaf_fft_size=n), device="cpu")
    got = pt.fft_32_dit_with_planner(re, im, pt.Direction.Forward, planner)
    assert hybrid_calls == []
    assert calls3 == [256]
    x = re.astype(np.float64) + 1j * im
    assert _rel(_c(got), np.fft.fft(x, axis=-1)) <= _bound(n)


def _mats(n1, dtype=torch.float32):
    planner = pt.PlannerDit32(n1 * 128, device="cpu")
    return tuple(m.to(dtype) for m in _hybrid_mats(planner, n1))


@pytest.mark.parametrize("case", ["n1_1", "n1_2048", "not_pow2", "tables",
                                  "f64", "shapes", "numpy"])
def test_hybrid_rejects_bad_arguments(case):
    x = torch.zeros(2, 1024)
    args = {
        "n1_1": (x[:, :128], x[:, :128], _mats(8), 1),
        "n1_2048": (torch.zeros(1, 1 << 18), torch.zeros(1, 1 << 18), _mats(8), 2048),
        "not_pow2": (torch.zeros(1, 768), torch.zeros(1, 768), _mats(8), 6),
        "tables": (x, x, _mats(16), 8),
        "f64": (x.double(), x.double(), _mats(8), 8),
        "shapes": (x, x[:1], _mats(8), 8),
        "numpy": (x.numpy(), x.numpy(), _mats(8), 8),
    }[case]
    err = TypeError if case in ("f64", "numpy") else ValueError
    for fn in (hybrid, hybrid_plain):
        with pytest.raises(err):
            fn(*args)


# -- the kernel's 3xTF32 contraction, emulated in torch ----------------------
# csrc/hybrid.cu contracts F(128) on the tensor cores in TF32. Each operand
# x is split into big = tf32(x) and small = tf32(x - big), tf32 rounding to
# nearest with ties away (add 0x1000 to the bits, clear the low 13), and a
# product is big*big + big*small + small*big with small*small dropped. The
# kernel sums each run of 16 i2 on its own, k-step by k-step and small terms
# first, and adds that to its f32 sums: k-step s of the run from k0 takes
# i2 = k0 + 4t + 2s + h, t < 4, h < 2.

def _tf32(x):
    bits = (x.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _tc_product(f, u, passes):
    """sum_i2 f[k2, i2] u[b, i2, k1] as the kernel forms it: (b, k2, k1)."""
    fb, fs = _split(f)
    ub, us = _split(u)
    terms = [(fb, ub), (fb, us), (fs, ub)][:passes]
    acc = torch.zeros(u.shape[0], f.shape[0], u.shape[2])
    for k0 in range(0, f.shape[1], 16):
        d = torch.zeros_like(acc)
        for s in (0, 1):
            step = torch.tensor([k0 + 4 * t + 2 * s + h for t in range(4) for h in (0, 1)])
            for a, b in reversed(terms):
                d = d + torch.matmul(a[:, step], b[:, step, :])
        acc = acc + d
    return acc


def _emulated_hybrid(re, im, mats, n1, passes=3):
    """hybrid_plain with the contraction in the kernel's 3xTF32 form (one
    pass: big*big alone). F_s is F_r + F_i in f32, as the planner's."""
    from phastft_tpu_torch.ops.stockham import stockham_axis2

    f2r, f2i, _, cr, ci = mats
    b = re.shape[0]
    tr, ti = stockham_axis2(re.reshape(b, n1, 128), im.reshape(b, n1, 128), n1)
    ur = (tr * cr - ti * ci).transpose(1, 2)
    ui = (tr * ci + ti * cr).transpose(1, 2)
    q1 = _tc_product(f2r, ur, passes)
    q2 = _tc_product(f2i, ui, passes)
    q3 = _tc_product(f2r + f2i, ur + ui, passes)
    return (q1 - q2).reshape(b, -1), (q3 - q1 - q2).reshape(b, -1)


def _rows(kind, rng, shape):
    re, im = _pair(rng, shape)
    if kind == "range_1e6":  # magnitudes spread over six decades
        re = re * (10.0 ** rng.uniform(0.0, 6.0, shape)).astype(np.float32)
        im = im * (10.0 ** rng.uniform(0.0, 6.0, shape)).astype(np.float32)
    return re, im


@pytest.mark.parametrize("kind", ["randn", "range_1e6"])
@pytest.mark.parametrize("n1", [2, 8, 64, 128, 256, 512, 1024])
def test_3xtf32_contraction_holds_parity(n1, kind):
    """The kernel's arithmetic, emulated: within 1e-6 of hybrid_plain and
    of the Pallas kernel in interpret mode, and within the leaf plans'
    bound of numpy's f64 FFT."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from phastft_tpu.ops.pallas_leaf import leaf_fft_pallas_hybrid

    n = n1 * 128
    mine, jp = _carried_leaf(n1)
    mats = _hybrid_mats(mine, n1)
    assert torch.equal(mats[0] + mats[1], mats[2])
    rng = np.random.default_rng(n1 + (7 if kind == "randn" else 11))
    re, im = _rows(kind, rng, (2, n))
    got = _emulated_hybrid(torch.from_numpy(re), torch.from_numpy(im), mats, n1)
    plain = hybrid_plain(torch.from_numpy(re), torch.from_numpy(im), mats, n1)
    jmats = jp.leaf_corrs[f"mxu{n1}"][3:6] + jp.leaf_corrs[f"leaf{n1}"]
    with pltpu.force_tpu_interpret_mode():
        want = leaf_fft_pallas_hybrid(jnp.asarray(re), jnp.asarray(im), jmats, n1)
    g = _c(got)
    assert _rel(g, _c(plain)) <= TOL
    assert _rel(g, _c(want)) <= TOL
    x = re.astype(np.float64) + 1j * im
    assert _rel(g, np.fft.fft(x, axis=-1)) <= _bound(n)


def test_one_tf32_pass_misses_parity():
    """big*big alone, plain TF32, misses 1e-6: the emulation can fail."""
    n1 = 64
    mine, _ = _carried(n1 * 128)
    mats = _hybrid_mats(mine, n1)
    re, im = _pair(np.random.default_rng(3), (2, n1 * 128))
    x = torch.from_numpy(re), torch.from_numpy(im)
    got = _emulated_hybrid(*x, mats, n1, passes=1)
    assert _rel(_c(got), _c(hybrid_plain(*x, mats, n1))) > 10 * TOL
