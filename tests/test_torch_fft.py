"""The port's public C2C entries on the CPU, against the JAX package and
numpy's f64 FFT, plus its error paths.

The error-path tests mirror tests/test_errors.py on the f32 and f64
entries: the same classes and messages. PlannerMode.Tune, the staged
strategy and use_pallas=False run (tests/test_torch_tune.py,
test_torch_staged.py and test_torch_plain.py hold them to the JAX
package); n = 2^31 is planned as the JAX package plans it, and leaves outside 128..2^16 points run. The f64 entries run the df64 (paired-f32)
engine; their tolerances are on f64 values.
"""

import numpy as np
import pytest
import torch

import phastft_tpu
import phastft_tpu_torch as pt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 1 << 17


def _bound(n):
    # f32 FFT error grows ~sqrt(log n): the bound of tests/test_pallas_leaft.py
    return 5e-7 * max(1.0, (n.bit_length() - 1) / 18.0)


def _pair(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _c(pair):
    return np.asarray(pair[0], np.float64) + 1j * np.asarray(pair[1], np.float64)


@pytest.mark.parametrize("log_n", [17, 18])
@pytest.mark.parametrize("direction", ["Forward", "Reverse"])
def test_matches_jax_and_numpy(log_n, direction):
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    re, im = _pair(rng, (2, n))
    got = pt.fft_32_dit(re, im, getattr(pt.Direction, direction), device="cpu")
    assert all(isinstance(x, torch.Tensor) and x.dtype == torch.float32
               and x.device.type == "cpu" and tuple(x.shape) == (2, n)
               for x in got)
    ref = phastft_tpu.fft_32_dit(re, im, getattr(phastft_tpu.Direction, direction))
    x = re.astype(np.float64) + 1j * im
    want = np.fft.fft(x, axis=-1) if direction == "Forward" else np.fft.ifft(x, axis=-1)
    g = _c((got[0].numpy(), got[1].numpy()))
    assert _rel(g, want) <= _bound(n)
    assert _rel(g, _c(ref)) <= 2 * _bound(n)


def test_unaligned_f32_view_is_copied_aligned():
    # a contiguous f32 view that starts 4 bytes past a 16-byte boundary:
    # the kernels load float4s, so _as_tensor hands them an aligned copy
    from phastft_tpu_torch.fft import _as_tensor

    n = N
    rng = np.random.default_rng(6)
    re, im = _pair(rng, (n,))
    bufs = []
    for plane in (re, im):
        buf = torch.zeros(n + 4, dtype=torch.float32)
        buf[1:1 + n] = torch.from_numpy(plane)
        bufs.append(buf)
    views = [buf[1:1 + n] for buf in bufs]
    assert all(v.is_contiguous() and v.data_ptr() % 16 == 4 for v in views)
    planner = pt.PlannerDit32(n, device="cpu")
    got = _as_tensor(views[0], planner)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, views[0])
    aligned = torch.from_numpy(re.copy())
    assert aligned.data_ptr() % 16 == 0
    assert _as_tensor(aligned, planner).data_ptr() == aligned.data_ptr()
    out = pt.fft_32_dit(views[0], views[1], pt.Direction.Forward, device="cpu")
    ref = phastft_tpu.fft_32_dit(re, im, phastft_tpu.Direction.Forward)
    want = np.fft.fft(re.astype(np.float64) + 1j * im)
    g = _c((out[0].numpy(), out[1].numpy()))
    assert _rel(g, want) <= _bound(n)
    assert _rel(g, _c(ref)) <= 2 * _bound(n)
    assert torch.equal(bufs[0][1:1 + n], torch.from_numpy(re))  # input untouched


def test_roundtrip():
    rng = np.random.default_rng(5)
    re, im = _pair(rng, (N,))
    fwd = pt.fft_32_dit(re, im, pt.Direction.Forward, device="cpu")
    back = pt.fft_32_dit(fwd[0], fwd[1], pt.Direction.Reverse, device="cpu")
    x = re.astype(np.float64) + 1j * im
    assert _rel(_c((back[0].numpy(), back[1].numpy())), x) <= 1e-6


def test_planner_reuse_and_inputs_untouched():
    rng = np.random.default_rng(9)
    planner = pt.PlannerDit32(N, device="cpu")
    for _ in range(3):
        re, im = _pair(rng, (3, N))
        tre, tim = torch.from_numpy(re.copy()), torch.from_numpy(im.copy())
        got = pt.fft_32_dit_with_planner(tre, tim, pt.Direction.Forward, planner)
        want = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1)
        assert _rel(_c((got[0].numpy(), got[1].numpy())), want) <= _bound(N)
        # the caller's tensors are never written (no buffer donation)
        assert np.array_equal(tre.numpy(), re) and np.array_equal(tim.numpy(), im)
    opts = pt.Options.guess_options(N, np.float32)
    got2 = pt.fft_32_dit_with_planner_and_opts(re, im, "f", planner, opts)
    assert torch.equal(got2[0], got[0]) and torch.equal(got2[1], got[1])


def test_leading_batch_dims():
    rng = np.random.default_rng(21)
    re, im = _pair(rng, (2, 3, N))
    got = pt.fft_32_dit(re, im, pt.Direction.Reverse, device="cpu")
    assert tuple(got[0].shape) == (2, 3, N)
    want = np.fft.ifft(re.astype(np.float64) + 1j * im, axis=-1)
    assert _rel(_c((got[0].numpy(), got[1].numpy())), want) <= _bound(N)


def test_planner_from_jax_tables():
    """A planner built on the JAX planner's tables computes the same result
    as the port's own planner: both start from the same bits."""
    jp = phastft_tpu.PlannerDit32(N)
    tables = {k: tuple(np.asarray(a) for a in v)
              for k, v in jp.leaf_corrs.items()}
    carried = pt.PlannerDit32.from_numpy_tables(N, tables, device="cpu")
    own = pt.PlannerDit32(N, device="cpu")
    assert carried.plan == own.plan == jp.plan
    assert set(carried.leaf_corrs) == set(own.leaf_corrs)
    rng = np.random.default_rng(13)
    re, im = _pair(rng, (N,))
    a = pt.fft_32_dit_with_planner(re, im, pt.Direction.Forward, carried)
    b = pt.fft_32_dit_with_planner(re, im, pt.Direction.Forward, own)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(KeyError):
        pt.PlannerDit32.from_numpy_tables(N, {}, device="cpu")


# -- the leaf plans, n <= 2^16 ------------------------------------------------

@pytest.mark.parametrize("log_n", [0, 1, 3, 6, 7, 8, 12, 15, 16])
@pytest.mark.parametrize("direction", ["Forward", "Reverse"])
def test_leaf_sizes_match_jax_and_numpy(log_n, direction):
    n = 1 << log_n
    rng = np.random.default_rng(100 + log_n)
    re, im = _pair(rng, (3, n))
    got = pt.fft_32_dit(re, im, getattr(pt.Direction, direction), device="cpu")
    assert all(tuple(x.shape) == (3, n) and x.dtype == torch.float32
               for x in got)
    ref = phastft_tpu.fft_32_dit(re, im, getattr(phastft_tpu.Direction, direction))
    x = re.astype(np.float64) + 1j * im
    want = np.fft.fft(x, axis=-1) if direction == "Forward" else np.fft.ifft(x, axis=-1)
    g = _c((got[0].numpy(), got[1].numpy()))
    assert _rel(g, want) <= _bound(n)
    assert _rel(g, _c(ref)) <= 1e-6


@pytest.mark.parametrize("log_n", [6, 12, 16])
def test_leaf_leading_batch_dims(log_n):
    n = 1 << log_n
    rng = np.random.default_rng(40 + log_n)
    re, im = _pair(rng, (2, 3, n))
    got = pt.fft_32_dit(re, im, pt.Direction.Forward, device="cpu")
    assert tuple(got[0].shape) == (2, 3, n)
    want = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1)
    assert _rel(_c((got[0].numpy(), got[1].numpy())), want) <= _bound(n)


def test_leaf_roundtrip():
    n = 1 << 16
    rng = np.random.default_rng(6)
    re, im = _pair(rng, (2, n))
    fwd = pt.fft_32_dit(re, im, pt.Direction.Forward, device="cpu")
    back = pt.fft_32_dit(fwd[0], fwd[1], pt.Direction.Reverse, device="cpu")
    x = re.astype(np.float64) + 1j * im
    assert _rel(_c((back[0].numpy(), back[1].numpy())), x) <= 1e-6


@pytest.mark.parametrize("log_n", [8, 16])
def test_leaf_planner_from_jax_tables(log_n):
    """A leaf planner built on the JAX planner's leaf_corrs (which hold
    more keys than the port reads) computes what the port's own does."""
    n = 1 << log_n
    jp = phastft_tpu.PlannerDit32(n)
    tables = {k: tuple(np.asarray(a) for a in v)
              for k, v in jp.leaf_corrs.items()}
    carried = pt.PlannerDit32.from_numpy_tables(n, tables, device="cpu")
    own = pt.PlannerDit32(n, device="cpu")
    assert carried.plan == own.plan == jp.plan
    assert set(carried.leaf_corrs) == set(own.leaf_corrs)
    rng = np.random.default_rng(log_n)
    re, im = _pair(rng, (2, n))
    a = pt.fft_32_dit_with_planner(re, im, pt.Direction.Forward, carried)
    b = pt.fft_32_dit_with_planner(re, im, pt.Direction.Forward, own)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_length_one_returns_new_tensors():
    """n = 1 is a copy: new tensors, and the inverse's 1/n scale, applied
    in place to the result, never reaches the caller's tensors."""
    re = torch.arange(3, dtype=torch.float32).reshape(3, 1) + 1.0
    im = -re
    keep_re, keep_im = re.clone(), im.clone()
    for direction in (pt.Direction.Forward, pt.Direction.Reverse):
        out = pt.fft_32_dit(re, im, direction, device="cpu")
        assert all(o.data_ptr() not in (re.data_ptr(), im.data_ptr())
                   for o in out)
        assert torch.equal(out[0], keep_re) and torch.equal(out[1], keep_im)
    assert torch.equal(re, keep_re) and torch.equal(im, keep_im)


# -- nested and classic plans -------------------------------------------------

#: (log2 n, leaf_fft_size, batch): plans forced by a small leaf, the shapes
#: of the default plans at n >= 2^26 cut to a CPU's size.
#: 2^22 / 2^10: outer classic 32 over an inner fused 128 x 1024 (the nested
#: plan); 2^19 / 128: outer classic 32 over an inner classic 128 x 128;
#: 2^17 and 2^20 / 2^16: one classic level (n1 = 2, 16) over leaf3 rows.
FORCED_PLANS = [(22, 1 << 10, None), (19, 128, 2), (17, 1 << 16, 2),
                (20, 1 << 16, None)]


@pytest.mark.parametrize("log_n,leaf,b", FORCED_PLANS)
@pytest.mark.parametrize("direction", ["Forward", "Reverse"])
def test_forced_plans_match_jax_and_numpy(log_n, leaf, b, direction):
    n = 1 << log_n
    rng = np.random.default_rng(log_n + leaf)
    shape = ((b,) if b else ()) + (n,)
    re, im = _pair(rng, shape)
    planner = pt.PlannerDit32(n, options=pt.Options(leaf_fft_size=leaf),
                              device="cpu")
    jp = phastft_tpu.PlannerDit32(
        n, options=phastft_tpu.Options(leaf_fft_size=leaf))
    assert planner.plan == jp.plan and planner.plan[0] == "split"
    got = pt.fft_32_dit_with_planner(re, im, getattr(pt.Direction, direction),
                                     planner)
    assert all(tuple(x.shape) == shape and x.dtype == torch.float32
               for x in got)
    ref = phastft_tpu.fft_32_dit_with_planner(
        re, im, getattr(phastft_tpu.Direction, direction), jp)
    x = re.astype(np.float64) + 1j * im
    want = np.fft.fft(x, axis=-1) if direction == "Forward" else np.fft.ifft(x, axis=-1)
    g = _c((got[0].numpy(), got[1].numpy()))
    assert _rel(g, want) <= _bound(n)
    assert _rel(g, _c(ref)) <= 1e-6


@pytest.mark.parametrize("log_n,leaf", [(22, 1 << 10), (19, 128),
                                        (17, 1 << 16)])
def test_forced_plan_planner_from_jax_tables(log_n, leaf):
    """A nested or classic planner built on the JAX planner's leaf_corrs
    (which hold more keys than the port reads) computes what the port's
    own does, from tables equal bit for bit."""
    n = 1 << log_n
    jp = phastft_tpu.PlannerDit32(
        n, options=phastft_tpu.Options(leaf_fft_size=leaf))
    tables = {k: tuple(np.asarray(a) for a in v)
              for k, v in jp.leaf_corrs.items()}
    opts = pt.Options(leaf_fft_size=leaf)
    carried = pt.PlannerDit32.from_numpy_tables(n, tables, device="cpu",
                                                options=opts)
    own = pt.PlannerDit32(n, options=opts, device="cpu")
    assert carried.plan == own.plan == jp.plan
    assert set(carried.leaf_corrs) == set(own.leaf_corrs)
    for key, arrays in own.leaf_corrs.items():
        for mine, theirs in zip(arrays, tables[key]):
            assert np.array_equal(mine.numpy(), theirs)
    rng = np.random.default_rng(log_n)
    re, im = _pair(rng, (n,))
    a = pt.fft_32_dit_with_planner(re, im, pt.Direction.Forward, carried)
    b = pt.fft_32_dit_with_planner(re, im, pt.Direction.Forward, own)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    missing = {k: v for k, v in tables.items() if not k.startswith("pcol")}
    with pytest.raises(KeyError):
        pt.PlannerDit32.from_numpy_tables(n, missing, device="cpu",
                                          options=opts)


def test_forced_plan_roundtrip_and_batch_dims():
    n = 1 << 19
    rng = np.random.default_rng(19)
    re, im = _pair(rng, (2, 2, n))
    planner = pt.PlannerDit32(n, options=pt.Options(leaf_fft_size=1 << 9),
                              device="cpu")
    # one classic level with a deep column factor (radix-16 residues)
    assert planner.plan == ("split", 1024, ("leaf", 4), 512)
    tre, tim = torch.from_numpy(re.copy()), torch.from_numpy(im.copy())
    fwd = pt.fft_32_dit_with_planner(tre, tim, pt.Direction.Forward, planner)
    assert tuple(fwd[0].shape) == (2, 2, n)
    back = pt.fft_32_dit_with_planner(fwd[0], fwd[1], pt.Direction.Reverse,
                                      planner)
    x = re.astype(np.float64) + 1j * im
    assert _rel(_c((back[0].numpy(), back[1].numpy())), x) <= 1e-6
    # the caller's tensors are never written
    assert np.array_equal(tre.numpy(), re) and np.array_equal(tim.numpy(), im)


def test_classic_plan_launches_no_kernel_on_cpu():
    """On CPU tensors every wrapper of the classic branch runs its plain
    version: no launch is counted."""
    from phastft_tpu_torch.tracing import launch_count

    kernels = ("colfft", "colfft_out3d", "leaft", "leaf", "leaf3", "transpose2")
    before = [launch_count(k) for k in kernels]
    n = 1 << 17
    x = np.ones(n, np.float32)
    planner = pt.PlannerDit32(n, options=pt.Options(leaf_fft_size=1 << 9),
                              device="cpu")
    out = pt.fft_32_dit_with_planner(x, 0 * x, "f", planner)
    assert abs(float(out[0][0]) - n) <= 1e-6 * n
    assert [launch_count(k) for k in kernels] == before


# -- error paths (tests/test_errors.py on the f32 entries) -------------------

def test_non_power_of_two_raises():
    with pytest.raises(pt.NonPowerOfTwoError, match="power of 2"):
        pt.fft_32_dit(np.zeros(100), np.zeros(100), pt.Direction.Forward,
                      device="cpu")


def test_zero_length_raises():
    with pytest.raises(pt.NonPowerOfTwoError):
        pt.fft_32_dit(np.zeros(0), np.zeros(0), pt.Direction.Forward,
                      device="cpu")


def test_length_mismatch_raises():
    with pytest.raises(pt.LengthMismatchError, match="equal length"):
        pt.fft_32_dit_with_planner(np.zeros(N), np.zeros(2 * N),
                                   pt.Direction.Forward,
                                   pt.PlannerDit32(N, device="cpu"))


def test_planner_size_mismatch_raises():
    planner = pt.PlannerDit32(N, device="cpu")
    with pytest.raises(pt.PlannerSizeMismatchError, match="size"):
        pt.fft_32_dit_with_planner(np.zeros(2 * N), np.zeros(2 * N),
                                   pt.Direction.Forward, planner)


def test_planner_rejects_non_power_of_two():
    with pytest.raises(pt.NonPowerOfTwoError):
        pt.PlannerDit32(100, device="cpu")


def test_errors_are_value_errors():
    assert issubclass(pt.PhastftError, ValueError)
    assert issubclass(pt.NonPowerOfTwoError, pt.PhastftError)
    assert issubclass(pt.LengthMismatchError, pt.PhastftError)
    assert issubclass(pt.PlannerSizeMismatchError, pt.PhastftError)


def test_direction_chars_accepted():
    re, im = np.ones(N), np.zeros(N)
    fre, _ = pt.fft_32_dit(re, im, "f", device="cpu")
    assert abs(float(fre[0]) - N) <= 1e-6 * N
    rre, _ = pt.fft_32_dit(re, im, "r", device="cpu")
    assert abs(float(rre[0]) - 1.0) <= 1e-6  # scaled by 1/N


def test_bad_direction_rejected():
    with pytest.raises(pt.PhastftError, match="direction"):
        pt.fft_32_dit(np.ones(N), np.zeros(N), "x", device="cpu")
    with pytest.raises(pt.PhastftError, match="direction"):
        pt.fft_32_dit(np.ones(N), np.zeros(N), 1, device="cpu")


def test_tensor_dtype_and_device_checked():
    """A tensor of another dtype is converted to the planner's, as
    phastft_tpu/fft.py converts it; one on another device raises."""
    planner = pt.PlannerDit32(N, device="cpu")
    rng = np.random.default_rng(3)
    re, im = _pair(rng, (N,))
    got = pt.fft_32_dit_with_planner(torch.from_numpy(re).double(),
                                     torch.from_numpy(im).double(),
                                     pt.Direction.Forward, planner)
    want = pt.fft_32_dit_with_planner(re, im, pt.Direction.Forward, planner)
    assert got[0].dtype == torch.float32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(pt.PhastftError, match="planner is on"):
        pt.fft_32_dit_with_planner(torch.zeros(N, device="meta"),
                                   torch.zeros(N, device="meta"),
                                   pt.Direction.Forward, planner)


# -- outside the slice --------------------------------------------------------

@pytest.mark.parametrize("log_n,leaf,item", [
    (31, None, "item 16"),      # past 2^30: planned since item 16 landed
    (17, 64, "item 15"),        # rows of 64 points under a 2048-point column pass
    (17, 1 << 17, "item 15"),   # a leaf past 2^16: leaf3 at a = 256
    (20, 1 << 17, "item 15"),   # the same under a classic split
])
def test_sizes_outside_slice_not_implemented(log_n, leaf, item):
    """The sizes that raised until their item was ported. n = 2^31 (item
    16) is planned as the JAX package plans it, on tables of a few MiB (no
    transform runs here: one pair is 16 GiB). Leaves outside 128..2^16
    points (item 15) run: a batch of 2, planned as the JAX package plans it,
    against it and numpy."""
    n = 1 << log_n
    if item == "item 16":
        from phastft_tpu.ops.fourstep import plan_rows

        planner = pt.PlannerDit32(n, device="cpu")
        opts = phastft_tpu.Options.guess_options(n, np.float32)
        assert planner.plan == plan_rows(n, opts.leaf_fft_size)
        assert planner.plan[:2] == ("split", 1024)
        floats = sum(t.numel() for ts in planner.leaf_corrs.values() for t in ts)
        assert floats < 1 << 22
        return
    re, im = _pair(np.random.default_rng(log_n + leaf), (2, n))
    planner = pt.PlannerDit32(n, options=pt.Options(leaf_fft_size=leaf), device="cpu")
    jax_planner = phastft_tpu.PlannerDit32(
        n, options=phastft_tpu.Options(leaf_fft_size=leaf))
    assert planner.plan == jax_planner.plan
    got = _c(pt.fft_32_dit_with_planner(re, im, pt.Direction.Forward, planner))
    ref = _c(phastft_tpu.fft_32_dit_with_planner(re, im, phastft_tpu.Direction.Forward,
                                                 jax_planner))
    want = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1)
    assert _rel(got, want) <= _bound(n)
    assert _rel(got, ref) <= 2 * _bound(n)


@pytest.mark.parametrize("entry", ["fft_64_dit", "fft_64_dit_with_planner",
                                   "fft_64_dit_with_planner_and_opts",
                                   "PlannerDit64"])
def test_f64_not_implemented(entry, monkeypatch):
    """Every f64 entry that resolves to the native engine runs it (it
    raised until the engine was ported): an explicit "native" planner, a
    per-call "native" on a df64 planner, and an engine-less Options() on an
    f64 planner, which resolves to "native" as in the JAX package. The
    result is the native transform's, bit for bit, and matches the df64
    engine."""
    from phastft_tpu_torch.ops.dit import build_native_fft

    n = 256
    rng = np.random.default_rng(256)
    re, im = rng.standard_normal((2, n)), rng.standard_normal((2, n))
    native = pt.PlannerDit64(n, options=pt.Options(f64_engine="native"),
                             device="cpu")
    df64 = pt.PlannerDit64(n, options=pt.Options(f64_engine="df64"), device="cpu")
    if entry == "PlannerDit64":
        bare = pt.PlannerDit64(n, options=pt.Options(), device="cpu")
        got = pt.fft_64_dit_with_planner(re, im, pt.Direction.Forward, bare)
    elif entry == "fft_64_dit":
        import phastft_tpu_torch.fft as port_fft

        monkeypatch.setattr(port_fft, "_cached_planner",
                            lambda n, bits, device: native)
        got = pt.fft_64_dit(re, im, pt.Direction.Forward, device="cpu")
    elif entry == "fft_64_dit_with_planner":
        got = pt.fft_64_dit_with_planner(re, im, pt.Direction.Forward, native)
    else:
        got = pt.fft_64_dit_with_planner_and_opts(
            re, im, pt.Direction.Forward, df64, pt.Options(f64_engine="native"))
    want = build_native_fft(n, 1 << 16, False)(
        torch.from_numpy(re), torch.from_numpy(im), native.native_state)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ref = pt.fft_64_dit_with_planner(re, im, pt.Direction.Forward, df64)
    assert _rel(_g(got), _g(ref)) <= 1e-12
    assert _rel(_g(got), np.fft.fft(re + 1j * im, axis=-1)) <= 1e-12


def test_tune_and_classic_not_implemented():
    """Items 7 and 8 are ported: a Tune planner is built on measured options
    and transforms, and the staged and plain pipelines run, against numpy
    (the plain one bit for bit with the default route: both are plain on the
    CPU)."""
    n = 1 << 12
    rng = np.random.default_rng(12)
    re, im = _pair(rng, (n,))
    tuned = pt.PlannerDit32(n, pt.PlannerMode.Tune, device="cpu")
    assert tuned.mode is pt.PlannerMode.Tune
    assert tuned.options.leaf_fft_size in (1 << 10, 1 << 12)
    got = pt.fft_32_dit_with_planner(re, im, "f", tuned)
    assert _rel(_c(got), np.fft.fft(re.astype(np.float64) + 1j * im)) <= _bound(n)
    planner = pt.PlannerDit32(N, device="cpu")
    re, im = _pair(rng, (N,))
    want = np.fft.fft(re.astype(np.float64) + 1j * im)
    default = pt.fft_32_dit_with_planner(re, im, "f", planner)
    for opts in (pt.Options(strategy="staged"), pt.Options(use_pallas=False)):
        got = pt.fft_32_dit_with_planner_and_opts(re, im, "f", planner, opts)
        assert _rel(_c(got), want) <= _bound(N)
    assert torch.equal(got[0], default[0]) and torch.equal(got[1], default[1])


def test_default_device_is_cuda(monkeypatch):
    """device=None means CUDA; with no GPU it raises, never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros(N, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.fft_32_dit(x, x, pt.Direction.Forward)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.PlannerDit32(N)


# -- f64 on the df64 (paired-f32) engine ---------------------------------------

F64_JAX_TOL = 1e-13    # the same arithmetic in both packages
F64_NUMPY_TOL = 1e-12  # the bound of tests/test_df64.py


def _pair64(rng, shape):
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _want(re, im, direction):
    x = re + 1j * im
    return np.fft.fft(x, axis=-1) if direction == "Forward" else np.fft.ifft(x, axis=-1)


def _g(out):
    return out[0].numpy() + 1j * out[1].numpy()


@pytest.mark.parametrize("log_n,direction", [
    *((log_n, "Forward") for log_n in (0, 2, 5, 7, 10, 13, 15)),
    # the inverse compiles a second JAX executable per size: three sizes
    (0, "Reverse"), (7, "Reverse"), (13, "Reverse"),
])
def test_f64_matches_jax_and_numpy(log_n, direction):
    """tiny plans (1, 4, 32), one leaf (128, 2^10, 2^13) and one split level
    (2^15: n1 = 4 over a 2^13 leaf) through the explicit-options entry."""
    n = 1 << log_n
    rng = np.random.default_rng(200 + log_n)
    re, im = _pair64(rng, (2, n))
    planner = pt.PlannerDit64(n, device="cpu")
    assert planner.options.f64_engine is None  # the native engine's window
    got = pt.fft_64_dit_with_planner_and_opts(
        re, im, getattr(pt.Direction, direction), planner,
        pt.Options(f64_engine="df64"))
    assert all(isinstance(x, torch.Tensor) and x.dtype == torch.float64
               and x.device.type == "cpu" and tuple(x.shape) == (2, n)
               for x in got)
    jp = phastft_tpu.PlannerDit64(n)
    assert planner.plan == jp.plan
    ref = phastft_tpu.fft_64_dit_with_planner_and_opts(
        re, im, getattr(phastft_tpu.Direction, direction), jp,
        phastft_tpu.Options(f64_engine="df64"))
    assert _rel(_g(got), _want(re, im, direction)) <= F64_NUMPY_TOL
    assert _rel(_g(got), _c(ref)) <= F64_JAX_TOL


@pytest.mark.parametrize("log_n,engine,plan", [
    (12, "df64", ("split", 32, ("leaf", 1), 128)),
    (12, "df64-split", ("split", 32, ("leaf", 1), 128)),
    (19, "df64", ("split", 32, ("split", 128, ("leaf", 1), 128), 1 << 14)),
])
def test_f64_forced_plans(log_n, engine, plan):
    """Options(leaf_fft_size=128): a classic level over leaves of n1 = 1,
    and the smallest nested plan, 32 x (128 x 128). The nested plan is
    held against numpy alone (the JAX side takes long there)."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    re, im = _pair64(rng, (n,))
    planner = pt.PlannerDit64(
        n, options=pt.Options(leaf_fft_size=128, f64_engine=engine),
        device="cpu")
    assert planner.plan == plan
    got = pt.fft_64_dit_with_planner(re, im, pt.Direction.Forward, planner)
    assert _rel(_g(got), _want(re, im, "Forward")) <= F64_NUMPY_TOL
    if log_n <= 12:
        jp = phastft_tpu.PlannerDit64(
            n, options=phastft_tpu.Options(leaf_fft_size=128,
                                           f64_engine="df64"))
        ref = phastft_tpu.fft_64_dit_with_planner_and_opts(
            re, im, phastft_tpu.Direction.Forward, jp, jp.options)
        assert _rel(_g(got), _c(ref)) <= F64_JAX_TOL


@pytest.mark.parametrize("log_n", [11, 13])
def test_f64_leaf_engines_agree(log_n):
    """"df64-split" (two column passes and a transpose per leaf),
    "df64-fused" and bare "df64" (one leaf kernel) compute the same
    transform; an unknown suffix falls to the default."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    re, im = _pair64(rng, (3, n))
    planner = pt.PlannerDit64(n, device="cpu")
    out = {
        engine: _g(pt.fft_64_dit_with_planner_and_opts(
            re, im, pt.Direction.Forward, planner,
            pt.Options(f64_engine=engine)))
        for engine in ("df64", "df64-fused", "df64-split", "df64-xla")
    }
    assert np.array_equal(out["df64"], out["df64-fused"])
    assert np.array_equal(out["df64"], out["df64-xla"])
    assert _rel(out["df64-split"], out["df64"]) <= F64_JAX_TOL
    assert _rel(out["df64-split"], _want(re, im, "Forward")) <= F64_NUMPY_TOL


def test_f64_roundtrip_and_exact_inverse_scale():
    n = 1 << 13
    rng = np.random.default_rng(64)
    re, im = _pair64(rng, (2, n))
    fwd = pt.fft_64_dit(re, im, pt.Direction.Forward, device="cpu")
    back = pt.fft_64_dit(fwd[0], fwd[1], pt.Direction.Reverse, device="cpu")
    assert _rel(_g(back), re + 1j * im) <= F64_NUMPY_TOL
    # the inverse of N * delta is all ones, exactly: the scale is 1/N
    delta = np.zeros(n)
    delta[0] = float(n)
    ones = pt.fft_64_dit(delta, np.zeros(n), pt.Direction.Reverse, device="cpu")
    assert bool((ones[0] == 1.0).all()) and bool((ones[1] == 0.0).all())


def test_f64_batch_dims_inputs_and_reuse():
    """A (3, 2, 2^10) batch; numpy inputs and torch f64 tensors give the
    same result; the caller's tensors are never written; a planner is
    reused across calls and directions."""
    n = 1 << 10
    rng = np.random.default_rng(10)
    re, im = _pair64(rng, (3, 2, n))
    planner = pt.PlannerDit64(n, device="cpu")
    a = pt.fft_64_dit_with_planner(re, im, pt.Direction.Forward, planner)
    tre, tim = torch.from_numpy(re.copy()), torch.from_numpy(im.copy())
    b = pt.fft_64_dit_with_planner(tre, tim, "f", planner)
    assert tuple(a[0].shape) == (3, 2, n)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert np.array_equal(tre.numpy(), re) and np.array_equal(tim.numpy(), im)
    assert _rel(_g(a), _want(re, im, "Forward")) <= F64_NUMPY_TOL
    back = pt.fft_64_dit_with_planner(a[0], a[1], pt.Direction.Reverse, planner)
    assert _rel(_g(back), re + 1j * im) <= F64_NUMPY_TOL
    # f32 input is converted, as the JAX package converts it
    c = pt.fft_64_dit_with_planner(re.astype(np.float32), im.astype(np.float32),
                                   "f", planner)
    assert c[0].dtype == torch.float64
    # so is an f32 tensor
    d = pt.fft_64_dit_with_planner(tre.float(), tim.float(), "f", planner)
    assert torch.equal(c[0], d[0]) and torch.equal(c[1], d[1])


def test_f64_runs_no_kernel_on_cpu():
    from phastft_tpu_torch.tracing import launch_count

    kernels = ("ddcol", "ddcol_nocorr", "ddleaf", "transpose2")
    before = [launch_count(k) for k in kernels]
    n = 1 << 15
    x = np.ones(n)
    for engine in ("df64", "df64-split"):
        planner = pt.PlannerDit64(n, options=pt.Options(
            leaf_fft_size=1 << 13, f64_engine=engine), device="cpu")
        out = pt.fft_64_dit_with_planner(x, 0 * x, "f", planner)
        assert abs(float(out[0][0]) - n) <= 1e-12 * n
    assert [launch_count(k) for k in kernels] == before


def test_f64_oz_per_call_engine_rules(monkeypatch):
    """The oz tables, not the engine string, arm the Ozaki kernels: a
    per-call "df64-oz" on a df64 planner runs the df64 kernels (and no
    longer raises), a per-call "df64" on an oz planner keeps the oz
    kernels, and an oz planner's leaf plan runs the df64 leaf."""
    from phastft_tpu_torch.ops.route import KERNELS

    n = 1 << 17
    rng = np.random.default_rng(17)
    re, im = _pair64(rng, (n,))
    want = np.fft.fft(re + 1j * im)
    df64 = pt.PlannerDit64(n, options=pt.Options(leaf_fft_size=1 << 10,
                                                 f64_engine="df64"), device="cpu")
    oz = pt.PlannerDit64(n, options=pt.Options(leaf_fft_size=1 << 10,
                                               f64_engine="df64-oz"), device="cpu")
    calls = []
    for name in ("ozcol", "ddcol"):
        real = getattr(KERNELS, name)
        monkeypatch.setattr(KERNELS, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    a = pt.fft_64_dit_with_planner_and_opts(
        re, im, "f", df64, pt.Options(f64_engine="df64-oz"))
    b = pt.fft_64_dit_with_planner_and_opts(
        re, im, "f", oz, pt.Options(f64_engine="df64"))
    assert calls == ["ddcol", "ozcol"]
    assert _rel(_g(a), want) <= F64_NUMPY_TOL
    assert _rel(_g(b), want) <= 1e-10
    x = np.zeros(1 << 10)
    leaf = pt.PlannerDit64(1 << 10, options=pt.Options(f64_engine="df64-oz"),
                           device="cpu")
    out = pt.fft_64_dit_with_planner(x + 1.0, x, "f", leaf)
    assert float(out[0][0]) == 1 << 10


@pytest.mark.parametrize("case", ["non_power_of_two", "zero_length",
                                  "length_mismatch", "planner_size",
                                  "planner_non_power_of_two", "no_cuda",
                                  "sizes_outside"])
def test_f64_error_paths(case, monkeypatch):
    n = 1 << 10
    if case == "non_power_of_two":
        with pytest.raises(pt.NonPowerOfTwoError, match="power of 2"):
            pt.fft_64_dit(np.zeros(100), np.zeros(100), "f", device="cpu")
    elif case == "zero_length":
        with pytest.raises(pt.NonPowerOfTwoError):
            pt.fft_64_dit(np.zeros(0), np.zeros(0), "f", device="cpu")
    elif case == "length_mismatch":
        with pytest.raises(pt.LengthMismatchError, match="equal length"):
            pt.fft_64_dit_with_planner(np.zeros(n), np.zeros(2 * n), "f",
                                       pt.PlannerDit64(n, device="cpu"))
    elif case == "planner_size":
        with pytest.raises(pt.PlannerSizeMismatchError, match="size"):
            pt.fft_64_dit_with_planner(np.zeros(2 * n), np.zeros(2 * n), "f",
                                       pt.PlannerDit64(n, device="cpu"))
    elif case == "planner_non_power_of_two":
        with pytest.raises(pt.NonPowerOfTwoError):
            pt.PlannerDit64(100, device="cpu")
    elif case == "no_cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.fft_64_dit(np.zeros(n), np.zeros(n), "f")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.PlannerDit64(n)
    else:
        # n = 2^31 (item 16, done) is planned as the JAX package plans it;
        # the native tables wait for the first transform, which no CPU test
        # runs (one f64 pair is 32 GiB)
        from phastft_tpu.ops.fourstep import plan_rows

        big = pt.PlannerDit64(1 << 31, device="cpu")
        opts = phastft_tpu.Options.guess_options(1 << 31, np.float64)
        assert big.plan == plan_rows(1 << 31, opts.leaf_fft_size)
        assert big._native_state is None and big._dd_state is None
        # df64 planners on leaves outside 128..2^16 points (they raised
        # item 15 until it was ported) run, planned as the JAX package plans
        # them, against its f64 transform on the same plan (its native engine:
        # its dd pipeline compiles for ~12-22 s a shape here;
        # tests/test_torch_edges.py holds the 2^17 leaf to its df64) and numpy
        for log_m, leaf in ((12, 64), (17, 1 << 17)):
            m = 1 << log_m
            rng = np.random.default_rng(log_m)
            re, im = rng.standard_normal((2, m)), rng.standard_normal((2, m))
            planner = pt.PlannerDit64(m, options=pt.Options(
                leaf_fft_size=leaf, f64_engine="df64"), device="cpu")
            jax_planner = phastft_tpu.PlannerDit64(m, options=phastft_tpu.Options(
                leaf_fft_size=leaf, f64_engine="native"))
            assert planner.plan == jax_planner.plan
            got = _g(pt.fft_64_dit_with_planner(re, im, pt.Direction.Forward, planner))
            ref = phastft_tpu.fft_64_dit_with_planner(
                re, im, phastft_tpu.Direction.Forward, jax_planner)
            assert _rel(got, _c(ref)) <= 1e-13
            assert _rel(got, np.fft.fft(re + 1j * im, axis=-1)) <= 1e-12
        # Tune (item 8, done) races the native and df64 engines on the
        # 2^10 leaf and transforms on the winner
        x, y = np.random.default_rng(10).standard_normal((2, n))
        tuned = pt.PlannerDit64(n, pt.PlannerMode.Tune, device="cpu")
        assert tuned.options.f64_engine in ("native", "df64")
        got = _g(pt.fft_64_dit_with_planner(x, y, "f", tuned))
        assert _rel(got, np.fft.fft(x + 1j * y)) <= F64_NUMPY_TOL


# -- the public surface against the reference's (ROADMAP Queue 3) ---------------

@pytest.mark.parametrize("dtype", [None, np.float64, np.int32, np.complex128])
def test_guess_options_without_f32_takes_the_f64_rule(dtype):
    """Fault 1: no dtype, and any dtype but f32, is the f64 leaf rule, as in
    phastft_tpu/options.py (outside its TPU Ozaki window, which the port
    does not inherit)."""
    from phastft_tpu.options import Options as JaxOptions

    args = () if dtype is None else (dtype,)
    for log_n in (7, 13, 16, 18, 25, 26, 28, 30):
        n = 1 << log_n
        got = pt.Options.guess_options(n, *args)
        assert got.leaf_fft_size == JaxOptions.guess_options(n, *args).leaf_fft_size
        # the H100 race: native (None) at every size
        assert got.f64_engine is None
    assert pt.Options.guess_options(1 << 16, *args).leaf_fft_size == 1 << 13
    # an f64 planner's default options run the native engine there
    assert pt.PlannerDit64(1 << 10, device="cpu").options.f64_engine is None


def test_planner_new_and_with_mode():
    """Fault 3: the reference's constructor aliases; ``with_mode`` builds a
    Tune planner on measured options, planned as a JAX planner on them."""
    for cls, ref_cls in ((pt.PlannerDit32, phastft_tpu.PlannerDit32),
                         (pt.PlannerDit64, phastft_tpu.PlannerDit64)):
        ref = ref_cls.new(N)
        for planner in (cls.new(N, device="cpu"),
                        cls.with_mode(N, pt.PlannerMode.Heuristic, device="cpu")):
            assert type(planner) is cls and planner.n == ref.n
            assert planner.plan == ref.plan
            assert planner.mode is pt.PlannerMode.Heuristic
        tuned = cls.with_mode(1 << 10, pt.PlannerMode.Tune, device="cpu")
        assert type(tuned) is cls and tuned.mode is pt.PlannerMode.Tune
        jax_opts = phastft_tpu.Options(leaf_fft_size=tuned.options.leaf_fft_size)
        assert tuned.plan == ref_cls(1 << 10, options=jax_opts).plan
        x = np.zeros(1 << 10, tuned.dtype)
        x[0] = 1.0
        out = (pt.fft_64_dit_with_planner if cls is pt.PlannerDit64
               else pt.fft_32_dit_with_planner)(x, 0 * x, "f", tuned)
        assert np.allclose(out[0].numpy(), 1.0) and np.allclose(out[1].numpy(), 0.0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls.new(N)  # the default device is CUDA, absent here


def test_tensor_of_another_dtype_is_cast_as_in_jax():
    """Fault 4: an f64 tensor on an f32 planner is converted, as
    phastft_tpu/fft.py converts every input."""
    rng = np.random.default_rng(4)
    re, im = rng.standard_normal(N), rng.standard_normal(N)
    got = pt.fft_32_dit_with_planner(torch.from_numpy(re), torch.from_numpy(im),
                                     "f", pt.PlannerDit32(N, device="cpu"))
    assert got[0].dtype == torch.float32
    ref = phastft_tpu.fft_32_dit_with_planner(re, im, "f", phastft_tpu.PlannerDit32(N))
    assert _rel(_c((got[0].numpy(), got[1].numpy())), _c(ref)) <= 2 * _bound(N)


@pytest.mark.parametrize("field", ["strategy", "use_pallas"])
def test_shapes_are_checked_before_the_pipeline(field):
    """Fault 5: mismatched planes give LengthMismatchError before the
    staged / plain pipelines run, as in the reference."""
    kw = {"strategy": "staged"} if field == "strategy" else {"use_pallas": False}
    x, y = np.zeros(N, np.float32), np.zeros(2 * N, np.float32)
    with pytest.raises(pt.LengthMismatchError, match="equal length"):
        pt.fft_32_dit_with_planner_and_opts(
            x, y, "f", pt.PlannerDit32(N, device="cpu"), pt.Options(**kw))
    with pytest.raises(phastft_tpu.LengthMismatchError, match="equal length"):
        phastft_tpu.fft_32_dit_with_planner_and_opts(
            x, y, "f", phastft_tpu.PlannerDit32(N), phastft_tpu.Options(**kw))


def test_with_planner_runs_on_the_planners_options(monkeypatch):
    """Fault 2, decided with the native f64 engine: the ``*_with_planner``
    entries pass ``Options.guess_options(n)`` per call, as the reference
    does. Its strategy is "auto", so a planner built on the staged strategy
    runs the default pipeline there (the explicit-options entry on the
    planner's own options runs the staged one); its ``f64_engine`` is None
    at every n, so the planner's engine decides."""
    import phastft_tpu_torch.fft as port_fft

    seen = []
    run = port_fft._run
    monkeypatch.setattr(port_fft, "_run",
                        lambda *a: seen.append(a[-1]) or run(*a))
    rng = np.random.default_rng(2)
    re, im = _pair(rng, (N,))
    planner = pt.PlannerDit32(N, options=pt.Options(strategy="staged"),
                              device="cpu")
    got = pt.fft_32_dit_with_planner(re, im, "f", planner)
    want = np.fft.fft(re.astype(np.float64) + 1j * im)
    assert _rel(_c((got[0].numpy(), got[1].numpy())), want) <= _bound(N)
    staged = pt.fft_32_dit_with_planner_and_opts(re, im, "f", planner, planner.options)
    assert _rel(_c((staged[0].numpy(), staged[1].numpy())), want) <= _bound(N)
    assert not torch.equal(staged[0], got[0])  # another pipeline's roundings
    n = 1 << 13
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    split = pt.PlannerDit64(n, options=pt.Options(leaf_fft_size=n,
                                                  f64_engine="df64-split"),
                            device="cpu")
    a = pt.fft_64_dit_with_planner(x, y, "f", split)
    b = pt.fft_64_dit_with_planner_and_opts(x, y, "f", split,
                                            pt.Options(f64_engine="df64-split"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert seen[0] == pt.Options.guess_options(N)
    assert seen[2] == pt.Options.guess_options(n) and seen[2].f64_engine is None
    # up to 2^30 no guess overrides an f64 planner's engine
    assert all(pt.Options.guess_options(1 << k).f64_engine is None for k in range(31))
