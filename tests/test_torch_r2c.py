"""The port's real transforms on the CPU: ``PlannerR2c32/64``, the four
passes' plain versions (``ops/r2c.py``), and the ten ``r2c_*`` / ``c2r_*``
entries, against the JAX package (its R2C as tests/test_r2c.py runs it) and
numpy's ``rfft`` / ``irfft``.

The untangles' mirror form (the partner rank's shard as the mirror) is
held here, in one process, against the one-device form: the shards of d
emulated ranks, each untangled on its own, concatenate to the same bits.
tests/test_torch_real_dist.py runs it on gloo ranks.

Tolerances: f64 (native and df64) rel L2 <= 1e-12 against the JAX package
and against numpy; f32 <= 2e-6 against the JAX package (two f32 pipelines
that sum in different orders) and <= 1e-5 against numpy's f64 rfft. The
plain passes compute the JAX package's formulas in the same order: they
match its XLA ops to the last bit or within 1e-15 (XLA on the CPU may fuse
a product into an FMA).
"""

import functools

import numpy as np
import pytest
import torch

import phastft_tpu
import phastft_tpu_torch as pt
from phastft_tpu.ops import r2c as jr2c
from phastft_tpu_torch import planner as planner_module
from phastft_tpu_torch.ops import r2c as tr2c


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL_F64 = 1e-12
TOL_JAX_F32 = 2e-6
TOL_NUMPY_F32 = 1e-5
DTYPES = {"f32": np.float32, "f64": np.float64}


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _c(pair):
    return np.asarray(pair[0], np.float64) + 1j * np.asarray(pair[1], np.float64)


def _signal(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- the planner -------------------------------------------------------------

@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("log_n", [3, 12])
def test_planner_tables_match_jax(bits, log_n):
    n = 1 << log_n
    cls = pt.PlannerR2c64 if bits == 64 else pt.PlannerR2c32
    jcls = phastft_tpu.PlannerR2c64 if bits == 64 else phastft_tpu.PlannerR2c32
    p, jp = cls(n, device="cpu"), jcls(n)
    assert p.n == n and p.log_n == log_n and p.device == torch.device("cpu")
    assert p.dit_planner.n == n // 2 and p.dit_planner.device == p.device
    assert p.inner_opts == p.dit_planner.options
    assert p.inner_opts.leaf_fft_size == jp.inner_opts.leaf_fft_size
    want = torch.float64 if bits == 64 else torch.float32
    assert p.twiddles_re.dtype == want and tuple(p.twiddles_re.shape) == (n // 4 + 1,)
    np.testing.assert_array_equal(p.twiddles_re.numpy(), np.asarray(jp.twiddles_re))
    np.testing.assert_array_equal(p.twiddles_im.numpy(), np.asarray(jp.twiddles_im))
    assert p._c2r_tw is None  # built on first inverse use
    np.testing.assert_array_equal(p.c2r_twiddles_re.numpy(), np.asarray(jp.c2r_twiddles_re))
    np.testing.assert_array_equal(p.c2r_twiddles_im.numpy(), np.asarray(jp.c2r_twiddles_im))
    assert tuple(p.c2r_twiddles[0].shape) == (n // 2,)
    assert cls.new(n, device="cpu").n == n


def test_planner_inner_options_and_device_rule():
    opts = pt.Options(leaf_fft_size=128, f64_engine="df64")
    p = pt.PlannerR2c64(1 << 10, inner_options=opts, device="cpu")
    assert p.dit_planner.options is opts
    assert p.dit_planner.plan == ("split", 4, ("leaf", 1), 128)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.PlannerR2c32(16)


# mirrors tests/test_planner.py::test_r2c_planner_minimum_size and
# tests/test_r2c.py::test_minimum_size_n4's bound
@pytest.mark.parametrize("cls", ["PlannerR2c32", "PlannerR2c64"])
def test_planner_errors(cls, monkeypatch):
    c = getattr(pt, cls)
    for n in (1, 2):
        with pytest.raises(pt.NonPowerOfTwoError,
                           match=f"R2C requires n to be a power of 2 and n >= 4, got {n}"):
            c(n, device="cpu")
    with pytest.raises(pt.NonPowerOfTwoError, match="n must be a power of 2, got 12"):
        c(12, device="cpu")
    # Tune (item 8, done): the inner options win the whole-R2C race
    tuned = c(16, pt.PlannerMode.Tune, device="cpu")
    assert tuned.mode is pt.PlannerMode.Tune
    assert tuned.inner_opts.leaf_fft_size in (128, 256)
    x = np.random.default_rng(16).standard_normal(16)
    spec = (pt.r2c_fft_f64_with_planner if cls == "PlannerR2c64"
            else pt.r2c_fft_f32_with_planner)(x, tuned)
    want = np.fft.rfft(x)
    got = spec[0].double().numpy() + 1j * spec[1].double().numpy()
    assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)
    # n = 2^32 (item 16, done): the inner planner is asked for n/2 = 2^31,
    # and the quarter table for n/4 + 1 entries (built here as a stand-in:
    # 8 GiB on the host otherwise)
    from phastft_tpu.ops.fourstep import plan_rows

    asked = []

    def table(n, count, dtype, device):
        asked.append((n, count))
        return torch.zeros(1), torch.zeros(1)

    monkeypatch.setattr(planner_module, "r2c_twiddles", table)
    big = c(1 << 32, device="cpu")
    inner = big.dit_planner
    opts = phastft_tpu.Options.guess_options(1 << 31, inner.dtype)
    assert inner.n == 1 << 31 and asked == [(1 << 32, (1 << 30) + 1)]
    assert inner.plan == plan_rows(1 << 31, opts.leaf_fft_size)


# -- the passes' plain versions against the JAX package's XLA ops -----------

@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("log_n", [2, 3, 8, 12])
def test_passes_match_jax(dtype, log_n):
    n = 1 << log_n
    dt = DTYPES[dtype]
    tol = 1e-15 if dtype == "f64" else 1e-6
    jp = phastft_tpu.PlannerR2c64(n) if dtype == "f64" else phastft_tpu.PlannerR2c32(n)
    q = (np.asarray(jp.twiddles_re), np.asarray(jp.twiddles_im))
    # the JAX package's _pre_untangle reads the full-length table, the
    # port's the quarter table with tw[H - k] = -conj(tw[k])
    full = (np.asarray(jp.c2r_twiddles_re), np.asarray(jp.c2r_twiddles_im))
    x = _signal((3, n), log_n, dt)
    even, odd = tr2c.deinterleave(_t(x))
    je, jo = jr2c._deinterleave(x, n)
    np.testing.assert_array_equal(even.numpy(), np.asarray(je))
    np.testing.assert_array_equal(odd.numpy(), np.asarray(jo))
    z = (_signal((3, n // 2), 1, dt), _signal((3, n // 2), 2, dt))
    got = tr2c.untangle(_t(z[0]), _t(z[1]), _t(q[0]), _t(q[1]))
    want = jr2c._untangle(*z, *q)
    assert tuple(got[0].shape) == (3, n // 2 + 1)
    assert _rel(_c((got[0].numpy(), got[1].numpy())), _c(want)) <= tol
    spec = (_signal((3, n // 2 + 1), 3, dt), _signal((3, n // 2 + 1), 4, dt))
    got = tr2c.pre_untangle(_t(spec[0]), _t(spec[1]), _t(q[0]), _t(q[1]))
    want = jr2c._pre_untangle(*spec, *full)
    assert _rel(_c((got[0].numpy(), got[1].numpy())), _c(want)) <= tol
    got = tr2c.interleave_scale(_t(z[0]), _t(z[1]), 2.0 / n)
    want = np.asarray(jr2c._scale_interleave(*z, n))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_untangles_mirror_form_matches_one_device(dtype, d):
    """The shards of d ranks, each untangled with its partner's shard as the
    mirror (``parallel/real_dist.py``'s layout), concatenate to the one-device
    result bit for bit."""
    n = 1 << 10
    half = n // 2
    length = half // d
    dt = DTYPES[dtype]
    p = pt.PlannerR2c64(n, device="cpu") if dtype == "f64" else pt.PlannerR2c32(n, device="cpu")
    z = (_t(_signal(half, 5, dt)), _t(_signal(half, 6, dt)))
    spec = (_t(_signal(half + 1, 7, dt)), _t(_signal(half + 1, 8, dt)))
    whole = tr2c.untangle(*z, p.twiddles_re, p.twiddles_im)
    whole_pre = tr2c.pre_untangle(*spec, p.twiddles_re, p.twiddles_im)

    def shard(x, r, extra=0):
        return x[r * length:(r + 1) * length + extra]

    fwd, inv = [], []
    for r in range(d):
        partner = d - 1 - r
        wrap = 0 if r == 0 else (d - r) * length
        mirror = (shard(z[0], partner), shard(z[1], partner), z[0][wrap], z[1][wrap])
        fwd.append(tr2c.untangle(shard(z[0], r), shard(z[1], r), p.twiddles_re,
                                 p.twiddles_im, mirror, k0=r * length, half=half,
                                 nyquist=r == d - 1))
        last = int(partner == d - 1)
        wrap = half if r == 0 else (d - r) * length
        mirror = (shard(spec[0], partner, last), shard(spec[1], partner, last),
                  spec[0][wrap], spec[1][wrap])
        inv.append(tr2c.pre_untangle(shard(spec[0], r), shard(spec[1], r), p.twiddles_re,
                                     p.twiddles_im, mirror, k0=r * length, half=half))
    for got, want in ((fwd, whole), (inv, whole_pre)):
        for i in range(2):
            np.testing.assert_array_equal(torch.cat([g[i] for g in got]).numpy(),
                                          want[i].numpy())


# -- the one-device untangles: per bin, and as the paired kernel runs them --

def _bin(a_re, a_im, b_re, b_im, t_re, t_im, inverse):
    """One bin, input a, mirror b, twiddle t, in csrc/r2c.cu's ``bin``
    order: numpy rounds every operation, no FMA."""
    h = a_re.dtype.type(0.5)
    s_re, s_im, d_re, d_im = a_re + b_re, a_im - b_im, a_re - b_re, a_im + b_im
    if inverse:
        p_re, p_im = t_re * d_re + t_im * d_im, t_re * d_im - t_im * d_re
        return h * s_re - p_im, h * s_im + p_re
    u_re, u_im = t_re * d_re - t_im * d_im, t_re * d_im + t_im * d_re
    return h * s_re + u_im, h * s_im - u_re


def _per_bin(a_re, a_im, q_re, q_im, inverse):
    """Every bin on its own: k with z[(H - k) mod H] (the forward, then X[H]
    = Re z0 - Im z0) or X[H - k] (the inverse), tw[k] = q[k] for k <= H/2,
    -conj(q[H - k]) past it."""
    half = a_re.shape[-1] - int(inverse)
    k = np.arange(half)
    m = half - k if inverse else (half - k) % half
    low = k <= half // 2
    idx = np.where(low, k, half - k)
    t_re = np.where(low, q_re[idx], -q_re[idx])
    x_re, x_im = _bin(a_re[..., k], a_im[..., k], a_re[..., m], a_im[..., m], t_re,
                      q_im[idx], inverse)
    if not inverse:
        ny = a_re[..., :1] - a_im[..., :1]
        x_re = np.concatenate((x_re, ny), -1)
        x_im = np.concatenate((x_im, np.zeros_like(ny)), -1)
    return x_re, x_im


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view(np.uint64 if x.dtype == np.float64 else np.uint32)


def _untangle_inputs(log_n, rows, dtype, inverse):
    n = 1 << log_n
    dt = DTYPES[dtype]
    half = n // 2
    width = half + int(inverse)
    a = (_signal((rows, width), 30 + log_n, dt), _signal((rows, width), 31 + log_n, dt))
    q = tr2c.r2c_twiddles_host(n, half // 2 + 1, dt)
    return half, a, q


def _one_device(a, q, inverse):
    fn = tr2c.pre_untangle if inverse else tr2c.untangle
    out = fn(_t(a[0]), _t(a[1]), _t(q[0]), _t(q[1]))
    return out[0].numpy(), out[1].numpy()


@pytest.mark.parametrize("inverse", [False, True], ids=["untangle", "pre_untangle"])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("log_n", [2, 3, 4, 12])
def test_one_device_untangles_match_per_bin_reference(log_n, dtype, rows, inverse):
    """The plain one-device untangles bit for bit against each bin computed
    on its own; the bins that pair with themselves against their closed
    forms: k = 0 (the forward's X[0] = Re z0 + Im z0 and X[H] = Re z0 -
    Im z0, both real; the inverse's z[0] from X[0] and X[H]) and k = H/2
    (conj of its input, up to the rounding of 0.5 cos(pi/2))."""
    half, a, q = _untangle_inputs(log_n, rows, dtype, inverse)
    got = _one_device(a, q, inverse)
    want = _per_bin(*a, *q, inverse)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    (a_re, a_im), (g_re, g_im) = a, got
    h = a_re.dtype.type(0.5)
    if inverse:
        x0, xh = (a_re[:, 0], a_im[:, 0]), (a_re[:, half], a_im[:, half])
        np.testing.assert_array_equal(
            g_re[:, 0], h * (x0[0] + xh[0]) - h * (x0[1] + xh[1]))
        np.testing.assert_array_equal(
            g_im[:, 0], h * (x0[1] - xh[1]) + h * (x0[0] - xh[0]))
    else:
        np.testing.assert_array_equal(g_re[:, 0], a_re[:, 0] + a_im[:, 0])
        np.testing.assert_array_equal(g_re[:, half], a_re[:, 0] - a_im[:, 0])
        assert not g_im[:, 0].any() and not g_im[:, half].any()
    c = a_re[:, half // 2] - 1j * a_im[:, half // 2].astype(np.float64)
    mid = g_re[:, half // 2] + 1j * g_im[:, half // 2].astype(np.float64)
    assert np.all(np.abs(mid - c) <= 4 * np.finfo(a_re.dtype).eps * np.abs(c))


def _paired_kernel(a, q, inverse, vector):
    """The one-device paired kernel of csrc/r2c.cu rebuilt in numpy, item
    by item: the scalar schedule (item j >= 1 the pair (j, H - j), item 0
    the self-paired bins of its row) or the vector one (item t the bins
    lo = Vt .. lo + V - 1 and their mirrors; the falling run's end element
    taken from the lane before, t = 0's from z[0] or X[H], lane 0's loaded;
    each output's falling run completed by the lane after, lane 31 leaving
    that element to the next warp's lane 0). Returns the outputs and how
    often each was written."""
    a_re, a_im = a
    q_re, q_im = q
    rows = a_re.shape[0]
    half = a_re.shape[-1] - int(inverse)
    width = half if inverse else half + 1
    out = (np.full((rows, width), np.nan, a_re.dtype), np.full((rows, width), np.nan, a_re.dtype))
    writes = np.zeros((rows, width), np.int64)

    def store(row, k, x):
        out[0][row, k], out[1][row, k] = x
        writes[row, k] += 1

    def at(row, k):
        return a_re[row, k], a_im[row, k]

    def tw(k, mirrored=False):
        return (-q_re[k] if mirrored else q_re[k]), q_im[k]

    def nyquist(row):
        store(row, half, (a_re[row, 0] - a_im[row, 0], a_re.dtype.type(0)))

    v = 16 // a_re.dtype.itemsize
    if not vector or half < 2 * v:
        for row in range(rows):
            for j in range(half // 2):
                if j == 0:  # the self-paired bins
                    b = at(row, half) if inverse else at(row, 0)
                    store(row, 0, _bin(*at(row, 0), *b, *tw(0), inverse))
                    if not inverse:
                        nyquist(row)
                    c = at(row, half // 2)
                    store(row, half // 2, _bin(*c, *c, *tw(half // 2), inverse))
                    continue
                x, y = at(row, j), at(row, half - j)
                store(row, j, _bin(*x, *y, *tw(j), inverse))
                store(row, half - j, _bin(*y, *x, *tw(j, True), inverse))
        return out, writes
    per_row = half // (2 * v)
    items = []
    for idx in range(rows * per_row):  # loads and bins
        row, t = divmod(idx, per_row)
        lo, lane = t * v, idx % 32
        hi = half - lo - v
        run = [at(row, hi + e) for e in range(v)]  # the aligned falling run
        if t == 0:
            first = at(row, half) if inverse else at(row, 0)
        elif lane == 0:
            first = at(row, half - lo)
        else:
            first = items[idx - 1]["run"][0]  # the shuffle from lane - 1
        b = [first] + [run[v - i] for i in range(1, v)]
        x = [_bin(*at(row, lo + i), *b[i], *tw(lo + i), inverse) for i in range(v)]
        y = [_bin(*b[i], *at(row, lo + i), *tw(lo + i, True), inverse) for i in range(v)]
        mid = _bin(*run[0], *run[0], *tw(hi), inverse) if t == per_row - 1 else None
        items.append({"row": row, "t": t, "lo": lo, "hi": hi, "lane": lane, "run": run,
                      "x": x, "y": y, "mid": mid})
    for idx, it in enumerate(items):  # stores
        row, t, lo, hi, lane, x, y, mid = (it[k] for k in ("row", "t", "lo", "hi", "lane",
                                                           "x", "y", "mid"))
        for i in range(v):
            store(row, lo + i, x[i])
        # the output's falling run: the next lane's y[0] (the shuffle), or H/2
        down = items[idx + 1]["y"][0] if idx + 1 < len(items) else None
        out_run = [mid if mid is not None else down] + [y[v - e] for e in range(1, v)]
        for e in range(0 if mid is not None or lane != 31 else 1, v):
            store(row, hi + e, out_run[e])
        if lane == 0 and t > 0:
            store(row, half - lo, y[0])
        if not inverse and t == 0:
            nyquist(row)
    return out, writes


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("inverse", [False, True], ids=["untangle", "pre_untangle"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("log_n", [2, 3, 4, 12])
def test_paired_kernel_schedules_match_plain(log_n, dtype, inverse, vector):
    """Both schedules of the paired kernel, rebuilt in numpy, write every
    output once and agree with the plain one-device untangles bit for bit
    (3 rows: the vector schedule's warps cross rows at small n, and at 2^12
    its lane 31 / lane 0 split runs fall inside rows; which rows move in
    vectors changes no value or address)."""
    _, a, q = _untangle_inputs(log_n, 3, dtype, inverse)
    got, writes = _paired_kernel(a, q, inverse, vector)
    assert np.all(writes == 1)
    for g, w in zip(got, _one_device(a, q, inverse)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_pre_untangle_refuses_the_full_table():
    """Both directions read the quarter table: a full-length table (the JAX
    package's C2R table) is refused by size."""
    for n in (16, 1 << 10):
        p = pt.PlannerR2c32(n, device="cpu")
        spec = (torch.zeros(n // 2 + 1), torch.zeros(n // 2 + 1))
        with pytest.raises(ValueError, match=f"twiddle table must hold {n // 4 + 1} entries"):
            tr2c.pre_untangle(*spec, *p.c2r_twiddles)
        with pytest.raises(ValueError, match=f"twiddle table must hold {n // 4 + 1} entries"):
            tr2c.pre_untangle_plain(*spec, *p.c2r_twiddles)


@pytest.mark.parametrize("bits", [32, 64])
def test_c2r_builds_no_full_table(bits):
    """A C2R through the auto-planned entry and through a planner leaves the
    planner's full-length table unbuilt."""
    from phastft_tpu_torch import real_fft

    n = 1 << 10
    x = _signal(n, 17, DTYPES[f"f{bits}"])
    r2c = pt.r2c_fft_f64 if bits == 64 else pt.r2c_fft_f32
    c2r = pt.c2r_fft_f64 if bits == 64 else pt.c2r_fft_f32
    c2r_p = pt.c2r_fft_f64_with_planner if bits == 64 else pt.c2r_fft_f32_with_planner
    spec = r2c(x, device="cpu")
    back = c2r(*spec, device="cpu")
    assert real_fft._cached_planner(n, bits, torch.device("cpu"))._c2r_tw is None
    p = (pt.PlannerR2c64 if bits == 64 else pt.PlannerR2c32)(n, device="cpu")
    assert torch.equal(c2r_p(*spec, p), back)
    assert p._c2r_tw is None
    assert _rel(back.numpy(), x) <= (TOL_F64 if bits == 64 else TOL_NUMPY_F32)


def test_pass_errors():
    x = torch.zeros(6)
    with pytest.raises(ValueError, match="power-of-two length >= 4"):
        tr2c.deinterleave(x)
    with pytest.raises(TypeError, match="float32 or float64"):
        tr2c.deinterleave(torch.zeros(8, dtype=torch.int32))
    q = torch.zeros(3)
    with pytest.raises(ValueError, match="twiddle table must hold 5 entries"):
        tr2c.untangle(torch.zeros(8), torch.zeros(8), q, q)
    with pytest.raises(ValueError, match="half length of 8"):
        tr2c.untangle(torch.zeros(8), torch.zeros(8), torch.zeros(5), torch.zeros(5),
                      (torch.zeros(8), torch.zeros(8), torch.zeros(()), torch.zeros(())),
                      k0=4, half=8)
    with pytest.raises(ValueError, match="two planes of one shape"):
        tr2c.interleave_scale(torch.zeros(8), torch.zeros(4), 1.0)
    with pytest.raises(ValueError, match=r"on one device the bins end with X\[H\]"):
        tr2c.untangle(torch.zeros(8), torch.zeros(8), torch.zeros(5), torch.zeros(5),
                      nyquist=False)


# -- the entries against the JAX package and numpy --------------------------

def _planners(n, bits, **opts):
    inner = pt.Options(**opts) if opts else None
    jinner = phastft_tpu.Options(**opts) if opts else None
    if bits == 64:
        return (pt.PlannerR2c64(n, inner_options=inner, device="cpu"),
                phastft_tpu.PlannerR2c64(n, inner_options=jinner))
    return (pt.PlannerR2c32(n, inner_options=inner, device="cpu"),
            phastft_tpu.PlannerR2c32(n, inner_options=jinner))


#: case -> (log2 n, batch shape, inner options): 1-D and batched, and a
#: plan with split levels (leaf 128 at 2^10: 4 x 128 over the 2^9 half)
CASES = {
    "n4": (2, (), {}),
    "n8": (3, (), {}),
    "2^8_batch3": (8, (3,), {}),
    "2^12_batch3": (12, (3,), {}),
    "2^14": (14, (), {}),
    "2^10_leaf128": (10, (3,), {"leaf_fft_size": 128}),
}


@functools.lru_cache(maxsize=None)
def _case(case, bits):
    """(signal, port spectrum, JAX spectrum, port inverse, JAX inverse) of
    a case, the inverse taken of numpy's rfft."""
    log_n, batch, opts = CASES[case]
    n = 1 << log_n
    x = _signal(batch + (n,), 40 + log_n, DTYPES[f"f{bits}"])
    p, jp = _planners(n, bits, **opts)
    r2c = pt.r2c_fft_f64_with_planner if bits == 64 else pt.r2c_fft_f32_with_planner
    c2r = pt.c2r_fft_f64_with_planner if bits == 64 else pt.c2r_fft_f32_with_planner
    jr = (phastft_tpu.r2c_fft_f64_with_planner if bits == 64
          else phastft_tpu.r2c_fft_f32_with_planner)
    jc = (phastft_tpu.c2r_fft_f64_with_planner if bits == 64
          else phastft_tpu.c2r_fft_f32_with_planner)
    spec = np.fft.rfft(x.astype(np.float64), axis=-1).astype(
        np.complex128 if bits == 64 else np.complex64)
    sre, sim = np.ascontiguousarray(spec.real), np.ascontiguousarray(spec.imag)
    got = r2c(x, p)
    back = c2r(sre, sim, p)
    want = jr(x, jp)
    jback = jc(sre, sim, jp)
    return (x, (got[0].numpy(), got[1].numpy()), (np.asarray(want[0]), np.asarray(want[1])),
            back.numpy(), np.asarray(jback))


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_r2c_matches_jax_and_numpy(case, bits):
    x, got, want, _, _ = _case(case, bits)
    n = x.shape[-1]
    assert got[0].shape == x.shape[:-1] + (n // 2 + 1,)
    assert got[0].dtype == (np.float64 if bits == 64 else np.float32)
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    g = _c(got)
    assert _rel(g, _c(want)) <= (TOL_F64 if bits == 64 else TOL_JAX_F32)
    assert _rel(g, ref) <= (TOL_F64 if bits == 64 else TOL_NUMPY_F32)
    # DC and Nyquist bins are real
    assert np.all(got[1][..., 0] == 0) and np.all(got[1][..., -1] == 0)


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_c2r_matches_jax_and_numpy(case, bits):
    x, _, _, back, jback = _case(case, bits)
    assert back.shape == x.shape and back.dtype == x.dtype
    want = np.fft.irfft(np.fft.rfft(x.astype(np.float64), axis=-1), axis=-1)
    assert _rel(back, jback) <= (TOL_F64 if bits == 64 else TOL_JAX_F32)
    assert _rel(back, want) <= (TOL_F64 if bits == 64 else TOL_NUMPY_F32)


@functools.lru_cache(maxsize=None)
def _df64(engine):
    n = 1 << 10
    x = _signal((3, n), 77)
    p, jp = _planners(n, 64, f64_engine=engine)
    got = pt.r2c_fft_f64_with_planner(x, p)
    back = pt.c2r_fft_f64_with_planner(*got, p)
    want = phastft_tpu.r2c_fft_f64_with_planner(x, jp)
    jback = phastft_tpu.c2r_fft_f64_with_planner(np.asarray(got[0].numpy()),
                                                  np.asarray(got[1].numpy()), jp)
    return x, got, want, back, jback


def test_df64_inner_engine_matches_jax_and_numpy():
    x, got, want, back, jback = _df64("df64")
    ref = np.fft.rfft(x, axis=-1)
    g = _c((got[0].numpy(), got[1].numpy()))
    assert _rel(g, _c(want)) <= TOL_F64
    assert _rel(g, ref) <= TOL_F64
    assert _rel(back.numpy(), np.asarray(jback)) <= TOL_F64
    assert _rel(back.numpy(), x) <= TOL_F64


@pytest.mark.parametrize("engine", ["df64-split", "df64-oz"])
def test_other_dd_inner_engines_match_numpy(engine):
    n = 1 << 12
    x = _signal(n, 78)
    opts = {"leaf_fft_size": 1 << 10} if engine == "df64-oz" else {}
    p = pt.PlannerR2c64(n, inner_options=pt.Options(f64_engine=engine, **opts), device="cpu")
    got = pt.r2c_fft_f64_with_planner(x, p)
    assert _rel(_c((got[0].numpy(), got[1].numpy())), np.fft.rfft(x)) <= TOL_F64
    assert _rel(pt.c2r_fft_f64_with_planner(*got, p).numpy(), x) <= TOL_F64


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("log_n", [2, 8, 13])
def test_roundtrip(bits, log_n):
    n = 1 << log_n
    x = _signal((2, n), 90 + log_n, DTYPES[f"f{bits}"])
    r2c = pt.r2c_fft_f64 if bits == 64 else pt.r2c_fft_f32
    c2r = pt.c2r_fft_f64 if bits == 64 else pt.c2r_fft_f32
    back = c2r(*r2c(x, device="cpu"), device="cpu")
    assert _rel(back.numpy(), x) <= (TOL_F64 if bits == 64 else TOL_NUMPY_F32)


# mirrors tests/test_r2c.py::test_dc_only_signal, test_nyquist_only_signal,
# test_all_zeros
def test_edge_signals():
    n = 64
    for x, k in ((np.ones(n), 0), (np.array([1.0, -1.0] * (n // 2)), n // 2)):
        sre, sim = pt.r2c_fft_f64(x, device="cpu")
        want = np.zeros(n // 2 + 1)
        want[k] = n
        np.testing.assert_allclose(sre.numpy(), want, atol=1e-12)
        np.testing.assert_allclose(sim.numpy(), 0, atol=1e-12)
    sre, sim = pt.r2c_fft_f64(np.zeros(32), device="cpu")
    assert not sre.any() and not sim.any()


# mirrors tests/test_r2c.py::test_planner_vs_convenience_bitwise and
# test_scratch_variant_bitwise_and_reusable
@pytest.mark.parametrize("bits", [32, 64])
def test_planner_convenience_and_scratch_bitwise(bits):
    n = 1 << 12
    x = _signal(n, 13, DTYPES[f"f{bits}"])
    cls = pt.PlannerR2c64 if bits == 64 else pt.PlannerR2c32
    r2c, r2c_p = ((pt.r2c_fft_f64, pt.r2c_fft_f64_with_planner) if bits == 64
                  else (pt.r2c_fft_f32, pt.r2c_fft_f32_with_planner))
    c2r, c2r_p, c2r_s = ((pt.c2r_fft_f64, pt.c2r_fft_f64_with_planner,
                          pt.c2r_fft_f64_with_planner_and_scratch) if bits == 64
                         else (pt.c2r_fft_f32, pt.c2r_fft_f32_with_planner,
                               pt.c2r_fft_f32_with_planner_and_scratch))
    p = cls(n, device="cpu")
    a = r2c(x, device="cpu")
    b = r2c_p(x, p)
    for i in range(2):
        assert torch.equal(a[i], b[i])
    back = c2r(*a, device="cpu")
    for call in (lambda: c2r_p(*a, p), lambda: c2r_s(*a, p, scratch=None),
                 lambda: c2r_s(*a, p, scratch=object())):
        assert torch.equal(call(), back)
    # the caller's spectrum is never written
    assert torch.equal(a[0], b[0])


# mirrors tests/test_r2c.py::test_c2r_shape_errors, and tests/test_errors.py's
# power-of-two and planner-size checks on the real entries
def test_entry_errors():
    p = pt.PlannerR2c64(16, device="cpu")
    with pytest.raises(pt.LengthMismatchError,
                       match=r"spec_re must have length N/2 \+ 1 = 9, got 8"):
        pt.c2r_fft_f64_with_planner(np.zeros(8), np.zeros(8), p)
    with pytest.raises(pt.LengthMismatchError, match="equal length"):
        pt.c2r_fft_f64_with_planner(np.zeros(9), np.zeros(8), p)
    with pytest.raises(pt.PlannerSizeMismatchError,
                       match="planner is for size 16 but input has size 32"):
        pt.r2c_fft_f64_with_planner(np.zeros(32), p)
    with pytest.raises(pt.NonPowerOfTwoError, match="n must be a power of 2, got 12"):
        pt.r2c_fft_f32(np.zeros(12), device="cpu")
    with pytest.raises(pt.NonPowerOfTwoError, match="R2C requires n"):
        pt.r2c_fft_f64(np.zeros(2), device="cpu")
    with pytest.raises(pt.NonPowerOfTwoError, match="n must be a power of 2, got 10"):
        pt.c2r_fft_f64(np.zeros(6), np.zeros(6), device="cpu")
    with pytest.raises(pt.PhastftError, match="planner is on cpu"):
        pt.r2c_fft_f64_with_planner(torch.zeros(16, device="meta"), p)
