"""The port's Ozaki engine (``f64_engine="df64-oz"``) on the CPU, against the
JAX package's ``ops/ozaki.py`` and ``ops/pallas_ozdd.py``.

The slicing and the scale are compared bit for bit (bf16 as f32). The
contraction is compared on joined f64 values. The port's plain ``ozcol`` ->
``ozleaft`` is held to numpy's f64 FFT at 1e-10 (the contract bound; ~1e-11
is the slice truncation), and to the JAX package's fused two-pass kernels in
tests/test_torch_ozaki_twopass.py (a file of its own: the Pallas
interpreter's runs take most of this suite's time, and a file runs on one
worker). The entries are held to the JAX package's entries, which take its
XLA dd path on the CPU, and to numpy at 1e-10.
"""

import numpy as np
import pytest
import torch

import phastft_tpu
import phastft_tpu_torch as pt
from phastft_tpu_torch.ops import ozaki, ozdd
from phastft_tpu_torch.ops.route import KERNELS
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
JOINED_TOL = 1e-13    # the same slice integers in both packages


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


def _dd_pair(x64):
    return tuple(torch.from_numpy(a) for a in split_hi_lo(x64))


def _tabs_torch(arrays, n_slices):
    return tuple(torch.from_numpy(a).to(torch.bfloat16 if i < n_slices
                                        else torch.float32)
                 for i, a in enumerate(arrays))


# -- slicing -----------------------------------------------------------------

@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_slice_matrix_host_matches_jax(bound):
    from phastft_tpu.ops.ozaki import oz_slice_matrix_host as jax_slice

    rng = np.random.default_rng(1)
    m = rng.uniform(-bound, bound, (48, 40))
    got = ozaki.oz_slice_matrix_host(m, bound=bound)
    want = jax_slice(m, bound=bound)
    assert len(got) == len(want) == ozaki.NSLICES
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, _f32(w))
        assert np.all(np.abs(g) <= 128)


def test_sigma_matches_jax_bit_for_bit():
    import jax.numpy as jnp

    from phastft_tpu.ops.ozaki import oz_sigma as jax_sigma

    # tests/test_ozaki.py's values, zero, subnormals, the smallest normal,
    # and exponents at and past the clamp of ozaki.py:98-100
    m = np.array([0.0, 1e-30, 0.75, 1.0, 1.5, 2.0, 1e20, 1e-45, 1e-40,
                  2.0 ** -126, 2.0 ** 124, 2.0 ** 125, 2.0 ** 126, 3e38],
                 np.float32)
    sigma, inv = ozaki.oz_sigma(torch.from_numpy(m))
    jsig, jinv = jax_sigma(jnp.asarray(m))
    for got, want in ((sigma, jsig), (inv, jinv)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))
    s, i = sigma.numpy().astype(np.float64), inv.numpy().astype(np.float64)
    np.testing.assert_array_equal(s * i, np.ones_like(s))
    assert np.all(s[:-2] > m[:-2])


@pytest.mark.parametrize("axis", [0, 1])
def test_slice_data_and_complex_match_jax_bit_for_bit(axis):
    import jax.numpy as jnp

    from phastft_tpu.ops.ozaki import oz_slice_complex as jax_complex
    from phastft_tpu.ops.ozaki import oz_slice_data as jax_data

    rng = np.random.default_rng(2 + axis)
    xr = rng.standard_normal((64, 32)) * np.exp(rng.standard_normal((64, 32)))
    xi = rng.standard_normal((64, 32))
    tr, ti = _dd_pair(xr), _dd_pair(xi)
    jr = tuple(jnp.asarray(a.numpy()) for a in tr)
    ji = tuple(jnp.asarray(a.numpy()) for a in ti)

    # the scale of each contraction column, as oz_slice_complex takes it
    inv = ozaki.oz_sigma(torch.amax(tr[0].abs(), dim=axis, keepdim=True))[1]
    got = ozaki.oz_slice_data(tr[0], tr[1], inv)
    want = jax_data(jr[0], jr[1], jnp.asarray(inv.numpy()))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(g), _f32(w))

    got = ozaki.oz_slice_complex(tr, ti, axis)
    want = jax_complex(jr, ji, axis)
    for gs, ws in zip(got[:3], want[:3]):
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(_f32(g), _f32(w))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_cmatmul_dd_matches_jax_and_f64():
    """tests/test_ozaki.py's case: (128 x 128) @ (128 x 256) with a wide
    dynamic range."""
    import functools

    import jax
    import jax.numpy as jnp

    from phastft_tpu.ops.ozaki import oz_cmatmul_dd as jax_cmatmul

    rng = np.random.default_rng(0)
    d, c = 128, 256
    ang = -2 * np.pi * np.outer(np.arange(d), np.arange(d)) / d
    fr64, fi64 = np.cos(ang), np.sin(ang)
    host = (ozaki.oz_slice_matrix_host(fr64), ozaki.oz_slice_matrix_host(fi64),
            ozaki.oz_slice_matrix_host(fr64 + fi64, bound=2.0))
    xr64 = rng.standard_normal((d, c)) * np.exp(rng.standard_normal((d, c)))
    xi64 = rng.standard_normal((d, c))

    fs_t = [tuple(torch.from_numpy(a).to(torch.bfloat16) for a in h) for h in host]
    got = ozaki.oz_cmatmul_dd(*fs_t, _dd_pair(xr64), _dd_pair(xi64),
                              ozdd._exact_dot, axis=0)
    fs_j = [tuple(jnp.asarray(a, jnp.bfloat16) for a in h) for h in host]
    dot = functools.partial(
        jax.lax.dot_general, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    want = jax_cmatmul(*fs_j, tuple(jnp.asarray(a) for a in split_hi_lo(xr64)),
                       tuple(jnp.asarray(a) for a in split_hi_lo(xi64)), dot,
                       axis=0)
    g = _joined(got)
    assert _rel(g, _joined(want)) <= JOINED_TOL
    assert _rel(g, (fr64 + 1j * fi64) @ (xr64 + 1j * xi64)) <= 1e-9


# -- the two passes ----------------------------------------------------------

def test_two_pass_batch_and_natural_order():
    """A batch of 3 at (128, 1024): each entry equals its own transform, and
    ozcol's relayout holds element [k1, i2] at [i2 // 128, k1, i2 % 128]."""
    n1, n2 = 128, 1024
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, n1 * n2)) + 1j * rng.standard_normal((3, n1 * n2))
    planes = [torch.from_numpy(a).reshape(3, n1, n2)
              for pair in (split_hi_lo(x.real), split_hi_lo(x.imag)) for a in pair]
    ctabs = _tabs_torch(ozdd.ozcol_tables_host(n1, n2), ozdd.OZCOL_SLICES)
    ltabs = _tabs_torch(ozdd.ozleaft_tables_host(n2), ozdd.OZLEAFT_SLICES)
    c = ozdd.ozcol(*planes, ctabs, n1)
    single = ozdd.ozcol(*(p[1] for p in planes), ctabs, n1)
    assert all(torch.equal(a[1], b) for a, b in zip(c, single))
    out = ozdd.ozleaft(*c, ltabs, n1)
    assert _rel(_joined(out), np.fft.fft(x, axis=-1)) <= OZ_TOL


# -- the planner -------------------------------------------------------------

def _jax_oz_planner(n, leaf, engine="df64-oz"):
    return phastft_tpu.PlannerDit64(n, options=phastft_tpu.Options(
        f64_engine=engine, leaf_fft_size=leaf))


def _numpy_state(jp):
    tables, corrs = jp.dd_state

    def conv(v):
        return tuple(conv(x) for x in v) if isinstance(v, tuple) else np.asarray(v)

    return ({k: conv(v) for k, v in tables.items()},
            {k: conv(v) for k, v in corrs.items()})


def _oz_keys(corrs):
    return {k for k in corrs if k.startswith("oz")}


def test_planner_oz_tables_equal_jax():
    n, leaf = 1 << 20, 1 << 13
    port = pt.PlannerDit64(n, options=pt.Options(f64_engine="df64-oz",
                                                 leaf_fft_size=leaf), device="cpu")
    jax_corrs = _jax_oz_planner(n, leaf).dd_state[1]
    corrs = port.dd_state[1]
    assert _oz_keys(corrs) == _oz_keys(jax_corrs) == {"ozcol128x8192", "ozleafT8192"}
    for key in _oz_keys(corrs):
        n_slices = ozdd.slice_count(key)
        assert len(corrs[key]) == len(jax_corrs[key])
        for i, (a, b) in enumerate(zip(corrs[key], jax_corrs[key])):
            assert a.dtype == (torch.bfloat16 if i < n_slices else torch.float32)
            np.testing.assert_array_equal(_f32(a), _f32(b))
    # the oz level reads neither the column nor the leaf tables of df64
    assert set(corrs) == _oz_keys(corrs)


@pytest.mark.parametrize("log_n,engine,want", [
    (20, "df64", set()),                              # no oz without the engine
    (25, "df64-oz", {"ozcol128x8192", "ozleafT8192"}),  # the inner level only
    (14, "df64-oz", set()),                           # n1 = 2: outside the window
])
def test_planner_oz_keys_follow_jax(log_n, engine, want):
    n, leaf = 1 << log_n, 1 << 13
    port = pt.PlannerDit64(n, options=pt.Options(f64_engine=engine,
                                                 leaf_fft_size=leaf), device="cpu")
    corrs = port.dd_state[1]
    assert _oz_keys(corrs) == want == _oz_keys(_jax_oz_planner(n, leaf, engine).dd_state[1])
    if log_n == 25:  # the outer level keeps its df64 column tables
        assert "ddpcol32x1048576" in corrs


def test_from_numpy_tables_takes_jax_oz_state():
    n, leaf = 1 << 17, 1 << 10
    opts = pt.Options(f64_engine="df64-oz", leaf_fft_size=leaf)
    jp = _jax_oz_planner(n, leaf)
    tables, corrs = _numpy_state(jp)
    assert corrs["ozcol128x1024"][0].dtype.name == "bfloat16"
    port = pt.PlannerDit64.from_numpy_tables(n, (tables, corrs), device="cpu",
                                             options=opts)
    own = pt.PlannerDit64(n, options=opts, device="cpu")
    assert set(port.dd_state[1]) == set(own.dd_state[1])
    for key in own.dd_state[1]:
        assert all(torch.equal(a, b) for a, b in
                   zip(port.dd_state[1][key], own.dd_state[1][key]))
    # float32 slices are taken too; a non-integer slice is refused
    f32 = dict(corrs)
    f32["ozleafT1024"] = tuple(a.astype(np.float32) for a in corrs["ozleafT1024"])
    pt.PlannerDit64.from_numpy_tables(n, (tables, f32), device="cpu", options=opts)
    bad = dict(f32)
    bad["ozleafT1024"] = (bad["ozleafT1024"][0] + 0.5,) + bad["ozleafT1024"][1:]
    with pytest.raises(ValueError, match="integers"):
        pt.PlannerDit64.from_numpy_tables(n, (tables, bad), device="cpu",
                                          options=opts)
    big = dict(f32)
    big["ozcol128x1024"] = (corrs["ozcol128x1024"][0].astype(np.float32) * 4,) \
        + corrs["ozcol128x1024"][1:]
    with pytest.raises(ValueError, match="ozcol128x1024"):
        pt.PlannerDit64.from_numpy_tables(n, (tables, big), device="cpu",
                                          options=opts)


# -- the entries -------------------------------------------------------------

@pytest.mark.parametrize("log_n,leaf,batch", [(17, 1 << 10, ()), (20, 1 << 13, ()),
                                              (17, 1 << 10, (2,))])
def test_oz_entries_match_jax_and_numpy(log_n, leaf, batch):
    n = 1 << log_n
    rng = np.random.default_rng(log_n + len(batch))
    re = rng.standard_normal(batch + (n,))
    im = rng.standard_normal(batch + (n,))
    port = pt.PlannerDit64(n, options=pt.Options(f64_engine="df64-oz",
                                                 leaf_fft_size=leaf), device="cpu")
    got = pt.fft_64_dit_with_planner(re, im, pt.Direction.Forward, port)
    assert got[0].dtype == torch.float64 and tuple(got[0].shape) == batch + (n,)
    g = got[0].numpy() + 1j * got[1].numpy()
    assert _rel(g, np.fft.fft(re + 1j * im, axis=-1)) <= OZ_TOL
    ref = phastft_tpu.fft_64_dit_with_planner(
        re, im, phastft_tpu.Direction.Forward, _jax_oz_planner(n, leaf))
    assert _rel(g, np.asarray(ref[0]) + 1j * np.asarray(ref[1])) <= OZ_TOL


def test_oz_roundtrip_and_inverse():
    n = 1 << 17
    rng = np.random.default_rng(11)
    re, im = rng.standard_normal(n), rng.standard_normal(n)
    planner = pt.PlannerDit64(n, options=pt.Options(f64_engine="df64-oz",
                                                    leaf_fft_size=1 << 10),
                              device="cpu")
    fwd = pt.fft_64_dit_with_planner(re, im, pt.Direction.Forward, planner)
    inv = pt.fft_64_dit_with_planner(re, im, pt.Direction.Reverse, planner)
    assert _rel(inv[0].numpy() + 1j * inv[1].numpy(),
                np.fft.ifft(re + 1j * im)) <= OZ_TOL
    back = pt.fft_64_dit_with_planner(fwd[0], fwd[1], pt.Direction.Reverse, planner)
    assert _rel(back[0].numpy() + 1j * back[1].numpy(), re + 1j * im) <= OZ_TOL


# -- dispatch: the oz tables arm it, as in phastft_tpu/ops/fourstep.py:514-536

@pytest.mark.parametrize("case,want", [
    ("oz planner", ["ozcol", "ozleaft"]),
    ("oz planner, per-call df64", ["ozcol", "ozleaft"]),
    ("df64 planner, per-call df64-oz", ["ddcol", "ddleaf"]),
    ("oz planner outside the window", ["ddcol", "ddleaf"]),
    ("oz planner, leaf plan", ["ddleaf"]),
])
def test_oz_dispatch(monkeypatch, case, want):
    calls = []
    for name in ("ozcol", "ozleaft", "ddcol", "ddleaf"):
        real = getattr(KERNELS, name)
        monkeypatch.setattr(KERNELS, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    n, leaf = 1 << 17, 1 << 10
    if case == "oz planner outside the window":
        n, leaf = 1 << 14, 1 << 13   # n1 = 2
    elif case == "oz planner, leaf plan":
        n, leaf = 1 << 13, 1 << 13
    engine = "df64" if case.startswith("df64 planner") else "df64-oz"
    planner = pt.PlannerDit64(n, options=pt.Options(f64_engine=engine,
                                                    leaf_fft_size=leaf), device="cpu")
    opts = planner.options
    if "per-call" in case:
        opts = pt.Options(f64_engine=case.rsplit(" ", 1)[1])
    x = np.random.default_rng(5).standard_normal(n)
    out = pt.fft_64_dit_with_planner_and_opts(x, 0 * x, "f", planner, opts)
    assert calls == want
    assert _rel(out[0].numpy() + 1j * out[1].numpy(), np.fft.fft(x)) <= OZ_TOL


def test_oz_runs_no_kernel_on_cpu():
    from phastft_tpu_torch.tracing import launch_count

    kernels = ("ozcol", "ozleaft", "ddcol", "ddcol_nocorr", "ddleaf", "transpose2")
    before = [launch_count(k) for k in kernels]
    n = 1 << 17
    planner = pt.PlannerDit64(n, options=pt.Options(f64_engine="df64-oz",
                                                    leaf_fft_size=1 << 10),
                              device="cpu")
    x = np.ones(n)
    out = pt.fft_64_dit_with_planner(x, 0 * x, "f", planner)
    assert abs(float(out[0][0]) - n) <= 1e-10 * n
    assert [launch_count(k) for k in kernels] == before


# -- the wrappers' refusals ------------------------------------------------------

@pytest.mark.parametrize("bad", ["n1=64", "n1=4096", "dtype", "contiguous", "tables"])
def test_ozcol_refuses(bad):
    n1, n2 = 128, 1024
    tabs = _tabs_torch(ozdd.ozcol_tables_host(n1, n2), ozdd.OZCOL_SLICES)
    if bad.startswith("n1="):
        n1 = int(bad[3:])
    planes = [torch.zeros(n1, n2) for _ in range(4)]
    err = ValueError
    if bad == "dtype":
        planes[1] = planes[1].double()
        err = TypeError
    elif bad == "contiguous":
        planes[2] = torch.zeros(n2, n1).t()
    elif bad == "tables":
        tabs = tabs[:-1]
    with pytest.raises(err):
        ozdd.ozcol(*planes, tabs, n1)


@pytest.mark.parametrize("bad", ["A=4", "A=128", "dtype", "contiguous", "tables"])
def test_ozleaft_refuses(bad):
    a, n1 = 8, 128
    tabs = _tabs_torch(ozdd.ozleaft_tables_host(a * 128), ozdd.OZLEAFT_SLICES)
    if bad.startswith("A="):
        a = int(bad[2:])
    planes = [torch.zeros(a, n1, 128) for _ in range(4)]
    err = ValueError
    if bad == "dtype":
        planes[0] = planes[0].double()
        err = TypeError
    elif bad == "contiguous":
        planes[3] = torch.zeros(a, 128, n1).transpose(-1, -2)
    elif bad == "tables":
        tabs = tabs[:3] + tuple(t.float() for t in tabs[3:6]) + tabs[6:]
        err = TypeError
    with pytest.raises(err):
        ozdd.ozleaft(*planes, tabs, n1)
