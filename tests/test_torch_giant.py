"""Transforms of n >= 2^31 on the CPU, without running one: the port's
plans, tables, kernel arguments and intermediates at the sizes one H100
runs (f32 C2C 2^31, R2C 2^32) and past them, against the JAX package.

- Plans: ``PlannerDit32/64`` at n = 2^31..2^40 plan as the JAX package's
  ``plan_rows(n, guess_options(n, dtype).leaf_fft_size)``, and the
  distributed factorizations (``_factor``, ``_factor_dd``, through
  ``_layout``) agree with the JAX package's at d = 1..64.
- Sizes: the planners' tables grow with the plan's column factors and the
  square root of its rows, never with n.
- Kernel arguments: the plans' launches, walked on meta tensors (shapes, no
  data) through the port's own row functions, pass ``_build.check_args``:
  every value the wrappers pass as a 32-bit int fits it.
- Hand-over: each split level's column output is freed once the inner
  level's first kernel has read it (weakrefs, small plans run on the CPU).
- The untangle table as the card builds it against the host's at n <= 2^20.

No transform past 2^20 points runs here.
"""

import collections
import time
import weakref

import numpy as np
import pytest
import torch

import phastft_tpu
import phastft_tpu_torch as pt
from phastft_tpu.ops.fourstep import plan_rows as jax_plan_rows
from phastft_tpu.parallel import fourstep_dist as jax_dist
from phastft_tpu_torch.ops import _build, colfft as colmod, fourstep
from phastft_tpu_torch.ops import leaf as leafmod, leaft as leaftmod
from phastft_tpu_torch.ops import longcol, native, r2c, transpose
from phastft_tpu_torch.ops.route import KERNELS
from phastft_tpu_torch.parallel import fourstep_dist as dist


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GIANT_LOGS = range(31, 41)
DTYPES = {"f32": np.float32, "f64": np.float64}
#: Table budget of a planner: 256 MiB (the f64 native state past 2^37 is
#: held to 1/4096 of one input pair instead, see test_tables_small).
TABLE_BYTES = 256 << 20


def _jax_plan(n, dtype):
    return jax_plan_rows(n, phastft_tpu.Options.guess_options(n, dtype).leaf_fft_size)


# -- plans -----------------------------------------------------------------

@pytest.mark.parametrize("log_n", GIANT_LOGS)
@pytest.mark.parametrize("tag", DTYPES)
def test_plans_match_jax(tag, log_n):
    n = 1 << log_n
    cls = pt.PlannerDit32 if tag == "f32" else pt.PlannerDit64
    planner = cls(n, device="cpu")
    assert planner.plan == _jax_plan(n, DTYPES[tag])
    assert planner.options.leaf_fft_size == (
        phastft_tpu.Options.guess_options(n, DTYPES[tag]).leaf_fft_size)


class _Opts:
    def __init__(self, leaf, engine=None):
        self.leaf_fft_size, self.f64_engine = leaf, engine


class _Planner:
    """What ``_layout`` reads of a planner."""

    def __init__(self, dtype, leaf, engine=None):
        self.dtype = np.dtype(dtype)
        self.options = _Opts(leaf, engine)


def _jax_or_error(fn, *args):
    try:
        return fn(*args)
    except phastft_tpu.PhastftError as err:
        return type(err).__name__


@pytest.mark.parametrize("tag", DTYPES)
def test_dist_factors_match_jax(tag):
    """``_factor`` / ``_factor_dd`` and the layout ``fft_distributed`` takes
    agree with the JAX package's factorizations at n = 2^31..2^40 over
    d = 1..64 ranks, and every column factor past 2048 splits, level by
    level (``ops/longcol.long_split``), into factors the column kernels
    take."""
    dtype = DTYPES[tag]
    for log_n in GIANT_LOGS:
        n = 1 << log_n
        leaf = phastft_tpu.Options.guess_options(n, dtype).leaf_fft_size
        for d in (1 << k for k in range(7)):
            assert dist._factor(n, d, leaf) == jax_dist._factor(n, d, leaf)
            assert (_jax_or_error(dist._factor_dd, n, d)
                    == _jax_or_error(jax_dist._factor_dd, n, d))
            engines = (None,) if tag == "f32" else (None, "df64")
            for engine in engines:
                got = dist._layout(n, d, _Planner(dtype, leaf, engine), False)
                want = (jax_dist._factor_dd(n, d) if engine
                        else jax_dist._factor(n, d, leaf))
                assert got[3:] == want
                n1, todo = got[3], [got[3]]
                while todo:
                    m = todo.pop()
                    if m <= longcol.MAX_N1:
                        continue
                    p, q = longcol.long_split(m)
                    assert p * q == m and p <= longcol.MAX_N1 and q >= p
                    todo.append(q)
                assert n1 >= 1


def test_twiddle_phases_exact_past_2_31():
    """The plain-torch twiddle's phases are exact integers at n = 2^40: the
    products k1 * j are int64, reduced mod n before the f64 angle."""
    n = 1 << 40
    rows = torch.tensor([(1 << 20) - 1, 3, (1 << 19) + 1], dtype=torch.int64)
    cols = torch.tensor([(1 << 20) - 1, (1 << 20) - 3, 7], dtype=torch.int64)
    re = torch.ones(3, 3, dtype=torch.float64)
    im = torch.zeros(3, 3, dtype=torch.float64)
    longcol.twiddle_(re, im, n, rows, cols)
    phase = np.array([[(int(r) * int(c)) % n for c in cols] for r in rows], np.float64)
    ang = phase * (-2.0 * np.pi / n)
    np.testing.assert_allclose(re.numpy(), np.cos(ang), rtol=0, atol=4e-16)
    np.testing.assert_allclose(im.numpy(), np.sin(ang), rtol=0, atol=4e-16)
    # the long columns' first-pass exponents q * (n / n1) + col_base + j
    n1, pp, c, base = 1 << 20, 1 << 10, 4, (1 << 20) - 4
    exps = longcol.level_exponents(n, n1, pp, c, base, False)
    want = [q * (n // n1) + base + j for q in range(n1 // pp) for j in range(c)]
    assert exps.dtype == np.int64 and exps.tolist() == want


# -- sizes -----------------------------------------------------------------

def _bytes(tables):
    return sum(t.numel() * t.element_size() for ts in tables.values() for t in ts)


def _native_bytes(plan):
    """Bytes of ``_native_tables_host(plan)`` from its shapes, unbuilt: the
    split twiddles of every level, the leaf's correction (every f64 plan
    past 2^30 ends on the 512 x 128 leaf) and the step tables (m/2 pairs)
    of each DFT size."""
    total, sizes = 0, {512, 128}
    for n1, _, n2 in fourstep.split_levels(plan):
        s = 1 << ((n2.bit_length() - 1) // 2)
        total += 16 * n1 * (n2 // s + s)
        sizes.add(n1)
    return total + 16 * 512 * 128 + 8 * sum(sizes)


@pytest.mark.parametrize("tag", DTYPES)
def test_tables_small(tag):
    """A planner's tables at n = 2^31..2^40 (the f64 native state built at
    2^31..2^37) are what its kernels read: a few MiB in f32; in f64 they
    grow as n1 * sqrt(n2), under 256 MiB to 2^37 and under 1/4096 of one
    input pair past it (269 MiB at 2^38, 561 MiB at 2^40). Each planner
    builds in under 5 s."""
    for log_n in GIANT_LOGS:
        n = 1 << log_n
        t0 = time.perf_counter()
        if tag == "f32":
            planner = pt.PlannerDit32(n, device="cpu")
            nbytes = _bytes(planner.leaf_corrs)
            assert nbytes < 16 << 20
        else:
            planner = pt.PlannerDit64(n, device="cpu")
            nbytes = _native_bytes(planner.plan)
            if log_n <= 37:
                assert _bytes(planner.native_state) == nbytes
                assert nbytes < TABLE_BYTES
            else:
                assert nbytes < 16 * n >> 12
        assert time.perf_counter() - t0 < 5.0, log_n
        del planner


# -- kernel arguments --------------------------------------------------------

def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _pair(shape, dtype=torch.float32):
    return _meta(shape, dtype), _meta(shape, dtype)


class _Launches:
    """Stand-ins for the kernel wrappers that ``ops/fourstep``,
    ``ops/longcol`` and ``parallel/fourstep_dist`` call (through
    ``ops/route.KERNELS``) on meta tensors: each checks the arguments
    its wrapper would pass (the wrapper's own ``*_args``) and returns the
    output's shape."""

    def __init__(self, monkeypatch):
        self.seen = []
        for name in ("colfft", "colfft_out3d", "leaft", "leaf", "leaf3",
                     "transpose2", "col64", "leaf64", "transpose2_64"):
            monkeypatch.setattr(KERNELS, name, getattr(self, name))

    def _check(self, entry, args, out):
        _build.check_args(entry, args)
        self.seen.append((entry, args))
        return out

    def colfft(self, re, im, tabs, n1, *, n_total=None, col_base=0):
        args = colmod.colfft_args(re.shape, n1, 0, n_total, col_base)
        return self._check("phastft_colfft", args, _pair(re.shape))

    def colfft_out3d(self, re, im, tabs, n1):
        args = colmod.colfft_args(re.shape, n1, 1)
        n2 = re.shape[-1]
        return self._check("phastft_colfft", args,
                           _pair(tuple(re.shape[:-2]) + (n2 // 128, n1, 128)))

    def leaft(self, cre, cim, mats, n1, out_scale=1.0):
        out = tuple(cre.shape[:-3]) + (cre.shape[-3] * 128 * n1,)
        args = leaftmod.leaft_args(cre.shape, out_scale=out_scale)
        return self._check("phastft_leaft", args, _pair(out))

    def leaf(self, re, im, mats, n1, out_scale=1.0):
        args = leafmod.leaf_args(re.shape, n1, out_scale=out_scale)
        return self._check("phastft_leaf", args, _pair(re.shape))

    def leaf3(self, re, im, mats, a, b, out_scale=1.0):
        args = leafmod.leaf3_args(re.shape, out_scale=out_scale)
        return self._check("phastft_leaf3", args, _pair(re.shape))

    def transpose2(self, a, b, out_scale=1.0, entry="phastft_transpose2"):
        out = tuple(a.shape[:-2]) + (a.shape[-1], a.shape[-2])
        args = transpose.transpose_args(a.shape, out_scale=out_scale)
        return self._check(entry, args, _pair(out, a.dtype))

    def transpose2_64(self, a, b, out_scale=1.0):
        return self.transpose2(a, b, out_scale, "phastft_transpose2_64")

    def col64(self, re, im, tabs, n1, steps):
        return self._check("phastft_col64", native.col64_args(re.shape, n1),
                           _pair(re.shape, torch.float64))

    def leaf64(self, re, im, corr, n, steps, out_scale=1.0):
        return self._check("phastft_leaf64", native.leaf64_args(re.shape, out_scale=out_scale),
                           _pair(re.shape, torch.float64))


_ANY_TABLE = collections.defaultdict(lambda: (None,) * 10)


@pytest.mark.parametrize("log_n", range(31, 37))
def test_kernel_args_f32_plans(log_n, monkeypatch):
    """The f32 plans of 2^31..2^36 launch their kernels with every 32-bit
    argument in range; at 2^31 one colfft (classic, n1 = 1024), one
    colfft_out3d, one leaft and one transpose2, a batch of 1024 rows of
    2^21 in the inner level."""
    run = _Launches(monkeypatch)
    n = 1 << log_n
    plan = _jax_plan(n, np.float32)
    out = fourstep.rows_f32([*_pair((n,))], plan, _ANY_TABLE)
    assert tuple(out[0].shape) == (n,)
    kinds = collections.Counter(e for e, _ in run.seen)
    levels = len(list(fourstep.split_levels(plan)))
    assert kinds == {"phastft_colfft": levels, "phastft_leaft": 1,
                     "phastft_transpose2": levels - 1}
    if log_n == 31:
        outer, inner = run.seen[0][1], run.seen[1][1]
        assert outer[8:12] == (1, 1024, 1 << 21, 0)
        assert inner[8:12] == (1024, 128, 1 << 14, 1)


@pytest.mark.parametrize("log_n", range(31, 39))
def test_kernel_args_f64_plans(log_n, monkeypatch):
    """The native f64 plans of 2^31..2^38: one col64 and one transpose2_64
    per split level and one leaf64, every 32-bit argument in range."""
    run = _Launches(monkeypatch)
    n = 1 << log_n
    plan = _jax_plan(n, np.float64)
    out = fourstep.rows_native([*_pair((n,), torch.float64)], plan, _ANY_TABLE)
    assert tuple(out[0].shape) == (n,)
    kinds = collections.Counter(e for e, _ in run.seen)
    levels = len(list(fourstep.split_levels(plan)))
    assert kinds == {"phastft_col64": levels, "phastft_leaf64": 1,
                     "phastft_transpose2_64": levels}


@pytest.mark.parametrize("shape,entry", [
    ((1 << 17, 1 << 14), "phastft_leaf"),
    ((1 << 15, 1 << 16), "phastft_leaf3"),
    ((1 << 15, 1 << 16), "phastft_leaf64"),
])
def test_kernel_args_leaf_batches(shape, entry):
    """Batches of 2^31 elements on the leaf kernels: the rows go as a
    64-bit count, the row length as a 32-bit int."""
    args, rows_at = {
        "phastft_leaf": (leafmod.leaf_args(shape, shape[-1] // 128), 10),
        "phastft_leaf3": (leafmod.leaf3_args(shape), 12),
        "phastft_leaf64": (native.leaf64_args(shape), 8)}[entry]
    _build.check_args(entry, args)
    assert args[rows_at] == shape[0] and shape[0] * shape[1] == 1 << 31


def test_kernel_args_r2c_2_32():
    """The real transforms' passes at n = 2^32 (2^31 bins): counts and
    offsets are 64-bit, only flags are 32-bit."""
    n = 1 << 32
    h = n // 2
    _build.check_args("phastft_r2c_deinterleave", r2c.deinterleave_args((n,), False))
    _build.check_args("phastft_r2c_interleave", r2c.interleave_args((h,), False, 2.0 / n))
    for inverse, length in ((False, h), (True, h)):
        args = r2c.untangle_args(False, inverse, (length,), length, 0, length, 0, h,
                                 not inverse)
        _build.check_args("phastft_r2c_untangle", args)
        assert args[16:20] == (1, length, 0, h)
        args = r2c.untangle_pair_args(False, inverse, 1, h, r2c.pair_schedule(1))
        _build.check_args("phastft_r2c_untangle_pair", args)
        assert args[8:10] == (1, h)


def test_kernel_args_dist_2_31(monkeypatch):
    """``fft_distributed``'s passes at f32 2^31 over one rank: the long
    columns (n1 = 2^17 = 256 x 512) as two colfft launches and two
    transposes, then the rows, every 32-bit argument in range."""
    run = _Launches(monkeypatch)
    n, d = 1 << 31, 1
    f64, _, _, n1, n2 = dist._layout(n, d, _Planner(np.float32, 1 << 14), False)
    assert (f64, n1, n2) == (False, 1 << 17, 1 << 14)
    t = longcol.columns([*_pair((n1, n2))], n, n1, 0, False, False)
    assert tuple(t[0].shape) == (n1, n2)
    rows = fourstep.rows_f32([*t], ("leaf", 128), _ANY_TABLE)
    assert tuple(rows[0].shape) == (n1, n2)
    cols = [(a[8], a[9], a[10], a[12]) for e, a in run.seen if e == "phastft_colfft"]
    assert cols == [(1, 256, 1 << 23, n), (256, 512, 1 << 14, 1 << 23)]
    assert [e for e, _ in run.seen].count("phastft_leaf") == 1


def test_check_args_refuses_a_cut_int():
    """A value past 2^31 - 1 where the entry takes a 32-bit int raises
    rather than reaching the kernel cut to its low bits."""
    args = colmod.colfft_args((256, 1 << 31), 256, 0)
    with pytest.raises(OverflowError, match="argument 10"):
        _build.check_args("phastft_colfft", args)
    with pytest.raises(TypeError, match="takes 15 arguments"):
        _build.check_args("phastft_colfft", args[:-1])


# -- hand-over ---------------------------------------------------------------

def _watch(monkeypatch, where, col_names):
    """Record calls and returns of the kernels ``where`` names ([(object,
    names)], the drivers' ``ops/route.KERNELS``) and the death of each
    output plane of those in ``col_names``."""
    events, outs = [], []

    def wrap(name, fn):
        def wrapped(*args, **kw):
            events.append(("call", name))
            out = fn(*args, **kw)
            events.append(("return", name))
            if name in col_names:
                level = len(outs)
                outs.append([weakref.ref(t) for t in out])
                for t in out:
                    weakref.finalize(t, events.append, ("dead", f"col{level}"))
            return out
        return wrapped

    for mod, names in where:
        for name in names:
            monkeypatch.setattr(mod, name, wrap(name, getattr(mod, name)))
    return events, outs


def _deaths_between(events, level, reader, planes):
    """Each plane of column output ``level`` dies after call ``reader``
    (its inner level's first kernel) returns and before the next call."""
    calls = [i for i, e in enumerate(events) if e[0] == "call"]
    ret = events.index(("return", events[calls[reader]][1]), calls[reader])
    at = [i for i, e in enumerate(events) if e == ("dead", f"col{level}")]
    assert len(at) == planes and all(ret < i < calls[reader + 1] for i in at)


@pytest.mark.parametrize("log_n,leaf,kernels", [
    # classic 32 x 2^14 around a classic 128 x 128 over the 128-point leaf
    (19, 128, ("colfft", "colfft", "leaf", "transpose2", "transpose2")),
    # classic 32 x 2^17 around the fused 128 x 1024 (colfft_out3d + leaft)
    (22, 1024, ("colfft", "colfft_out3d", "leaft", "transpose2")),
])
def test_f32_column_output_handed_over(log_n, leaf, kernels, monkeypatch):
    """``fft_rows``: each split level's column output is freed once the inner
    level's first kernel has read it; the caller's input stays alive and
    unchanged, and the result is the transform."""
    events, outs = _watch(
        monkeypatch,
        [(KERNELS, ("colfft", "colfft_out3d", "leaft", "leaf", "transpose2"))],
        ("colfft", "colfft_out3d"))
    n = 1 << log_n
    planner = pt.PlannerDit32(n, options=pt.Options(leaf_fft_size=leaf), device="cpu")
    rng = np.random.default_rng(11)
    re, im = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)) for _ in range(2))
    keep = (re.clone(), im.clone())
    out = pt.fft_32_dit_with_planner(re, im, "f", planner)
    calls = [e[1] for e in events if e[0] == "call"]
    assert calls == list(kernels)
    assert all(ref() is None for refs in outs for ref in refs)
    for level in range(len(outs)):
        _deaths_between(events, level, level + 1, 2)
    assert torch.equal(re, keep[0]) and torch.equal(im, keep[1])
    want = np.fft.fft(keep[0].numpy().astype(np.float64) + 1j * keep[1].numpy())
    got = out[0].numpy() + 1j * out[1].numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 5e-7 * max(1.0, log_n / 18)


def test_dd_column_output_handed_over(monkeypatch):
    """``fft_rows_dd``: the outer ``ddcol``'s four planes die after the inner
    ``ddcol`` returns, the inner one's after ``ddleaf`` returns."""
    events, outs = _watch(monkeypatch, [(KERNELS, ("ddcol", "ddleaf", "transpose2"))],
                          ("ddcol",))
    n = 1 << 19
    planner = pt.PlannerDit64(n, options=pt.Options(leaf_fft_size=128, f64_engine="df64"),
                              device="cpu")
    rng = np.random.default_rng(12)
    re, im = (torch.from_numpy(rng.standard_normal(n)) for _ in range(2))
    keep = (re.clone(), im.clone())
    out = pt.fft_64_dit_with_planner(re, im, "f", planner)
    calls = [e[1] for e in events if e[0] == "call"]
    assert calls == ["ddcol", "ddcol", "ddleaf"] + ["transpose2"] * 4
    assert all(ref() is None for refs in outs for ref in refs)
    _deaths_between(events, 0, 1, 4)
    _deaths_between(events, 1, 2, 4)
    assert torch.equal(re, keep[0]) and torch.equal(im, keep[1])
    want = np.fft.fft(keep[0].numpy() + 1j * keep[1].numpy())
    got = out[0].numpy() + 1j * out[1].numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-12


def test_r2c_pairs_handed_over(monkeypatch):
    """The R2C's deinterleaved pair dies once the inner transform's first
    kernel has read it, the C2R's z likewise; the caller's signal and
    spectrum stay."""
    events, outs = _watch(
        monkeypatch, [(KERNELS, ("deinterleave", "pre_untangle", "colfft_out3d", "leaft"))],
        ("deinterleave", "pre_untangle"))
    n = 1 << 18
    planner = pt.PlannerR2c32(n, device="cpu")
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    keep = x.clone()
    spec = pt.r2c_fft_f32_with_planner(x, planner)
    back = pt.c2r_fft_f32_with_planner(*spec, planner)
    calls = [e[1] for e in events if e[0] == "call"]
    assert calls == ["deinterleave", "colfft_out3d", "leaft",
                     "pre_untangle", "colfft_out3d", "leaft"]
    assert all(ref() is None for refs in outs for ref in refs)
    _deaths_between(events, 0, 1, 2)
    _deaths_between(events, 1, 4, 2)
    assert torch.equal(x, keep)
    assert float((back - keep).abs().max()) <= 1e-5
    want = np.fft.rfft(keep.numpy().astype(np.float64))
    got = spec[0].numpy() + 1j * spec[1].numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 5e-7


# -- the untangle table ------------------------------------------------------

@pytest.mark.parametrize("tag", DTYPES)
def test_card_table_matches_host(tag):
    """``r2c_twiddles_torch`` (what a GPU planner runs) against
    ``r2c_twiddles_host`` on the CPU at n = 2^2..2^20, quarter and full
    tables: f32 bit for bit; f64 within one unit in the last place (the two
    cos / sin implementations may round the same f64 angle apart)."""
    dtype = DTYPES[tag]
    for log_n in (2, 3, 8, 12, 16, 20):
        n = 1 << log_n
        for count in (n // 4 + 1, n // 2):
            host = r2c.r2c_twiddles_host(n, count, dtype)
            card = r2c.r2c_twiddles_torch(n, count, dtype, "cpu")
            for h, c in zip(host, card):
                c = c.numpy()
                assert c.dtype == h.dtype and c.shape == (count,)
                if tag == "f32":
                    np.testing.assert_array_equal(c, h)
                else:
                    assert np.all(np.abs(c - h) <= np.spacing(np.abs(h)))
