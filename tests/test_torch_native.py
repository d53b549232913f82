"""The port's native f64 engine on the CPU, against the JAX package's.

On the CPU the native engine runs its kernels' plain versions (the JAX
package's radix-16 Stockham arithmetic in torch, ``ops/stockham.py``), so
it is held against ``phastft_tpu``'s ``f64_engine="native"`` on the same
numpy inputs: rel L2 <= 1e-13, because the two packages sum in different
orders (XLA fuses and reorders the elementwise work). The host tables must
equal the JAX package's tables bit for bit, and a planner built from the JAX
planner's native state must give the port's own planner's output bit for
bit. The CUDA kernels themselves are checked on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import phastft_tpu
import phastft_tpu_torch as pt
from phastft_tpu_torch.ops.native import col64, col64_plain, leaf64, leaf64_plain
from phastft_tpu_torch.tracing import launch_count


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


JAX_TOL = 1e-13    # the same algorithm, summed in another order
NUMPY_TOL = 1e-12  # the f64 contract of the port's tests


def _opts(pkg, n, **kw):
    """``pkg``'s Options with the port's default leaf rule for n and the
    native engine (the JAX package's own guess picks other engines)."""
    leaf = pt.Options.guess_options(n, np.float64).leaf_fft_size
    return pkg.Options(leaf_fft_size=kw.pop("leaf", leaf), f64_engine="native", **kw)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _g(out):
    return np.asarray(out[0]) + 1j * np.asarray(out[1])


def _both(n, shape, direction, leaf=None, seed=0):
    """(port output, JAX output, input) of one transform on both packages'
    native engines, on one planner each."""
    rng = np.random.default_rng(seed + n)
    re, im = rng.standard_normal(shape), rng.standard_normal(shape)
    kw = {} if leaf is None else {"leaf": leaf}
    planner = pt.PlannerDit64(n, options=_opts(pt, n, **kw), device="cpu")
    jp = phastft_tpu.PlannerDit64(n, options=_opts(phastft_tpu, n, **kw))
    assert planner.plan == jp.plan
    got = pt.fft_64_dit_with_planner_and_opts(
        re, im, getattr(pt.Direction, direction), planner, planner.options)
    ref = phastft_tpu.fft_64_dit_with_planner_and_opts(
        re, im, getattr(phastft_tpu.Direction, direction), jp, jp.options)
    assert all(isinstance(x, torch.Tensor) and x.dtype == torch.float64
               and tuple(x.shape) == shape for x in got)
    return _g(got), _g(ref), re + 1j * im


@pytest.mark.parametrize("log_n,direction,rows", [
    *((log_n, "Forward", 1) for log_n in (*range(17), 17, 20)),
    # the inverse and a batch of 3: tiny, leaf and split plans
    (0, "Reverse", 1), (6, "Reverse", 1), (13, "Reverse", 1), (14, "Reverse", 3),
    (10, "Forward", 3), (17, "Forward", 3),
])
def test_native_matches_jax_and_numpy(log_n, direction, rows):
    """Every n = 2^0..2^16 (tiny, leaf and split plans), 2^17 and 2^20
    (split levels of n1 = 16 and 128 over 2^13 leaves)."""
    n = 1 << log_n
    shape = (rows, n) if rows > 1 else (n,)
    got, ref, x = _both(n, shape, direction)
    want = np.fft.fft(x, axis=-1) if direction == "Forward" else np.fft.ifft(x, axis=-1)
    assert _rel(got, ref) <= JAX_TOL
    assert _rel(got, want) <= NUMPY_TOL


@pytest.mark.parametrize("log_n,plan", [
    (12, ("split", 16, ("leaf", 2), 256)),
    (14, ("split", 64, ("leaf", 2), 256)),
])
def test_native_forced_plans(log_n, plan):
    """Options(leaf_fft_size=2^8): split levels over 256-point leaves."""
    n = 1 << log_n
    assert pt.PlannerDit64(n, options=_opts(pt, n, leaf=256), device="cpu").plan == plan
    got, ref, x = _both(n, (n,), "Forward", leaf=256)
    assert _rel(got, ref) <= JAX_TOL
    assert _rel(got, np.fft.fft(x)) <= NUMPY_TOL


def _jax_native_state(jp):
    """The JAX native planner's state as numpy: (fast_tables, leaf_corrs)."""
    fast = {key: tuple((np.asarray(wr), np.asarray(wi)) for wr, wi in entry)
            for key, entry in jp.fast_tables.items()}
    corrs = {key: tuple(np.asarray(a) for a in val) for key, val in jp.leaf_corrs.items()}
    return fast, corrs


@pytest.mark.parametrize("log_n", [5, 10, 16, 17])
def test_from_numpy_tables_native_bitwise(log_n):
    """A planner on the JAX native planner's state gives the port's own
    planner's output bit for bit, and holds exactly the keys the plan
    reads."""
    n = 1 << log_n
    jp = phastft_tpu.PlannerDit64(n, options=_opts(phastft_tpu, n))
    carried = pt.PlannerDit64.from_numpy_tables(
        n, device="cpu", options=_opts(pt, n), native_state=_jax_native_state(jp))
    own = pt.PlannerDit64(n, options=_opts(pt, n), device="cpu")
    assert carried.native_state.keys() == own.native_state.keys()
    rng = np.random.default_rng(log_n)
    re, im = rng.standard_normal((2, n)), rng.standard_normal((2, n))
    for direction in ("f", "r"):
        a = pt.fft_64_dit_with_planner(re, im, direction, carried)
        b = pt.fft_64_dit_with_planner(re, im, direction, own)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_from_numpy_tables_native_checks():
    n = 1 << 14
    jp = phastft_tpu.PlannerDit64(n, options=_opts(phastft_tpu, n))
    fast, corrs = _jax_native_state(jp)
    key = "split2x8192"
    for bad, err in ((dict(corrs, **{key: corrs[key][:2] + (corrs[key][2][:, :1],
                                                               corrs[key][3])}), ValueError),
                     (dict(corrs, **{key: tuple(a.astype(np.float32)
                                                for a in corrs[key])}), TypeError),
                     ({k: v for k, v in corrs.items() if k != "leaf64"}, KeyError)):
        with pytest.raises(err):
            pt.PlannerDit64.from_numpy_tables(n, device="cpu", options=_opts(pt, n),
                                              native_state=(fast, bad))


@pytest.mark.parametrize("log_n", [14, 16, 20, 22])
def test_native_tables_match_jax_planner(log_n):
    """Every table the port's native state holds (split{n1}x{n2} and
    leaf{n1}, 512 included) equals the JAX planner's bit for bit."""
    n = 1 << log_n
    leaf = 1 << 16 if log_n == 16 else None
    kw = {} if leaf is None else {"leaf": leaf}
    jp = phastft_tpu.PlannerDit64(n, options=_opts(phastft_tpu, n, **kw))
    own = pt.PlannerDit64(n, options=_opts(pt, n, **kw), device="cpu")
    shared = [key for key in own.native_state if not key.startswith("dif")]
    assert shared
    for key in shared:
        arrays, want = own.native_state[key], jp.leaf_corrs[key]
        assert len(arrays) == len(want)
        for g, w in zip(arrays, want):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype == np.float64
            assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("n1,n2", [(2, 8192), (64, 256), (512, 65536)])
def test_split_correction_bitwise(n1, n2):
    from phastft_tpu.ops.stockham import split_correction_host as jax_split

    from phastft_tpu_torch.ops.stockham import split_correction_host

    got, want = split_correction_host(n1, n2, "float64"), jax_split(n1, n2, "float64")
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype == np.float64 and np.array_equal(g, w)


def test_stockham_axis2_f64_matches_jax():
    """The f64 Stockham DFT on the JAX package's f64 step tables."""
    import jax.numpy as jnp
    from phastft_tpu.ops.stockham import radix_tables_host, stockham_axis2 as jax_st

    from phastft_tpu_torch.ops.stockham import stockham_axis2

    m, lanes = 512, 8
    rng = np.random.default_rng(5)
    re, im = rng.standard_normal((2, m, lanes)), rng.standard_normal((2, m, lanes))
    got = stockham_axis2(torch.from_numpy(re), torch.from_numpy(im), m)
    tables = {k: tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in v)
              for k, v in radix_tables_host(m, "float64").items()}
    want = jax_st(jnp.asarray(re), jnp.asarray(im), tables, m)
    assert got[0].dtype == torch.float64
    assert _rel(_g(got), _g(want)) <= JAX_TOL
    assert _rel(_g(got), np.fft.fft(re + 1j * im, axis=-2)) <= NUMPY_TOL


def _state(n, leaf):
    return pt.PlannerDit64(n, options=_opts(pt, n, leaf=leaf), device="cpu").native_state


@pytest.mark.parametrize("bad", ["dtype", "shape", "tables", "device"])
def test_native_wrappers_reject_bad_arguments(bad):
    n1, n2 = 16, 256
    x = torch.zeros(n1, n2, dtype=torch.float64)
    state = _state(n1 * n2, n2)
    tabs, w = state[f"split{n1}x{n2}"], state[f"dif{n1}"][0]
    leaf = _state(512, 512)
    corr, steps = leaf["leaf4"], (leaf["dif4"][0], leaf["dif128"][0])
    y = torch.zeros(3, 512, dtype=torch.float64)
    if bad == "dtype":
        with pytest.raises(TypeError):
            col64(x.float(), x.float(), tabs, n1, w)
        with pytest.raises(TypeError):
            leaf64(y.float(), y.float(), corr, 512, steps)
    elif bad == "shape":
        with pytest.raises(ValueError):
            col64(x, x, tabs, n1 // 2, w)
        with pytest.raises(ValueError):  # n1 past the kernel's 2048
            col64(torch.zeros(4096, 8, dtype=torch.float64),
                  torch.zeros(4096, 8, dtype=torch.float64), tabs, 4096, w)
        with pytest.raises(ValueError):
            leaf64(y, y, corr, 256, steps)
        with pytest.raises(ValueError):  # past 2^16 points
            leaf64(y, y, corr, 1 << 17, steps)
    elif bad == "tables":
        with pytest.raises(ValueError):
            col64(x, x, tabs[:2], n1, w)
        with pytest.raises(ValueError):  # the step table of another size
            col64(x, x, tabs, n1, steps[1])
        with pytest.raises(ValueError):
            leaf64(y, y, None, 512, steps)
        with pytest.raises(ValueError):
            leaf64(y, y, corr, 512, (None, steps[1]))
    else:
        with pytest.raises(ValueError, match="device"):
            col64(x.to("meta"), x.to("meta"), tuple(t.to("meta") for t in tabs), n1,
                  w.to("meta"))
        with pytest.raises(ValueError, match="device"):
            leaf64(y.to("meta"), y.to("meta"), tuple(t.to("meta") for t in corr), 512,
                   tuple(t.to("meta") for t in steps))


def test_native_wrappers_run_plain_on_cpu():
    """On CPU tensors each wrapper is its plain version, and launches
    nothing."""
    from phastft_tpu_torch.ops.transpose import transpose2_64

    kernels = ("col64", "leaf64", "transpose2_64")
    before = [launch_count(k) for k in kernels]
    rng = np.random.default_rng(1)
    x = tuple(torch.from_numpy(rng.standard_normal((3, 16, 256))) for _ in range(2))
    state = _state(4096, 256)
    tabs, w = state["split16x256"], state["dif16"][0]
    a, b = col64(*x, tabs, 16, w), col64_plain(*x, tabs, 16, w)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    y = tuple(t.reshape(-1, 64) for t in x)
    steps = (None, _state(64, 64)["dif64"][0])
    a, b = leaf64(*y, None, 64, steps), leaf64_plain(*y, None, 64, steps)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    t = transpose2_64(*x)
    assert torch.equal(t[0], x[0].transpose(-1, -2))
    assert [launch_count(k) for k in kernels] == before


#: The plan shapes of 2^26..2^30 on small leaves: one split level of
#: n1 = 1024 / 2048 (2^26 / 2^27 on 2^16-point leaves), and nested plans of
#: an outer level of 32 / 64 / 128 around a 128 x 128 inner level (2^28..2^30
#: around 128 x 2^16).
LONG_PLANS = {
    (17, 128): ("split", 1024, ("leaf", 1), 128),
    (18, 128): ("split", 2048, ("leaf", 1), 128),
    (19, 128): ("split", 32, ("split", 128, ("leaf", 1), 128), 16384),
    (20, 128): ("split", 64, ("split", 128, ("leaf", 1), 128), 16384),
    (21, 128): ("split", 128, ("split", 128, ("leaf", 1), 128), 16384),
    (18, 256): ("split", 1024, ("leaf", 2), 256),
    (19, 256): ("split", 2048, ("leaf", 2), 256),
}


@pytest.mark.parametrize("log_n,leaf,direction,rows", [
    *((log_n, leaf, "Forward", 1) for log_n, leaf in LONG_PLANS),
    (17, 128, "Reverse", 1), (19, 128, "Reverse", 1), (19, 256, "Reverse", 1),
    (18, 128, "Forward", 3), (20, 128, "Reverse", 3),
])
def test_native_long_columns_and_nested_plans(log_n, leaf, direction, rows):
    """The plans of 2^26..2^30 on small leaves: column factors of 1024 and
    2048, and nested plans (every level classic), forward, inverse and a
    batch of 3, against the JAX package's native engine and numpy."""
    n = 1 << log_n
    assert pt.PlannerDit64(n, options=_opts(pt, n, leaf=leaf), device="cpu").plan == \
        LONG_PLANS[log_n, leaf]
    shape = (rows, n) if rows > 1 else (n,)
    got, ref, x = _both(n, shape, direction, leaf=leaf)
    want = np.fft.fft(x, axis=-1) if direction == "Forward" else np.fft.ifft(x, axis=-1)
    assert _rel(got, ref) <= JAX_TOL
    assert _rel(got, want) <= NUMPY_TOL


@pytest.mark.parametrize("log_n", [17, 20])
def test_from_numpy_tables_native_bitwise_long_and_nested(log_n):
    """As test_from_numpy_tables_native_bitwise, on an n1 = 1024 plan and a
    nested one (leaf 128): every level's split{n1}x{n2} carried over."""
    n, leaf = 1 << log_n, 128
    jp = phastft_tpu.PlannerDit64(n, options=_opts(phastft_tpu, n, leaf=leaf))
    carried = pt.PlannerDit64.from_numpy_tables(
        n, device="cpu", options=_opts(pt, n, leaf=leaf), native_state=_jax_native_state(jp))
    own = pt.PlannerDit64(n, options=_opts(pt, n, leaf=leaf), device="cpu")
    assert carried.native_state.keys() == own.native_state.keys()
    assert sum(key.startswith("split") for key in own.native_state) == (
        2 if log_n == 20 else 1)
    rng = np.random.default_rng(log_n)
    re, im = rng.standard_normal(n), rng.standard_normal(n)
    for direction in ("f", "r"):
        a = pt.fft_64_dit_with_planner_and_opts(re, im, direction, carried, carried.options)
        b = pt.fft_64_dit_with_planner_and_opts(re, im, direction, own, own.options)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_column_output_is_handed_over(monkeypatch):
    """The classic branch hands each column pass's output to the inner
    plan, which drops it as soon as its own first kernel has read it: on a
    nested plan the outer col64's output dies after the inner col64 returns
    and before the leaf starts, the inner one's after the leaf returns and
    before the inner transpose starts. The caller's input stays alive and
    unchanged."""
    import weakref

    from phastft_tpu_torch.ops.route import KERNELS

    events, col_outs = [], []

    def watch(name, fn):
        def wrapped(*args, **kw):
            events.append(("call", name))
            out = fn(*args, **kw)
            events.append(("return", name))
            if name == "col64":
                level = len(col_outs)
                col_outs.append([weakref.ref(t) for t in out])
                for t in out:
                    weakref.finalize(t, events.append, ("dead", f"col{level}"))
            return out
        return wrapped

    for name in ("col64", "leaf64", "transpose2_64"):
        monkeypatch.setattr(KERNELS, name, watch(name, getattr(KERNELS, name)))
    n, leaf = 1 << 19, 128  # outer 32 x 2^14 around 128 x 128
    planner = pt.PlannerDit64(n, options=_opts(pt, n, leaf=leaf), device="cpu")
    rng = np.random.default_rng(9)
    re, im = (torch.from_numpy(rng.standard_normal(n)) for _ in range(2))
    keep = (re.clone(), im.clone())
    out = pt.fft_64_dit_with_planner_and_opts(re, im, "f", planner, planner.options)
    calls = [e for e in events if e[0] != "dead"]
    assert calls == [(k, nm) for nm in ("col64", "col64", "leaf64", "transpose2_64",
                                        "transpose2_64") for k in ("call", "return")]
    assert all(ref() is None for refs in col_outs for ref in refs)
    # each death (of both planes) falls between its reader's return and the
    # next kernel's call
    for level, reader, nxt in ((0, 1, 2), (1, 2, 3)):
        at = [i for i, e in enumerate(events) if e == ("dead", f"col{level}")]
        ret = events.index(("return", calls[2 * reader][1]), 2 * reader)
        start = [i for i, e in enumerate(events) if e[0] == "call"][nxt]
        assert len(at) == 2 and all(ret < i < start for i in at)
    assert torch.equal(re, keep[0]) and torch.equal(im, keep[1])
    want = np.fft.fft(keep[0].numpy() + 1j * keep[1].numpy())
    assert _rel(_g(out), want) <= NUMPY_TOL
