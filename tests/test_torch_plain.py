"""The port's plain route, ``Options(use_pallas=False)``, on the CPU, against
its default route and the JAX package's ``use_pallas=False`` (its XLA
lowering).

Every entry the JAX package honours the flag on: the C2C entries (per call
and on the planner), the real transforms (the planner's ``inner_options``),
``batch_fft_sharded`` and, on 2 gloo ranks, ``fft_distributed`` and the
distributed real transforms. On the CPU the default route runs each
kernel's plain version too, so both routes agree bit for bit; that the plain
route calls no wrapper at all is shown with every wrapper of
``ops/route.KERNELS`` replaced by one that raises. Against the JAX package:
f32 within twice the repo's f32 bound, f64 within 1e-12 (the JAX native
engine on the same plan for every f64 engine: its dd pipeline compiles for
many seconds a shape here).

The plain versions' full-f32 products restore the caller's TF32 setting
(``ops/leaf.full_f32_matmuls``).
"""

import datetime
import os
import pickle
import time

import numpy as np
import pytest
import torch

import phastft_tpu
import phastft_tpu_torch as pt
from phastft_tpu_torch.ops import route
from phastft_tpu_torch.parallel import batch_fft_sharded


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PLAIN = pt.Options(use_pallas=False)

#: case -> (log2 n, bits, planner options): one per engine and plan shape.
CASES = {
    "f32_leaf_2^12": (12, 32, {}),
    "f32_classic_2^14": (14, 32, {"leaf_fft_size": 1 << 10}),
    "f32_fused_2^17": (17, 32, {"leaf_fft_size": 1 << 10}),
    "f32_hybrid_2^12": (12, 32, {"leaf_kernel": "hybrid"}),
    "f32_long_leaf_2^19": (19, 32, {"leaf_fft_size": 1 << 19}),
    "f32_tiny_2^5": (5, 32, {}),
    "native_2^12": (12, 64, {}),
    "native_split_2^14": (14, 64, {"leaf_fft_size": 1 << 10}),
    "native_long_leaf_2^18": (18, 64, {"leaf_fft_size": 1 << 18}),
    "df64_2^12": (12, 64, {"leaf_fft_size": 1 << 10, "f64_engine": "df64"}),
    "df64_split_2^13": (13, 64, {"leaf_fft_size": 1 << 13, "f64_engine": "df64-split"}),
    "df64_oz_2^17": (17, 64, {"leaf_fft_size": 1 << 10, "f64_engine": "df64-oz"}),
}


def _bound(n):
    # the f32 bound of tests/test_torch_fft.py (tests/test_pallas_leaft.py)
    return 5e-7 * max(1.0, (n.bit_length() - 1) / 18.0)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _c(pair):
    return np.asarray(pair[0], np.float64) + 1j * np.asarray(pair[1], np.float64)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _signal(shape, bits, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32 if bits == 32 else np.float64)
                 for _ in range(2))


def _planner(case, **extra):
    log_n, bits, opts = CASES[case]
    cls = pt.PlannerDit32 if bits == 32 else pt.PlannerDit64
    return cls(1 << log_n, options=pt.Options(**opts, **extra), device="cpu")


def _entry(bits):
    return (pt.fft_32_dit_with_planner_and_opts if bits == 32
            else pt.fft_64_dit_with_planner_and_opts)


@pytest.fixture
def no_kernels(monkeypatch):
    """Every wrapper of ops/route.KERNELS replaced by one that raises: a
    route that still calls a wrapper fails."""
    for name in vars(route.KERNELS):
        def boom(*args, _name=name, **kwargs):
            raise AssertionError(f"the plain route called the {_name} wrapper")

        monkeypatch.setattr(route.KERNELS, name, boom)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("direction", ["Forward", "Reverse"])
def test_plain_route_matches_default_and_jax(case, direction):
    log_n, bits, opts = CASES[case]
    n = 1 << log_n
    re, im = _signal((2, n), bits, log_n)
    planner = _planner(case)
    d = getattr(pt.Direction, direction)
    default = _entry(bits)(re, im, d, planner, planner.options)
    plain = _entry(bits)(re, im, d, planner, PLAIN)
    assert _same(plain, default)
    # on the planner: the *_with_planner entries' per-call guess_options
    # has use_pallas None, so the planner's False holds
    with_planner = (pt.fft_32_dit_with_planner if bits == 32
                    else pt.fft_64_dit_with_planner)
    assert _same(with_planner(re, im, d, _planner(case, use_pallas=False)), default)
    jax_cls = phastft_tpu.PlannerDit32 if bits == 32 else phastft_tpu.PlannerDit64
    jax_planner = jax_cls(n, options=phastft_tpu.Options(
        leaf_fft_size=planner.options.leaf_fft_size))
    jax_entry = (phastft_tpu.fft_32_dit_with_planner_and_opts if bits == 32
                 else phastft_tpu.fft_64_dit_with_planner_and_opts)
    want = jax_entry(re, im, getattr(phastft_tpu.Direction, direction), jax_planner,
                     phastft_tpu.Options(use_pallas=False))
    oz = opts.get("f64_engine") == "df64-oz"
    tol = 2 * _bound(n) if bits == 32 else 1e-10 if oz else 1e-12
    assert _rel(_c(plain), _c(want)) <= tol


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_route_calls_no_wrapper(case, no_kernels):
    log_n, bits, _ = CASES[case]
    n = 1 << log_n
    re, im = _signal((n,), bits, 1)
    planner = _planner(case)
    out = _entry(bits)(re, im, "f", planner, PLAIN)
    want = np.fft.fft(re.astype(np.float64) + 1j * im)
    assert _rel(_c(out), want) <= (_bound(n) if bits == 32 else 1e-10)
    assert _rel(_c(_entry(bits)(out[0], out[1], "r", _planner(case, use_pallas=False),
                                pt.Options())), _c((re, im))) <= (
        _bound(n) if bits == 32 else 1e-10)
    staged = _entry(bits)(re, im, "f", planner, pt.Options(strategy="staged"))
    assert _rel(_c(staged), want) <= (_bound(n) if bits == 32 else 1e-12)
    if n > 1:
        with pytest.raises(AssertionError, match="the plain route called"):
            _entry(bits)(re, im, "f", planner, planner.options)
    # a per-call True runs the kernels on a plain planner
    with pytest.raises(AssertionError, match="the plain route called"):
        _entry(bits)(re, im, "f", _planner(case, use_pallas=False),
                     pt.Options(use_pallas=True))


R2C_CASES = {"f32_2^12": (12, 32, {}), "native_2^12": (12, 64, {}),
             "df64_2^13": (13, 64, {"leaf_fft_size": 1 << 10, "f64_engine": "df64"})}


@pytest.mark.parametrize("case", sorted(R2C_CASES))
def test_real_transforms_follow_inner_options(case, no_kernels):
    """R2C and C2R on a planner whose inner options say use_pallas=False:
    the four passes and the half-length C2C on their plain versions (no
    wrapper called), bit for bit with the default route (run with the
    wrappers back), and against the JAX package's plain R2C / C2R."""
    log_n, bits, opts = R2C_CASES[case]
    n = 1 << log_n
    x = _signal((2, n), bits, 7)[0]
    cls = pt.PlannerR2c32 if bits == 32 else pt.PlannerR2c64
    plain = cls(n, inner_options=pt.Options(**opts, use_pallas=False), device="cpu")
    r2c = pt.r2c_fft_f32_with_planner if bits == 32 else pt.r2c_fft_f64_with_planner
    c2r = pt.c2r_fft_f32_with_planner if bits == 32 else pt.c2r_fft_f64_with_planner
    spec = r2c(x, plain)
    back = c2r(spec[0], spec[1], plain)
    with pytest.raises(AssertionError, match="the plain route called"):
        r2c(x, cls(n, inner_options=pt.Options(**opts), device="cpu"))
    jax_cls = phastft_tpu.PlannerR2c32 if bits == 32 else phastft_tpu.PlannerR2c64
    jax_planner = jax_cls(n, inner_options=phastft_tpu.Options(
        leaf_fft_size=plain.inner_opts.leaf_fft_size, use_pallas=False))
    jax_r2c = (phastft_tpu.r2c_fft_f32_with_planner if bits == 32
               else phastft_tpu.r2c_fft_f64_with_planner)
    jax_c2r = (phastft_tpu.c2r_fft_f32_with_planner if bits == 32
               else phastft_tpu.c2r_fft_f64_with_planner)
    tol = 2 * _bound(n) if bits == 32 else 1e-12
    assert _rel(_c(spec), _c(jax_r2c(x, jax_planner))) <= tol
    want_back = np.asarray(jax_c2r(spec[0].numpy(), spec[1].numpy(), jax_planner))
    assert _rel(back.numpy(), want_back) <= tol
    assert _rel(back.numpy(), x) <= tol


def test_real_transforms_plain_equals_default():
    for case, (log_n, bits, opts) in R2C_CASES.items():
        n = 1 << log_n
        x = _signal((2, n), bits, 7)[0]
        cls = pt.PlannerR2c32 if bits == 32 else pt.PlannerR2c64
        plain = cls(n, inner_options=pt.Options(**opts, use_pallas=False), device="cpu")
        default = cls(n, inner_options=pt.Options(**opts), device="cpu")
        r2c = pt.r2c_fft_f32_with_planner if bits == 32 else pt.r2c_fft_f64_with_planner
        c2r = pt.c2r_fft_f32_with_planner if bits == 32 else pt.c2r_fft_f64_with_planner
        a, b = r2c(x, plain), r2c(x, default)
        assert _same(a, b), case
        assert torch.equal(c2r(a[0], a[1], plain), c2r(b[0], b[1], default)), case


def test_batch_fft_sharded_follows_the_planner(no_kernels):
    """The batch entry runs the planner's plain route (no wrapper called)
    and never its staged strategy, as the JAX package's batch path builds
    its fast path whatever the strategy."""
    n = 1 << 12
    re, im = _signal((4, n), 32, 3)
    plain = batch_fft_sharded(re, im, "f", pt.PlannerDit32(n, options=pt.Options(
        use_pallas=False), device="cpu"))
    staged = batch_fft_sharded(re, im, "f", pt.PlannerDit32(n, options=pt.Options(
        use_pallas=False, strategy="staged"), device="cpu"))
    assert _same(plain, staged)
    with pytest.raises(AssertionError, match="the plain route called"):
        batch_fft_sharded(re, im, "f", pt.PlannerDit32(n, device="cpu"))
    jax_planner = phastft_tpu.PlannerDit32(n, options=phastft_tpu.Options(use_pallas=False))
    want = phastft_tpu.fft_32_dit_with_planner(re, im, phastft_tpu.Direction.Forward,
                                               jax_planner)
    assert _rel(_c(plain), _c(want)) <= 2 * _bound(n)


def test_batch_fft_sharded_plain_equals_default():
    n = 1 << 12
    re, im = _signal((4, n), 32, 3)
    a = batch_fft_sharded(re, im, "r", pt.PlannerDit32(
        n, options=pt.Options(use_pallas=False, strategy="staged"), device="cpu"))
    b = batch_fft_sharded(re, im, "r", pt.PlannerDit32(n, device="cpu"))
    assert _same(a, b)


def test_plain_products_restore_the_tf32_setting(monkeypatch):
    """The plain versions turn TF32 off for their products and give the
    caller's setting back: a user's other matmuls are not changed."""
    seen = []
    matmul = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda *a, **k: seen.append(
        torch.backends.cuda.matmul.allow_tf32) or matmul(*a, **k))
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            seen.clear()
            for case in ("f32_leaf_2^12", "f32_fused_2^17", "f32_classic_2^14",
                         "f32_hybrid_2^12"):
                log_n, _, _ = CASES[case]
                re, im = _signal((1 << log_n,), 32, 5)
                pt.fft_32_dit_with_planner_and_opts(re, im, "f", _planner(case), PLAIN)
            assert seen and not any(seen)  # full f32 inside every product
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# -- fft_distributed and the distributed real transforms on 2 gloo ranks ------

WORLD = 2
INIT_S = 60
DEADLINE_S = 120
#: case -> (log2 n, bits, engine, flags)
DIST = {
    "f32_natural": (12, 32, None, {}),
    "f32_permuted_output": (12, 32, None, {"permuted_output": True}),
    "f32_long_columns": (14, 32, None, {}),
    "native_natural": (12, 64, None, {}),
    "native_permuted_input": (12, 64, None, {"permuted_input": True}),
    "df64_natural": (12, 64, "df64", {}),
}
LONG_LEAF = 4  # f32_long_columns: a leaf of 4 points, n1 = 4096 columns


def _dist_opts(case, plain: bool):
    """The planner options of a distributed case (None: the heuristic's)."""
    _, _, engine, _ = DIST[case]
    kw = {"f64_engine": engine} if engine else {}
    if case == "f32_long_columns":
        kw["leaf_fft_size"] = LONG_LEAF
    if plain:
        kw["use_pallas"] = False
    return pt.Options(**kw) if kw else None


def _rank_cases(rank, d):
    from phastft_tpu_torch.parallel import c2r_fft_distributed, fft_distributed
    from phastft_tpu_torch.parallel import r2c_fft_distributed

    def shard(x):
        m = x.shape[-1] // d
        return x[..., rank * m:(rank + 1) * m]

    def run(use_pallas):
        out = {}
        for case, (log_n, bits, _, flags) in DIST.items():
            re, im = _signal((1 << log_n,), bits, log_n)
            cls = pt.PlannerDit32 if bits == 32 else pt.PlannerDit64
            planner = cls(1 << log_n, options=_dist_opts(case, not use_pallas), device="cpu")
            got = fft_distributed(shard(re), shard(im), pt.Direction.Forward, planner, **flags)
            out[case] = tuple(t.numpy() for t in got)
        for bits in (32, 64):
            n = 1 << 12
            x = _signal((n,), bits, 9)[0]
            cls = pt.PlannerR2c32 if bits == 32 else pt.PlannerR2c64
            inner = None if use_pallas else pt.Options(use_pallas=False)
            planner = cls(n, inner_options=inner, device="cpu")
            spec = r2c_fft_distributed(shard(x), planner)
            out[f"r2c_{bits}"] = tuple(t.numpy() for t in spec)
            out[f"c2r_{bits}"] = c2r_fft_distributed(spec[0], spec[1], planner).numpy()
        return out

    default = run(True)
    # the plain route on the wrappers replaced: a wrapper call fails the rank
    for name in vars(route.KERNELS):
        def boom(*args, _name=name, **kwargs):
            raise AssertionError(f"the plain route called the {_name} wrapper")

        setattr(route.KERNELS, name, boom)
    return {"default": default, "plain": run(False)}


def _rank_main(rank, d, store, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=d, timeout=datetime.timedelta(seconds=INIT_S))
    try:
        out = _rank_cases(rank, d)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """{route: {case: gathered result}} from WORLD gloo ranks spawned once."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("gloo_plain")
    ctx = mp.start_processes(_rank_main, args=(WORLD, str(tmp / "store"), str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"{WORLD} gloo ranks did not finish in {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    parts = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            parts.append(pickle.load(f))
    out = {}
    for kind in ("default", "plain"):
        out[kind] = {}
        for key, val in parts[0][kind].items():
            if isinstance(val, tuple):
                out[kind][key] = tuple(np.concatenate([p[kind][key][i] for p in parts])
                                       for i in range(2))
            else:
                out[kind][key] = np.concatenate([p[kind][key] for p in parts])
    return out


@pytest.mark.parametrize("case", sorted(DIST))
def test_fft_distributed_plain_matches_default_and_jax(world, case):
    import jax
    from phastft_tpu.parallel import default_mesh, fft_distributed

    log_n, bits, engine, flags = DIST[case]
    got, default = world["plain"][case], world["default"][case]
    assert all(np.array_equal(a, b) for a, b in zip(got, default))
    re, im = _signal((1 << log_n,), bits, log_n)
    tol = 2e-6 if bits == 32 else 1e-12  # tests/test_torch_dist.py's f32 bound
    # n1 = 4096 (the long columns): the JAX package's planner lacks the
    # radix tables of its XLA column pass there (tests/test_torch_dist64.py
    # hands them in to hold the default route to it); numpy holds this one
    if case != "f32_long_columns":
        cls = phastft_tpu.PlannerDit32 if bits == 32 else phastft_tpu.PlannerDit64
        planner = cls(1 << log_n, options=phastft_tpu.Options(use_pallas=False))
        mesh = default_mesh("x", devices=jax.devices()[:WORLD])
        want = fft_distributed(re, im, phastft_tpu.Direction.Forward, planner, mesh=mesh,
                               **flags)
        assert _rel(_c(got), _c(want)) <= tol
    if not flags:
        spectrum = np.fft.fft(re.astype(np.float64) + 1j * im)
        assert _rel(_c(got), spectrum) <= (1e-5 if bits == 32 else 1e-12)


@pytest.mark.parametrize("bits", [32, 64])
def test_real_distributed_plain_matches_default_and_numpy(world, bits):
    n = 1 << 12
    x = _signal((n,), bits, 9)[0]
    for key in (f"r2c_{bits}", f"c2r_{bits}"):
        a, b = world["plain"][key], world["default"][key]
        if isinstance(a, tuple):
            assert all(np.array_equal(p, q) for p, q in zip(a, b))
        else:
            assert np.array_equal(a, b)
    tol = 1e-5 if bits == 32 else 1e-12
    assert _rel(_c(world["plain"][f"r2c_{bits}"]), np.fft.rfft(x.astype(np.float64))) <= tol
    assert _rel(world["plain"][f"c2r_{bits}"], x) <= tol
