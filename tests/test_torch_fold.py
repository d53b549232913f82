"""The inverse's 1/n folded into the stores of a transform's last kernel.

The seven kernels that can write a transform's output (``leaf``,
``leaf3``, ``hybrid``, ``leaft``, ``transpose2``, ``transpose2_64``,
``leaf64``) take ``out_scale`` and multiply every value by it just before
its store; their plain versions multiply their result. An inverse hands its
1/n (a power of two) to that kernel instead of multiplying its output in a
pass of its own, so its result must be the same bits as the kernel at 1
followed by an in-place multiply: the rule the inverse followed before the
fold, which the tests below hold every kernel and every plan kind to.
``tracing.scales`` says where each inverse's 1/n went.

Cases marked ``cuda`` run the kernels at the cells' kernel shapes and skip
without a card: ``python -m pytest -m cuda tests/test_torch_fold.py`` on the
card. The others run the plain versions and the plain route on the CPU.
"""

import datetime
import os
import pickle
import time

import pytest
import torch

import phastft_tpu_torch as pt
from phastft_tpu_torch import tracing
from phastft_tpu_torch.ops import leaf as leafmod
from phastft_tpu_torch.ops import leaft as leaftmod
from phastft_tpu_torch.ops import native, transpose


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def device(request):
    """The case's device; a ``cuda`` case skips where there is no card."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


ON = [pytest.param("cpu"), pytest.param("cuda", marks=pytest.mark.cuda)]


def _planes(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, dtype=dtype).to(device) for _ in range(2))


# -- each kernel: out_scale = s against the kernel at 1, then mul_(s) --------
#
# case -> maker(device, big) -> (wrapper, plain version, arguments); big
# (on the card) is the shape of a cell's plan, or one of its kernel's
# configuration at fewer rows, else a small shape of the same kernel.

def _leaf(n, rows, big_rows):
    def make(dev, big):
        p = pt.PlannerDit32(n, device=dev)
        kind, n1 = p.plan
        corrs = p.leaf_corrs
        if kind == "tiny":
            tail = ((), 1)
        elif n1 == 1:
            tail = (corrs["mxu1"], 1)
        else:
            tail = (corrs[f"mxu{n1}"][:6] + tuple(corrs[f"leaf{n1}"]), n1)
        x = _planes((big_rows if big else rows, n), torch.float32, dev, n)
        return leafmod.leaf, leafmod.leaf_plain, (*x, *tail)
    return make


def _leaf3(rows, big_rows):
    def make(dev, big):
        n = 1 << 16
        mats3 = pt.PlannerDit32(n, device=dev).leaf_corrs[f"mxu3_{n // 128}"]
        x = _planes((big_rows if big else rows, n), torch.float32, dev, n)
        return leafmod.leaf3, leafmod.leaf3_plain, (*x, mats3, 128, 128)
    return make


def _hybrid(n, rows, big_rows):
    def make(dev, big):
        p = pt.PlannerDit32(n, options=pt.Options(leaf_kernel="hybrid"), device=dev)
        n1 = p.plan[1]
        corrs = p.tables_for(p.plan, "hybrid")
        mats = corrs[f"mxu{n1}"][3:6] + tuple(corrs[f"leaf{n1}"])
        x = _planes((big_rows if big else rows, n), torch.float32, dev, n)
        return leafmod.hybrid, leafmod.hybrid_plain, (*x, mats, n1)
    return make


def _leaft(a, n1, big_n1, big_batch):
    def make(dev, big):
        mats = tuple(torch.from_numpy(t).to(dev)
                     for t in leaftmod.leaft_tables_host(a * 128))
        rows = big_n1 if big else n1
        shape = ((big_batch,) if big else ()) + (a, rows, 128)
        x = _planes(shape, torch.float32, dev, a + rows)
        return leaftmod.leaft, leaftmod.leaft_plain, (*x, mats, rows)
    return make


def _transpose(wrapper, dtype, shape, big_shape):
    def make(dev, big):
        x = _planes(big_shape if big else shape, dtype, dev, shape[-1])
        return wrapper, transpose.transpose2_plain, x
    return make


def _leaf64(n, rows, big_rows):
    def make(dev, big):
        p = pt.PlannerDit64(n, options=pt.Options(leaf_fft_size=1 << 16), device=dev)
        state = p.native_state
        n1 = max(1, n // 128)

        def steps(m):
            return state[f"dif{m}"][0] if m > 1 else None

        corr = state.get(f"leaf{n1}") if n1 > 1 else None
        x = _planes((big_rows if big else rows, n), torch.float64, dev, n)
        return native.leaf64, native.leaf64_plain, (*x, corr, n, (steps(n1), steps(min(n, 128))))
    return make


KERNEL_CASES = {
    "leaf_tiny": _leaf(16, 5, 1 << 16),
    "leaf_n1_1": _leaf(128, 3, 1 << 14),
    "leaf_n12_cell": _leaf(1 << 12, 3, 1 << 12),
    "leaf_cluster": _leaf(1 << 15, 2, 256),
    "leaf3": _leaf3(2, 128),
    "hybrid": _hybrid(1 << 12, 3, 1 << 10),
    "hybrid_cluster": _hybrid(1 << 14, 2, 128),
    "leaft": _leaft(8, 128, 128, 3),
    "leaft_n24_cell": _leaft(128, 8, 1024, 2),
    "transpose2": _transpose(transpose.transpose2, torch.float32, (3, 32, 64), (32, 1 << 21)),
    "transpose2_64_level": _transpose(transpose.transpose2_64, torch.float64, (2, 128, 256),
                                      (128, 1 << 21)),
    "transpose2_64_shard": _transpose(transpose.transpose2_64, torch.float64, (64, 32),
                                      (1 << 15, 1 << 14)),
    "leaf64_tiny": _leaf64(8, 5, 1 << 16),
    "leaf64": _leaf64(1 << 12, 3, 1 << 10),
    "leaf64_cluster": _leaf64(1 << 16, 1, 256),
}

SCALES = (1.0, 2.0 ** -12, 2.0 ** -31)


@pytest.mark.parametrize("device", ON, indirect=True)
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_out_scale_is_the_kernel_then_a_multiply(case, scale, device):
    """On the card the kernel at ``out_scale = s`` equals the same kernel at
    1 followed by ``mul_(s)``, bit for bit; on the CPU the plain version
    does: its result at s is its result at 1 times s."""
    cuda = device.type == "cuda"
    wrapper, plain, args = KERNEL_CASES[case](device, cuda)
    fn = wrapper if cuda else plain
    want = [x.clone() for x in fn(*args)]
    for x in want:
        x.mul_(scale)
    got = fn(*args, out_scale=scale)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# -- each plan kind: the inverse against forward(swap) * 1/n ------------------

F32, F64 = torch.float32, torch.float64

#: case -> (planner maker, dtype, n, rows, options of the call, where the
#: 1/n goes): the plans of every kind, each one's inverse
PLAN_CASES = {
    "leaf": (lambda d: pt.PlannerDit32(1 << 10, device=d), F32, 1 << 10, 3, None,
             {"leaf": 1}),
    "tiny": (lambda d: pt.PlannerDit32(32, device=d), F32, 32, 4, None, {"leaf": 1}),
    "leaf3": (lambda d: pt.PlannerDit32(1 << 16, device=d), F32, 1 << 16, None, None,
              {"leaf3": 1}),
    "hybrid": (lambda d: pt.PlannerDit32(1 << 12, options=pt.Options(leaf_kernel="hybrid"),
                                         device=d), F32, 1 << 12, 2, None, {"hybrid": 1}),
    "fused_split": (lambda d: pt.PlannerDit32(1 << 17, options=pt.Options(leaf_fft_size=1 << 10),
                                              device=d), F32, 1 << 17, None, None, {"leaft": 1}),
    "classic_split": (lambda d: pt.PlannerDit32(1 << 17,
                                                options=pt.Options(leaf_fft_size=1 << 9),
                                                device=d), F32, 1 << 17, None, None,
                      {"transpose2": 1}),
    "leaf_columns": (lambda d: pt.PlannerDit32(1 << 18,
                                               options=pt.Options(leaf_fft_size=1 << 18),
                                               device=d), F32, 1 << 18, None, None,
                     {"transpose2": 1}),
    "native_leaf": (lambda d: pt.PlannerDit64(1 << 12, device=d), F64, 1 << 12, 2, None,
                    {"leaf64": 1}),
    "native_tiny": (lambda d: pt.PlannerDit64(16, device=d), F64, 16, 3, None, {"leaf64": 1}),
    "native_split": (lambda d: pt.PlannerDit64(1 << 17, device=d), F64, 1 << 17, None, None,
                     {"transpose2_64": 1}),
    "native_leaf_columns": (lambda d: pt.PlannerDit64(1 << 17,
                                                      options=pt.Options(leaf_fft_size=1 << 17),
                                                      device=d), F64, 1 << 17, None, None,
                            {"transpose2_64": 1}),
    "df64": (lambda d: pt.PlannerDit64(1 << 10, options=pt.Options(f64_engine="df64"),
                                       device=d), F64, 1 << 10, None, None, {"torch": 1}),
    "staged": (lambda d: pt.PlannerDit32(1 << 8, device=d), F32, 1 << 8, None,
               pt.Options(strategy="staged"), {"torch": 1}),
}

#: the cells' plans at fewer rows, on the card: n12's leaf, n24's fused
#: split, and qsim30's two native split levels at 2^28
CELL_CASES = {
    "n12_cell": (lambda d: pt.PlannerDit32(1 << 12, device=d), F32, 1 << 12, 1 << 14, None,
                 {"leaf": 1}),
    "n24_cell": (lambda d: pt.PlannerDit32(1 << 24, device=d), F32, 1 << 24, 2, None,
                 {"leaft": 1}),
    "qsim30_levels": (lambda d: pt.PlannerDit64(1 << 28, device=d), F64, 1 << 28, None, None,
                      {"transpose2_64": 1}),
}


def _run(planner, dtype, x, direction, opts):
    if opts is not None:
        call = (pt.fft_64_dit_with_planner_and_opts if dtype == F64
                else pt.fft_32_dit_with_planner_and_opts)
        return call(*x, direction, planner, opts)
    call = pt.fft_64_dit_with_planner if dtype == F64 else pt.fft_32_dit_with_planner
    return call(*x, direction, planner)


def _inverse_against_the_rule(case, dev):
    make, dtype, n, rows, opts, where = case
    if dev.type == "cpu" and opts is None:
        opts = pt.Options(use_pallas=False)  # the plain route
    planner = make(dev)
    x = _planes((n,) if rows is None else (rows, n), dtype, dev, n)
    tracing.scales.clear()
    got_re, got_im = _run(planner, dtype, x, "r", opts)
    assert dict(tracing.scales) == where
    # the rule: swap(IDFT(z)) = (1/n) DFT(swap(z)), the scale in place after
    f_re, f_im = _run(planner, dtype, x[::-1], "f", opts)
    f_re.mul_(1.0 / n)
    f_im.mul_(1.0 / n)
    assert torch.equal(got_re, f_im) and torch.equal(got_im, f_re)


@pytest.mark.parametrize("device", ON, indirect=True)
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_inverse_is_the_forward_then_its_scale(case, device):
    """Every plan kind's inverse equals the forward of the swapped planes
    with 1/n multiplied in afterwards, bit for bit; ``tracing.scales``
    names the kernel that folded it, or "torch" where it stays a pass of
    its own (df64, the staged oracle)."""
    _inverse_against_the_rule(PLAN_CASES[case], device)


@pytest.mark.cuda
@pytest.mark.parametrize("device", ["cuda"], indirect=True)
@pytest.mark.parametrize("case", sorted(CELL_CASES))
def test_cell_plans_inverse_is_the_forward_then_its_scale(case, device):
    _inverse_against_the_rule(CELL_CASES[case], device)


def test_a_forward_counts_no_scale():
    tracing.scales.clear()
    p = pt.PlannerDit32(1 << 10, device="cpu")
    pt.fft_32_dit_with_planner(*_planes((1 << 10,), F32, "cpu", 1), "f", p)
    pt.fft_32_dit_with_planner(*_planes((1,), F32, "cpu", 1), "r",
                               pt.PlannerDit32(1, device="cpu"))
    assert not tracing.scales


def test_fold_counts_only_a_scale():
    tracing.scales.clear()
    assert tracing.fold("leaf", 1.0) == 1.0
    assert tracing.fold("leaf", 0.25) == 0.25
    assert tracing.scales == {"leaf": 1}
    tracing.scales.clear()


# -- fft_distributed on two gloo ranks ----------------------------------------

DIST_N = 1 << 12
INIT_S, DEADLINE_S = 60, 120

#: case -> (dtype, the planner's engine, flags, where a rank's 1/n goes)
DIST_CASES = {
    "f32_natural": (F32, None, {}, {"transpose2": 1}),
    "f32_permuted_output": (F32, None, {"permuted_output": True}, {"leaf": 1}),
    "f32_permuted_input": (F32, None, {"permuted_input": True}, {"torch": 1}),
    "f64_natural": (F64, None, {}, {"transpose2_64": 1}),
    "f64_permuted_output": (F64, None, {"permuted_output": True}, {"leaf64": 1}),
    "df64_natural": (F64, "df64", {}, {"torch": 1}),
}


def _rank_main(rank, d, store, out_dir):
    import torch.distributed as dist

    from phastft_tpu_torch.parallel import fft_distributed

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=d, timeout=datetime.timedelta(seconds=INIT_S))
    out = {}
    try:
        for case, (dtype, engine, flags, _) in DIST_CASES.items():
            opts = pt.Options(leaf_fft_size=1 << 8, f64_engine=engine)
            cls = pt.PlannerDit64 if dtype == F64 else pt.PlannerDit32
            p = cls(DIST_N, options=opts, device="cpu")
            m = DIST_N // d
            x = tuple(t[rank * m:(rank + 1) * m]
                      for t in _planes((DIST_N,), dtype, "cpu", DIST_N))
            tracing.scales.clear()
            got = fft_distributed(*x, "r", p, **flags)
            scales = dict(tracing.scales)
            f_re, f_im = fft_distributed(x[1], x[0], "f", p, **flags)
            f_re.mul_(1.0 / DIST_N)
            f_im.mul_(1.0 / DIST_N)
            out[case] = (torch.equal(got[0], f_im) and torch.equal(got[1], f_re), scales)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    """{case: (inverse equals the rule, tracing.scales)} of each of two
    gloo ranks."""
    import torch.multiprocessing as mp

    d = 2
    tmp = tmp_path_factory.mktemp("gloo_fold")
    ctx = mp.start_processes(_rank_main, args=(d, str(tmp / "store"), str(tmp)),
                             nprocs=d, join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                pytest.fail(f"{d} gloo ranks did not finish in {DEADLINE_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    results = []
    for r in range(d):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.mark.parametrize("rank", (0, 1))
@pytest.mark.parametrize("case", sorted(DIST_CASES))
def test_distributed_inverse_is_the_forward_then_its_scale(dist_results, case, rank):
    """``fft_distributed``'s inverse folds its 1/n into the last pass of
    natural order (the transpose) or of a permuted output (the rows' leaf)
    and stays a multiply of its own after a permuted input's land copy and
    the dd join; each is the forward of the swapped shards times 1/n."""
    equal, scales = dist_results[rank][case]
    assert equal
    assert scales == DIST_CASES[case][3]
