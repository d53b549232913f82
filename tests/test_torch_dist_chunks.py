"""The chunked column stage of the port's ``fft_distributed``
(``parallel/fourstep_dist.py``): the chunk count against the JAX package's
``_chunk_count``, and, in one process with a recorder in place of
``torch.distributed`` (world size 1), the order in which the pipelines start
their collectives, wait on them and run their column passes.

The recorder copies each ``all_to_all_single``'s input to its output (what a
world of one does), returns a stand-in for the ``Work`` whose ``wait()`` it
logs, and wraps the column passes (``columns``, and ``_dd_columns`` of the
df64 pipeline) to log each chunk's first column and its planes. The
collectives and passes are linked by the planes' storage: a column pass
reads what one collective received, and a column -> row collective sends
what one column pass wrote.

The property held, for 2, 4 and 8 chunks in the natural, permuted-input and
df64 pipelines (the counterpart of tests/test_dist_overlap.py, which holds
the JAX package's compiled schedule): chunk c+1's row -> column collective
is started before chunk c's column pass, chunk c+1's column pass before the
wait on chunk c's column -> row collective, every collective is waited on
once and before its output is read, and each chunk's column pass runs on
its own columns. The results against the one-chunk run: bit for bit where
each column's arithmetic is the same (permuted input: the twiddle is exact
per element and the column pass bare; df64 blocks factored on the same
256-column tables), else within a few f32 / f64 roundings (natural order
factors each chunk's shard twiddle on its own columns, as the JAX package
does). The gloo ranks of tests/test_torch_dist.py, test_torch_dist64.py and
test_torch_real_dist.py hold the chunked pipelines at 2 and 4 ranks against
the JAX package.
"""

import types

import numpy as np
import pytest
import torch

import phastft_tpu_torch as pt
from phastft_tpu_torch.ops import dd, longcol, native, route
from phastft_tpu_torch.parallel import fourstep_dist as fd


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ENV = "PHASTFT_TPU_DIST_CHUNKS"
#: Values of the env variable: unset, counts, a count no width of 1..64
#: divides but 1, 3, and two that are not counts.
ENV_VALUES = [None, "1", "2", "3", "8", "0", "x"]
#: Block bytes around the JAX package's 8 MiB threshold.
BLOCK_BYTES = [0, 1, (8 << 20) - 1, 8 << 20, (8 << 20) + 1, 16 << 20, 1 << 31]
WIDTHS = range(1, 65)
CHUNKS = (2, 4, 8)
#: pipeline -> (log2 n, planner options, flags): n1 = 32, n2 = 256 (f32 and
#: native), n1 = 8, n2 = 1024 (df64), at world size 1.
PIPELINES = {
    "natural": (13, 32, {"leaf_fft_size": 256}, {}),
    "permuted_input": (13, 32, {"leaf_fft_size": 256}, {"permuted_input": True}),
    "df64": (13, 64, {"leaf_fft_size": 256, "f64_engine": "df64"}, {}),
}
#: A result against the one-chunk run, where the twiddle is factored anew.
ONE_CHUNK_TOL = {32: 5e-7, 64: 1e-14}


def _set_env(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, value)


@pytest.mark.parametrize("value", ENV_VALUES)
def test_chunk_count_matches_jax(monkeypatch, value):
    """A count set through the env variable is the JAX package's on the
    whole grid of block sizes and widths; unset, or not a count, the port
    takes one chunk where the JAX package takes 4 from 8 MiB (its default
    read slower on the H100, on one card and on four)."""
    from phastft_tpu.parallel.fourstep_dist import _chunk_count as jax_count

    _set_env(monkeypatch, value)
    forced = value is not None and value.isdigit() and int(value) >= 1
    for b in BLOCK_BYTES:
        for w in WIDTHS:
            want = jax_count(b, w) if forced else 1
            assert fd._chunk_count(w) == want, (value, b, w)


#: (kind, log2 n, d, permuted) of ``column_chunks``: f32 and native f64
#: (natural and permuted; the permuted JAX pipeline counts its (n1/d, n2)
#: rows, natural order its (n1, n2/d) columns) and df64 natural, blocks below,
#: at and above 8 MiB.
LAYOUTS = [(kind, log_n, d, permuted)
           for kind in ("f32", "native", "df64")
           for log_n in (18, 20, 21, 22, 24)
           for d in (1, 2, 4)
           for permuted in ((False,) if kind == "df64" else (False, True))]


def _jax_block(kind, n, d, planner, permuted):
    """(block bytes, width) of the JAX package's pipeline for the layout, by
    its own formulas (``fourstep_dist.py:247-248``, ``:177-178``,
    ``:444-445``) on its own factorizations."""
    from phastft_tpu.parallel.fourstep_dist import _factor, _factor_dd

    if kind == "df64":
        n1, n2 = _factor_dd(n, d)
        return 4 * n1 * (n2 // d) * 4, n2 // d
    n1, n2 = _factor(n, d, planner.options.leaf_fft_size)
    itemsize = 4 if kind == "f32" else 8
    if permuted:
        return 2 * (n1 // d) * n2 * itemsize, n2 // d
    return 2 * n1 * (n2 // d) * itemsize, n2 // d


def _layout_planner(kind, n):
    opts = {"f64_engine": "df64"} if kind == "df64" else {}
    cls = pt.PlannerDit32 if kind == "f32" else pt.PlannerDit64
    return cls(n, options=pt.Options(**opts), device="cpu")


@pytest.mark.parametrize("value", ["1", "2", "3", "8"])
def test_column_chunks_counts_the_jax_blocks(monkeypatch, value):
    """``column_chunks``' width (n2/d columns) gives the JAX package's count
    for each of its three pipelines' blocks, under every forced count."""
    from phastft_tpu.parallel.fourstep_dist import _chunk_count as jax_count

    _set_env(monkeypatch, value)
    for kind, log_n, d, permuted in LAYOUTS:
        n = 1 << log_n
        planner = _layout_planner(kind, n)
        want = jax_count(*_jax_block(kind, n, d, planner, permuted))
        assert fd.column_chunks(n, d, planner, permuted) == want, (kind, log_n, d, permuted)


@pytest.mark.parametrize("d", (1, 2, 4, 8))
@pytest.mark.parametrize("value", [None, "0", "x"])
def test_default_is_one_chunk_at_every_world_size(monkeypatch, value, d):
    """With no count set, every layout runs one chunk over d ranks, also
    where the JAX package's block of 8 MiB or more takes 4."""
    from phastft_tpu.parallel.fourstep_dist import _chunk_count as jax_count

    _set_env(monkeypatch, value)
    jax_four = 0
    for kind, log_n, _, permuted in LAYOUTS:
        n = 1 << log_n
        planner = _layout_planner(kind, n)
        assert fd.column_chunks(n, d, planner, permuted) == 1, (kind, log_n, permuted)
        jax_four += jax_count(*_jax_block(kind, n, d, planner, permuted)) == 4
    assert jax_four > 0


# -- the recorder --------------------------------------------------------------

class _Recorder:
    """A world of one in place of ``torch.distributed`` in ``fourstep_dist``,
    and the log of what the pipelines did."""

    def __init__(self):
        self.log = []
        self.starts = []

    def namespace(self):
        def all_to_all_single(out, inp, group=None, async_op=False):
            assert inp.is_contiguous() and out.is_contiguous()
            out.copy_(inp)
            i = len(self.starts)
            self.starts.append((inp.data_ptr(), out.data_ptr()))
            self.log.append(("start", i, async_op))
            if async_op:
                return types.SimpleNamespace(wait=lambda: self.log.append(("wait", i)))
            return None

        return types.SimpleNamespace(all_to_all_single=all_to_all_single,
                                     get_world_size=lambda group=None: 1,
                                     get_rank=lambda group=None: 0)

    def wrap(self, fn, planes_arg):
        def wrapped(*args, **kwargs):
            planes = list(args[planes_arg])
            base = args[planes_arg + 3]
            entry = {"col_base": base, "width": int(planes[0].shape[-1]),
                     "in": [x.data_ptr() for x in planes],
                     "data": [x.clone() for x in planes]}
            self.log.append(("col", entry))
            out = fn(*args, **kwargs)
            entry["out"] = [x.data_ptr() for x in out]
            return out

        return wrapped


def _run(monkeypatch, pipeline, chunks, plain=False):
    """(result, recorder) of one forward of ``pipeline`` at world size 1 with
    ``chunks`` forced."""
    log_n, bits, opts, flags = PIPELINES[pipeline]
    rec = _Recorder()
    monkeypatch.setattr(fd, "dist", rec.namespace())
    # columns(pair, n, n1, col_base, ...), _dd_columns(quad, n, n1, col_base, ...)
    monkeypatch.setattr(fd, "columns", rec.wrap(longcol.columns, 0))
    monkeypatch.setattr(fd, "_dd_columns", rec.wrap(fd._dd_columns, 0))
    monkeypatch.setenv(ENV, str(chunks))
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    dtype = np.float32 if bits == 32 else np.float64
    re, im = (rng.standard_normal(n).astype(dtype) for _ in range(2))
    cls = pt.PlannerDit32 if bits == 32 else pt.PlannerDit64
    planner = cls(n, options=pt.Options(use_pallas=False if plain else None, **opts),
                  device="cpu")
    out = fd.fft_distributed(re, im, pt.Direction.Forward, planner, **flags)
    monkeypatch.undo()
    return tuple(x.clone() for x in out), rec


def _stage(rec):
    """Per chunk of the column stage, in order: (its column pass's log index
    and entry, the indices of the collectives that fed it, of those that
    took its output)."""
    cols = [(i, e[1]) for i, e in enumerate(rec.log) if e[0] == "col"]
    started_at = {e[1]: i for i, e in enumerate(rec.log) if e[0] == "start"}
    chunks = []
    for at, entry in cols:
        feeds = [max(k for k, (_, o) in enumerate(rec.starts) if o == p and started_at[k] < at)
                 for p in entry["in"]]
        takes = [min(k for k, (s, _) in enumerate(rec.starts) if s == p and started_at[k] > at)
                 for p in entry["out"]]
        chunks.append((at, entry, feeds, takes))
    return chunks


@pytest.mark.parametrize("chunks", CHUNKS)
@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_pipeline_order(monkeypatch, pipeline, chunks):
    log_n, bits, opts, flags = PIPELINES[pipeline]
    one, rec1 = _run(monkeypatch, pipeline, 1)
    got, rec = _run(monkeypatch, pipeline, chunks)
    started_at = {e[1]: i for i, e in enumerate(rec.log) if e[0] == "start"}
    started_async = {e[1] for e in rec.log if e[0] == "start" and e[2]}
    waited_at = {}
    for i, e in enumerate(rec.log):
        if e[0] == "wait":
            assert e[1] not in waited_at, f"collective {e[1]} waited on twice"
            waited_at[e[1]] = i
    assert set(waited_at) == started_async, "a collective was never waited on"
    assert all(waited_at[k] > started_at[k] for k in started_async)
    # one chunk has nothing to overlap: every collective on the current stream
    assert not any(e[2] for e in rec1.log if e[0] == "start")
    stage = _stage(rec)
    assert len(stage) == chunks
    planes = 2 if bits == 32 else 4
    for c, (at, entry, feeds, takes) in enumerate(stage):
        assert len(set(feeds)) == len(set(takes)) == planes
        # the column stage's collectives are started async
        assert set(feeds) | set(takes) <= started_async
        # its input was waited on before the pass read it
        assert all(waited_at[k] < at for k in feeds)
        if c + 1 < chunks:
            nxt_at, _, nxt_feeds, _ = stage[c + 1]
            # chunk c+1's row -> column collectives before chunk c's pass
            assert all(started_at[k] < at for k in nxt_feeds), (c, rec.log)
            # chunk c+1's pass before the wait on chunk c's column -> row
            assert all(nxt_at < waited_at[k] for k in takes), (c, rec.log)
    # each chunk's column pass on its own columns: the chunks' inputs side by
    # side are the one-chunk pass's input, and natural order's column bases
    # step by the chunk's width
    (_, whole, _, _), = _stage(rec1)
    width = whole["width"] // chunks
    for c, (_, entry, _, _) in enumerate(stage):
        assert entry["width"] == width
        if not flags:
            assert entry["col_base"] == c * width
        for p, x in enumerate(entry["data"]):
            assert torch.equal(x, whole["data"][p][..., c * width:(c + 1) * width])
    if pipeline == "permuted_input" or (pipeline == "df64" and width >= dd.DD_COL_TILE):
        assert all(torch.equal(a, b) for a, b in zip(got, one))
    else:
        g = np.asarray(got[0], np.float64) + 1j * np.asarray(got[1], np.float64)
        w = np.asarray(one[0], np.float64) + 1j * np.asarray(one[1], np.float64)
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= ONE_CHUNK_TOL[bits]


@pytest.fixture
def no_kernels(monkeypatch):
    """Every wrapper of ops/route.KERNELS replaced by one that raises."""
    for name in vars(route.KERNELS):
        def boom(*args, _name=name, **kwargs):
            raise AssertionError(f"the plain route called the wrapper {_name}")

        monkeypatch.setattr(route.KERNELS, name, boom)


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_plain_route_chunked_calls_no_wrapper(monkeypatch, no_kernels, pipeline):
    """A ``use_pallas=False`` planner runs every chunk's passes on their
    plain versions: no wrapper is called at 4 chunks, and the chunks are
    the same pipeline as on the default route."""
    got, rec = _run(monkeypatch, pipeline, 4, plain=True)
    assert sum(e[0] == "col" for e in rec.log) == 4
    monkeypatch.undo()
    want, _ = _run(monkeypatch, pipeline, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


#: engine -> (the shard-table cache, log2 n of two sizes, planner options):
#: the column stage at 8 chunks builds one entry a chunk.
CACHES = {
    "native": (native.col64_shard_tables, (13, 14), {"leaf_fft_size": 256}),
    "df64": (dd.dd_shard_tables, (13, 14), {"leaf_fft_size": 256, "f64_engine": "df64"}),
    "long": (longcol._level_tables, (18, 19), {"leaf_fft_size": 64}),
}


@pytest.mark.parametrize("engine", sorted(CACHES))
def test_shard_tables_hold_eight_chunks_of_two_sizes(monkeypatch, engine):
    """At 8 chunks, one transform's chunks do not evict each other, nor a
    second size's entries: a transform run again after another size builds
    no table."""
    cache, logs, opts = CACHES[engine]
    rec = _Recorder()
    monkeypatch.setattr(fd, "dist", rec.namespace())
    monkeypatch.setenv(ENV, "8")
    cache.cache_clear()

    def forward(log_n):
        n = 1 << log_n
        x = torch.from_numpy(np.random.default_rng(log_n).standard_normal(n))
        planner = pt.PlannerDit64(n, options=pt.Options(**opts), device="cpu")
        fd.fft_distributed(x, x, pt.Direction.Forward, planner)

    for log_n in logs:
        forward(log_n)
    built = cache.cache_info().misses
    assert built >= 16
    for log_n in logs:
        forward(log_n)
    assert cache.cache_info().misses == built
