"""The one-block column path of csrc/colfft.cu (colfft_block: n1 <= 512, and
shard blocks narrower than 32 columns), rebuilt in torch on the CPU.

A CUDA kernel cannot run here, so this file repeats what ``colfft_block``
does, trip for trip, with the kernel's own index formulas, on every block of
a call at once:

* the slab: T = min(8192 / n1, 512, n2) neighbouring columns of one entry a
  block (narrowed down to 16 for a call of fewer than two blocks an SM),
  512 threads of 16 points (fewer threads when the slab is smaller);
* the trips of F(n1) (2 | 4 | 8 | 16 | 4.8 | 8.8 | 16.8 | 16.16 | 8.8.8 |
  16.8.8 | 16.16.8), each a radix-4 DIF group in f32 (f64.cuh's butterfly
  order) and a last radix-2 for an odd stage count, the in-block twiddles
  from the wrapper's host-built W_n1 table;
* the first trip straight from the input, the last straight to the output,
  and between trips the swizzled words of shared memory (NaN until written,
  so a read of a word no trip wrote shows);
* the split twiddle as T1 of the block's first column (exact phase, once a
  block) times T2 from the wrapper's table, and the store maps of the
  classic, out3d and bare modes (every output stored once).

The model is held against ``colfft_plain``, ``colfft_out3d_plain`` and
``colfft_nocorr_plain`` (rel L2 <= 1e-6), the JAX ``colfft_pallas`` /
``colfft_pallas_nocorr`` in interpret mode (1e-6) and numpy's f64 FFT
(5e-7). One more case counts, from the same re-enactment, the
shared-memory accesses per point and the bank conflicts of every access,
and pins the numbers the kernel's header states. The kernel on the card is
checked by ``chip_smoke.py``.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from phastft_tpu.ops import pallas_col

from phastft_tpu_torch.ops import colfft as col

TOL = 1e-6
NUMPY_TOL = 5e-7
# csrc/colfft.cu's constants (test_model_constants_are_the_kernels pins them)
THREADS, PER_THREAD, LOCAL, MAX_T = 512, 16, 8192, 512
FILL, MIN_FILL_LOGT = 2, 4
#: Stages of each trip of F(n1), by log2(n1), as the kernel's f1_stages.
F1_TRIPS = {1: (1,), 2: (2,), 3: (3,), 4: (4,), 5: (2, 3), 6: (3, 3), 7: (4, 3), 8: (4, 4),
            9: (3, 3, 3), 10: (4, 3, 3), 11: (4, 4, 3)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The model's tensors are small; one intra-op thread keeps its cost to
    one core when the suite runs on several workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(index):
    return torch.as_tensor(np.asarray(index))


def _log2(n):
    return int(n).bit_length() - 1


def _bitrev(k, bits):
    k = np.asarray(k)
    out = np.zeros_like(k)
    for b in range(bits):
        out |= ((k >> b) & 1) << (bits - 1 - b)
    return out


def _twiddle(tw, k, log_n):
    """The kernel's ``twiddle``: W_N^k for 0 <= k < N from the table of
    k < N/2 (W^(k + N/2) = -W^k)."""
    h = 1 << (log_n - 1)
    k = np.asarray(k)
    w = tw[_t(k & (h - 1))]
    return torch.where(_t((k & h) != 0), -w, w)


def _dif4_group(x, s, r, log_r, log_w, log_l, tw):
    """The kernel's ``dif4_group<S>`` on a list of 2^S tensors (blocks,
    items), r per item: radix-4 layers, a last radix-2 for an odd S."""
    x = list(x)
    r = np.asarray(r)
    for t in range(0, s - 1, 2):
        h = 1 << (s - 2 - t)
        shift = log_w - log_l + t
        trivial = log_l - t == 2
        for j in range(1 << s):
            if j & (3 * h):
                continue
            k = (r + ((j & (h - 1)) << log_r)) << shift
            a, b = x[j] + x[j + 2 * h], x[j + h] + x[j + 3 * h]
            c, d = x[j] - x[j + 2 * h], -1j * (x[j + h] - x[j + 3 * h])
            x[j], x[j + h], x[j + 2 * h], x[j + 3 * h] = a + b, a - b, c + d, c - d
            if not trivial:
                x[j + h] = x[j + h] * _twiddle(tw, 2 * k, log_w)
                x[j + 2 * h] = x[j + 2 * h] * _twiddle(tw, k, log_w)
                x[j + 3 * h] = x[j + 3 * h] * _twiddle(tw, 3 * k, log_w)
    if s & 1:
        shift = log_w - log_l + s - 1
        trivial = log_l - (s - 1) == 1
        for j in range(0, 1 << s, 2):
            a, b = x[j], x[j + 1]
            x[j], x[j + 1] = a + b, a - b
            if not trivial:
                x[j + 1] = x[j + 1] * _twiddle(tw, r << shift, log_w)
    return x


def _ways(slots, valid):
    """Bank conflicts of one warp-wide access of 4-byte words (lanes in
    order, 32 a warp; invalid lanes idle): the most distinct words on one of
    the 32 banks of a warp."""
    slots = np.asarray(slots).reshape(-1, 32)
    valid = np.asarray(valid).reshape(-1, 32)
    worst = 1
    for row, ok in zip(slots, valid):
        words = np.unique(row[ok])
        if len(words):
            worst = max(worst, int(np.bincount(words & 31).max()))
    return worst


class _Shared:
    """The shared words of every block (one complex value stands for the
    word of each plane), NaN until written, with the count of data accesses
    and the worst bank conflict."""

    def __init__(self, blocks, words):
        self.mem = torch.full((blocks, words), complex(np.nan, np.nan), dtype=torch.complex64)
        self.accesses = 0
        self.ways = 1

    def _note(self, slots, valid):
        self.accesses += int(np.count_nonzero(valid)) * self.mem.shape[0]
        self.ways = max(self.ways, _ways(slots, valid))

    def read(self, slots, valid):
        self._note(slots, valid)
        vals = self.mem[:, _t(slots[valid])]
        assert torch.isfinite(vals.real).all()  # written before read
        return vals

    def write(self, slots, valid, vals):
        self._note(slots, valid)
        self.mem[:, _t(slots[valid])] = vals


def _slab_log(log_n1, log_n2, b, sms):
    """The kernel's slab_log: LOCAL points, at most MAX_T and n2 columns,
    narrowed down to 16 while the call has fewer than FILL blocks an SM of
    a card of ``sms`` SMs."""
    logt = min(_log2(LOCAL) - log_n1, _log2(MAX_T), log_n2)
    while logt > MIN_FILL_LOGT and (b << (log_n2 - logt)) < FILL * sms:
        logt -= 1
    return logt


def _colfft_block_by_kernel(re, im, mode, t2=None, n_total=None, sms=1):
    """csrc/colfft.cu's colfft_block on (b, n1, n2) f32 planes in ``mode``
    ("classic", "out3d", "nocorr") with the T2 pair ``t2``, on a card of
    ``sms`` SMs; returns the output planes, the shared accesses per point
    and the worst bank conflict."""
    b, n1, n2 = re.shape
    log_n1 = _log2(n1)
    logt = _slab_log(log_n1, _log2(n2), b, sms)
    t_ = 1 << logt
    points = n1 << logt
    threads = max(32, points // PER_THREAD)
    nblk = n2 >> logt
    blocks = b * nblk
    bid = np.arange(blocks)
    col0, entry = (bid & (nblk - 1)) << logt, bid >> _log2(nblk)
    n_total = n_total or n1 * n2
    x = torch.complex(re, im).reshape(b, n1, nblk, t_).permute(0, 2, 1, 3).reshape(
        blocks, n1, t_)
    steps = col._steps(n1, torch.device("cpu"))
    tw = torch.complex(steps[:, 0].contiguous(), steps[:, 1].contiguous())
    if mode != "nocorr":
        m = (np.arange(n1)[None, :].astype(np.int64) * col0[:, None]) & (n_total - 1)
        t1 = torch.from_numpy(np.exp(-2j * np.pi * m / n_total).astype(np.complex64))
        t2c = torch.complex(t2[0], t2[1])
    trips = F1_TRIPS[log_n1]
    sl = trips[-1]
    zmask = (32 >> logt) - 1 if logt < 5 else 0
    sh = _Shared(blocks, points)
    out = torch.full((b * n1 * n2,), complex(np.nan, np.nan), dtype=torch.complex64)

    def slot(i1, q):
        return ((i1 ^ ((i1 >> sl) & zmask)) << logt) + q

    log_l = log_n1
    tid = np.arange(threads)
    for i, s in enumerate(trips):
        first, last = i == 0, i == len(trips) - 1
        log_r = log_l - s
        items = points >> s
        for u in range(PER_THREAD >> s):
            e = tid + u * threads
            valid = e < items
            rest = e >> logt
            q = e & (t_ - 1)
            r = rest & ((1 << log_r) - 1)
            p = ((rest >> log_r) << log_l) + r
            i1 = [p + (j << log_r) for j in range(1 << s)]
            if first:
                vals = [x[:, _t(a[valid]), _t(q[valid])] for a in i1]
            else:
                vals = [sh.read(slot(a, q), valid) for a in i1]
            vals = _dif4_group(vals, s, r[valid], log_r, log_n1, log_l, tw)
            for a, v in zip(i1, vals):
                if not last:
                    sh.write(slot(a, q), valid, v)
                    continue
                k1, qv = _bitrev(a[valid], log_n1), q[valid]
                if mode != "nocorr":
                    v = v * (t1[:, _t(k1)] * t2c[_t(k1), _t(qv)])
                i2 = col0[:, None] + qv[None, :]
                if mode == "out3d":
                    o = ((i2 >> 7) * n1 + k1[None, :]) * 128 + (i2 & 127)
                else:
                    o = k1[None, :] * n2 + i2
                o = (entry[:, None] * (n1 * n2) + o).reshape(-1)
                assert len(np.unique(o)) == len(o)
                assert torch.isnan(out[_t(o)].real).all()  # stored once
                out[_t(o)] = v.reshape(-1)
        log_l -= s
    assert torch.isfinite(out.real).all()
    shape = (b, n2 // 128, n1, 128) if mode == "out3d" else (b, n1, n2)
    out = out.reshape(shape)
    return (out.real.contiguous(), out.imag.contiguous()), sh.accesses / (b * n1 * n2), sh.ways


# -- references -----------------------------------------------------------------

def _pair(rng, shape):
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel(got, want):
    g = np.asarray(got[0], np.float64) + 1j * np.asarray(got[1], np.float64)
    w = np.asarray(want[0], np.float64) + 1j * np.asarray(want[1], np.float64)
    assert g.shape == w.shape
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def _col_numpy(re, im, mode, n_total=None, col_base=0):
    b, n1, n2 = re.shape
    z = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-2)
    if mode != "nocorr":
        n_total = n_total or n1 * n2
        k1 = np.arange(n1)[:, None]
        i2 = np.arange(n2)[None, :] + col_base
        z = z * np.exp(-2j * np.pi * ((k1 * i2) % n_total) / n_total)
    if mode == "out3d":
        z = np.transpose(z.reshape(b, n1, n2 // 128, 128), (0, 2, 1, 3))
    return z.real, z.imag


def _tables(n1, n2, mode):
    t = col.col_tile3d(n1, n2) if mode == "out3d" else col.col_tile(n1, n2)
    return col.col_split_tables_host(n1, n2, "float32", t=t)


def _plain(x, n1, mode, host):
    if mode == "nocorr":
        return col.colfft_nocorr_plain(*x, n1)
    tabs = tuple(torch.from_numpy(a) for a in host)
    return (col.colfft_out3d_plain if mode == "out3d" else col.colfft_plain)(*x, tabs, n1)


def _slab_n2(n1):
    """Two slabs of the kernel at n1, and at least 128 columns (out3d)."""
    return max(128, 2 * min(LOCAL // n1, MAX_T))


# -- cases ----------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("mode", ["classic", "out3d", "nocorr"])
@pytest.mark.parametrize("n1", [2, 4, 8, 16, 32, 64, 128, 256, 512])
def test_one_block_schedule_matches_plain_and_numpy(n1, mode, b):
    """Every trip shape of F(n1) for n1 = 2..512 in each mode, on two slabs
    an entry and batches of 1 and 3: the model against the mode's plain
    version (1e-6) and numpy (5e-7)."""
    n2 = _slab_n2(n1)
    rng = np.random.default_rng((n1, len(mode), b))
    re_, im_ = _pair(rng, (b, n1, n2))
    x = (torch.from_numpy(re_), torch.from_numpy(im_))
    host = None if mode == "nocorr" else _tables(n1, n2, mode)
    t2 = None if host is None else tuple(torch.from_numpy(a) for a in host)
    got, _, ways = _colfft_block_by_kernel(*x, mode, t2)
    assert ways == 1
    assert _rel(got, _plain(x, n1, mode, host)) <= TOL
    assert _rel(got, _col_numpy(re_, im_, mode)) <= NUMPY_TOL


@pytest.mark.parametrize("n1,n2,mode", [
    (8, 1024, "classic"), (128, 256, "classic"), (512, 128, "classic"),
    (128, 256, "out3d"), (512, 128, "out3d"), (64, 256, "nocorr"),
])
def test_one_block_schedule_matches_pallas(n1, n2, mode):
    """The model against the Pallas kernel it stands for, in interpret
    mode (1e-6): colfft_pallas (out3d=False / True) and
    colfft_pallas_nocorr."""
    rng = np.random.default_rng((n1, n2, 7))
    re_, im_ = _pair(rng, (2, n1, n2))
    x = (torch.from_numpy(re_), torch.from_numpy(im_))
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        if mode == "nocorr":
            host, t2 = None, None
            want = pallas_col.colfft_pallas_nocorr(jnp.asarray(re_), jnp.asarray(im_), n1)
        else:
            host = _tables(n1, n2, mode)
            t2 = tuple(torch.from_numpy(a) for a in host)
            want = pallas_col.colfft_pallas(jnp.asarray(re_), jnp.asarray(im_),
                                            tuple(jnp.asarray(a) for a in host), n1,
                                            out3d=mode == "out3d")
    got, _, _ = _colfft_block_by_kernel(*x, mode, t2)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("n1,n2,n_total,col_base", [
    (32, 64, 1 << 16, 512), (512, 16, 1 << 20, 2032), (128, 4, 1 << 12, 28),
    (1024, 16, 1 << 20, 208), (2048, 8, 1 << 22, 1000),
])
def test_one_block_shard_block_matches_plain_and_numpy(n1, n2, n_total, col_base):
    """A distributed shard's column block (n_total, col_base; the T2 table
    the wrapper builds, as colfft_plain does), also narrower than 32 columns
    (the swizzled words) and at n1 = 1024 / 2048 below a cluster's slab:
    colfft_plain (1e-6), numpy (5e-7); the bare mode on the same block
    against colfft_nocorr_plain."""
    rng = np.random.default_rng((n1, n2, col_base))
    re_, im_ = _pair(rng, (2, n1, n2))
    x = (torch.from_numpy(re_), torch.from_numpy(im_))
    t2 = col._shard_t2(n1, col.col_tile(n1, n2), n_total, col_base, torch.device("cpu"))
    got, _, ways = _colfft_block_by_kernel(*x, "classic", t2, n_total)
    assert ways == 1
    plain = col.colfft_plain(*x, None, n1, n_total=n_total, col_base=col_base)
    assert _rel(got, plain) <= TOL
    assert _rel(got, _col_numpy(re_, im_, "classic", n_total, col_base)) <= NUMPY_TOL
    bare, _, _ = _colfft_block_by_kernel(*x, "nocorr")
    assert _rel(bare, col.colfft_nocorr_plain(*x, n1)) <= TOL


@pytest.mark.parametrize("b,n1,n2,mode,logt", [
    (1, 128, 1024, "out3d", 4), (2, 64, 2048, "classic", 4), (3, 16, 4096, "classic", 5),
    (1, 256, 2048, "out3d", 4), (1, 32, 4096, "nocorr", 4),
])
def test_small_calls_narrow_the_slab(b, n1, n2, mode, logt):
    """A call with fewer slabs than two blocks an SM of an H100 (132 SMs)
    takes narrower slabs, down to 16 columns: the model on those slabs
    against the plain version (1e-6) and numpy (5e-7)."""
    assert _slab_log(_log2(n1), _log2(n2), b, 132) == logt
    rng = np.random.default_rng((b, n1, n2))
    re_, im_ = _pair(rng, (b, n1, n2))
    x = (torch.from_numpy(re_), torch.from_numpy(im_))
    host = None if mode == "nocorr" else _tables(n1, n2, mode)
    t2 = None if host is None else tuple(torch.from_numpy(a) for a in host)
    got, _, ways = _colfft_block_by_kernel(*x, mode, t2, sms=132)
    assert ways == 1
    assert _rel(got, _plain(x, n1, mode, host)) <= TOL
    assert _rel(got, _col_numpy(re_, im_, mode)) <= NUMPY_TOL


def test_shared_accesses_and_conflicts():
    """The kernel header's numbers, from the re-enactment: shared-memory
    accesses per point 0 at n1 <= 16, 2 at 32..256, 4 at 512..2048 (one-block
    slabs, and slabs narrower than 32 columns), and no bank conflict on any
    data access."""
    want = {2: 0, 16: 0, 32: 2, 64: 2, 128: 2, 256: 2, 512: 4, 1024: 4, 2048: 4}
    for n1, acc in want.items():
        for n2 in (_slab_n2(n1), 8, 4):
            rng = np.random.default_rng((n1, n2))
            x = tuple(torch.from_numpy(a) for a in _pair(rng, (1, n1, n2)))
            _, per_point, ways = _colfft_block_by_kernel(*x, "nocorr")
            assert per_point == acc, (n1, n2, per_point)
            assert ways == 1, (n1, n2, ways)


def test_model_constants_are_the_kernels():
    """The model's block, thread and trip constants are csrc/colfft.cu's,
    and its header states the trip shapes and accesses the model counts."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "phastft_tpu_torch",
                        "csrc", "colfft.cu")
    with open(path) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert const("THREADS") == THREADS and const("PER_THREAD") == PER_THREAD
    assert const("LOCAL") == LOCAL and const("MAX_T") == MAX_T
    assert const("FILL") == FILL and const("MIN_FILL_LOGT") == MIN_FILL_LOGT
    assert "__launch_bounds__(THREADS, 2)" in src
    trips = " | ".join(".".join(str(1 << s) for s in F1_TRIPS[k]) for k in range(1, 12))
    assert trips in re.sub(r"\s*//\s*", " ", src)
    assert "0 at n1 <= 16, 2 at n1 = 32..256, 4 at 512..2048" in re.sub(r"\s*//\s*", " ", src)
    code = re.sub(r"//[^\n]*", "", src)
    # the only trigonometry: T1, once a block (block_t1)
    assert code.count("sincospi(") == 1 and code.count("block_t1(") == 3
