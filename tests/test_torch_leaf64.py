"""The schedule of the native f64 leaf kernel csrc/leaf64.cu, rebuilt in torch
on the CPU.

A CUDA kernel cannot run here, so this file repeats what ``leaf64.cu`` does,
trip for trip and block for block, with the kernel's own index formulas:
the trip sizes (F(n1) as 2 | 4 | 8 | 16 | 8.4 | 8.8 | 16.8 | 16.16 | 8.8.8,
F(128) as 16.8, F(64) 8.8, F(32) 4.8), the twiddle indices (the planner's
``dif{m}`` step tables, the radix-16's lane table), the bit-reversed
placements, the swizzled shared slots, the cluster column split, the
exchange map and the store map. Every block's shared memory is a tensor
that starts as NaN, so a read of a slot no trip wrote shows in the output.
The result is held against ``leaf64_plain``, the JAX package's ``leaf_fft``
/ ``tiny_fft`` on the same numpy inputs and ``numpy.fft.fft`` (rel L2 <=
1e-13: the same DFT summed in another order). One more case counts, from
the same re-enactment, the shared-memory accesses per point of every path
and the bank conflicts of every access, and pins the numbers the kernel's
header states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from phastft_tpu.ops import stockham as jax_stockham

from phastft_tpu_torch import Options, PlannerDit64
from phastft_tpu_torch.ops.native import leaf64_plain


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = 1e-13
LOCAL, THREADS, M = 4096, 256, 128
TID = np.arange(THREADS)
#: Stages of each F(n1) trip, by log2(n1), as csrc/leaf64.cu's f1_stages.
F1_TRIPS = {1: (1,), 2: (2,), 3: (3,), 4: (4,), 5: (3, 2), 6: (3, 3), 7: (4, 3), 8: (4, 4),
            9: (3, 3, 3)}


def _t(index):
    return torch.as_tensor(np.asarray(index))


def _rev(k, bits):
    k = np.asarray(k)
    out = np.zeros_like(k)
    for b in range(bits):
        out |= ((k >> b) & 1) << (bits - 1 - b)
    return out


def _slot(w):
    """The kernel's shared slot of point w."""
    return w ^ (((w >> 3) ^ (w >> 6) ^ (w >> 9)) & 7)


def _ways(slots):
    """Bank conflicts of one warp-wide access of 16-byte points (256 lanes,
    32 quarter-warps of 8): the most distinct slots on one bank of 8."""
    quarters = np.sort(np.asarray(slots).reshape(-1, 8), axis=1)
    first = np.ones(quarters.shape, dtype=bool)
    first[:, 1:] = quarters[:, 1:] != quarters[:, :-1]
    banks = np.arange(quarters.shape[0])[:, None] * 8 + (quarters & 7)
    return int(np.bincount(banks[first]).max())


class _Shared:
    """The shared buffers of ``blocks`` blocks (NaN until written), with the
    count of their data accesses and the worst bank conflict of each kind."""

    def __init__(self, blocks):
        self.mem = torch.full((blocks, LOCAL), complex(np.nan, np.nan), dtype=torch.complex128)
        self.accesses = 0
        self.ways = {}

    def _note(self, kind, slots, blocks):
        self.accesses += slots.size * blocks
        self.ways[kind] = max(self.ways.get(kind, 1), _ways(slots))

    def read(self, w, kind, block=None, src=None):
        """Values of points w (one per thread) of every block (or of the
        blocks ``block``); on a cluster, the reading blocks' points of the
        buffers of the blocks ``src``."""
        slots = _slot(np.asarray(w))
        mem = self.mem[slice(None) if block is None else block] if src is None else self.mem[src]
        self._note(kind, slots, mem.shape[0])
        return mem[:, _t(slots)]

    def write(self, w, values, kind, block=None):
        slots = _slot(np.asarray(w))
        rows = slice(None) if block is None else block
        self._note(kind, slots, self.mem[rows].shape[0])
        self.mem[rows, _t(slots)] = values


def _step(tab, log_n, m):
    """W_N^m from the table of W_N^m, m < N/2: the kernel's ``step``."""
    m = np.asarray(m)
    w = tab[_t(m & ((1 << (log_n - 1)) - 1))]
    return torch.where(_t((m >> (log_n - 1)) & 1 == 1), -w, w)


def _table_tw(tab, log_n, log_l, log_r, r):
    """The kernel's ``TableTw``: W_(L >> t)^(k (r + jj R)) from W_N."""
    return lambda t, jj, k: _step(tab, log_n, (k * (r + (jj << log_r))) << (log_n - log_l + t))


def _lane_table(tab2, log_n2):
    """The kernel's ``build_lane_table``: the first F(n2) trip's twiddles,
    entry off(t) + ((k - 1) h + jj) * 8 + r."""
    s = log_n2 - 3
    size = {7: 120, 6: 56, 5: 24}[log_n2]
    first = 3 * 8 * (1 << (s - 2))
    exps = []
    for e in range(size):
        r = e & 7
        if e < first:
            t, k, jj = 0, (e >> 3) // (1 << (s - 2)) + 1, (e >> 3) % (1 << (s - 2))
        elif s >= 4:
            t, k, jj = 2, ((e - first) >> 3) + 1, 0
        else:
            t, k, jj = s - 1, 1, 0
        exps.append((k * (r + 8 * jj)) << t)
    return _step(tab2, log_n2, np.array(exps))


def _lane_tw(ta, s, r):
    """The kernel's ``LaneTw``."""
    def tw(t, jj, k):
        h = 1 << (s - 2 - t) if t + 2 <= s else 1
        off = 0 if t == 0 else 3 * 8 * (1 << (s - 2))
        return ta[_t(off + (((k - 1) * h + jj) << 3) + r)]
    return tw


def _dif_group(x, s, r1, tw):
    """The kernel's ``dif_group``: S DIF stages on the list x of 2^S
    elements (each a tensor over threads), radix-4 layers in f64.cuh's
    butterfly order, a radix-2 last for an odd S; R1: butterfly 0 of every
    layer is trivial."""
    x = list(x)
    for t in range(0, s - 1, 2):
        h = 1 << (s - 2 - t)
        for j in range(1 << s):
            if j & (3 * h):
                continue
            jj = j & (h - 1)
            a, b = x[j] + x[j + 2 * h], x[j + h] + x[j + 3 * h]
            c, d = x[j] - x[j + 2 * h], -1j * (x[j + h] - x[j + 3 * h])
            x[j] = a + b
            if r1 and jj == 0:
                x[j + h], x[j + 2 * h], x[j + 3 * h] = a - b, c + d, c - d
            else:
                x[j + h] = (a - b) * tw(t, jj, 2)
                x[j + 2 * h] = (c + d) * tw(t, jj, 1)
                x[j + 3 * h] = (c - d) * tw(t, jj, 3)
    if s & 1:
        for j in range(0, 1 << s, 2):
            a, b = x[j], x[j + 1]
            x[j] = a + b
            x[j + 1] = a - b if r1 else (a - b) * tw(s - 1, 0, 1)
    return x


def _col_fft(sh, log_n1, log_q, load, corr, tab1, block=None):
    """The kernel's ``col_fft``: the F(n1) trips over 2^log_q columns of one
    block's (i1, q) view, the first from ``load``, the correction in the
    last."""
    trips = F1_TRIPS[log_n1]
    log_l = log_n1
    for i, s in enumerate(trips):
        log_r = log_l - s
        for u in range(16 >> s):
            e = TID + THREADS * u
            rest = e >> log_q
            q = e & ((1 << log_q) - 1)
            r = rest & ((1 << log_r) - 1)
            p = ((rest >> log_r) << log_l) + r
            i1 = [p + (j << log_r) for j in range(1 << s)]
            if i == 0:
                x = [load(a, q) for a in i1]
            else:
                x = [sh.read((a << log_q) + q, "columns", block) for a in i1]
            x = _dif_group(x, s, log_r == 0, _table_tw(tab1, log_n1, log_l, log_r, r))
            for a, v in zip(i1, x):
                if i == len(trips) - 1:
                    v = v * corr(_rev(a, log_n1), q)
                sh.write((a << log_q) + q, v, "columns", block)
        log_l -= s


def _leaf64_by_kernel(z, corr, n, tab1, tab2):
    """leaf64 as csrc/leaf64.cu computes it: (output, shared accesses per
    point, {access kind: worst bank conflict}). z (rows, n) complex128."""
    rows = z.shape[0]
    log_n = n.bit_length() - 1
    if log_n >= 13:
        return _cluster_by_kernel(z, corr, n, tab1, tab2)
    log_n2 = min(log_n, 7)
    log_n1 = log_n - log_n2
    n1, n2 = 1 << log_n1, 1 << log_n2
    log_r = 12 - log_n
    blocks = -(-rows // (1 << log_r))
    x = torch.zeros(blocks << log_r, n, dtype=torch.complex128)
    x[:rows] = z  # rows past the batch load as zeros
    x = x.reshape(blocks, 1 << log_r, n)
    out = torch.full_like(x, complex(np.nan, np.nan))
    sh = _Shared(blocks)
    if log_n <= 4:  # natural order through shared memory, one trip in registers
        flat = x.reshape(blocks, LOCAL)
        for u in range(8):
            f = 2 * (TID + THREADS * u)
            for v in (0, 1):
                sh.write(f + v, flat[:, _t(f + v)], "rows")
        for u in range(16 >> log_n):
            r = TID + THREADS * u
            y = _dif_group([sh.read((r << log_n) + i, "rows") for i in range(n)], log_n, True,
                           _table_tw(tab2, log_n, log_n, 0, 0))
            for j in range(n):
                sh.write((r << log_n) + int(_rev(j, log_n)), y[j], "rows")
        out = out.reshape(blocks, LOCAL)
        for u in range(8):
            f = 2 * (TID + THREADS * u)
            for v in (0, 1):
                out[:, _t(f + v)] = sh.read(f + v, "rows")
        return out.reshape(-1, n)[:rows], sh.accesses / (blocks * LOCAL), sh.ways
    ta = _lane_table(tab2, log_n2)
    if n1 > 1:
        def load(i1, q):
            return x[:, _t(q >> 7), _t((i1 << 7) + (q & (M - 1)))]

        def mul(k1, q):
            return corr[_t(k1), _t(q & (M - 1))]

        _col_fft(sh, log_n1, log_r + 7, load, mul, tab1)
        rr, row = TID & 7, TID >> 3
        w = [(row << 7) + rr + 8 * j for j in range(16)]
        y = _dif_group([sh.read(a, "row radix-16") for a in w], 4, False, _lane_tw(ta, 4, rr))
        for a, v in zip(w, y):
            sh.write(a, v, "row radix-16")
    else:  # n = 32..128: F(n / 8) straight from the loads
        sa = log_n - 3
        for u in range(16 >> sa):
            e = TID + THREADS * u
            rr, r = e & 7, e >> 3
            y = _dif_group([x[:, _t(r), _t(rr + 8 * j)] for j in range(1 << sa)], sa, False,
                           _lane_tw(ta, sa, rr))
            for j, v in enumerate(y):
                sh.write((r << log_n) + rr + 8 * j, v, "row radix-16")
    for u in range(2):  # the radix-8 to the stores
        e = TID + THREADS * u
        k1 = e & (n1 - 1)
        m = (e >> log_n1) & (n2 // 8 - 1)
        r = e >> (log_n1 + log_n2 - 3)
        g = _rev(m, log_n2 - 3)
        row = (_rev(k1, log_n1) << log_r) + r
        w0 = (row << log_n2) + 8 * g
        y = _dif_group([sh.read(w0 + j, "last trip") for j in range(8)], 3, True,
                       _table_tw(tab2, log_n2, 3, 0, 0))
        for j, v in enumerate(y):
            out[:, _t(r), _t(k1 + n1 * (int(_rev(j, 3)) * (n2 // 8) + m))] = v
    return out.reshape(-1, n)[:rows], sh.accesses / (blocks * LOCAL), sh.ways


def _cluster_by_kernel(z, corr, n, tab1, tab2):
    """The cluster path, n = 2^13..2^16: C = n / 4096 blocks a row, block c
    on columns [W c, W c + W) for F(n1), then rows k1 in [32c, 32c + 32) of
    every block for F(128)."""
    rows = z.shape[0]
    log_c = n.bit_length() - 1 - 12
    c_n = 1 << log_c
    log_n1, log_w = 5 + log_c, 7 - log_c
    n1, w_cols = 1 << log_n1, 1 << log_w
    x = z.reshape(rows, n1, M)
    sh = _Shared(rows * c_n)  # block b * C + c
    ta = _lane_table(tab2, 7)
    for c in range(c_n):
        blocks = slice(c, None, c_n)

        def load(i1, q, c=c):
            return x[:, _t(i1), _t(w_cols * c + q)]

        def mul(k1, q, c=c):
            return corr[_t(k1), _t(w_cols * c + q)]

        _col_fft(sh, log_n1, log_w, load, mul, tab1, blocks)
    # the exchange: every block reads before any writes (the split barrier)
    rr, kl = TID & 7, TID >> 3
    held = []
    for d in range(c_n):
        row = _rev(32 * d + kl, log_n1) << log_w
        y = []
        for j in range(16):
            src = slice(j >> (log_w - 3), None, c_n)
            y.append(sh.read(row + ((rr + 8 * j) & (w_cols - 1)), "exchange", src=src))
        held.append(_dif_group(y, 4, False, _lane_tw(ta, 4, rr)))
    out = torch.full((rows, n), complex(np.nan, np.nan), dtype=torch.complex128)
    for d in range(c_n):
        blocks = slice(d, None, c_n)
        for j, v in enumerate(held[d]):
            sh.write((kl << 7) + rr + 8 * j, v, "exchange", blocks)
        for u in range(2):  # the radix-8 to the stores
            e = TID + THREADS * u
            lane, g = e & 31, e >> 5
            y = _dif_group([sh.read((lane << 7) + 8 * g + j, "last trip", blocks)
                            for j in range(8)], 3, True, _table_tw(tab2, 7, 3, 0, 0))
            for j, v in enumerate(y):
                k2 = int(_rev(j, 3)) * 16 + _rev(g, 4)
                out[:, _t(k2 * n1 + 32 * d + lane)] = v
    return out, sh.accesses / (rows * c_n * LOCAL), sh.ways


def _case(n, rows, seed):
    """(z, port tables, kernel re-enactment's tables) of one case: z from a
    seeded numpy generator; the planner's leaf{n1} and dif{m} on the CPU."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n))
    state = PlannerDit64(n, options=Options(leaf_fft_size=max(n, M)), device="cpu").native_state
    n1 = n // M
    corr = state.get(f"leaf{n1}") if n1 > 1 else None
    steps = (state[f"dif{n1}"][0] if n1 > 1 else None, state[f"dif{min(n, M)}"][0])

    def tab(pairs):
        return torch.complex(pairs[:, 0], pairs[:, 1])

    tab1 = tab(steps[0]) if n1 > 1 else None
    ccorr = torch.complex(*corr) if corr is not None else None
    return z, corr, steps, (ccorr, tab1, tab(steps[1]))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax(z, n):
    """The JAX package's leaf_fft (n >= 128) or tiny_fft on z."""
    re, im = jnp.asarray(z.real), jnp.asarray(z.imag)
    n1 = n // M
    tables = jax_stockham.radix_tables_host(max(n1, M) if n >= M else n, "float64")
    if n < M:
        out = jax_stockham.tiny_fft(re, im, tables, n)
    else:
        cr, ci = (jnp.asarray(a) for a in jax_stockham.leaf_correction_host(n1, M, "float64")) \
            if n1 > 1 else (None, None)
        out = jax_stockham.leaf_fft(re, im, tables, cr, ci, n1)
    return np.asarray(out[0]) + 1j * np.asarray(out[1])


@pytest.mark.parametrize("n,rows", [
    (2, 5), (8, 3), (64, 5),                      # one F(n) (two trips at 64)
    (1 << 8, 17), (1 << 10, 9), (1 << 12, 3),     # one block of whole rows, ragged batch
    *(((1 << k), r) for k in range(13, 17) for r in (1, 3)),  # every cluster size
])
def test_leaf64_schedule_matches_plain_jax_numpy(n, rows):
    z, corr, steps, (ccorr, tab1, tab2) = _case(n, rows, seed=n + rows)
    got, _, _ = _leaf64_by_kernel(torch.from_numpy(z), ccorr, n, tab1, tab2)
    assert bool(torch.isfinite(got).all())  # every slot read was written
    got = got.numpy()
    pr, pi = leaf64_plain(torch.from_numpy(z.real.copy()), torch.from_numpy(z.imag.copy()),
                          corr, n, steps)
    assert _rel(got, pr.numpy() + 1j * pi.numpy()) <= TOL
    assert _rel(got[:1], _jax(z[:1], n)) <= TOL  # one row: one JAX trace per n
    assert _rel(got, np.fft.fft(z, axis=-1)) <= TOL


def test_leaf64_shared_accesses_and_conflicts():
    """Shared-memory accesses per point (a 16-byte read or write) of every
    path, counted from the re-enacted schedule: the kernel header's 8 at
    2^16, 6 at 2^13..2^15 and 2^12, 4 at 2^8..2^11 and at n <= 16, 2 at
    32..128. Every access is free of bank conflicts but the last trip's at 256
    points (2-way)."""
    want = {**{n: 4 for n in (2, 4, 8, 16)}, **{n: 2 for n in (32, 64, 128)},
            **{1 << k: 4 for k in range(8, 12)}, 1 << 12: 6,
            **{1 << k: 6 for k in range(13, 16)}, 1 << 16: 8}
    for n, accesses in want.items():
        z, _, _, (ccorr, tab1, tab2) = _case(n, 1, seed=n)
        _, got, ways = _leaf64_by_kernel(torch.from_numpy(z), ccorr, n, tab1, tab2)
        assert got == accesses, n
        for kind, worst in ways.items():
            assert worst == (2 if (n, kind) == (256, "last trip") else 1), (n, kind, worst)
