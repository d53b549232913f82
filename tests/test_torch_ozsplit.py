"""The tilings of the Ozaki kernels csrc/ozcol.cu and csrc/ozleaft.cu, rebuilt
in torch on the CPU.

A CUDA kernel cannot run here, so each test repeats what its kernel does,
for every block at once (a leading block axis): each block's shared memory
is a flat array of bf16 half-words or f32 words addressed with the kernel's
own index formulas, every read checks that its word was written since the
buffer was last refilled, and every output element must be written exactly
once. The steps are the kernels': the column scales, the cp.async copies of
the DFT matrices' slice tiles (one bulk copy of a tile of the card table,
ops/ozdd.py), the copies of the data and their slicing (FMA rounding
against 1.5 * 2^23), the wgmma operands (the data
tile through ldmatrix's lane addresses, the constant tile through the
descriptor's LBO 128 / SBO 256 bytes), the tier sums of each depth chunk
(integers, exact), the fold, the dd phase, correction and radix-4, and the
stores:

* ``ozcol`` at n1 = 128 and 512: 32 (k_m) x 64 (column) tiles a block, the
  four digits' 16-deep chunks through a ring of four stages, u_p parked in
  the output rows p*m + k_m and combined by the radix-4 pass.
* ``ozleaft`` at A = 8 (one 8-row block) and 64 (8-block clusters of one
  row): stage 1 in column groups and k_A halves, stage 2 in four passes of
  32 k_M, each pass folded into the (k_M, k_A, row) buffer and gathered
  from the cluster's blocks into 8-row runs.

Each rebuilt kernel is held bit for bit to its plain version, to numpy's
f64 FFT at the f64 contract's 1e-10, and (at the shape the JAX package's
interpret-mode run takes in seconds) to the Pallas kernels, at 1e-6: the
Pallas interpreter breaks TwoSum (tests/test_ozaki.py), so its runs differ
from the compiled arithmetic near 1e-7.
"""

import numpy as np
import pytest
import torch

from phastft_tpu_torch.ops import ozdd
from phastft_tpu_torch.ops.df64 import _dft_regs_dd, dd_cmul, split_hi_lo
from phastft_tpu_torch.ops.ozaki import MAXTIER, NSLICES, oz_sigma


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread: the suite runs on several workers at once,
    and each worker's own thread pool would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


OZ_TOL = 1e-10        # the f64 contract
INTERPRET_TOL = 1e-6  # tests/test_ozaki.py's gate for interpret-mode runs
NSETS = 3 * NSLICES
THREADS = 256
MAGIC = 12582912.0    # 1.5 * 2^23: rounds an f32 |x| < 2^22 to an integer


class Smem:
    """A block axis of flat shared-memory buffers with a written mask."""

    def __init__(self, blocks, size):
        self.val = torch.zeros(blocks, size, dtype=torch.float64)
        self.ok = torch.zeros(blocks, size, dtype=torch.bool)

    def clear(self):
        self.ok.zero_()

    def write(self, idx, val):
        """idx: (size,) shared by every block, or (blocks, size)."""
        idx = idx.expand(self.val.shape[0], -1) if idx.dim() == 1 else idx
        val = val.expand(idx.shape)
        self.val.scatter_(1, idx, val.to(torch.float64))
        self.ok.scatter_(1, idx, torch.ones_like(idx, dtype=torch.bool))

    def read(self, idx, src=None):
        """Each block's words idx, or (distributed shared memory) those of
        block src[i] for block i."""
        idx = idx.expand(self.val.shape[0], -1) if idx.dim() == 1 else idx
        val, ok = (self.val, self.ok) if src is None else (self.val[src], self.ok[src])
        assert bool(ok.gather(1, idx).all()), "read of an unwritten word"
        return val.gather(1, idx)


class Out:
    """Output planes with a count of writes per element."""

    def __init__(self, size):
        self.p = [torch.zeros(size, dtype=torch.float32) for _ in range(4)]
        self.count = torch.zeros(size, dtype=torch.int64)
        self.plane_count = [torch.zeros(size, dtype=torch.int64) for _ in range(4)]

    def write(self, idx, quad):
        idx = idx.reshape(-1)
        for plane, val in zip(self.p, quad):
            plane[idx] = val.reshape(-1).float()
        self.count.index_add_(0, idx, torch.ones_like(idx))

    def write_plane(self, pl, idx, val):
        """One plane's values: counts a quarter write, so that an element
        whose four planes are written once each counts one."""
        idx = idx.reshape(-1)
        self.p[pl][idx] = val.reshape(-1).float()
        self.plane_count[pl].index_add_(0, idx, torch.ones_like(idx))


def _tile_word(r, j):
    """oz.cuh tile_word: core matrices of 8 rows x 16 bytes, LBO 128, SBO 256."""
    return (r >> 3) * 64 + (j >> 2) * 32 + (r & 7) * 4 + (j & 3)


def _tile_half(r, k):
    """The bf16 half-word of depth k of row r."""
    return 2 * _tile_word(r, k >> 1) + (k & 1)


def _slice_kernel(vh, vl, inv):
    """oz.cuh slice_data in f32: the five slices of (vh, vl) * inv."""
    k_ = [2.0 ** (7 + 8 * j) for j in range(NSLICES)]
    out = []
    r = vh * inv
    for j in range(NSLICES):
        s = ((r * k_[j]).float() + MAGIC) - MAGIC  # r * K exact: fma's rounding
        out.append(s)
        r = r - s * (1.0 / k_[j])                  # s * IK exact
        if j == 2:
            r = r + vl * inv
    return out


def _slice_bits(x, inv):
    """slice_bits: the 15 slice values of a dd complex (re, im, re + im)."""
    rh, rl, ih, il = x
    sr = _slice_kernel(rh, rl, inv)
    si = _slice_kernel(ih, il, inv)
    sh = rh + ih
    b = sh - rh
    sl = ((rh - (sh - b)) + (ih - b)) + (rl + il)
    ss = _slice_kernel(sh, sl, inv * 0.5)
    return sr + si + ss


def _bulk_tile(tile, card, start, size):
    """One bulk copy of a tile's ``size`` half-words from the card table at
    ``start`` (an int, or one per block) into the tile."""
    start = torch.as_tensor(start).reshape(-1, 1)
    tile.write(torch.arange(size), card.float()[start + torch.arange(size)].double())


def _a_operand(tile, rows_set, set_idx, a0):
    """A (64 rows from a0, 16 depths) of one slice array, as each warp's
    ldmatrix.x4 addresses it: lane l reads row l % 8 of core matrix l / 8,
    matrix (mi & 1) the row group, (mi >> 1) the depth half."""
    out = torch.empty(tile.val.shape[0], 64, 16, dtype=torch.float64)
    base = set_idx * rows_set * 16 + (a0 >> 3) * 128
    for w in range(4):
        for lane in range(32):
            mi = lane >> 3
            half = base + ((2 * w + (mi & 1)) * 256 + (mi >> 1) * 128 + (lane & 7) * 16) // 2
            row = 16 * w + 8 * (mi & 1) + (lane & 7)
            out[:, row, 8 * (mi >> 1):8 * (mi >> 1) + 8] = tile.read(half + torch.arange(8))
    return out


def _b_operand(tile, rows_set, set_idx, b0, n):
    """B (n rows from b0, 16 depths) of one slice array through the
    descriptor: element (row, k) at byte (row >> 3) * 256 + (k >> 3) * 128 +
    (row & 7) * 16 + (k & 7) * 2 from the tile's row b0."""
    row = torch.arange(n)[:, None]
    k = torch.arange(16)[None, :]
    byte = (row >> 3) * 256 + (k >> 3) * 128 + (row & 7) * 16 + (k & 7) * 2
    half = set_idx * rows_set * 16 + (b0 >> 3) * 128 + byte // 2
    return tile.read(half.reshape(-1)).reshape(-1, n, 16)


def _products(acc, dtile, d_rows, a0, ftile, f_rows, b0, n):
    """One depth chunk of a warpgroup's products: acc[op][s] (blocks, 64, n)
    += data slice j x constant slice i, i + j = s, each exact, summed in
    f32 (integers below 2^24)."""
    for op in range(3):
        a = [_a_operand(dtile, d_rows, op * NSLICES + j, a0) for j in range(NSLICES)]
        for i in range(NSLICES):
            bmat = _b_operand(ftile, f_rows, op * NSLICES + i, b0, n)
            for j in range(NSLICES - i):
                acc[op][i + j] += (a[j] @ bmat.transpose(1, 2)).float()


def _fold(acc, sigma):
    """oz.cuh fold (ozaki.oz_contract_sliced's fold), elementwise."""
    scale = sigma * float(2.0 ** -14)
    reh = rel = imh = iml = rrest = irest = None
    for s in range(MAXTIER + 1):
        a, b, c = acc[0][s], acc[1][s], acc[2][s]
        k = scale * float(2.0 ** (-8 * s))
        re_v = (a - b) * k
        im_v = (4.0 * c - a - b) * k
        if s == 0:
            reh, imh = re_v, im_v
        elif s == 1:
            t = reh + re_v
            bb = t - reh
            rel = (reh - (t - bb)) + (re_v - bb)
            reh = t
            t = imh + im_v
            bb = t - imh
            iml = (imh - (t - bb)) + (im_v - bb)
            imh = t
        elif s == 2:
            rrest, irest = re_v, im_v
        else:
            rrest = rrest + re_v
            irest = irest + im_v
    rel = rel + rrest
    iml = iml + irest
    h2 = reh + rel
    rel = rel - (h2 - reh)
    reh = h2
    h2 = imh + iml
    iml = iml - (h2 - imh)
    imh = h2
    return reh, rel, imh, iml


def _zero_acc(blocks, rows, n):
    return [[torch.zeros(blocks, rows, n) for _ in range(MAXTIER + 1)] for _ in range(3)]


def _f32_tables(tabs, n_slices):
    return [t.float() if i < n_slices else t for i, t in enumerate(tabs)]


# -- ozcol -------------------------------------------------------------------

def _ozcol_by_kernel(planes, tabs, n1):
    TK, TC, CH, STAGES, RS = 32, 64, 16, 4, 66
    batch, _, n2 = planes[0].shape
    m = n1 // 4
    ktiles, groups, nch = m // TK, n2 // TC, m // CH
    total = 4 * nch
    tabs = _f32_tables(tabs, ozdd.OZCOL_SLICES)
    card = ozdd.ozcol_card(tabs, n1)
    phase = tabs[NSETS:NSETS + 4]
    t1, t2 = tabs[NSETS + 4:NSETS + 8], tabs[NSETS + 8:NSETS + 12]
    blocks = batch * groups * ktiles
    bid = torch.arange(blocks)
    kt, rest = bid % ktiles, bid // ktiles
    col0, b = (rest % groups) * TC, rest // groups
    km0 = kt * TK
    flat = [p.reshape(-1) for p in planes]
    n = n1 * n2

    def gx(pl, row, col):
        """x[b, row, col0 + col] of every block: (blocks, k)."""
        o = b[:, None] * n + row[None, :] * n2 + col0[:, None] + col[None, :]
        return flat[pl][o]

    # the column scales: thread (p, c4, rg) over rows i_m = rg mod 4
    tid = torch.arange(THREADS)
    p_t, c4, rg = tid >> 6, tid & 15, (tid >> 4) & 3
    cmax = torch.zeros(blocks, 4 * TC)
    for u in range(4):
        col = 4 * c4 + u
        for i in range(m // 4):
            im = rg + 4 * i
            v = torch.maximum(gx(0, im * 4 + p_t, col).abs(), gx(2, im * 4 + p_t, col).abs())
            cmax.scatter_reduce_(1, (p_t * TC + col).expand(blocks, -1), v, "amax")
    sig, inv = oz_sigma(cmax)

    fbuf = [Smem(blocks, NSETS * TK * CH) for _ in range(STAGES)]
    rbuf = [Smem(blocks, 4 * CH * RS) for _ in range(STAGES)]
    dbuf = [Smem(blocks, NSETS * TC * CH) for _ in range(2)]
    lane, warp = tid & 31, tid >> 5
    j, cp = lane & 7, (lane >> 3) + 4 * warp

    def issue(q):
        if q >= total:
            return
        p, c, st = q // nch, q % nch, q % STAGES
        fbuf[st].clear()
        rbuf[st].clear()
        tile = NSETS * TK * CH
        _bulk_tile(fbuf[st], card, (kt * nch + c) * tile, tile)  # the block's k_m tile
        for h in range(2):  # thread (j, cp): depths 2j + h, columns 2cp, 2cp + 1
            im = c * CH + 2 * j + h
            for pl in range(4):
                for e in range(2):
                    rbuf[st].write((pl * CH + 2 * j + h) * RS + 2 * cp + e,
                                   gx(pl, im * 4 + p, 2 * cp + e))

    def slice_(q, buf):
        p, st = q // nch, q % STAGES
        for e in range(2):
            col = 2 * cp + e
            vals = [[rbuf[st].read((pl * CH + 2 * j + h) * RS + col).float() for pl in range(4)]
                    for h in range(2)]
            cinv = inv[:, p * TC + col]
            for h in range(2):
                sl = _slice_bits(vals[h], cinv)
                for s in range(NSETS):
                    dbuf[buf].write(s * TC * CH + _tile_half(col, 2 * j + h), sl[s])

    uscr = Smem(1, batch * n * 4)  # the output rows as u_p scratch: written-checks
    out = Out(batch * n)
    for q in range(STAGES - 1):
        issue(q)
    dbuf[0].clear()
    slice_(0, 0)
    acc = [_zero_acc(blocks, TC, 16) for _ in range(2)]
    for q in range(total):
        nxt = (q + 1) & 1
        for wg in range(2):
            _products(acc[wg], dbuf[q & 1], TC, 0, fbuf[q % STAGES], TK, 16 * wg, 16)
        if q + 1 < total:
            dbuf[nxt].clear()
            slice_(q + 1, nxt)
        issue(q + STAGES - 1)
        if q % nch == nch - 1:
            p = q // nch
            for wg in range(2):
                cc = torch.arange(TC)[None, :, None]
                km = km0[:, None, None] + 16 * wg + torch.arange(16)[None, None, :]
                sigma = sig[:, p * TC:(p + 1) * TC][:, :, None]
                u = dd_cmul(*_fold(acc[wg], sigma), *(ph[km, p] for ph in phase))
                i2 = col0[:, None, None] + cc
                o = (b[:, None, None] * n + (i2 // 128) * n1 * 128 + (p * m + km) * 128
                     + i2 % 128)
                for pl in range(4):
                    uscr.write(o.reshape(1, -1) * 4 + pl, u[pl].reshape(1, -1))
            acc = [_zero_acc(blocks, TC, 16) for _ in range(2)]

    e = torch.arange(TK * TC)
    km = km0[:, None] + e[None, :] // TC
    i2 = col0[:, None] + e[None, :] % TC
    base = b[:, None] * n + (i2 // 128) * n1 * 128 + i2 % 128
    us = []
    for p in range(4):
        o = base + (p * m + km) * 128
        us.append(tuple(uscr.read(o.reshape(1, -1) * 4 + pl).reshape(o.shape).float()
                        for pl in range(4)))
    ys = _dft_regs_dd(us)
    for kr in range(4):
        k1 = kr * m + km
        w1 = [t[k1, i2 // 256] for t in t1]
        w2 = [t[k1, i2 % 256] for t in t2]
        v = dd_cmul(*dd_cmul(*ys[kr], *w1), *w2)
        out.write(base + k1 * 128, v)
    assert bool((out.count == 1).all()), "an output written other than once"
    shape = (batch, n2 // 128, n1, 128)
    return tuple(p.reshape(shape) for p in out.p)


# -- ozleaft -----------------------------------------------------------------

def _ozleaft_by_kernel(planes, tabs, n1):
    LANES, POINTS, ROWS, KM_PASS = 128, 8192, 8, 32
    batch, a = planes[0].shape[0], planes[0].shape[1]
    rb, cl = POINTS // (a * LANES), ROWS * a * LANES // POINTS
    kb = min(a, 32)
    n_wg = 16 if kb == 32 else kb
    split_n = kb == 32
    cols = 64 if split_n else 128
    groups, halves, ch = POINTS // a // cols, a // kb, min(a, 16)
    w1 = ch // 2
    tabs = _f32_tables(tabs, ozdd.OZLEAFT_SLICES)
    card = ozdd.ozleaft_card(tabs, a)
    card1 = halves * (a // ch) * NSETS * kb * 16  # stage 1's tiles
    corr = tabs[2 * NSETS:2 * NSETS + 4]
    blocks = batch * n1 // rb
    bid = torch.arange(blocks)
    cid, rank = bid // cl, bid % cl
    bb = cid // (n1 // ROWS)
    k1c = (cid % (n1 // ROWS)) * ROWS
    r0 = k1c + rank * rb
    n = n1 * a * LANES
    plane = n1 * LANES
    xrow0 = bb * n + r0 * LANES
    flat = [p.reshape(-1) for p in planes]
    tid = torch.arange(THREADS)
    lane, warp = tid & 31, tid >> 5

    v = Smem(blocks, 4 * POINTS)  # the dd values of the block's rows, plane-major
    ftile = Smem(blocks, NSETS * 32 * 16)
    dtile = Smem(blocks, NSETS * cols * 16)

    # ---- stage 1
    for grp in range(groups):
        cbase = grp * cols
        per = THREADS // cols
        c = tid % cols
        cmax = torch.zeros(blocks, cols)
        for ia0 in range(0, a, per):
            ia = ia0 + tid // cols
            o = xrow0[:, None] + ia[None, :] * plane + cbase + c[None, :]
            val = torch.maximum(flat[0][o].abs(), flat[2][o].abs())
            cmax.scatter_reduce_(1, c.expand(blocks, -1), val, "amax")
        sig, inv = oz_sigma(cmax)
        for h in range(halves):
            acc = [_zero_acc(blocks, 64, n_wg) for _ in range(2)]
            for cc in range(a // ch):
                ftile.clear()
                dtile.clear()
                if ch == 8:  # the data tile's upper core matrices, zeroed at the start
                    dtile.write(torch.arange(NSETS * cols * 16), torch.zeros(1))
                tile = NSETS * kb * 16
                _bulk_tile(ftile, card, (h * (a // ch) + cc) * tile, tile)
                for it in range(cols * w1 // THREADS):
                    jj = lane % w1
                    col = lane // w1 + (32 // w1) * (warp + 8 * it)
                    o = xrow0[:, None] + (cc * ch + 2 * jj)[None, :] * plane + cbase + col[None, :]
                    x0 = [f[o] for f in flat]
                    x1 = [f[o + plane] for f in flat]
                    cinv = inv.gather(1, col.expand(blocks, -1))
                    for hh, xv in enumerate((x0, x1)):
                        sl = _slice_bits(xv, cinv)
                        for s in range(NSETS):
                            dtile.write(s * cols * 16 + _tile_half(col, 2 * jj + hh), sl[s])
                for wg in range(2):
                    a0, b0 = (0, 16 * wg) if split_n else (64 * wg, 0)
                    _products(acc[wg], dtile, cols, a0, ftile, kb, b0, n_wg)
            for wg in range(2):
                a0, b0 = (0, 16 * wg) if split_n else (64 * wg, 0)
                clc = a0 + torch.arange(64)[None, :, None]
                ccol = cbase + clc
                rr, im = ccol // LANES, ccol % LANES
                ka = h * kb + b0 + torch.arange(n_wg)[None, None, :]
                k = ka * LANES + im
                sigma = sig.gather(1, clc.reshape(1, -1).expand(blocks, -1)).reshape(blocks, 64, 1)
                w = dd_cmul(*_fold(acc[wg], sigma), *(t.reshape(-1)[k] for t in corr))
                slot = (rr * a * LANES + k).expand(blocks, -1, -1).reshape(blocks, -1)
                for pl in range(4):
                    v.write(pl * POINTS + slot, w[pl].reshape(blocks, -1))

    # ---- stage 2
    vr = torch.arange(64)
    im = torch.arange(LANES)
    at = (vr[:, None] * LANES + im[None, :]).reshape(-1)
    m2 = torch.maximum(v.read(at).abs(), v.read(2 * POINTS + at).abs()).reshape(blocks, 64, LANES)
    sig2, inv2 = oz_sigma(m2.amax(-1).float())
    out = Out(batch * n)
    wcount = 4 * KM_PASS * 64
    for pas in range(LANES // KM_PASS):
        acc = [_zero_acc(blocks, 64, 16) for _ in range(2)]
        for cc in range(LANES // 16):
            ftile.clear()
            vtile = Smem(blocks, NSETS * 64 * 16)
            tile = NSETS * KM_PASS * 16
            _bulk_tile(ftile, card, card1 + (pas * (LANES // 16) + cc) * tile, tile)
            for it in range(2):
                jj = lane & 7
                vrow = (lane >> 3) + 4 * (warp + 8 * it)
                idx = vrow * LANES + cc * 16 + 2 * jj
                cinv = inv2.gather(1, vrow.expand(blocks, -1))
                for hh in range(2):
                    xv = [v.read(pl * POINTS + idx + hh).float() for pl in range(4)]
                    sl = _slice_bits(xv, cinv)
                    for s in range(NSETS):
                        vtile.write(s * 64 * 16 + _tile_half(vrow, 2 * jj + hh), sl[s])
            for wg in range(2):
                _products(acc[wg], vtile, 64, 0, ftile, KM_PASS, 16 * wg, 16)
        wbuf = Smem(blocks, wcount)
        for wg in range(2):
            vrow = torch.arange(64)[None, :, None]
            kml = 16 * wg + torch.arange(16)[None, None, :]
            rr, ka = vrow // a, vrow % a
            sigma = sig2[:, :, None]
            w = _fold(acc[wg], sigma)
            slot = (kml * 64 + ka * rb + rr).expand(blocks, -1, -1).reshape(blocks, -1)
            for pl in range(4):
                wbuf.write(pl * (wcount // 4) + slot, w[pl].reshape(blocks, -1))
        # the cluster barrier, then each block's 256 pairs q = 256 rank + i
        # from every block: thread (plane, f) reads the RB float4s at words
        # q0 * RB of each block, q0 = 256 rank + 4f, and stores pairs q0..q0+3
        pl_t, f = tid >> 6, tid & 63
        q0 = rank[:, None] * THREADS + 4 * f[None, :]
        vals = torch.empty(blocks, THREADS, 4, ROWS, dtype=torch.float64)
        for jb in range(cl):
            src = bid - rank + jb  # block jb of the cluster
            for w in range(4 * rb):
                words = wbuf.read(pl_t[None, :] * (wcount // 4) + q0 * rb + w, src)
                vals[:, :, w // rb, jb * rb + w % rb] = words
        for pp in range(4):
            q = q0 + pp
            kml, ka = q // a, q % a
            o = (bb[:, None] * n + ((pas * KM_PASS + kml) * a + ka) * n1 + k1c[:, None])
            for pl in range(4):
                sel = pl_t == pl
                idx = o[:, sel][:, :, None] + torch.arange(ROWS)
                quad = [torch.zeros(idx.shape) for _ in range(4)]
                quad[pl] = vals[:, sel, pp, :].float()
                out.write_plane(pl, idx, quad[pl])
    assert all(bool((c == 1).all()) for c in out.plane_count), \
        "an output written other than once"
    return tuple(out.p[i].reshape(batch, n) for i in range(4))


# -- the tests ---------------------------------------------------------------

def _planes(rng, batch, n1, n2):
    x = rng.standard_normal((batch, n1 * n2)) + 1j * rng.standard_normal((batch, n1 * n2))
    quad = [torch.from_numpy(p).reshape(batch, n1, n2)
            for pair in (split_hi_lo(x.real), split_hi_lo(x.imag)) for p in pair]
    return x, quad


def _tabs(n1, n2):
    ct = tuple(torch.from_numpy(a).to(torch.bfloat16 if i < ozdd.OZCOL_SLICES else torch.float32)
               for i, a in enumerate(ozdd.ozcol_tables_host(n1, n2)))
    lt = tuple(torch.from_numpy(a).to(torch.bfloat16 if i < ozdd.OZLEAFT_SLICES else torch.float32)
               for i, a in enumerate(ozdd.ozleaft_tables_host(n2)))
    return ct, lt


def _joined(quad):
    return (quad[0].double() + quad[1].double()
            + 1j * (quad[2].double() + quad[3].double())).numpy()


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_kernel_slicing_equals_the_plain_slicing():
    """The FMA rounding against 1.5 * 2^23 gives torch.round's integers (a
    zero may differ in sign only: the same slice value)."""
    from phastft_tpu_torch.ops.ozaki import oz_slice_data

    rng = np.random.default_rng(3)
    vh = torch.from_numpy(rng.uniform(-1.0, 1.0, 4096).astype(np.float32))
    vl = vh * torch.from_numpy(rng.uniform(-2 ** -25, 2 ** -25, 4096).astype(np.float32))
    vh[:8] = torch.tensor([0.0, -0.0, 2 ** -9, -2 ** -9, 0.5, -0.5, 127.5 / 128, -1.0])
    inv = torch.full((4096,), 1.0)
    got = _slice_kernel(vh, vl, inv)
    want = oz_slice_data(vh, vl, inv)
    for g, w in zip(got, want):
        assert torch.equal(g, w.float())


@pytest.mark.parametrize("n1,n2,batch", [(128, 1024, 2), (512, 1024, 1)])
def test_ozcol_tiling_matches_plain_bit_for_bit(n1, n2, batch):
    rng = np.random.default_rng(n1)
    x, quad = _planes(rng, batch, n1, n2)
    ct, lt = _tabs(n1, n2)
    got = _ozcol_by_kernel(quad, ct, n1)
    want = ozdd.ozcol_plain(*quad, ct, n1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    out = ozdd.ozleaft_plain(*got, lt, n1)
    assert _rel(_joined(out), np.fft.fft(x, axis=-1)) <= OZ_TOL


@pytest.mark.parametrize("a,batch", [(8, 2), (64, 1)])
def test_ozleaft_tiling_matches_plain_bit_for_bit(a, batch):
    n1, n2 = 128, a * 128
    rng = np.random.default_rng(a)
    x, quad = _planes(rng, batch, n1, n2)
    ct, lt = _tabs(n1, n2)
    col = ozdd.ozcol_plain(*quad, ct, n1)
    got = _ozleaft_by_kernel(col, lt, n1)
    want = ozdd.ozleaft_plain(*col, lt, n1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _rel(_joined(got), np.fft.fft(x, axis=-1)) <= OZ_TOL


def test_rebuilt_kernels_match_pallas_in_interpret_mode():
    """ozcol -> ozleaft rebuilt, against the JAX package's Pallas kernels at
    (128, 1024) in interpret mode (A = 8, one k_m tile)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from phastft_tpu.ops.pallas_ozdd import (
        ozcol_pallas, ozcol_tables_host, ozleaft_pallas, ozleaft_tables_host,
    )

    n1, n2 = 128, 1024
    rng = np.random.default_rng(11)
    x, quad = _planes(rng, 1, n1, n2)
    ct, lt = _tabs(n1, n2)
    col = _ozcol_by_kernel(quad, ct, n1)
    got = _joined(_ozleaft_by_kernel(col, lt, n1))[0]
    arrs = [jnp.asarray(p.numpy()[0]) for p in quad]
    jct = tuple(jnp.asarray(t) for t in ozcol_tables_host(n1, n2))
    jlt = tuple(jnp.asarray(t) for t in ozleaft_tables_host(n2))
    with pltpu.force_tpu_interpret_mode():
        jc = ozcol_pallas(*arrs, jct, n1)
        jout = ozleaft_pallas(*jc, jlt, n1)
    want = (np.asarray(jout[0], np.float64) + np.asarray(jout[1])
            + 1j * (np.asarray(jout[2], np.float64) + np.asarray(jout[3])))
    assert _rel(got, want) <= INTERPRET_TOL
    assert _rel(got, np.fft.fft(x[0])) <= OZ_TOL
