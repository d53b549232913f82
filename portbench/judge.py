"""The comparison that decides ``correct``.

Numbers compared (each a relative L2 error, sqrt(sum |got - want|^2 /
sum |want|^2)):

* ``fwd_rel_l2`` (``inv_rel_l2`` where a step starts with the inverse):
  the step's first output against the reference transform of the input,
  in float64 (``reference.DFT``), over every point of the last step of the
  window and over the fingerprint points of every step;
* ``roundtrip_rel_l2`` (round-trip steps): the inverse's output against
  the input itself, over the same points.

A real entry's forward (R2C) is compared at bins 0..n/2 of each row with
the reference DFT of (x, 0), the plain complex DFT with a zero imaginary
plane that is never made (``reference.DFT`` takes it as None); its inverse
(C2R) with x.

Each number's limit is the configuration's stated accuracy
(``limits``). A step fails where one of its numbers passes its limit.

Across ranks every rank judges its own shard; the sums add over ranks
(``combine``). The reference's blocks sum their partial products over the
ranks through ``reduce``, the harness's own collective.
"""

from __future__ import annotations

import math

import torch

from .reference import DFT, first_factor_log, log2_exact

CHUNK = 1 << 26


def names(traffic: dict) -> list:
    first = "fwd_rel_l2" if traffic["step"][0] == "forward" else "inv_rel_l2"
    return [first, "roundtrip_rel_l2"] if len(traffic["step"]) == 2 else [first]


def limits(config: dict, traffic: dict) -> dict:
    """{number: limit}: the configuration's ``limits`` entry for each
    number, ``limit * max(1, log2(n) / grows_past_log2n)`` where the entry
    gives that key."""
    out = {}
    log_n = log2_exact(traffic["n"])
    for name in names(traffic):
        entry = config["limits"][name]
        grow = entry.get("grows_past_log2n")
        out[name] = entry["limit"] * (max(1.0, log_n / grow) if grow else 1.0)
    return out


def _sq(t) -> float:
    return float(t.double().square().sum())


def _diff_sums(got, want):
    """(sum |got - want|^2, sum |want|^2) in float64, by chunks, over the
    planes of ``got`` and ``want`` (re and im, or one real plane)."""
    got = [g.reshape(-1) for g in got]
    want = [w.reshape(-1) for w in want]
    num = den = 0.0
    for s in range(0, got[0].numel(), CHUNK):
        ws = [w[s:s + CHUNK].double() for w in want]
        num += sum(_sq(g[s:s + CHUNK].double() - w) for g, w in zip(got, ws))
        den += sum(_sq(w) for w in ws)
    return num, den


def _step_sums(fps, wants, rows):
    """Per step: sum over the fingerprint of |got - want|^2 (``rows``: the
    fingerprint's planes of one output, ``wants`` theirs), and sum
    |want|^2."""
    num = sum((fps[:, r].double() - w.double()).square().sum(1) for r, w in zip(rows, wants))
    den = float(sum(w.double().square().sum() for w in wants))
    return [float(v) for v in num], den


def _real_forward(dft, x, spec, fp_idx, want_r, want_i, n: int):
    """(sum |got - want|^2, sum |want|^2) of an R2C's bins ``spec`` (re,
    im; (R, n/2 + 1)) against the reference DFT of the real rows ``x`` (R,
    n) at bins 0..n/2, filling the wants at the flat bins ``fp_idx``.
    Whole rows go CHUNK points at a time; a longer row by blocks of k1 of
    its (n1, n2) view, where bin k1 + n1 k2 is Z[k1, k2], so bins
    0..n/2 - 1 are Z[:, :n2/2] and bin n/2 is Z[0, n2/2]."""
    rows, h = x.shape[0], n // 2 + 1
    yr, yi = (p.reshape(rows, h) for p in spec)
    fp_row, fp_bin = fp_idx // h, fp_idx % h
    num = den = 0.0
    step = CHUNK // n
    if step:
        for r0 in range(0, rows, step):
            wr, wi = (w[:, :h] for w in dft.rows(x[r0:r0 + step], None))
            a, b = _diff_sums((yr[r0:r0 + step], yi[r0:r0 + step]), (wr, wi))
            num, den = num + a, den + b
            sel = (fp_row >= r0) & (fp_row < r0 + step)
            want_r[sel] = wr[fp_row[sel] - r0, fp_bin[sel]]
            want_i[sel] = wi[fp_row[sel] - r0, fp_bin[sel]]
            del wr, wi
        return num, den
    n1 = 1 << first_factor_log(log2_exact(n))
    half = n // n1 // 2
    k1, k2 = fp_bin % n1, fp_bin // n1
    for r in range(rows):
        vr, vi = yr[r, :n // 2].view(half, n1), yi[r, :n // 2].view(half, n1)
        for lo, hi, zr, zi in dft.blocks(x[r], None, n):
            a, b = _diff_sums((vr[:, lo:hi].T, vi[:, lo:hi].T), (zr[:, :half], zi[:, :half]))
            if lo == 0:
                c, d = _diff_sums((yr[r, -1:], yi[r, -1:]),
                                  (zr[0, half:half + 1], zi[0, half:half + 1]))
                a, b = a + c, b + d
            num, den = num + a, den + b
            sel = (fp_row == r) & (k1 >= lo) & (k1 < hi)
            want_r[sel] = zr[k1[sel] - lo, k2[sel]]
            want_i[sel] = zi[k1[sel] - lo, k2[sel]]
            del zr, zi
    return num, den


def judge(traffic: dict, x, outs, fps, fp_idx, rank: int = 0, reduce=None) -> dict:
    """This process's sums. ``x``: its input planes (re, im; a real entry's
    one real plane); ``outs``: the last step's output planes, a tuple a
    call; ``fps``: (steps, planes of all calls, k) fingerprints of every
    step at ``fp_idx``, a flat index tensor a call. Returns {number:
    {"full": [num, den], "steps": [[num per step], den]}}."""
    xr = x[0]
    yr, yi = outs[0]
    inverse = traffic["step"][0] == "inverse"
    device = xr.device
    dft = DFT(torch.float64, device)
    n, batch = traffic["n"], traffic["batch"]
    want_fp_r = torch.empty(fp_idx[0].numel(), dtype=torch.float64, device=device)
    want_fp_i = torch.empty_like(want_fp_r)
    first, *rest = names(traffic)
    if len(x) == 1:
        num, den = _real_forward(dft, xr.reshape(-1, n), outs[0], fp_idx[0], want_fp_r,
                                 want_fp_i, n)
        out = {first: {"full": [num, den],
                       "steps": list(_step_sums(fps, (want_fp_r, want_fp_i), (0, 1)))}}
        if rest:
            (z,) = outs[1]
            out[rest[0]] = {"full": list(_diff_sums((z,), (xr,))), "steps": list(_step_sums(
                fps, (xr.reshape(-1)[fp_idx[1]],), (2,)))}
        return out
    xi = x[1]
    fp_idx = fp_idx[0]
    num = den = 0.0
    if traffic["ranks"] == 1 and batch > 1:
        step = max(1, CHUNK // n)
        rows_of = fp_idx // n
        for r0 in range(0, batch, step):
            wr, wi = dft.rows(xr[r0:r0 + step], xi[r0:r0 + step], inverse)
            a, b = _diff_sums((yr[r0:r0 + step], yi[r0:r0 + step]), (wr, wi))
            num, den = num + a, den + b
            sel = (rows_of >= r0) & (rows_of < r0 + step)
            local = fp_idx[sel] - r0 * n
            want_fp_r[sel] = wr.reshape(-1)[local]
            want_fp_i[sel] = wi.reshape(-1)[local]
            del wr, wi
    else:
        n1 = 1 << first_factor_log(log2_exact(n))
        n2 = n // n1
        count = xr.numel()
        if count % n1 or count % n2:
            raise ValueError(f"a shard of {count} points is not whole rows of ({n1}, {n2})")
        first_row = rank * (count // n2)
        k2_lo, k2_n = first_row * n2 // n1, count // n1
        vr, vi = yr.reshape(k2_n, n1), yi.reshape(k2_n, n1)
        fp_k1, fp_k2 = fp_idx % n1, fp_idx // n1 + k2_lo
        for lo, hi, zr, zi in dft.blocks(xr.reshape(-1), xi.reshape(-1), n, first_row,
                                          reduce, inverse):
            wr, wi = zr[:, k2_lo:k2_lo + k2_n], zi[:, k2_lo:k2_lo + k2_n]
            a, b = _diff_sums((vr[:, lo:hi].T, vi[:, lo:hi].T), (wr, wi))
            num, den = num + a, den + b
            sel = (fp_k1 >= lo) & (fp_k1 < hi)
            want_fp_r[sel] = zr[fp_k1[sel] - lo, fp_k2[sel]]
            want_fp_i[sel] = zi[fp_k1[sel] - lo, fp_k2[sel]]
            del zr, zi, wr, wi
    out = {first: {"full": [num, den],
                   "steps": list(_step_sums(fps, (want_fp_r, want_fp_i), (0, 1)))}}
    if rest:
        a, b = _diff_sums(outs[1], (xr, xi))
        out[rest[0]] = {"full": [a, b], "steps": list(_step_sums(
            fps, (xr.reshape(-1)[fp_idx], xi.reshape(-1)[fp_idx]), (2, 3)))}
    return out


def combine(partials: list, limit: dict) -> tuple:
    """({number: {"value", "limit"}}, failed steps) over the ranks'
    ``judge`` sums: each number is the largest of the last step's full
    error and every step's fingerprint error; a step fails where one of its
    errors passes the limit."""
    checks, bad = {}, set()
    for name, lim in limit.items():
        num = sum(p[name]["full"][0] for p in partials)
        den = sum(p[name]["full"][1] for p in partials)
        full = math.sqrt(num / den) if den > 0 else math.inf
        steps = len(partials[0][name]["steps"][0])
        s_den = sum(p[name]["steps"][1] for p in partials)
        worst = full
        for s in range(steps):
            s_num = sum(p[name]["steps"][0][s] for p in partials)
            err = math.sqrt(s_num / s_den) if s_den > 0 else math.inf
            if not err <= lim:
                bad.add(s)
            worst = max(worst, err) if not math.isnan(err) else math.inf
        if not full <= lim:
            bad.add(steps - 1)
        if math.isnan(worst):
            worst = math.inf
        checks[name] = {"value": worst, "limit": lim}
    return checks, len(bad)
