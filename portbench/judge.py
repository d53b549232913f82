"""The comparison that decides ``correct``.

Numbers compared (each a relative L2 error, sqrt(sum |got - want|^2 /
sum |want|^2)):

* ``fwd_rel_l2`` (``inv_rel_l2`` where a step starts with the inverse):
  the step's first output against the reference transform of the input,
  in float64 (``reference.DFT``), over every point of the last step of the
  window and over the fingerprint points of every step;
* ``roundtrip_rel_l2`` (round-trip steps): the inverse's output against
  the input itself, over the same points.

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


def _diff_sums(got_r, got_i, want_r, want_i):
    """(sum |got - want|^2, sum |want|^2) in float64, by chunks."""
    got_r, got_i = got_r.reshape(-1), got_i.reshape(-1)
    want_r, want_i = want_r.reshape(-1), want_i.reshape(-1)
    num = den = 0.0
    for s in range(0, got_r.numel(), CHUNK):
        wr, wi = want_r[s:s + CHUNK].double(), want_i[s:s + CHUNK].double()
        num += _sq(got_r[s:s + CHUNK].double() - wr) + _sq(got_i[s:s + CHUNK].double() - wi)
        den += _sq(wr) + _sq(wi)
    return num, den


def _step_sums(fps, want_r, want_i, rows):
    """Per step: sum over the fingerprint of |got - want|^2 (``rows``: the
    fingerprint's two planes of one output), and sum |want|^2."""
    got_r, got_i = fps[:, rows[0]].double(), fps[:, rows[1]].double()
    num = (got_r - want_r.double()).square().sum(1) + (got_i - want_i.double()).square().sum(1)
    den = float(want_r.double().square().sum() + want_i.double().square().sum())
    return [float(v) for v in num], den


def judge(traffic: dict, x, outs, fps, fp_idx, rank: int = 0, reduce=None) -> dict:
    """This process's sums. ``x``: its input planes; ``outs``: the last
    step's output planes, one pair a call; ``fps``: (steps, 2 * calls, k)
    fingerprints of every step at ``fp_idx``. Returns {number: {"full":
    [num, den], "steps": [[num per step], den]}}."""
    xr, xi = x
    yr, yi = outs[0]
    inverse = traffic["step"][0] == "inverse"
    device = xr.device
    dft = DFT(torch.float64, device)
    n, batch = traffic["n"], traffic["batch"]
    want_fp_r = torch.empty(fp_idx.numel(), dtype=torch.float64, device=device)
    want_fp_i = torch.empty_like(want_fp_r)
    num = den = 0.0
    if traffic["ranks"] == 1 and batch > 1:
        step = max(1, CHUNK // n)
        rows_of = fp_idx // n
        for r0 in range(0, batch, step):
            wr, wi = dft.rows(xr[r0:r0 + step], xi[r0:r0 + step], inverse)
            a, b = _diff_sums(yr[r0:r0 + step], yi[r0:r0 + step], wr, wi)
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
            a, b = _diff_sums(vr[:, lo:hi].T, vi[:, lo:hi].T, wr, wi)
            num, den = num + a, den + b
            sel = (fp_k1 >= lo) & (fp_k1 < hi)
            want_fp_r[sel] = zr[fp_k1[sel] - lo, fp_k2[sel]]
            want_fp_i[sel] = zi[fp_k1[sel] - lo, fp_k2[sel]]
            del zr, zi, wr, wi
    first, *rest = names(traffic)
    out = {first: {"full": [num, den],
                   "steps": list(_step_sums(fps, want_fp_r, want_fp_i, (0, 1)))}}
    if rest:
        zr, zi = outs[1]
        a, b = _diff_sums(zr, zi, xr, xi)
        out[rest[0]] = {"full": [a, b], "steps": list(_step_sums(
            fps, xr.reshape(-1)[fp_idx], xi.reshape(-1)[fp_idx], (2, 3)))}
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
