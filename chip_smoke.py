#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``phastft_tpu_torch``.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It prints one JSON line per phase and fails (non-zero exit, no final line)
on any failed check:

1. ``device``: the card, and its name and power limit from ``nvidia-smi``.
2. ``build``: builds the CUDA kernels from ``phastft_tpu_torch/csrc``.
3. ``parity``: each kernel against its plain torch version on the card, at
   the slice's shapes (n1, n2) = (128, 8192), (1024, 16384), (2048, 16384),
   rel L2 <= 1e-6.
4. ``e2e``: the main path through the public entries, launch counters set
   to 0 just before and read just after: ``fft_32_dit`` forward at 2^20,
   2^24 and 2^25 against numpy's f64 FFT (rel L2 <= 5e-7 * max(1,
   log2(n)/18)), a round trip at 2^24 (<= 1e-6), and one ``PlannerDit32``
   reused on a (4, 2^22) batch. Each transform must launch each kernel
   exactly once.
5. ``times``: device-time medians of 20 calls (CUDA events, the GPU kept
   busy until the call is enqueued), L2 flushed before each, at 2^20, 2^24
   and 2^25: each kernel, its plain version, the whole transform (and its
   host-clock time), and ``torch.fft.fft`` on complex64 as a yardstick (the
   port never calls it), beside each kernel's memory bound.

The line before the last is the kernel summary; the last line is the
device record. No CUDA device: exit 1 before any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

#: Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32
#: (non-tensor-core) flop/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

PARITY_SHAPES = [(128, 8192), (1024, 16384), (2048, 16384)]
E2E_LOGS = (20, 24, 25)
TIME_LOGS = (20, 24, 25)
KERNEL_TOL = 1e-6
OUT_DIR = "chiprun_out"
#: ~1 ms at the H100's clocks: longer than the host takes to enqueue a call.
SLEEP_CYCLES = 2_000_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_l2(got_re, got_im, want_re, want_im) -> float:
    import torch

    num = torch.sqrt(
        ((got_re.double() - want_re.double()) ** 2).sum()
        + ((got_im.double() - want_im.double()) ** 2).sum()
    )
    den = torch.sqrt((want_re.double() ** 2).sum() + (want_im.double() ** 2).sum())
    return float(num / den)


def max_abs(got_re, got_im, want_re, want_im) -> float:
    return float(max((got_re - want_re).abs().max(), (got_im - want_im).abs().max()))


def oracle_err(got, x) -> float:
    """rel L2 of (re, im) tensors against numpy's f64 FFT of complex x."""
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    g = got[0].cpu().numpy().astype(np.float64) + 1j * got[1].cpu().numpy()
    if not np.all(np.isfinite(g)) or g.shape != want.shape:
        raise AssertionError(f"bad output: shape {g.shape}, finite {np.isfinite(g).all()}")
    return float(np.linalg.norm(g - want) / np.linalg.norm(want))


def signal(rng, shape):
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    return re, im


def check(name, value, bound):
    if not value <= bound:
        raise AssertionError(f"{name}: {value} > {bound}")


def time_ms(fn, flush, reps=20):
    """Median device time of ``fn`` over ``reps`` CUDA-event timings, after
    3 warm-up calls, with the L2 flushed before each timed call. A sleep
    kernel of SLEEP_CYCLES keeps the GPU busy until the host has enqueued
    ``fn``, so the host's Python overhead does not fall between the events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))


def wall_ms(fn, flush, reps=20):
    """Median host-clock time of ``fn`` up to its synchronised end, L2
    flushed before each call: what a caller of one transform waits."""
    import torch

    out = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def kernel_bound(n: int, log_len: int, table_floats: int = 0):
    """(bound_ms, bound_by) of one pass over a length-n planar f32
    transform: 8 B read and 8 B written per complex element, plus the
    tables the kernel reads, against 5*log2(len) + 6 flops per element."""
    nbytes = 16 * n + 4 * table_floats
    flops = (5 * log_len + 6) * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from phastft_tpu_torch import Direction, PlannerDit32, fft_32_dit
    from phastft_tpu_torch import fft_32_dit_with_planner
    from phastft_tpu_torch.ops import _build
    from phastft_tpu_torch.ops.colfft import (
        col_split_tables_host, col_tile3d, colfft_out3d, colfft_out3d_plain,
    )
    from phastft_tpu_torch.ops.leaft import leaft, leaft_plain, leaft_tables_host

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "torch_name": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log = _build.build_log()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(log)
    ptxas = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s,
          "sources": sorted(os.listdir(_build.SRC_DIR)), "ptxas": ptxas})

    # -- parity: each kernel against its plain version on the same inputs
    rng = np.random.default_rng(2025)
    max_err = {"colfft_out3d": 0.0, "leaft": 0.0}
    for n1, n2 in PARITY_SHAPES:
        re, im = signal(rng, (1, n1, n2))
        xr = torch.from_numpy(re).to(dev)
        xi = torch.from_numpy(im).to(dev)
        tabs = tuple(
            torch.from_numpy(a).to(dev)
            for a in col_split_tables_host(n1, n2, "float32", t=col_tile3d(n1, n2))
        )
        mats = tuple(torch.from_numpy(a).to(dev) for a in leaft_tables_host(n2))
        kc = colfft_out3d(xr, xi, tabs, n1)
        pc = colfft_out3d_plain(xr, xi, tabs, n1)
        torch.cuda.synchronize()
        kl = leaft(pc[0], pc[1], mats, n1)
        pl = leaft_plain(pc[0], pc[1], mats, n1)
        torch.cuda.synchronize()
        for name, k, p in (("colfft_out3d", kc, pc), ("leaft", kl, pl)):
            err = rel_l2(k[0], k[1], p[0], p[1])
            mabs = max_abs(k[0], k[1], p[0], p[1])
            max_err[name] = max(max_err[name], mabs)
            emit({"phase": "parity", "kernel": name, "n1": n1, "n2": n2,
                  "rel_l2": err, "max_abs_err": mabs, "bound": KERNEL_TOL})
            check(f"{name} parity at ({n1}, {n2})", err, KERNEL_TOL)
        del kc, pc, kl, pl

    # -- main path: counters at 0 just before, read just after
    colfft_out3d.launches = 0
    leaft.launches = 0
    transforms = 0
    errs = {}
    x24 = None
    for log_n in E2E_LOGS:
        n = 1 << log_n
        re, im = signal(rng, (n,))
        out = fft_32_dit(re, im, Direction.Forward)
        transforms += 1
        err = oracle_err(out, re + 1j * im)
        errs[f"fwd_2^{log_n}"] = err
        check(f"fft_32_dit 2^{log_n}", err, 5e-7 * max(1.0, log_n / 18.0))
        if log_n == 24:
            x24 = (re, im, out)
    re, im, out = x24
    back = fft_32_dit(out[0], out[1], Direction.Reverse)
    transforms += 1
    rt = rel_l2(back[0], back[1], torch.from_numpy(re).to(dev),
                torch.from_numpy(im).to(dev))
    errs["roundtrip_2^24"] = rt
    check("round trip 2^24", rt, 1e-6)
    planner = PlannerDit32(1 << 22)
    for _ in range(2):
        re, im = signal(rng, (4, 1 << 22))
        out = fft_32_dit_with_planner(re, im, Direction.Forward, planner)
        transforms += 1
        err = oracle_err(out, re + 1j * im)
        errs.setdefault("planner_2^22_batch4", []).append(err)
        check("planner reuse 2^22 x4", err, 5e-7 * max(1.0, 22 / 18.0))
    torch.cuda.synchronize()
    launches = {"colfft_out3d": colfft_out3d.launches, "leaft": leaft.launches}
    emit({"phase": "e2e", "rel_l2": errs, "transforms": transforms,
          "launches": launches})
    for name, count in launches.items():
        if count != transforms:
            raise AssertionError(f"{name}: {count} launches for {transforms} transforms")

    # -- times
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    summary = {}
    for log_n in TIME_LOGS:
        n = 1 << log_n
        planner = PlannerDit32(n)
        _, n1, _, n2 = planner.plan
        a = n2 // 128
        tabs = planner.leaf_corrs[f"pcolT{n1}x{n2}"]
        mats = planner.leaf_corrs[f"leafT{n2}"]
        re, im = signal(rng, (1, n))
        xr = torch.from_numpy(re).to(dev)
        xi = torch.from_numpy(im).to(dev)
        ar, ai = xr.view(1, n1, n2), xi.view(1, n1, n2)
        c3 = colfft_out3d(ar, ai, tabs, n1)
        xc = torch.complex(xr, xi)
        row = {
            "colfft_out3d": {
                "ms": time_ms(lambda: colfft_out3d(ar, ai, tabs, n1), flush),
                "plain_ms": time_ms(lambda: colfft_out3d_plain(ar, ai, tabs, n1), flush),
            },
            "leaft": {
                "ms": time_ms(lambda: leaft(c3[0], c3[1], mats, n1), flush),
                "plain_ms": time_ms(lambda: leaft_plain(c3[0], c3[1], mats, n1), flush),
            },
        }
        bound_a = kernel_bound(n, n1.bit_length() - 1)
        bound_b = kernel_bound(n, n2.bit_length() - 1, a + 128 + 2 * a * 128)
        row["colfft_out3d"].update(bound_ms=bound_a[0], bound_by=bound_a[1])
        row["leaft"].update(bound_ms=bound_b[0], bound_by=bound_b[1])
        def transform():
            return fft_32_dit_with_planner(xr, xi, Direction.Forward, planner)

        emit({"phase": "times", "n": n, "n1": n1, "n2": n2, "card": smi,
              "kernels": row, "transform_ms": time_ms(transform, flush),
              "transform_wall_ms": wall_ms(transform, flush),
              "transform_bound_ms": bound_a[0] + bound_b[0],
              "library_ms": time_ms(lambda: torch.fft.fft(xc), flush)})
        summary[log_n] = row
        del c3, xc

    top = summary[max(TIME_LOGS)]
    sources = {
        "colfft_out3d": ("phastft_tpu_torch/csrc/colfft.cu",
                         "phastft_tpu/ops/pallas_col.py:490"),
        "leaft": ("phastft_tpu_torch/csrc/leaft.cu",
                  "phastft_tpu/ops/pallas_leaft.py:322"),
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": top[name]["ms"], "plain_ms": top[name]["plain_ms"],
         "bound_ms": top[name]["bound_ms"], "bound_by": top[name]["bound_by"],
         "library_ms": None, "n": 1 << max(TIME_LOGS)}
        for name, (src, rep) in sources.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
