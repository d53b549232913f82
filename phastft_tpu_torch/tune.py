"""Measured plan autotuning: ``PlannerMode.Tune``.

Counterpart of the JAX package's ``tune.py``: time every candidate plan for
(n, dtype) on the device and keep the fastest (the FFTW "MEASURE" idea).
The candidates are the port's own knobs: the leaf sizes the JAX package
races (2^10, 2^13, 2^16, bounded by n, and n itself up to 2^16) and the
heuristic's own ``Options.guess_options(n, dtype)``; in f32 each leaf on the
default leaf kernels and, where the plan runs its leaf through a leaf
kernel of 2^8..2^17 points, on the hybrid one; in f64 the native and the
df64 engines on each leaf, the split dd leaf on the big leaf from n = 2^16
and the Ozaki engine on the 2^13 leaf for 2^20 <= n <= 2^24. Candidates
that run the same plan on the same kernels are measured once
(``"df64-fused"`` runs the same kernels as ``"df64"`` in the port).

A candidate is timed on the planner's device: on a GPU with CUDA events
around each call (warm-up calls, then the median of several), a sleep
kernel ahead of each keeping the GPU busy while the host enqueues the call,
so that the reading is the call's device time, as the JAX package's
chain-slope timing cancels its dispatch; on the CPU with
``time.perf_counter``. The kernel library is built before the first
timing. A candidate that runs out of device memory is skipped; any other
failure propagates, since every candidate must run. The chain-slope
method itself (``phastft_tpu/utils/timing.py``), a workaround for the TPU's
dispatch, is not ported.

Winners are cached in process, keyed by the device's name, and on disk
(``~/.cache/phastft_tpu_torch/tune-torch-<device>.json``, the device's
name sanitized; ``"cpu"`` on the CPU), under the JAX package's wisdom keys
("{n}:{dtype}" and "r2c:{n}:{dtype}"). ``PHASTFT_TPU_TUNE_CACHE=dir``
relocates it, ``=0`` disables the disk cache. The file name differs from
the JAX package's ``tune-<device_kind>.json``, so both packages can share
one directory without reading each other's entries.
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time

import numpy as np
import torch

from .options import Options

__all__ = ["tune_options", "tune_r2c_options", "clear_tune_cache"]

_LOCK = threading.Lock()
_MEM_CACHE: dict = {}

#: Candidate leaf sizes (complex elements), the JAX package's set: 2^10
#: keeps small transforms in cache, 2^16 minimizes split levels, 2^13 is
#: the midpoint. Bounded by n itself.
_LEAF_CANDIDATES = (1 << 10, 1 << 13, 1 << 16)

#: Calls before timing, and timed calls whose median is kept.
_WARMUP = 3
_REPS = 7
#: ``torch.cuda._sleep`` cycles a second on each device, measured once.
_SLEEP_RATE: dict = {}


def _cache_dir() -> str | None:
    env = os.environ.get("PHASTFT_TPU_TUNE_CACHE")
    if env == "0":
        return None
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "phastft_tpu_torch")


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _disk_path(device_name: str) -> str | None:
    d = _cache_dir()
    if d is None:
        return None
    safe = "".join(c if c.isalnum() or c in "-._" else "_" for c in device_name)
    return os.path.join(d, f"tune-torch-{safe}.json")


def _load_disk(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store_disk(path: str, table: dict) -> None:
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(table, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # caching is best-effort


def _elapsed(fn) -> float:
    """Seconds between CUDA events recorded around ``fn()``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def _sleep_rate(device: torch.device) -> float:
    if device not in _SLEEP_RATE:
        cycles = 10_000_000
        _SLEEP_RATE[device] = cycles / _elapsed(lambda: torch.cuda._sleep(cycles))
    return _SLEEP_RATE[device]


def _seconds(run, device: torch.device) -> float:
    """Seconds per call of ``run()``: the median of ``_REPS`` timed calls
    after ``_WARMUP`` untimed ones, each output dropped at once. On a GPU
    the device time: a sleep of twice the host's time for a whole call
    runs ahead of each, so that the call is enqueued before its start
    event is reached."""
    for _ in range(_WARMUP):
        run()
    times = []
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            cycles = int(2 * (time.perf_counter() - t0) * _sleep_rate(device))
            for _ in range(_REPS):
                torch.cuda._sleep(cycles)
                times.append(_elapsed(run))
    else:
        for _ in range(_REPS):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _randn(shape, dtype: np.dtype, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(0)
    want = torch.float64 if dtype == np.float64 else torch.float32
    return torch.randn(shape, generator=gen, dtype=want, device=device)


def _measure(n: int, dtype: np.dtype, opts: Options, device: torch.device) -> float:
    """Seconds per forward transform of one length-n row on a planner built
    with ``opts``, through the closure ``fft.engine_of`` dispatches (the dd
    builder for the df64 engines)."""
    from .fft import engine_of
    from .planner import PlannerDit32, PlannerDit64

    cls = PlannerDit64 if dtype == np.float64 else PlannerDit32
    planner = cls(n, options=opts, device=device)
    re, im = _randn((n,), dtype, device), _randn((n,), dtype, device)
    build, variant, args = engine_of(planner)
    run = build(n, opts.leaf_fft_size, False, *variant)
    return _seconds(lambda: run(re, im, *args), device)


def _engine_key(opts: Options, dtype: np.dtype):
    """What a candidate runs on beyond its plan: the f64 engine as
    ``fft.engine_of`` resolves it, or the f32 leaf kernel."""
    if dtype != np.float64:
        return opts.leaf_kernel == "hybrid"
    engine = opts.f64_engine or "native"
    if not engine.startswith("df64"):
        return "native"
    return engine if engine in ("df64-split", "df64-oz") else "df64"


def _distinct(n: int, dtype: np.dtype, candidates):
    """``candidates`` in order, each (plan, engine) once."""
    from .ops.fourstep import plan_rows

    seen = set()
    for opts in candidates:
        key = (plan_rows(n, opts.leaf_fft_size), _engine_key(opts, dtype))
        if key not in seen:
            seen.add(key)
            yield opts


def _runs_hybrid(plan) -> bool:
    """Whether ``leaf_kernel="hybrid"`` changes what ``plan`` runs: its
    leaf of 2..1024 rows (2^8..2^17 points) goes through a leaf kernel, not
    through the fused pipeline's row kernel."""
    from .ops.fourstep import fused_two_pass, split_levels
    from .ops.leaf import HYBRID_MAX_N1

    inner = plan
    for n1, inner, n2 in split_levels(plan):
        if fused_two_pass(n1, inner, n2):
            return False
    return inner[0] == "leaf" and 1 < inner[1] <= HYBRID_MAX_N1


def _candidates(n: int, dtype):
    """The C2C candidates for (n, dtype), in order, without duplicates: the
    JAX package's leaf sizes on the port's engines, then the heuristic's
    options."""
    from .ops.fourstep import plan_rows

    dtype = np.dtype(dtype)
    leaves = sorted({min(leaf, n) for leaf in _LEAF_CANDIDATES}
                    | ({n} if n <= max(_LEAF_CANDIDATES) else set()))
    tiled = Options.guess_options(n).tiled_bit_reversal
    out = []
    if dtype == np.float32:
        for leaf in leaves:
            leaf = max(leaf, 128)
            out.append(Options(leaf_fft_size=leaf, tiled_bit_reversal=tiled))
            if _runs_hybrid(plan_rows(n, leaf)):
                out.append(Options(leaf_fft_size=leaf, leaf_kernel="hybrid",
                                   tiled_bit_reversal=tiled))
    else:
        for leaf in leaves:
            for engine in ("native", "df64"):
                out.append(Options(leaf_fft_size=max(leaf, 128), f64_engine=engine,
                                   tiled_bit_reversal=tiled))
        big = max(min(1 << 16, n), 128)
        if n >= (1 << 16):
            for engine in ("df64-split", "df64-fused"):
                out.append(Options(leaf_fft_size=big, f64_engine=engine,
                                   tiled_bit_reversal=tiled))
        if (1 << 20) <= n <= (1 << 24):
            out.append(Options(leaf_fft_size=1 << 13, f64_engine="df64-oz",
                               tiled_bit_reversal=tiled))
    out.append(Options.guess_options(n, dtype))
    return list(_distinct(n, dtype, out))


def _race(candidates, measure, device: torch.device):
    """(best options, seconds) of ``measure(opts)`` over ``candidates``;
    (None, inf) when every one ran out of device memory."""
    if device.type == "cuda":
        from .ops import _build

        _build.library()  # no candidate is charged the build
    best, best_t = None, float("inf")
    for opts in candidates:
        try:
            t = measure(opts)
        except torch.OutOfMemoryError:
            torch.cuda.empty_cache()
            continue
        if t < best_t:
            best, best_t = opts, t
    return best, best_t


def _tuned(key: str, device, race, read):
    """The options cached under ``key`` for the device (in process, then on
    disk, ``read(entry)``), else the winner of ``race()``, cached in both."""
    from .planner import resolve_device

    name = _device_name(resolve_device(device))
    mem_key = (name, key)
    with _LOCK:
        if mem_key in _MEM_CACHE:
            return _MEM_CACHE[mem_key]
        path = _disk_path(name)
        disk = _load_disk(path) if path else {}
        if key in disk:
            opts = read(disk[key])
            _MEM_CACHE[mem_key] = opts
            return opts
    best, best_t = race()
    with _LOCK:
        _MEM_CACHE[mem_key] = best
        if path:
            disk = _load_disk(path)
            disk[key] = {
                "leaf_fft_size": best.leaf_fft_size,
                "f64_engine": best.f64_engine,
                "leaf_kernel": best.leaf_kernel,
                "seconds": best_t,
            }
            _store_disk(path, disk)
    return best


def tune_options(n: int, dtype, device=None) -> Options:
    """Measured-best ``Options`` for a length-n C2C of ``dtype`` on
    ``device`` (None = "cuda"); the heuristic's when every candidate ran out
    of memory."""
    from .planner import resolve_device

    dtype = np.dtype(dtype)
    device = resolve_device(device)
    tiled = Options.guess_options(n).tiled_bit_reversal

    def race():
        best, t = _race(_candidates(n, dtype),
                        lambda opts: _measure(n, dtype, opts, device), device)
        return (best, t) if best is not None else (Options.guess_options(n, dtype), t)

    def read(entry):
        return Options(
            leaf_fft_size=int(entry["leaf_fft_size"]),
            f64_engine=entry.get("f64_engine") or None,
            leaf_kernel=entry.get("leaf_kernel") or None,
            tiled_bit_reversal=tiled,
        )

    return _tuned(f"{n}:{dtype.name}", device, race, read)


def _measure_r2c(n: int, dtype: np.dtype, opts: Options, device: torch.device) -> float:
    """Seconds per forward R2C of one length-n real row on a planner whose
    inner half-length plan is built with ``opts``: deinterleave, the inner
    C2C on its engine, untangle, as the R2C entries run them."""
    from .planner import PlannerR2c32, PlannerR2c64
    from .real_fft import _r2c

    cls = PlannerR2c64 if dtype == np.float64 else PlannerR2c32
    planner = cls(n, inner_options=opts, device=device)
    x = _randn((n,), dtype, device)
    return _seconds(lambda: _r2c(x, planner), device)


def _r2c_candidates(n: int, dtype):
    """The R2C inner-plan candidates, in order, without duplicates: the JAX
    package's (the half-length plan's leaf sizes; f64 also ``"df64"`` on
    the big leaf and ``"df64-oz"`` for 2^20 <= n/2 <= 2^24), then the
    heuristic's options for the half length."""
    dtype = np.dtype(dtype)
    half = n // 2
    out = [Options(leaf_fft_size=max(leaf, 128))
           for leaf in sorted({min(leaf, half) for leaf in _LEAF_CANDIDATES})]
    if dtype == np.float64:
        out.append(Options(leaf_fft_size=max(min(1 << 16, half), 128), f64_engine="df64"))
        if (1 << 20) <= half <= (1 << 24):
            out.append(Options(leaf_fft_size=1 << 13, f64_engine="df64-oz"))
    out.append(Options.guess_options(half, dtype))
    return list(_distinct(half, dtype, out))


def tune_r2c_options(n: int, dtype, device=None) -> Options:
    """Measured-best inner ``Options`` for a length-n R2C of ``dtype`` on
    ``device`` (None = "cuda"): the half-length plan raced as a whole R2C
    (deinterleave + C2C + untangle), cached under an "r2c:" wisdom key."""
    from .planner import resolve_device

    dtype = np.dtype(dtype)
    device = resolve_device(device)

    def race():
        best, t = _race(_r2c_candidates(n, dtype),
                        lambda opts: _measure_r2c(n, dtype, opts, device), device)
        return (best, t) if best is not None else (Options.guess_options(n // 2, dtype), t)

    def read(entry):
        return Options(leaf_fft_size=int(entry["leaf_fft_size"]),
                       f64_engine=entry.get("f64_engine") or None,
                       leaf_kernel=entry.get("leaf_kernel") or None)

    return _tuned(f"r2c:{n}:{dtype.name}", device, race, read)


def clear_tune_cache() -> None:
    """Drop the in-process tuning cache (tests; device changes)."""
    with _LOCK:
        _MEM_CACHE.clear()
