"""One run of one cell: set-up, warm-up, the measured window, the trace
and the check, on this process's device (one rank of a cell that spans
several), and the result line made from the ranks' parts.

The window is a closed loop with one caller: each step makes the cell's
calls on the input held since set-up, each call on the previous one's
output, keeps the fingerprint points of every output, and ends in a
synchronise. The step's outputs are dropped before the next step, so a
step holds what a caller of these calls holds. The window ends at the
first step that ends ``seconds`` after it began (rank 0 decides across
ranks). Nothing is built or compiled in the window: set-up loads the
kernels, builds the planner and runs ``WARM_STEPS`` steps of the cell's
own shapes.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np
import torch

from . import judge, peaks, port_spans, spec, systems, trace
from . import traffic as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "phastft_tpu")
WARM_STEPS = 2
GIB = float(1 << 30)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run may not load, compared
    whole (``phastft_tpu_torch`` is not ``phastft_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def make_system(kind: str, cell: spec.Cell, device, rank: int, reduce):
    if kind == "port":
        return systems.Port(cell.config, cell.traffic, device)
    if kind == "control":
        return systems.Control(cell.config, cell.traffic, device, rank, reduce)
    if kind.startswith("fault:"):
        from .faults import Faulty

        return Faulty(kind.split(":", 1)[1], cell.config, cell.traffic, device)
    raise ValueError(f"unknown system {kind!r}")


def _no_span(name):
    return contextlib.nullcontext()


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def run_rank(cell: spec.Cell, seeds, seconds: float, trace_on: bool, device, *,
             rank: int = 0, system: str = "port", agree=None, reduce=None,
             barrier=None, marks=None) -> list:
    """This rank's part of a run for each seed (one build, then for each
    seed its input, warm-up, window and check). Alone, the window ends at
    the first step that ends ``seconds`` after it began. Across ranks,
    ``agree(last)`` starts handing rank 0's decision that the step is the
    last (its start plus the previous step's length reaches ``seconds``),
    once the step's launches are queued, so that the exchange runs on the
    host while the card works; it returns a wait for it that the ranks
    call once the step has ended. ``reduce`` sums a tensor over the ranks;
    ``barrier`` lines them up before each window. Only the first seed's
    window is traced. ``marks``: (phase, wall time) pairs so far, to which
    the set-up's phases are added."""
    device = torch.device(device)
    traffic = cell.traffic
    dtype = systems.DTYPES[cell.config["precision"]]
    real = cell.config["entry"] == "real"
    marks = list(marks or [])
    sut = make_system(system, cell, device, rank, reduce)
    setup = sut.build()
    marks.append(("built", time.time()))
    calls = [sut.forward if c == "forward" else sut.inverse for c in traffic["step"]]
    names = ["portbench." + c for c in traffic["step"]]
    parts = []
    for i, seed in enumerate(seeds):
        x = tr.make_input(traffic, seed, rank, dtype, device, real)
        fp_idx = tr.fingerprint_index(traffic, seed, rank, device, real)
        systems.sync(device)
        marks.append(("input", time.time()))
        tracing = trace_on and i == 0
        span = torch.profiler.record_function if tracing else _no_span

        def step():
            outs, host, src = [], [], x
            for call, name in zip(calls, names):
                t0 = time.perf_counter()
                with span(name):
                    src = call(*src)
                host.append(time.perf_counter() - t0)
                outs.append(src)
            with span("portbench.fingerprint"):
                fp = torch.stack([p.reshape(-1)[idx] for o, idx in zip(outs, fp_idx)
                                  for p in o])
            return outs, fp, host

        warm = []
        for _ in range(WARM_STEPS):
            systems.sync(device)
            t0 = time.perf_counter()
            outs = step()
            systems.sync(device)
            warm.append(time.perf_counter() - t0)
            outs = None
        if i == 0:
            setup["plan_build_s"] = setup.get("planner_s", 0.0) + max(0.0, warm[0] - warm[-1])
            marks.append(("warm", time.time()))
        prof = None
        if tracing:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.start()
        if barrier is not None:
            barrier()
        fps, step_s, host_s = [], [], []
        prev = warm[-1]
        window_wall = time.time()
        t_start = time.perf_counter()
        with span("portbench.window"):
            while True:
                t0 = time.perf_counter()
                outs, fp, host = step()
                if agree is not None:
                    with span("portbench.flag"):
                        last = agree(t0 - t_start + prev >= seconds)
                systems.sync(device)
                t1 = time.perf_counter()
                step_s.append(t1 - t0)
                host_s.extend(host)
                fps.append(fp)
                prev = t1 - t0
                if agree is None:
                    last = t1 - t_start >= seconds
                else:
                    with span("portbench.flag"):
                        last = last()
                if last:
                    break
                outs = fp = None
        window_s = time.perf_counter() - t_start
        peak = _peak(device)
        summary = None
        if prof is not None:
            prof.stop()
            events = trace.export_events(prof)
            summary = trace.summary(events)
            if summary:
                summary["port"] = port_spans.summary(events)
            prof = events = None
        if i == len(seeds) - 1:
            sut.close()
        sums = judge.judge(traffic, x, outs, torch.stack(fps), fp_idx, rank, reduce)
        parts.append({
            "rank": rank, "seed": seed, "steps": len(step_s), "step_s": step_s,
            "host_s": host_s, "window_s": window_s, "window_wall": window_wall,
            "setup": dict(setup), "marks": marks if i == 0 else [], "peak_bytes": peak,
            "trace": summary, "judge": sums,
            "forbidden": forbidden_modules(),
        })
        del x, outs, fps, fp
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return parts


class RunView:
    """What a per-layer metric's reader sees of one run: the cell, every
    rank's part (``parts``, rank 0 first, as ``lead``), the steps, the
    step's least time on the card (``bound_s``, one rank's share) and rank
    0's trace summary (``trace``, None in an untraced run; its ``port`` the
    port's own spans, ``port_spans.summary``)."""

    def __init__(self, cell: spec.Cell, parts: list):
        self.cell, self.parts = cell, parts
        self.lead = parts[0]
        self.steps = self.lead["steps"]
        self.trace = self.lead["trace"] or None
        self.bound_s = peaks.step_bound_s(cell.traffic, cell.config["precision"],
                                          cell.config["entry"])


def end_to_end(cell: spec.Cell, parts: list, t_process: float) -> dict:
    lead = parts[0]
    step_ms = np.asarray(lead["step_s"]) * 1e3
    return {
        "gpoints_per_s": tr.points_per_step(cell.traffic) * lead["steps"]
        / lead["window_s"] / 1e9,
        "step_p95_ms": float(np.percentile(step_ms, 95)),
        "peak_gib": max(p["peak_bytes"] for p in parts) / GIB,
        "setup_s": max(p["window_wall"] for p in parts) - t_process,
    }


def result(cell: spec.Cell, parts: list, t_process: float, trace_on: bool,
           device_kind: str) -> tuple:
    """(the result line's object, the lines of numbers against limits for
    standard error). ``parts``: one per rank, rank 0 first."""
    limit = judge.limits(cell.config, cell.traffic)
    checks, failed_steps = judge.combine([p["judge"] for p in parts], limit)
    lead = parts[0]
    per_step = len(cell.traffic["step"]) * cell.traffic["batch"]
    metrics = {}
    if trace_on:
        view = RunView(cell, parts)
        for m in cell.per_layer:
            value = spec.reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = end_to_end(cell, parts, t_process)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if device_kind != "cpu" else "cpu", "kind": device_kind,
              "count": len(parts), "memory_peak_bytes": max(p["peak_bytes"] for p in parts)}
    out = {"correct": failed_steps == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()),
           "attempted": lead["steps"] * per_step, "failed": failed_steps * per_step,
           "metrics": metrics, "device": device,
           "setup": {"kernels_s": max(p["setup"].get("kernels_s", 0.0) for p in parts),
                     "kernels_built": any(p["setup"].get("kernels_built", False)
                                          for p in parts)}}
    if trace_on and lead["trace"]:
        traced = [p["trace"] for p in parts if p["trace"]]
        device["busy_s"] = sum(t["busy_us"] for t in traced) / len(traced) / 1e6
        device["window_s"] = lead["trace"]["window_us"] / 1e6
        out["breakdown"] = {"device_ops": lead["trace"]["device_ops"],
                            "idle_gaps": lead["trace"]["idle_gaps"]}
    out["checks"] = checks
    lines = [f"check {k} = {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    return out, lines


def finite(obj):
    """``obj`` with every float that JSON cannot hold (inf, nan) as a string."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    return obj
