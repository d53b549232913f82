"""Reading the window's ``torch.profiler`` trace: the device's busy time,
each kernel's time by class, the idle gaps and what the host was doing in
them.

Device events are the trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
events (as ``chip_smoke.py``'s ``device_trace`` reads them). Each falls in
one class:

* ``harness``: launched inside one of the benchmark's own spans
  (``portbench.fingerprint``, ``portbench.flag``), matched through the
  launch's correlation id;
* ``nccl``: NCCL's kernels, and copies on a stream that runs them;
* ``torch``: PyTorch's and its libraries' kernels (ATen, CUB, cuBLAS),
  and the other copies and fills: the plain torch work between the port's
  kernels;
* ``port``: every other kernel, the port's own.

Busy time is the union of the device intervals inside the window span
(``portbench.window``), so kernels that overlap count once.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
HARNESS_SPANS = ("portbench.fingerprint", "portbench.flag")
LIBRARY_MARKS = ("at::", "at_cuda_detail", "cub::", "cublas", "cutlass", "xmma", "gemm",
                 "nvjet", "cudnn")
TOP = 10
NAME_CHARS = 120


def spans_union(spans):
    """The union of (start, end) intervals as sorted disjoint [start, end]."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def export_events(prof) -> list:
    """The profiler's chrome-trace events (written to a file under TMPDIR,
    read and removed)."""
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)


def classify(events) -> tuple:
    """(device events as (name, class, start us, end us), host events as
    (name, start, end), the window (start, end) or None)."""
    host, device, window = [], [], None
    harness = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in HOST_CATS:
            host.append((name, a, b, (e.get("args") or {}).get("correlation")))
            if cat == "user_annotation" and name == "portbench.window":
                window = (a, b)
            elif cat == "user_annotation" and name in HARNESS_SPANS:
                harness.append((a, b))
        elif cat in DEVICE_CATS:
            args = e.get("args") or {}
            device.append((name, cat, args.get("stream"), args.get("correlation"), a, b))
    harness = spans_union(harness)
    starts = [a for a, _ in harness]
    owned = set()
    for name, a, b, corr in host:
        if corr is None:
            continue
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a <= harness[i][1]:
            owned.add(corr)
    nccl_streams = {s for name, cat, s, *_ in device
                    if cat == "kernel" and "nccl" in name.lower()}
    out = []
    for name, cat, stream, corr, a, b in device:
        low = name.lower()
        if corr is not None and corr in owned:
            kind = "harness"
        elif "nccl" in low or (cat != "kernel" and stream in nccl_streams):
            kind = "nccl"
        elif cat != "kernel" or any(m in low for m in LIBRARY_MARKS):
            kind = "torch"
        else:
            kind = "port"
        out.append((name, kind, a, b))
    return out, [(n, a, b) for n, a, b, _ in host], window


def _innermost(host_sorted, starts, t):
    """The name of the host event with the latest start that covers t."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        name, a, b = host_sorted[i]
        if b >= t:
            return name
        i -= 1
    return None


def summary(events) -> dict:
    """The window's numbers: ``window_us``, ``busy_us`` (union of device
    intervals clipped to the window), ``class_us`` (summed durations by
    class), ``device_ops`` (the TOP names by device seconds) and
    ``idle_gaps`` (idle seconds summed by what the host was doing at each
    gap's middle: its innermost event, in the innermost benchmark span)."""
    device, host, window = classify(events)
    if window is None:
        return {}
    w0, w1 = window
    inside = [(n, k, max(a, w0), min(b, w1)) for n, k, a, b in device if b > w0 and a < w1]
    busy = spans_union([(a, b) for _, _, a, b in inside])
    class_us, by_name = {}, {}
    for name, kind, a, b in inside:
        class_us[kind] = class_us.get(kind, 0.0) + (b - a)
        key = name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + (b - a)
    host_sorted = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host_sorted]
    spans = sorted((h for h in host if h[0].startswith("portbench.")
                    and h[0] != "portbench.window"), key=lambda h: h[1])
    span_starts = [h[1] for h in spans]
    gaps, prev = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            mid = (prev + a) / 2
            what = _innermost(host_sorted, starts, mid) or "host"
            phase = _innermost(spans, span_starts, mid) or "portbench.window"
            label = what if what == phase else f"{what} in {phase}"
            gaps[label] = gaps.get(label, 0.0) + (a - prev)
        prev = max(prev, b)
    top = lambda d: [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_us": w1 - w0, "busy_us": sum(b - a for a, b in busy),
            "class_us": class_us, "device_ops": top(by_name), "idle_gaps": top(gaps)}
