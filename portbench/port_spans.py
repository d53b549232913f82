"""The port's own spans in the window's ``torch.profiler`` trace.

``phastft_tpu_torch`` opens ``phastft.*`` spans (``tracing.py`` there)
while a profiler records: the entry's root (``phastft.fft``,
``phastft.real``, ``phastft.dist``), the planner on a cache miss
(``phastft.plan``), the levels of the plan, each kernel launch
(``phastft.launch.<entry>``) and the distributed column stage. They are
user annotations on the caller's thread, on the same clock as the device's
events, so the device's idle time can be put down to the span the host was
in. A program without them (an older port) gives nothing here.

``summary(events)`` reads the spans that start inside the window span
(``portbench.window``; the whole trace without one):

* ``spans``: for each name its ``count``, ``host_us`` (summed durations)
  and ``self_us`` (each duration less the union of the ``phastft.*``
  spans inside it on the same thread);
* ``calls``: root spans not inside another root span, one a call;
* ``idle_us``: the device's idle time (no kernel, copy or fill, as
  ``trace.py`` counts busy time) inside the union of the spans;
* ``idle_by_span``: that idle time by the innermost span at the middle of
  each idle interval.
"""

from __future__ import annotations

import bisect

from .trace import DEVICE_CATS, spans_union

PREFIX = "phastft."
ROOTS = ("phastft.fft", "phastft.real", "phastft.dist")
LAUNCH = "phastft.launch."
PLAN = "phastft.plan"
WINDOW = "portbench.window"
#: Microseconds by which a span may seem to outlast its parent (the
#: trace's timestamps are rounded to the nanosecond).
SLACK_US = 0.01


def _read(events):
    """(the port's spans as (tid, start, end, name), the device's
    intervals, the window (start, end) or None)."""
    spans, device, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        name, cat = e.get("name", ""), e.get("cat", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in DEVICE_CATS:
            device.append((a, b))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((e.get("tid"), a, b, name))
        elif cat == "user_annotation" and name == WINDOW:
            window = (a, b)
    return spans, device, window


def _nest(spans):
    """Each span's index of its parent (None for an outermost one), the
    spans sorted by thread, start and longest first."""
    parents, stack = [], []
    for i, (tid, a, b, _) in enumerate(spans):
        while stack and (spans[stack[-1]][0] != tid or spans[stack[-1]][2] < b - SLACK_US):
            stack.pop()
        parents.append(stack[-1] if stack else None)
        stack.append(i)
    return parents


def _innermost(spans, starts, t):
    """The name of the span with the latest start that covers t."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        _, a, b, name = spans[i]
        if b >= t:
            return name
        i -= 1
    return None


def _intersect(xs, ys):
    """The non-empty intersections of two sorted lists of disjoint
    intervals, in order."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def summary(events) -> dict:
    """The numbers above for the window of ``events``; {} where the trace
    holds no ``phastft.*`` span in it."""
    spans, device, window = _read(events)
    if window is not None:
        spans = [s for s in spans if window[0] <= s[1] <= window[1]]
    if not spans:
        return {}
    spans.sort(key=lambda s: (str(s[0]), s[1], -s[2]))
    lo, hi = window or (min(s[1] for s in spans), max(s[2] for s in spans))
    parents = _nest(spans)
    kids = [[] for _ in spans]
    for i, p in enumerate(parents):
        if p is not None:
            kids[p].append(i)
    out = {}
    for i, (_, a, b, name) in enumerate(spans):
        inner = spans_union([(max(a, spans[k][1]), min(b, spans[k][2])) for k in kids[i]])
        row = out.setdefault(name, {"count": 0, "host_us": 0.0, "self_us": 0.0})
        row["count"] += 1
        row["host_us"] += b - a
        row["self_us"] += (b - a) - sum(y - x for x, y in inner)

    def in_root(i):
        p = parents[i]
        while p is not None:
            if spans[p][3] in ROOTS:
                return True
            p = parents[p]
        return False

    calls = sum(1 for i, s in enumerate(spans) if s[3] in ROOTS and not in_root(i))
    busy = spans_union([(max(a, lo), min(b, hi)) for a, b in device if b > lo and a < hi])
    idle, prev = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    covered = spans_union([(a, b) for _, a, b, _ in spans])
    by_time = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in by_time]
    idle_us, by_span = 0.0, {}
    for a, b in _intersect(idle, covered):
        idle_us += b - a
        name = _innermost(by_time, starts, (a + b) / 2) or PREFIX
        by_span[name] = by_span.get(name, 0.0) + (b - a)
    return {"spans": out, "calls": calls, "idle_us": idle_us, "idle_by_span": by_span}
