"""launch_us (kernels layer, moves gpoints_per_s): mean host microseconds
of one ``phastft.launch.*`` span, a kernel launch through the port's
``ops/_build.call`` (its argument checks and the ctypes call into the
kernel's launcher); rank 0's trace (``port_spans.py``; None where the
program opens no launch span)."""

from portbench.port_spans import LAUNCH


def read(run):
    port = (run.trace or {}).get("port")
    rows = [v for k, v in (port or {}).get("spans", {}).items() if k.startswith(LAUNCH)]
    count = sum(r["count"] for r in rows)
    return sum(r["host_us"] for r in rows) / count if count else None
