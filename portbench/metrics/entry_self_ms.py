"""entry_self_ms (entry layer, moves gpoints_per_s): host milliseconds a
call spends in the port's entry spans themselves (``phastft.fft``,
``phastft.real``, ``phastft.dist``) outside every ``phastft.*`` span
inside them: validation, the swap trick, allocations and plain torch
between the passes; rank 0's trace (``port_spans.py``; None where the
program opens no span)."""

from portbench.port_spans import ROOTS


def read(run):
    port = (run.trace or {}).get("port")
    if not port or not port["calls"]:
        return None
    own = sum(port["spans"][name]["self_us"] for name in ROOTS if name in port["spans"])
    return own / port["calls"] / 1e3
