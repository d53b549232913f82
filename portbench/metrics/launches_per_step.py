"""launches_per_step (kernels layer, moves gpoints_per_s): the port's
kernel launches a step, its ``phastft.launch.*`` spans in the window over
the steps; rank 0's trace (``port_spans.py``; None where the program opens
no span)."""

from portbench.port_spans import LAUNCH


def read(run):
    port = (run.trace or {}).get("port")
    if not port:
        return None
    count = sum(v["count"] for k, v in port["spans"].items() if k.startswith(LAUNCH))
    return count / run.steps
