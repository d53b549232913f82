"""plans_built_per_step (planner layer, moves setup_s): ``phastft.plan``
spans in the window over the steps, plans, planners or tables built on a
cache miss: 0 on a reused planner, whose set-up built them all; rank 0's
trace (``port_spans.py``; None where the program opens no span)."""

from portbench.port_spans import PLAN


def read(run):
    port = (run.trace or {}).get("port")
    if not port:
        return None
    return port["spans"].get(PLAN, {}).get("count", 0) / run.steps
