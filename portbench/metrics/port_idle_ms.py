"""port_idle_ms (device layer, moves gpoints_per_s): milliseconds a step
in which rank 0's device ran nothing while its host was inside a
``phastft.*`` span: the idle time the port's own host code leaves
(``port_spans.py``; None where the program opens no span). The summary's
``idle_by_span`` splits it by span."""


def read(run):
    port = (run.trace or {}).get("port")
    if not port:
        return None
    return port["idle_us"] / 1e3 / run.steps
