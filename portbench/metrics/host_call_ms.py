"""host_call_ms (entry layer, moves gpoints_per_s): mean host-clock
milliseconds of one call of the port's entry over the window's calls,
from the call to its return, which comes before the device finishes;
rank 0's, in the traced run."""


def read(run):
    calls = run.lead["host_s"]
    return 1e3 * sum(calls) / len(calls) if calls else None
