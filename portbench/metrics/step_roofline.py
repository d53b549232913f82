"""step_roofline (kernels layer, moves gpoints_per_s): percent of the
device's busy time a step that the step's transforms need at least on the
card (``peaks.step_bound_s``: the input read once and the output written
once, against 3.35 TB/s, or 5 n log2 n flops against the FP32 / FP64 peak,
whichever is larger), rank 0's share and rank 0's busy time. The bound
comes from the cell's shape alone, so it reads the same work whatever
implements it."""


def read(run):
    if run.trace is None or run.trace["busy_us"] <= 0:
        return None
    busy_s = run.trace["busy_us"] / 1e6 / run.steps
    return 100.0 * run.bound_s / busy_s
