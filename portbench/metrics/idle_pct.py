"""idle_pct (device layer, moves gpoints_per_s): percent of the traced
window in which no kernel, copy or fill ran on rank 0's device."""


def read(run):
    if run.trace is None or run.trace["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_us"] / run.trace["window_us"])
