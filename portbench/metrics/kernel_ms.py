"""kernel_ms (kernels layer, moves gpoints_per_s): device milliseconds a
step of the port's own kernels, summed over their launches; rank 0's
trace. The breakdown lists them by name."""


def read(run):
    if run.trace is None:
        return None
    return run.trace["class_us"].get("port", 0.0) / 1e3 / run.steps
