"""torch_ops_ms (row transforms layer, moves gpoints_per_s): device
milliseconds a step of kernels, copies and fills that are neither the
port's own nor NCCL's: the plain torch work between the port's kernels,
such as the inverse's 1/N scale; rank 0's trace."""


def read(run):
    if run.trace is None:
        return None
    return run.trace["class_us"].get("torch", 0.0) / 1e3 / run.steps
