"""nccl_ms (distributed layer, moves gpoints_per_s): device milliseconds
a step of NCCL's kernels and copies on rank 0, the collectives' time,
waits on the other ranks included; only cells of several ranks."""


def read(run):
    if run.trace is None or run.cell.traffic["ranks"] == 1:
        return None
    return run.trace["class_us"].get("nccl", 0.0) / 1e3 / run.steps
