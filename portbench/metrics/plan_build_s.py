"""plan_build_s (planner layer, moves setup_s): seconds to build the
planner (its constructor, through a synchronise) plus what the first step
of set-up took beyond the second, where the first call builds its tables
and takes its buffers; rank 0's, host clock."""


def read(run):
    return run.lead["setup"].get("plan_build_s")
