#!/usr/bin/env python3
"""The readings that a cell's limits are checked against, many seeds in one
process (one build, then each seed's input, warm-up, a short window at the
cell's own size and load, and the check):

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 2 \
        [--system port|control|fault:<name>]

``port`` gives the lower readings (sound runs of the timed path),
``control`` the reference in the port's place one precision lower, which
has to fail, and ``fault:<name>`` the port with a fault of ``faults.py``
planted under it. One JSON line a seed: the numbers compared with their
limits, ``correct``, and the window's end-to-end metrics. Needs the
cell's cards; it is not part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--system", default="port")
    args = p.parse_args(argv)
    run.environment()
    import torch

    from portbench import harness, launch, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    seeds = run.seeds_of(args.seeds)
    kind = torch.cuda.get_device_name(0)
    t0 = time.time()
    if cell.chips == 1:
        per_rank = [harness.run_rank(cell, seeds, args.seconds, False, torch.device("cuda", 0),
                                     system=args.system)]
    else:
        per_rank = launch.run_ranks(cell, seeds, args.seconds, False, system=args.system)
    for i, seed in enumerate(seeds):
        parts = [rank[i] for rank in per_rank]
        out, _ = harness.result(cell, parts, t0, False, kind)
        line = {"workload": args.workload, "system": args.system, "seed": seed,
                "correct": out["correct"], "checks": out["checks"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "steps": parts[0]["steps"], "card": kind}
        print(json.dumps(harness.finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
