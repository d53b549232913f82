#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the repository root:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``. The run makes
its input on the card from the seed, builds the port's planner, warms up
the cell's shapes, measures for ``--seconds``, then checks the window's
outputs against the plain reference (``reference.py``). The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones, read from a ``torch.profiler`` trace of the
window), ``device``, with ``--trace 1`` ``breakdown``, and ``checks``, each
number compared beside its limit, which also end standard error.

It exits non-zero and prints no result without as many CUDA devices as the
cell's chips, when a step or the check fails to run, or when ``jax``,
``jaxlib``, ``flax`` or ``phastft_tpu`` is loaded once the result is made
(the metrics' readers included), just before it would be printed. A cell
of several chips starts one rank a card as subprocesses (``launch.py``);
the options after ``--trace`` are that rank mode's.

Caches (``TRITON_CACHE_DIR``, ``TORCH_EXTENSIONS_DIR``, ``CUDA_CACHE_PATH``)
go to ``.portbench_cache/`` in the checkout; the port builds its kernels in
``phastft_tpu_torch/_build/``, so only a checkout's first run compiles.
``setup_s`` counts that build; the result line's ``setup`` gives it apart
(``kernels_s``, ``kernels_built``).
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"


def environment() -> None:
    """Caches inside the checkout, one torch thread, the port's default
    chunking, and the checkout on sys.path."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ.pop("PHASTFT_TPU_DIST_CHUNKS", None)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, help="a whole number (rank mode: a list)")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, help=argparse.SUPPRESS)
    p.add_argument("--cell", help=argparse.SUPPRESS)
    p.add_argument("--parts", help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--system", default="port", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def seeds_of(text: str) -> list:
    return [int(s) for s in text.split(",")]


def ask_power_limits():
    """``nvidia-smi`` asked for every card's name and power limit, in the
    background (None where it cannot start)."""
    try:
        return subprocess.Popen(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def power_limits(asked, count: int) -> list:
    """The answer of ``ask_power_limits`` for the first ``count`` cards."""
    if asked is None:
        return ["nvidia-smi did not start"]
    try:
        out, _ = asked.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        asked.kill()
        asked.wait()
        return ["nvidia-smi did not answer"]
    return [line.strip() for line in out.splitlines() if line.strip()][:count]


def rank_main(args) -> int:
    """One rank of a cell of several chips: its parts into ``--parts``."""
    import torch
    import torch.distributed as dist

    from portbench import harness, spec

    cuda = args.device != "cpu"
    device = torch.device("cuda", args.rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    marks = [("start", T_PROCESS), ("imported", time.time())]
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{args.port}",
                            rank=args.rank, world_size=args.world,
                            device_id=device if cuda else None)
    try:
        flags = dist.new_group(backend="gloo") if cuda else None
        marks.append(("group", time.time()))

        def agree(last: bool):
            t = torch.tensor([int(last)])
            work = dist.broadcast(t, 0, group=flags, async_op=True)
            return lambda: work.wait() and bool(t.item())

        with open(args.cell) as f:
            cell = spec.Cell(**json.load(f))
        parts = harness.run_rank(
            cell, seeds_of(args.seed), args.seconds, bool(args.trace),
            device, rank=args.rank, system=args.system, agree=agree,
            reduce=lambda t: dist.all_reduce(t), barrier=lambda: dist.barrier(group=flags),
            marks=marks)
    finally:
        dist.destroy_process_group()
    with open(args.parts, "w") as f:
        json.dump(harness.finite(parts), f)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    if args.rank is not None:
        return rank_main(args)
    asked = ask_power_limits()
    try:
        return measure(args, asked)
    finally:
        if asked is not None and asked.poll() is None:
            asked.kill()
            asked.wait()


def measure(args, asked) -> int:
    """The run of one cell on this machine's cards, and its result line. A
    cell of several chips starts its ranks first, so that their start-up
    runs beside this process's."""
    from portbench import launch, spec

    cell = spec.cell(args.workload)
    seed = int(args.seed)
    with contextlib.ExitStack() as stack:
        ranks = None
        if cell.chips > 1:
            ranks = stack.enter_context(launch.Ranks(cell, [seed], args.seconds,
                                                     bool(args.trace)))
        import torch

        from portbench import harness

        marks = [("start", T_PROCESS), ("imported", time.time())]
        torch.set_num_threads(1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        kind = torch.cuda.get_device_name(0)
        marks.append(("cuda", time.time()))
        if ranks is None:
            torch.cuda.set_device(0)
            parts = harness.run_rank(cell, [seed], args.seconds, bool(args.trace),
                                     torch.device("cuda", 0), marks=marks)
        else:
            parts = [p[0] for p in ranks.wait()]
    limits = power_limits(asked, cell.chips)
    print(f"cards: {limits}", file=sys.stderr, flush=True)
    out, lines = harness.result(cell, parts, T_PROCESS, bool(args.trace), kind)
    for p in parts:
        phases = ", ".join(f"{k} {t - T_PROCESS:.3f}" for k, t in p["marks"])
        print(f"rank {p['rank']} set-up (s after the command's start): {phases}, window "
              f"{p['window_wall'] - T_PROCESS:.3f}; {p['setup']}", file=sys.stderr)
    print(f"{parts[0]['steps']} steps in {parts[0]['window_s']:.3f} s", file=sys.stderr)
    out["device"]["power_limit"] = limits
    out["checks"] = out.pop("checks")
    bad = sorted(set(harness.forbidden_modules()).union(*(p["forbidden"] for p in parts)))
    if bad:
        print(f"modules that may not be loaded: {bad}", file=sys.stderr)
        return 1
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(harness.finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
