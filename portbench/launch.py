"""Cells that span several cards: the ranks as subprocesses of the one
command, one a card, meeting on ``tcp://127.0.0.1`` at a free port.

Each rank runs ``run.py`` in its rank mode on the cell this process hands
it in a file under TMPDIR, and writes its parts to another that this
process reads; both are removed. A rank's output goes to this
process's standard error, so that the result line stays the last line of
standard output. A rank that fails, or outlives the deadline, fails the
run, and every rank still running is killed and waited for.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import asdict
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"
POLL_S = 0.2


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _temp(prefix: str) -> str:
    fd, path = tempfile.mkstemp(prefix=prefix, suffix=".json")
    os.close(fd)
    return path


class Ranks:
    """The ranks of ``cell`` (a ``spec.Cell``), one process each on its
    ``traffic["ranks"]`` ranks, started at once; ``wait`` gives their
    parts, ``close`` (also on leaving a ``with``) stops what still runs and
    removes the files."""

    def __init__(self, cell, seeds, seconds: float, trace_on: bool, *, device: str = "cuda",
                 system: str = "port", deadline_s: float = 1100.0):
        self.deadline = time.monotonic() + deadline_s
        self.cell_file = _temp("portbench-cell-")
        self.files, self.procs = [], []
        world = cell.traffic["ranks"]
        port = free_port()
        try:
            with open(self.cell_file, "w") as f:
                json.dump(asdict(cell), f)
            for rank in range(world):
                path = _temp(f"portbench-rank{rank}-")
                self.files.append(path)
                cmd = [sys.executable, str(RUN), "--workload", cell.name,
                       "--seed", ",".join(str(s) for s in seeds), "--seconds", str(seconds),
                       "--trace", str(int(trace_on)), "--rank", str(rank),
                       "--world", str(world), "--port", str(port), "--cell", self.cell_file,
                       "--parts", path, "--device", device, "--system", system]
                self.procs.append(subprocess.Popen(cmd, stdout=sys.stderr, stderr=sys.stderr))
        except BaseException:
            self.close()
            raise

    def wait(self) -> list:
        """Every rank's parts, rank 0 first (a list of per-seed lists)."""
        procs = self.procs
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0]} exited with {procs[bad[0]].returncode}")
            if time.monotonic() > self.deadline:
                raise RuntimeError("ranks still running past the deadline")
            time.sleep(POLL_S)
        bad = [i for i, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"rank {bad[0]} exited with {procs[bad[0]].returncode}")
        parts = []
        for path in self.files:
            with open(path) as f:
                parts.append(json.load(f))
        return parts

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for path in self.files + [self.cell_file]:
            if os.path.exists(path):
                os.remove(path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def run_ranks(cell, seeds, seconds: float, trace_on: bool, **kwargs) -> list:
    """``Ranks(...).wait()``, the ranks stopped after."""
    with Ranks(cell, seeds, seconds, trace_on, **kwargs) as ranks:
        return ranks.wait()
