"""What the window drives: the port (the system under test) and the control
that puts the reference in its place one precision lower.

Both take this process's input planes and return new planes of the same
shape and dtype; ``forward`` / ``inverse`` are the calls a step makes.
The port is reached only through its public entries:
``fft_32_dit_with_planner`` / ``fft_64_dit_with_planner`` on one planner
built once, or ``parallel.fft_distributed`` on the default process group,
in natural order and at its default chunking.
"""

from __future__ import annotations

import importlib
import time

import torch

from .reference import DFT, first_factor_log, log2_exact

DTYPES = {"f32": torch.float32, "f64": torch.float64}
#: The precision one step below each stated one, for the control.
LOWER = {"f32": torch.bfloat16, "f64": torch.float32}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Port:
    """phastft_tpu_torch on ``device``: one planner for the cell's n, built
    by ``build``."""

    def __init__(self, config: dict, traffic: dict, device):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.planner = None

    def build(self) -> dict:
        """Load the kernels (building them where the checkout has none),
        then build the planner; the seconds of each, and whether the
        kernels were built."""
        pt = importlib.import_module("phastft_tpu_torch")
        times = {}
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            build = importlib.import_module("phastft_tpu_torch.ops._build")
            build.library()
            times["kernels_built"] = bool(build.build_log())
        times["kernels_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cls = pt.PlannerDit64 if self.config["precision"] == "f64" else pt.PlannerDit32
        self.planner = cls(self.traffic["n"], device=self.device)
        sync(self.device)
        times["planner_s"] = time.perf_counter() - t0
        self._forward_dir = pt.Direction.Forward
        self._inverse_dir = pt.Direction.Reverse
        if self.traffic["ranks"] > 1:
            self._entry = importlib.import_module("phastft_tpu_torch.parallel").fft_distributed
        elif self.config["precision"] == "f64":
            self._entry = pt.fft_64_dit_with_planner
        else:
            self._entry = pt.fft_32_dit_with_planner
        return times

    def forward(self, re, im):
        return self._entry(re, im, self._forward_dir, self.planner)

    def inverse(self, re, im):
        return self._entry(re, im, self._inverse_dir, self.planner)

    def close(self) -> None:
        self.planner = self._entry = None


class Control:
    """The reference in the port's place, computed in the precision below
    the configuration's (float32 for float64, bfloat16 for float32), its
    outputs in the configuration's dtype. Across ranks each rank computes
    its own bins, the blocks' partial products summed by ``reduce``."""

    def __init__(self, config: dict, traffic: dict, device, rank: int = 0,
                 reduce=None):
        self.traffic, self.rank, self.reduce = traffic, rank, reduce
        self.out_dtype = DTYPES[config["precision"]]
        self.dft = DFT(LOWER[config["precision"]], device)

    def build(self) -> dict:
        return {}

    def _call(self, re, im, inverse: bool):
        n, ranks = self.traffic["n"], self.traffic["ranks"]
        if ranks == 1 and self.traffic["batch"] > 1:
            yr, yi = self.dft.rows(re, im, inverse)
            return yr.to(self.out_dtype), yi.to(self.out_dtype)
        n2 = n >> first_factor_log(log2_exact(n))
        first_row = self.rank * (re.numel() // n2)
        yr, yi = self.dft.signal(re.reshape(-1), im.reshape(-1), n, first_row,
                                 self.reduce, inverse, self.out_dtype)
        return yr.view(re.shape), yi.view(re.shape)

    def forward(self, re, im):
        return self._call(re, im, False)

    def inverse(self, re, im):
        return self._call(re, im, True)

    def close(self) -> None:
        self.dft = None
