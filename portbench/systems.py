"""What the window drives: the port (the system under test) and the control
that puts the reference in its place one precision lower.

Both take this process's input planes and return a tuple of new planes
in the configuration's dtype; ``forward`` / ``inverse`` are the calls a
step makes. The port is reached only through its public entries:
``fft_32_dit_with_planner`` / ``fft_64_dit_with_planner`` on one planner
built once, ``parallel.fft_distributed`` on the default process group, in
natural order and at its default chunking, or, for a real entry,
``r2c_fft_f{32,64}_with_planner`` (one real plane in, the n/2 + 1 bins
out) and ``c2r_fft_f{32,64}_with_planner`` (the bins in, one real plane
out) on one ``PlannerR2c32`` / ``PlannerR2c64``.
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
        self.real = config["entry"] == "real"
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
        bits = self.config["precision"][1:]
        cls = getattr(pt, ("PlannerR2c" if self.real else "PlannerDit") + bits)
        self.planner = cls(self.traffic["n"], device=self.device)
        sync(self.device)
        times["planner_s"] = time.perf_counter() - t0
        self._forward_dir = pt.Direction.Forward
        self._inverse_dir = pt.Direction.Reverse
        if self.real:
            self._r2c = getattr(pt, f"r2c_fft_f{bits}_with_planner")
            self._c2r = getattr(pt, f"c2r_fft_f{bits}_with_planner")
        elif self.traffic["ranks"] > 1:
            self._entry = importlib.import_module("phastft_tpu_torch.parallel").fft_distributed
        elif self.config["precision"] == "f64":
            self._entry = pt.fft_64_dit_with_planner
        else:
            self._entry = pt.fft_32_dit_with_planner
        return times

    def forward(self, *planes):
        if self.real:
            return tuple(self._r2c(*planes, self.planner))
        return self._entry(*planes, self._forward_dir, self.planner)

    def inverse(self, *planes):
        if self.real:
            return (self._c2r(*planes, self.planner),)
        return self._entry(*planes, self._inverse_dir, self.planner)

    def close(self) -> None:
        self.planner = self._entry = self._r2c = self._c2r = None


class Control:
    """The reference in the port's place, computed in the precision below
    the configuration's (float32 for float64, bfloat16 for float32), its
    outputs in the configuration's dtype. Across ranks each rank computes
    its own bins, the blocks' partial products summed by ``reduce``. For a
    real entry the forward gives the n/2 + 1 bins of the DFT of (x, 0),
    and the inverse rebuilds the whole Hermitian spectrum from them and
    keeps the real part of its inverse DFT."""

    def __init__(self, config: dict, traffic: dict, device, rank: int = 0,
                 reduce=None):
        self.traffic, self.rank, self.reduce = traffic, rank, reduce
        self.real = config["entry"] == "real"
        self.out_dtype = DTYPES[config["precision"]]
        self.dft = DFT(LOWER[config["precision"]], device)

    def build(self) -> dict:
        return {}

    def _call(self, re, im, inverse: bool, real_part: bool = False):
        """The reference in the port's place: (re, im) planes out, or with
        ``real_part`` the real plane alone; ``im`` None: a real input."""
        n, ranks = self.traffic["n"], self.traffic["ranks"]
        if ranks == 1 and self.traffic["batch"] > 1:
            ys = self.dft.rows(re, im, inverse)
            return tuple(y.to(self.out_dtype) for y in ys[:1 if real_part else 2])
        n2 = n >> first_factor_log(log2_exact(n))
        first_row = self.rank * (re.numel() // n2)
        ys = self.dft.signal(re.reshape(-1), None if im is None else im.reshape(-1), n,
                             first_row, self.reduce, inverse, self.out_dtype, real_part)
        return tuple(y.view(re.shape) for y in ys)

    def _hermitian(self, re, im):
        """The n bins of each row whose bins 0..n/2 (re, im) hold, bin k >
        n/2 conj(X[n - k]), in the control's dtype."""
        n, h = self.traffic["n"], re.shape[-1]
        fr = torch.empty(*re.shape[:-1], n, dtype=self.dft.dtype, device=re.device)
        fi = torch.empty_like(fr)
        fr[..., :h], fi[..., :h] = re, im
        fr[..., h:] = fr[..., 1:n // 2].flip(-1)
        fi[..., h:] = -fi[..., 1:n // 2].flip(-1)
        return fr, fi

    def forward(self, *planes):
        if not self.real:
            return self._call(*planes, False)
        h = self.traffic["n"] // 2 + 1
        return tuple(y[..., :h].clone(memory_format=torch.contiguous_format)
                     for y in self._call(planes[0], None, False))

    def inverse(self, *planes):
        if not self.real:
            return self._call(*planes, True)
        return self._call(*self._hermitian(*planes), True, real_part=True)

    def close(self) -> None:
        self.dft = None
