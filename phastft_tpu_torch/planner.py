"""Planners: the plan and its precomputed tables, resident on the device.

Counterpart of the JAX package's ``planner.py``. A planner is built once
per size and reused across calls and directions. The f32 planner builds
only the tables of the fused two-pass pipeline: ``pcolT{n1}x{n2}`` (the
column pass's T2 split-twiddle table) and ``leafT{n2}`` (the row pass's
DFT matrices and correction), under the JAX planner's gates. Twiddles are
exact f64 angles rounded once to f32 (the reference's accuracy contract).

``PlannerDit32.from_numpy_tables`` builds a planner on tables handed over
as numpy arrays, for instance the JAX planner's ``leaf_corrs``, so both
packages compute from the same bits.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from .errors import ensure_power_of_two, not_ported
from .options import Options
from .ops.colfft import col_split_tables_host, col_tile3d
from .ops.fourstep import plan_rows
from .ops.leaft import leaft_tables_host
from .ops.stockham import LANES

__all__ = [
    "Direction",
    "PlannerMode",
    "PlannerDit32",
    "PlannerDit64",
    "resolve_device",
]

#: The sizes the port runs: the fused two-pass window of the f32 plans.
MIN_LOG_N = 17
MAX_LOG_N = 25


class Direction(enum.Enum):
    """Transform direction."""

    Forward = 1
    Reverse = -1


class PlannerMode(enum.Enum):
    """Plan-construction mode. ``Tune`` is not ported yet."""

    Heuristic = 0
    Tune = 1


def resolve_device(device=None) -> torch.device:
    """The device a planner and its transforms run on. ``None`` means
    ``"cuda"``; with no CUDA device present that raises. It never falls
    back to the CPU: the CPU runs only when asked for (``"cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain torch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _two_pass_levels(plan):
    """(n1, n2) of every split level that gets the fused two-pass tables,
    under the JAX planner's gates."""
    node = plan
    while node[0] == "split":
        _, sn1, sub, sn2 = node
        if (
            sub[0] == "leaf"
            and sn1 % LANES == 0
            and LANES <= sn1 <= 2048
            and sn2 % LANES == 0
            and 8 <= sn2 // LANES <= 128
        ):
            yield sn1, sn2
        node = sub


def _table_shapes(plan):
    """{key: [shape of each array]} of the tables the plan needs."""
    out = {}
    for sn1, sn2 in _two_pass_levels(plan):
        a = sn2 // LANES
        out[f"pcolT{sn1}x{sn2}"] = [(sn1, col_tile3d(sn1, sn2))] * 2
        out[f"leafT{sn2}"] = (
            [(a, a)] * 3 + [(LANES, LANES)] * 3 + [(a, LANES)] * 2
        )
    return out


def _to_device(arrays, device):
    # a copy: the planner never shares memory with the (cached) host tables
    return tuple(torch.from_numpy(np.array(a, copy=True)).to(device)
                 for a in arrays)


class PlannerDit32:
    """f32 DIT planner for n = 2^17..2^25 on ``device`` (None = "cuda")."""

    dtype = np.dtype(np.float32)

    def __init__(
        self,
        n: int,
        mode: PlannerMode = PlannerMode.Heuristic,
        options: Optional[Options] = None,
        device=None,
    ):
        self._setup(n, mode, options, device)
        self.leaf_corrs = {}
        for sn1, sn2 in _two_pass_levels(self.plan):
            self.leaf_corrs[f"pcolT{sn1}x{sn2}"] = _to_device(
                col_split_tables_host(sn1, sn2, self.dtype.name,
                                      t=col_tile3d(sn1, sn2)),
                self.device,
            )
            self.leaf_corrs[f"leafT{sn2}"] = _to_device(
                leaft_tables_host(sn2, self.dtype.name), self.device
            )

    def _setup(self, n, mode, options, device):
        self.log_n = ensure_power_of_two(n)
        self.n = n
        self.mode = mode
        if mode is PlannerMode.Tune:
            raise not_ported("PlannerMode.Tune", "tune")
        if self.log_n < MIN_LOG_N:
            raise not_ported(f"f32 n = 2^{self.log_n}", "leaf")
        if self.log_n > MAX_LOG_N:
            raise not_ported(f"f32 n = 2^{self.log_n}", "nested")
        self.device = resolve_device(device)
        self.options = (
            options if options is not None
            else Options.guess_options(n, self.dtype)
        )
        self.plan = plan_rows(n, self.options.leaf_fft_size)

    @classmethod
    def from_numpy_tables(cls, n: int, tables, device=None,
                          options: Optional[Options] = None):
        """A planner for size ``n`` on ``device`` whose tables are exactly
        the given arrays. ``tables`` maps ``pcolT{n1}x{n2}`` to (t2r, t2i)
        and ``leafT{n2}`` to its 8 arrays, as the JAX planner's
        ``leaf_corrs`` holds them (other keys are ignored). Raises if a
        table the plan needs is missing, of another shape, or not f32."""
        self = cls.__new__(cls)
        self._setup(n, PlannerMode.Heuristic, options, device)
        self.leaf_corrs = {}
        for key, shapes in _table_shapes(self.plan).items():
            if key not in tables:
                raise KeyError(f"table {key!r} missing for n = {n}")
            arrays = [np.asarray(a) for a in tables[key]]
            if [a.shape for a in arrays] != shapes:
                raise ValueError(f"table {key!r}: expected shapes {shapes}")
            if any(a.dtype != np.float32 for a in arrays):
                raise TypeError(f"table {key!r} must be float32")
            self.leaf_corrs[key] = _to_device(arrays, self.device)
        return self


class PlannerDit64:
    """f64 DIT planner: not ported yet."""

    dtype = np.dtype(np.float64)

    def __init__(self, n: int, *args, **kwargs):
        ensure_power_of_two(n)
        raise not_ported("PlannerDit64 (f64 transforms)", "f64")
