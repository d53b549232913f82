"""Planners: the plan and its precomputed tables, resident on the device.

Counterpart of the JAX package's ``planner.py``. A planner is built once
per size and reused across calls and directions. The f32 planner builds
only the tables its plan's kernels read, under the JAX planner's keys and
layouts:

* a tiny plan (n < 128): none;
* a leaf plan of n1 = 1..256 (n = 2^7..2^15): ``mxu{n1}`` (F(n1), F(128)
  with their Karatsuba sums and the transposed correction, zero-size
  placeholders at n1 = 1) and ``leaf{n1}`` (the (n1, 128) correction,
  n1 >= 2); at n = 2^16 (n1 = 512): ``mxu3_512`` only;
* a split plan: ``pcolT{n1}x{n2}`` (the column pass's T2 split-twiddle
  table) and ``leafT{n2}`` (the row pass's DFT matrices and correction),
  under the JAX planner's gates.

Twiddles are exact f64 angles rounded once to f32 (the reference's
accuracy contract).

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
from .ops.mxu import mxu_leaf_tables3_host, mxu_leaf_tables_host
from .ops.stockham import LANES, leaf_correction_host

__all__ = [
    "Direction",
    "PlannerMode",
    "PlannerDit32",
    "PlannerDit64",
    "resolve_device",
]

#: The largest size the port runs: the top of the fused two-pass window.
MAX_LOG_N = 25

#: Leaf factor of the three-factor leaf (n = 2^16 = 128 * 4 * 128), the
#: only leaf past 2^15 that the default leaf rule plans.
LEAF3_N1 = 512


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


def _leaf_tables_host(n1: int, dtype_name: str):
    """{key: host arrays} of the tables a ("leaf", n1) plan's kernel reads,
    as the JAX planner holds them."""
    if n1 == LEAF3_N1:
        return {f"mxu3_{n1}": mxu_leaf_tables3_host(LANES, LANES, dtype_name)}
    f1, f2, corr = mxu_leaf_tables_host(n1, dtype_name)
    zero = np.zeros((0,), np.dtype(dtype_name))
    out = {f"mxu{n1}": (*(f1 or (zero,) * 3), *f2, *(corr or (zero,) * 2))}
    if n1 > 1:
        out[f"leaf{n1}"] = leaf_correction_host(n1, LANES, dtype_name)
    return out


def _table_shapes(plan):
    """{key: [shape of each array]} of the tables the plan needs."""
    if plan[0] == "leaf":
        return {k: [a.shape for a in v]
                for k, v in _leaf_tables_host(plan[1], "float32").items()}
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
    """f32 DIT planner for n = 1..2^25 on ``device`` (None = "cuda")."""

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
        if self.plan[0] == "leaf":
            for key, arrays in _leaf_tables_host(self.plan[1],
                                                 self.dtype.name).items():
                self.leaf_corrs[key] = _to_device(arrays, self.device)
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
        if self.log_n > MAX_LOG_N:
            raise not_ported(f"f32 n = 2^{self.log_n}", "nested")
        self.device = resolve_device(device)
        self.options = (
            options if options is not None
            else Options.guess_options(n, self.dtype)
        )
        self.plan = plan_rows(n, self.options.leaf_fft_size)
        if self.plan[0] == "leaf" and self.plan[1] > LEAF3_N1:
            raise not_ported(f"a leaf of {n} points", "big_leaf")

    @classmethod
    def from_numpy_tables(cls, n: int, tables, device=None,
                          options: Optional[Options] = None):
        """A planner for size ``n`` on ``device`` whose tables are exactly
        the given arrays. ``tables`` maps each key the plan reads
        (``mxu{n1}``, ``leaf{n1}`` or ``mxu3_512`` for a leaf plan,
        ``pcolT{n1}x{n2}`` and ``leafT{n2}`` for a split plan) to its
        arrays, as the JAX planner's ``leaf_corrs`` holds them (other keys
        are ignored). Raises if a table the plan needs is missing, of
        another shape, or not f32."""
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
