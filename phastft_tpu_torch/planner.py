"""Planners: the plan and its precomputed tables, resident on the device.

Counterpart of the JAX package's ``planner.py``. A planner is built once
per size and reused across calls and directions. The f32 planner builds
only the tables its plan's kernels read, under the JAX planner's keys and
layouts:

* a tiny plan (n < 128): none;
* a leaf plan of n1 = 1..256 (n = 2^7..2^15): ``mxu{n1}`` (F(n1), F(128)
  with their Karatsuba sums and the transposed correction, zero-size
  placeholders at n1 = 1) and ``leaf{n1}`` (the (n1, 128) correction,
  n1 >= 2); at n = 2^16 and 2^17 (n1 = 512, 1024) ``mxu3_{n1}`` only; past
  2^17 (``Options.leaf_fft_size`` > 2^17) ``mxu1``, the tables of the
  leaf's 128-point rows (its column pass builds its own, ``ops/longcol``);
* every split level that runs the fused two-pass pipeline (the JAX
  planner's gates): ``pcolT{n1}x{n2}`` (the column pass's T2 split-twiddle
  table) and ``leafT{n2}`` (the row pass's DFT matrices and correction);
* every other split level (classic): ``pcol{n1}x{n2}`` (the T2 table
  factored on the classic slab width, n2 columns wide below 128: the rows
  of a split planned with ``leaf_fft_size`` < 128), and when the innermost
  level is classic the leaf tables of the plan's leaf, as for a leaf
  plan.

Twiddles are exact f64 angles rounded once to f32 (the reference's
accuracy contract).

The f64 planner holds no f32 tables. It builds, each on first use, the
state of the engine a transform runs on it: ``native_state``, the native
engine's f64 tables under the JAX planner's keys (``split{n1}x{n2}`` of
every split level, ``leaf{n1}`` of the plan's leaf up to 2^16 points), and
``dd_state``, the df64 engine's: the dd radix tables of a tiny plan or of
the tiny rows under a split, the dd corrections of the plan's leaf (up to
2^16 points) and split levels, and with ``f64_engine="df64-oz"`` the
Ozaki slice tables of every split level inside the oz kernels' window
(``ops/ozdd.oz_window``).

``PlannerDit32.tables_for(plan, leaf_kernel)`` builds, once, the tables
of another plan on the same options (the row plan of a distributed
shard), or of a plan whose leaf runs the opt-in hybrid kernel
(``leaf_kernel="hybrid"``: ``mxu{n1}`` and ``leaf{n1}`` at n1 = 512 and
1024, which no default kernel reads);
``PlannerDit64.native_tables_for(plan)`` does the same for the native
engine's tables.

``PlannerDit32.from_numpy_tables`` and ``PlannerDit64.from_numpy_tables``
build a planner on tables handed over as numpy arrays, for instance the
JAX planner's ``leaf_corrs``, ``dd_state`` or native state
(``fast_tables``, ``leaf_corrs``), so both packages compute from the same
bits.

Both DIT planners also hold, each built on first use, the staged
strategy's state as the JAX planner holds it: ``stage_twiddles`` (stage s:
W_{2^(s+1)}^k for k < 2^s, exact f64 angles rounded once) and ``bitrev``
(the bit-reversal index table); ``num_twiddles()`` counts the former.

``PlannerMode.Tune`` (``tune.py``) times candidate options on the
planner's device and keeps the fastest, cached in process and on disk;
explicit ``options`` win over it, as in the JAX package.

``PlannerR2c32`` / ``PlannerR2c64`` plan a real transform of n points: an
n/2 DIT planner of the same dtype and device (on ``inner_options``; with
``PlannerMode.Tune`` and none given, the winner of the whole-R2C race,
``tune.tune_r2c_options``) and the untangle table 0.5 W_n^k, k = 0..n/4,
which both directions read; the JAX planner's full-length table for
k = 0..n/2 - 1 is built on first access, and no transform reads it.
"""

from __future__ import annotations

import enum
import functools
from typing import Optional

import numpy as np
import torch

from .errors import NonPowerOfTwoError, ensure_power_of_two
from .options import Options
from .ops.bitrev import bit_reverse_indices
from .ops.colfft import col_split_tables_host, col_tile, col_tile3d
from .ops.dd import MAX_LEAF_N1 as DD_MAX_LEAF_N1
from .ops.dd import dd_col_tables_host
from .ops.df64 import dd_leaf_correction_host, dd_radix_tables_host
from .ops.fourstep import LEAF_KERNEL_N1, fused_two_pass, plan_rows, split_levels
from .ops.ozdd import (
    oz_window,
    ozcol_tables_host,
    ozleaft_tables_host,
    slice_count,
)
from .ops.leaft import leaft_tables_host
from .ops.leaf import HYBRID_MAX_N1, LEAF3_AS
from .ops.mxu import mxu_leaf_tables3_host, mxu_leaf_tables_host
from .ops.native import MAX_LEAF_N, dif_twiddles_host
from .ops.r2c import r2c_twiddles
from .ops.stockham import LANES, leaf_correction_host, split_correction_host
from .tracing import span, traced

__all__ = [
    "Direction",
    "PlannerMode",
    "PlannerDit32",
    "PlannerDit64",
    "PlannerR2c32",
    "PlannerR2c64",
    "resolve_device",
]

#: Leaf factors n1 = 4a of the three-factor leaf ``leaf3`` (n = a * 4 * 128):
#: 512 (2^16, the only leaf past 2^15 the default leaf rule plans) and 1024
#: (2^17, ``Options.leaf_fft_size = 2^17``), the JAX planner's ``mxu3_{n1}``.
LEAF3_N1 = frozenset(4 * a for a in LEAF3_AS)


class Direction(enum.Enum):
    """Transform direction."""

    Forward = 1
    Reverse = -1


class PlannerMode(enum.Enum):
    """Plan-construction mode. ``Heuristic`` takes
    ``Options.guess_options``; ``Tune`` times every candidate plan on the
    planner's device and keeps the fastest (``tune.py``)."""

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


def _leaf_tables_host(n1: int, dtype_name: str, hybrid: bool = False):
    """{key: host arrays} of the tables a ("leaf", n1) plan's kernel reads
    (``leaf``, ``leaf3``, or with ``hybrid`` the hybrid leaf up to n1 = 1024;
    past n1 = 1024 the ``leaf`` tables of its 128-point rows), as the JAX
    planner holds them."""
    if n1 > LEAF_KERNEL_N1:
        return _leaf_tables_host(1, dtype_name)
    if n1 in LEAF3_N1 and not (hybrid and n1 <= HYBRID_MAX_N1):
        return {f"mxu3_{n1}": mxu_leaf_tables3_host(n1 // 4, LANES, dtype_name)}
    f1, f2, corr = mxu_leaf_tables_host(n1, dtype_name)
    zero = np.zeros((0,), np.dtype(dtype_name))
    out = {f"mxu{n1}": (*(f1 or (zero,) * 3), *f2, *(corr or (zero,) * 2))}
    if n1 > 1:
        out[f"leaf{n1}"] = leaf_correction_host(n1, LANES, dtype_name)
    return out


def _tables_host(plan, dtype_name: str, hybrid: bool = False):
    """{key: host arrays} of every table the plan's kernels read, as the
    JAX planner holds them; ``hybrid``: the leaf's for the hybrid kernel."""
    out = {}
    inner = plan
    leaf_rows = True  # the innermost plan runs through leaf / leaf3
    for n1, inner, n2 in split_levels(plan):
        if fused_two_pass(n1, inner, n2):
            out[f"pcolT{n1}x{n2}"] = col_split_tables_host(
                n1, n2, dtype_name, t=col_tile3d(n1, n2))
            out[f"leafT{n2}"] = leaft_tables_host(n2, dtype_name)
            leaf_rows = False
        else:
            out[f"pcol{n1}x{n2}"] = col_split_tables_host(
                n1, n2, dtype_name, t=col_tile(n1, n2))
    if inner[0] == "leaf" and leaf_rows:
        out.update(_leaf_tables_host(inner[1], dtype_name, hybrid))
    return out


def _twiddle_table(m: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """(cos, -sin) of W_m^k = exp(-2 pi i k / m) for k in [0, m/2), from
    exact f64 angles cast once to ``dtype`` (the JAX planner's table)."""
    k = np.arange(m // 2, dtype=np.float64)
    ang = -2.0 * np.pi * k / float(m)
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@functools.lru_cache(maxsize=4)
def _stage_twiddles_cached(n: int, dtype_name: str):
    """Host tables of the staged strategy: stage s (chunk 2^(s+1)) holds
    W_{2^(s+1)}^k for k < 2^s; n - 1 complex entries in all."""
    return tuple(_twiddle_table(1 << (s + 1), np.dtype(dtype_name))
                 for s in range(n.bit_length() - 1))


def _to_device(arrays, device):
    # a copy: the planner never shares memory with the (cached) host tables
    return tuple(torch.from_numpy(np.array(a, copy=True)).to(device)
                 for a in arrays)


class _PlannerDitBase:
    """What both planners share: the size, the device, the options (given,
    tuned or guessed), the plan, and the staged strategy's state."""

    dtype: np.dtype

    def _setup(self, n, mode, options, device):
        self.log_n = ensure_power_of_two(n)
        self.n = n
        self.mode = mode
        self.device = resolve_device(device)
        self._derived = {}
        if options is not None:
            self.options = options
        elif mode is PlannerMode.Tune:
            from .tune import tune_options  # tune builds planners itself

            self.options = tune_options(n, self.dtype, self.device)
        else:
            self.options = Options.guess_options(n, self.dtype)
        self.plan = plan_rows(n, self.options.leaf_fft_size)
        self._stage_twiddles = None
        self._bitrev = None

    @property
    def stage_twiddles(self):
        """The staged strategy's tables on the planner's device, built on
        first use: a tuple of (wre, wim) per stage s, each of length 2^s, in
        the planner's dtype."""
        if self._stage_twiddles is None:
            self._stage_twiddles = tuple(
                _to_device(stage, self.device)
                for stage in _stage_twiddles_cached(self.n, self.dtype.name))
        return self._stage_twiddles

    @property
    def bitrev(self):
        """The bit-reversal index table (int32) on the planner's device,
        built on first use."""
        if self._bitrev is None:
            self._bitrev = torch.from_numpy(bit_reverse_indices(self.n)).to(self.device)
        return self._bitrev

    def num_twiddles(self) -> int:
        """Complex entries of ``stage_twiddles`` (2^0 + ... + 2^(log n - 1)
        = n - 1), counted without building them."""
        return self.n - 1

    @classmethod
    def new(cls, n: int, device=None):
        """Constructor alias of the reference's ``Planner::new``."""
        return cls(n, device=device)

    @classmethod
    def with_mode(cls, n: int, mode: PlannerMode, device=None):
        """A planner of ``mode``: ``PlannerMode.Tune`` times the candidate
        options on ``device`` (``tune.tune_options``)."""
        return cls(n, mode, device=device)


class PlannerDit32(_PlannerDitBase):
    """f32 DIT planner for any power of two n on ``device`` (None =
    "cuda"). One H100 holds a transform up to n = 2^31 (the input and two
    more pairs of 16 GiB); past it the planner plans, and the transform
    fails with ``torch.OutOfMemoryError`` where the card cannot hold it."""

    dtype = np.dtype(np.float32)

    @traced("phastft.plan")
    def __init__(
        self,
        n: int,
        mode: PlannerMode = PlannerMode.Heuristic,
        options: Optional[Options] = None,
        device=None,
    ):
        self._setup(n, mode, options, device)
        self.leaf_corrs = {
            key: _to_device(arrays, self.device)
            for key, arrays in _tables_host(self.plan, self.dtype.name).items()
        }

    def tables_for(self, plan, leaf_kernel=None):
        """The tables ``ops/fourstep.fft_rows`` reads for ``plan`` (a plan
        derived from this planner's options, such as a distributed shard's
        row plan) with the resolved ``leaf_kernel``, on the planner's
        device; built on first use and kept, and ``leaf_corrs`` itself for
        the planner's own plan on the default leaf kernels."""
        hybrid = leaf_kernel == "hybrid"
        if plan == self.plan and not hybrid:
            return self.leaf_corrs
        if (plan, hybrid) not in self._derived:
            with span("phastft.plan"):
                host = _tables_host(plan, self.dtype.name, hybrid)
                self._derived[plan, hybrid] = {
                    key: self.leaf_corrs.get(key) or _to_device(arrays, self.device)
                    for key, arrays in host.items()
                }
        return self._derived[plan, hybrid]

    @classmethod
    def from_numpy_tables(cls, n: int, tables, device=None,
                          options: Optional[Options] = None):
        """A planner for size ``n`` on ``device`` whose tables are exactly
        the given arrays. ``tables`` maps each key the plan reads
        (``mxu{n1}``, ``leaf{n1}`` or ``mxu3_{n1}`` for leaf rows, ``mxu1``
        for the rows of a leaf past 2^17 points,
        ``pcolT{n1}x{n2}`` and ``leafT{n2}`` for a fused split level,
        ``pcol{n1}x{n2}`` for a classic one) to its arrays, as the JAX
        planner's ``leaf_corrs`` holds them. The hybrid leaf's ``mxu{n1}``
        and ``leaf{n1}`` at n1 = 512 and 1024 are taken too when both are
        present (as ``tables_for``'s hybrid tables); other keys are
        ignored. Raises if a table the plan needs is missing, of another
        shape, or not f32."""
        self = cls.__new__(cls)
        self._setup(n, PlannerMode.Heuristic, options, device)
        name = self.dtype.name
        # the planner's own tables are built only to name the keys and the
        # shapes: one walker of the plan, at the cost of a second build
        own = _tables_host(self.plan, name)
        hybrid = _tables_host(self.plan, name, True)
        extra = {k: v for k, v in hybrid.items() if k not in own}
        if not extra.keys() <= tables.keys():
            extra = {}
        carried = {}
        for key, want in {**own, **extra}.items():
            if key not in tables:
                raise KeyError(f"table {key!r} missing for n = {n}")
            arrays = [np.asarray(a) for a in tables[key]]
            shapes = [a.shape for a in want]
            if [a.shape for a in arrays] != shapes:
                raise ValueError(f"table {key!r}: expected shapes {shapes}")
            if any(a.dtype != np.float32 for a in arrays):
                raise TypeError(f"table {key!r} must be float32")
            carried[key] = _to_device(arrays, self.device)
        self.leaf_corrs = {key: carried[key] for key in own}
        if extra:
            self._derived[self.plan, True] = {key: carried[key] for key in hybrid}
        return self


def _dd_tables_host(plan, engine=None):
    """(radix tables, corrs) of the df64 engine for ``plan`` as host
    arrays, under the JAX planner's keys, holding only what
    ``fourstep.fft_rows_dd`` reads: for a tiny plan the
    ``dd_radix_tables_host`` entries up to its length and no correction;
    else no radix table and, for every split level, ``ozcol{n1}x{n2}`` and
    ``ozleafT{n2}`` (the flat tuples of ``ozcol_tables_host`` and
    ``ozleaft_tables_host``) when ``engine`` starts with "df64-oz" and the
    level is in ``oz_window``, else ``ddpcol{n1}x{n2}``; ``ddleaf{n1}`` for
    the plan's leaf factor (n1 = 2..512) unless an oz level runs it; and the
    radix tables up to the length of the innermost plan when it is tiny,
    under a split planned with ``leaf_fft_size`` < 128."""
    if plan[0] == "tiny":
        return dd_radix_tables_host(plan[1]), {}
    oz = (engine or "").startswith("df64-oz")
    corrs = {}
    inner = plan
    leaf_read = True
    for n1, inner, n2 in split_levels(plan):
        if oz and oz_window(n1, inner, n2):
            corrs[f"ozcol{n1}x{n2}"] = ozcol_tables_host(n1, n2)
            corrs[f"ozleafT{n2}"] = ozleaft_tables_host(n2)
            leaf_read = False
        else:
            _, p1, p2 = dd_col_tables_host(n1, n2)
            corrs[f"ddpcol{n1}x{n2}"] = (p1, p2)
    if inner[0] == "tiny":
        return dd_radix_tables_host(inner[1]), corrs
    if inner[0] == "leaf" and 1 < inner[1] <= DD_MAX_LEAF_N1 and leaf_read:
        corrs[f"ddleaf{inner[1]}"] = dd_leaf_correction_host(inner[1], LANES)
    return {}, corrs


def _oz_to_device(key, arrays, device):
    """An oz table set on ``device``: its slice arrays as bfloat16 (exact:
    integers |s| <= 128), the dd tables as float32."""
    n_slices = slice_count(key)
    out = _to_device(arrays, device)
    return tuple(a.to(torch.bfloat16) if i < n_slices else a
                 for i, a in enumerate(out))


def _native_tables_host(plan):
    """{key: (re, im, ...)} of what the native kernels read for ``plan``,
    as f64 host arrays under the JAX planner's keys and layouts:
    ``split{n1}x{n2}`` = (T1 re, T1 im, T2 re, T2 im) of every split level
    and ``leaf{n1}`` = (re, im) of the plan's leaf factor (n1 = 2..512; a
    leaf past 2^16 points builds its column pass's own, ``ops/longcol``);
    and, under keys of the port's own (the JAX package holds no such table),
    ``dif{m}`` = (pairs,), the (m/2, 2) step twiddles of every DFT size m
    a kernel of the plan runs (``ops/native.dif_twiddles_host``)."""
    out = {}
    sizes = set()
    inner = plan
    for n1, inner, n2 in split_levels(plan):
        out[f"split{n1}x{n2}"] = split_correction_host(n1, n2, "float64")[1:]
        sizes.add(n1)
    if inner[0] == "leaf":
        n1 = inner[1]
        if 1 < n1 and n1 * LANES <= MAX_LEAF_N:
            out[f"leaf{n1}"] = leaf_correction_host(n1, LANES, "float64")
            sizes.add(n1)
        sizes.add(LANES)
    elif inner[1] > 1:
        sizes.add(inner[1])
    for m in sorted(sizes):
        out[f"dif{m}"] = (dif_twiddles_host(m),)
    return out


class PlannerDit64(_PlannerDitBase):
    """f64 DIT planner for any power of two n on ``device`` (None =
    "cuda"), for the native and the df64 (paired-f32) engines. One H100
    holds a native transform up to n = 2^30 (three pairs of 16 GiB).

    ``native_state`` = {key: tensors}, built on first use and kept on the
    planner's device: the native engine's tables (``_native_tables_host``).

    ``dd_state`` = (tables, corrs), built on first use and kept on the
    planner's device, holding what the transform reads under the JAX
    planner's keys and layouts: for a tiny plan (n < 128) the dd Stockham
    step twiddles ``{(cur, R): ...}``; else the dd corrections
    ``ddleaf{n1}`` of the plan's leaf (a 4-tuple) and ``ddpcol{n1}x{n2}``
    of every split level (two 4-tuples). With ``f64_engine="df64-oz"`` a
    split level inside ``ops/ozdd.oz_window`` holds ``ozcol{n1}x{n2}`` and
    ``ozleafT{n2}`` instead (flat tuples, the slice arrays as bfloat16),
    and the transform runs it on the oz kernels. The default options
    (``guess_options``) carry ``f64_engine=None``, the native engine, as
    does engine-less ``Options()``."""

    dtype = np.dtype(np.float64)

    def __init__(
        self,
        n: int,
        mode: PlannerMode = PlannerMode.Heuristic,
        options: Optional[Options] = None,
        device=None,
    ):
        with span("phastft.plan"):
            self._setup(n, mode, options, device)
        self._dd_state = None
        self._native_state = None

    @property
    def native_state(self):
        if self._native_state is None:
            with span("phastft.plan"):
                self._native_state = {
                    key: _to_device(arrays, self.device)
                    for key, arrays in _native_tables_host(self.plan).items()}
        return self._native_state

    def native_tables_for(self, plan):
        """The native tables ``ops/fourstep.fft_rows_native`` reads for
        ``plan`` (a plan on this planner's leaf, such as a distributed
        shard's row plan), on the planner's device: built on first use and
        kept, and ``native_state`` itself for the planner's own plan."""
        if plan == self.plan:
            return self.native_state
        if plan not in self._derived:
            with span("phastft.plan"):
                self._derived[plan] = {
                    key: _to_device(arrays, self.device)
                    for key, arrays in _native_tables_host(plan).items()}
        return self._derived[plan]

    @property
    def dd_state(self):
        if self._dd_state is None:
            with span("phastft.plan"):
                self._dd_state = self._dd_to_device(
                    *_dd_tables_host(self.plan, self.options.f64_engine))
        return self._dd_state

    def _dd_to_device(self, tables, corrs):
        dev = self.device
        return (
            {key: tuple(_to_device(digit, dev) for digit in entry)
             for key, entry in tables.items()},
            {key: (_to_device(val, dev) if key.startswith("ddleaf")
                   else _oz_to_device(key, val, dev) if key.startswith("oz")
                   else tuple(_to_device(half, dev) for half in val))
             for key, val in corrs.items()},
        )

    @classmethod
    def from_numpy_tables(cls, n: int, dd_state=None, device=None,
                          options: Optional[Options] = None,
                          native_state=None):
        """A planner for size ``n`` on ``device`` whose ``dd_state`` and
        ``native_state`` are exactly the given arrays (either or both; one
        not given is built on first use, as by the constructor).

        ``dd_state`` = (tables, corrs) as the JAX planner's ``dd_state``
        holds them, converted to numpy. Only the entries the plan's
        transform reads are taken (see ``dd_state``); every other key is
        ignored. The oz slice arrays may be bfloat16 (as the JAX planner
        holds them) or float32, and must be integers of at most 128 in
        magnitude. Raises if an entry the plan needs is missing, of another
        shape, or not f32.

        ``native_state`` = (fast_tables, leaf_corrs), a JAX native
        planner's state converted to numpy. The native kernels read no
        radix table, so ``fast_tables`` is ignored; of ``leaf_corrs`` the
        plan's ``split{n1}x{n2}`` and ``leaf{n1}`` are taken, every other
        key ignored, and the ``dif{m}`` step tables, which the JAX package
        does not hold, are built. Raises if a taken table is missing, of
        another shape, or not f64."""
        self = cls.__new__(cls)
        self._setup(n, PlannerMode.Heuristic, options, device)
        self._native_state = None
        if native_state is not None:
            _, leaf_corrs = native_state
            carried = {}
            for key, want in _native_tables_host(self.plan).items():
                if key.startswith("dif"):  # the port's own tables
                    carried[key] = _to_device(want, self.device)
                    continue
                if key not in leaf_corrs:
                    raise KeyError(f"table {key!r} missing for n = {n}")
                arrays = [np.asarray(a) for a in leaf_corrs[key]]
                shapes = [a.shape for a in want]
                if [a.shape for a in arrays] != shapes:
                    raise ValueError(f"table {key!r}: expected shapes {shapes}")
                if any(a.dtype != np.float64 for a in arrays):
                    raise TypeError(f"table {key!r} must be float64")
                carried[key] = _to_device(arrays, self.device)
            self._native_state = carried
        self._dd_state = None
        if dd_state is None:
            return self
        tables, corrs = dd_state
        own_tables, own_corrs = _dd_tables_host(self.plan,
                                                self.options.f64_engine)

        def take(key, given, own, sliced=False):
            """``given`` as numpy arrays in ``own``'s nesting, checked."""
            if isinstance(own, np.ndarray):
                arr = np.asarray(given)
                if arr.shape != own.shape:
                    raise ValueError(
                        f"table {key!r}: expected shape {own.shape}, got "
                        f"{arr.shape}")
                if sliced and arr.dtype.name == "bfloat16":
                    arr = arr.astype(np.float32)
                if arr.dtype != np.float32:
                    raise TypeError(f"table {key!r} must be float32")
                if sliced and not (np.all(arr == np.rint(arr))
                                   and np.all(np.abs(arr) <= 128)):
                    raise ValueError(
                        f"table {key!r}: slices must be integers |s| <= 128")
                return arr
            if len(given) != len(own):
                raise ValueError(
                    f"table {key!r}: expected {len(own)} entries, got "
                    f"{len(given)}")
            oz = isinstance(key, str) and key.startswith("oz")
            n_slices = slice_count(key) if oz else 0
            return tuple(take(key, g, o, i < n_slices)
                         for i, (g, o) in enumerate(zip(given, own)))

        picked = []
        for given, own in ((tables, own_tables), (corrs, own_corrs)):
            out = {}
            for key, val in own.items():
                if key not in given:
                    raise KeyError(f"table {key!r} missing for n = {n}")
                out[key] = take(key, given[key], val)
            picked.append(out)
        self._dd_state = self._dd_to_device(*picked)
        return self


class _PlannerR2cBase:
    """What both real-transform planners share (the JAX package's
    ``_PlannerR2cBase``, ``phastft_tpu/planner.py:417``): an n/2 DIT planner
    of the same dtype, ``dit_planner``, on ``inner_options`` (None: its
    ``guess_options``), and the untangle tables on its device.

    ``twiddles_re`` / ``twiddles_im``: 0.5 * W_n^k for k in [0, n/4], from
    exact f64 angles rounded once to the dtype; the R2C and the C2R read it
    (with tw[n/2 - k] = -conj(tw[k])). ``c2r_twiddles`` (and its ``_re`` /
    ``_im``): the JAX planner's full-length table, k in [0, n/2), built on
    first access; no transform of the port reads it. n >= 4, any power of
    two; on a GPU the tables are built on the card
    (``ops/r2c.r2c_twiddles``). With ``PlannerMode.Tune`` and no
    ``inner_options``, the inner options are the winner of the whole-R2C
    race (``tune.tune_r2c_options``), and the inner planner is built in
    ``Heuristic`` mode on them, as in the JAX package; ``mode`` stays
    ``Tune``."""

    dtype: np.dtype
    _dit_cls: type

    def __init__(
        self,
        n: int,
        mode: PlannerMode = PlannerMode.Heuristic,
        inner_options: Optional[Options] = None,
        device=None,
    ):
        log_n = ensure_power_of_two(n)
        if n < 4:
            raise NonPowerOfTwoError(
                f"R2C requires n to be a power of 2 and n >= 4, got {n}"
            )
        self.n = n
        self.log_n = log_n
        self.mode = mode
        if inner_options is None and mode is PlannerMode.Tune:
            from .tune import tune_r2c_options

            inner_options = tune_r2c_options(n, self.dtype, resolve_device(device))
        with span("phastft.plan"):
            self.dit_planner = self._dit_cls(
                n // 2, PlannerMode.Heuristic, options=inner_options, device=device
            )
            self.inner_opts: Options = self.dit_planner.options
            self.device = self.dit_planner.device
            self.twiddles_re, self.twiddles_im = r2c_twiddles(
                n, n // 4 + 1, self.dtype, self.device)
        self._c2r_tw = None

    @property
    def c2r_twiddles(self):
        """(re, im) of 0.5 * W_n^k for k in [0, n/2), the JAX planner's
        full-length C2R table, built on first use (the port's C2R reads the
        quarter table)."""
        if self._c2r_tw is None:
            self._c2r_tw = r2c_twiddles(self.n, self.n // 2, self.dtype,
                                        self.device)
        return self._c2r_tw

    @property
    def c2r_twiddles_re(self):
        return self.c2r_twiddles[0]

    @property
    def c2r_twiddles_im(self):
        return self.c2r_twiddles[1]

    @classmethod
    def new(cls, n: int, device=None):
        """Constructor alias of the reference's ``PlannerR2c::new``."""
        return cls(n, device=device)


class PlannerR2c64(_PlannerR2cBase):
    """f64 real-transform planner for n >= 4 on ``device`` (None =
    "cuda"); the inner ``PlannerDit64``'s engine runs the half-length
    transform."""

    dtype = np.dtype(np.float64)
    _dit_cls = PlannerDit64


class PlannerR2c32(_PlannerR2cBase):
    """f32 real-transform planner for n >= 4 on ``device`` (None =
    "cuda")."""

    dtype = np.dtype(np.float32)
    _dit_cls = PlannerDit32
