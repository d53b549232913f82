"""phastft_tpu_torch — the PyTorch/CUDA port of phastft_tpu.

Planar (separate real/imaginary) C2C FFTs on an NVIDIA Hopper GPU, with
the same public names, contracts and error classes as the JAX package.
The transforms run through hand-written CUDA kernels (``csrc/``), built
with ``nvcc`` on first use; a CPU tensor runs each kernel's plain torch
version instead.

Device rule: planners and entries take ``device=None``, which means
``"cuda"``; with no GPU present that raises. Pass ``device="cpu"`` to run
on the CPU.

The port plans planar f32 for every power of two n, forward and inverse,
with leading batch dimensions (one H100 holds up to 2^31 points): up to 2^16 through one leaf kernel per
transform, to 2^25 through the fused two-pass four-step pipeline, above
it through a classic outer level (column pass, inner transform, paired
transpose) around that pipeline; every ``Options.leaf_fft_size`` the JAX
package takes runs, planned as it plans it: 128..2^16 points on classic
levels, rows of 1..64 points under a column pass of n2 = 1..64 columns,
2^17 on ``leaf3``, and larger leaves as a column pass (two past n1 = 2048)
over 128-point rows and a transpose. Planar f64 runs for the same
sizes on the native engine, the default: the H100's FP64 units through
three kernels (a leaf of up to 2^16 points, a column pass with the split
twiddle for n1 = 2..2048, a transpose of 64-bit words). It also runs on
the df64 (paired-f32) engine, four f32 planes per complex array through
the dd kernels (``f64_engine`` = ``"df64"``, ``"df64-fused"``,
``"df64-split"``), and with ``"df64-oz"`` the split levels of
n1 = 128..2048 over a leaf of 2^10..2^13 points on the Ozaki bf16-slice
kernels; both are opt-in. A transform the card cannot hold fails with
``torch.OutOfMemoryError``. ``PlannerMode.Tune`` times candidate plans on
the planner's device and caches the winner (``tune.py``, importable as
``phastft_tpu_torch.tune``); ``Options(strategy="staged")`` and
``Options(use_pallas=False)`` run the JAX package's two oracles, the
radix-2 staged path and every pass's plain version, which launch no
kernel.

The real transforms (``PlannerR2c32/64``, ``r2c_*`` / ``c2r_*``, compact
N/2 + 1 spectrum, n >= 4; one H100 holds f32 up to 2^32) run the half-length C2C between the four
streaming kernels of ``csrc/r2c.cu``; the interleaved-complex entries
(``*_interleaved``) and ``numpy_like`` (``numpy.fft``'s surface, numpy in
and out) ride the planar entries. The package imports neither JAX nor
phastft_tpu.
"""

from __future__ import annotations

from .errors import (
    LengthMismatchError,
    NonPowerOfTwoError,
    PhastftError,
    PlannerSizeMismatchError,
)
from .options import Options
from .planner import (
    Direction,
    PlannerDit32,
    PlannerDit64,
    PlannerMode,
    PlannerR2c32,
    PlannerR2c64,
)
from .fft import (
    fft_32_dit,
    fft_32_dit_with_planner,
    fft_32_dit_with_planner_and_opts,
    fft_64_dit,
    fft_64_dit_with_planner,
    fft_64_dit_with_planner_and_opts,
)
from .real_fft import (
    c2r_fft_f32,
    c2r_fft_f32_with_planner,
    c2r_fft_f32_with_planner_and_scratch,
    c2r_fft_f64,
    c2r_fft_f64_with_planner,
    c2r_fft_f64_with_planner_and_scratch,
    r2c_fft_f32,
    r2c_fft_f32_with_planner,
    r2c_fft_f64,
    r2c_fft_f64_with_planner,
)
from . import numpy_like
from .interleaved import (
    fft_32_interleaved,
    fft_32_interleaved_with_planner,
    fft_32_interleaved_with_planner_and_opts,
    fft_64_interleaved,
    fft_64_interleaved_with_planner,
    fft_64_interleaved_with_planner_and_opts,
)

__version__ = "0.1.0"

__all__ = [
    "numpy_like",
    "Direction",
    "PlannerMode",
    "PlannerDit32",
    "PlannerDit64",
    "PlannerR2c32",
    "PlannerR2c64",
    "Options",
    "PhastftError",
    "NonPowerOfTwoError",
    "LengthMismatchError",
    "PlannerSizeMismatchError",
    "fft_32_dit",
    "fft_64_dit",
    "fft_32_dit_with_planner",
    "fft_64_dit_with_planner",
    "fft_32_dit_with_planner_and_opts",
    "fft_64_dit_with_planner_and_opts",
    "r2c_fft_f32",
    "r2c_fft_f64",
    "r2c_fft_f32_with_planner",
    "r2c_fft_f64_with_planner",
    "c2r_fft_f32",
    "c2r_fft_f64",
    "c2r_fft_f32_with_planner",
    "c2r_fft_f64_with_planner",
    "c2r_fft_f32_with_planner_and_scratch",
    "c2r_fft_f64_with_planner_and_scratch",
    "fft_32_interleaved",
    "fft_64_interleaved",
    "fft_32_interleaved_with_planner",
    "fft_64_interleaved_with_planner",
    "fft_32_interleaved_with_planner_and_opts",
    "fft_64_interleaved_with_planner_and_opts",
    "__version__",
]
