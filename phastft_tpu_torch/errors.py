"""Error types for phastft_tpu_torch.

The same four classes, with the same messages, as the JAX package's
``errors.py``: the reference library's contract panics become exceptions
(non-power-of-2 length, planar length mismatch, planner-size mismatch).
The port runs the JAX package's whole public surface (``PlannerMode.Tune``,
the staged strategy and ``use_pallas=False`` included), so no error of its
own says that something is not ported.
"""

from __future__ import annotations

__all__ = [
    "PhastftError",
    "NonPowerOfTwoError",
    "LengthMismatchError",
    "PlannerSizeMismatchError",
    "ensure_power_of_two",
]


class PhastftError(ValueError):
    """Base class for all phastft contract violations."""


class NonPowerOfTwoError(PhastftError):
    """Raised when an input length is not a power of two."""


class LengthMismatchError(PhastftError):
    """Raised when paired real/imag buffers have different lengths."""


class PlannerSizeMismatchError(PhastftError):
    """Raised when a planner was built for a different size than the input."""


def ensure_power_of_two(n: int) -> int:
    """Validate that ``n`` is a positive power of two and return log2(n)."""
    if n <= 0 or (n & (n - 1)) != 0:
        raise NonPowerOfTwoError(f"n must be a power of 2, got {n}")
    return n.bit_length() - 1

