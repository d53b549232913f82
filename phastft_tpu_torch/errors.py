"""Error types for phastft_tpu_torch.

The same four classes, with the same messages, as the JAX package's
``errors.py``: the reference library's contract panics become exceptions
(non-power-of-2 length, planar length mismatch, planner-size mismatch).

``not_ported`` builds the ``NotImplementedError`` raised for everything
the port does not run yet (the staged and plain pipelines, Tune); its
message names the ``ROADMAP.md`` item that will bring it. Item numbers are
names: an item that is done keeps its number.
"""

from __future__ import annotations

__all__ = [
    "PhastftError",
    "NonPowerOfTwoError",
    "LengthMismatchError",
    "PlannerSizeMismatchError",
    "ensure_power_of_two",
    "not_ported",
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


#: ROADMAP.md Queue 1 items that bring what the port does not run yet.
ROADMAP_ITEMS = {
    "classic": "ROADMAP.md Queue 1 item 7 (use_pallas=False and the staged "
               "strategy)",
    "tune": "ROADMAP.md Queue 1 item 8 (PlannerMode.Tune)",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for ``what``, outside the port's slice; ``item`` is a key
    of ``ROADMAP_ITEMS``."""
    return NotImplementedError(
        f"{what} is not ported to phastft_tpu_torch yet: {ROADMAP_ITEMS[item]}"
    )
