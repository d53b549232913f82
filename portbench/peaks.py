"""The yardstick of the kernels layer: one H100's published peaks and the
least time a step's transforms could take on it.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): HBM
3.35 TB/s, 67 TFLOP/s FP32 and 34 TFLOP/s FP64 outside the tensor cores.
A transform is counted from the cell's shape alone, whatever implements
it: it reads its input once and writes its output once (8 B a complex
point each way in f32, 16 B in f64) and does 5 n log2(n) flops. A real
transform of n samples (an R2C, or a C2R the other way) reads the n reals
(4 B each in f32, 8 B in f64) and writes the n/2 + 1 complex bins, and
does 2.5 n log2(n) flops.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"f32": 67e12, "f64": 34e12}
BYTES_PER_POINT = {"f32": 8, "f64": 16}
BYTES_PER_REAL = {"f32": 4, "f64": 8}


def transform_bound_s(n: int, rows: int, precision: str, share: int = 1) -> tuple:
    """(seconds, "bytes" or "flops") of ``rows`` transforms of n points,
    ``share`` ranks dividing the work evenly: the larger of the bytes
    bound and the flops bound."""
    points = n * rows / share
    bytes_s = 2 * BYTES_PER_POINT[precision] * points / HBM_BYTES_PER_S
    flops_s = 5 * points * (n.bit_length() - 1) / FLOPS_PER_S[precision]
    return (bytes_s, "bytes") if bytes_s >= flops_s else (flops_s, "flops")


def real_bound_s(n: int, rows: int, precision: str) -> tuple:
    """(seconds, "bytes" or "flops") of ``rows`` real transforms of n
    samples, R2C or C2R: the larger of the bytes bound and the flops
    bound."""
    bytes_s = rows * (n * BYTES_PER_REAL[precision]
                      + (n // 2 + 1) * BYTES_PER_POINT[precision]) / HBM_BYTES_PER_S
    flops_s = 2.5 * n * rows * (n.bit_length() - 1) / FLOPS_PER_S[precision]
    return (bytes_s, "bytes") if bytes_s >= flops_s else (flops_s, "flops")


def step_bound_s(traffic: dict, precision: str, entry: str = "planner") -> float:
    """One rank's least time for one step of the cell, whose configuration
    has ``entry``."""
    if entry == "real":
        one, _ = real_bound_s(traffic["n"], traffic["batch"], precision)
    else:
        one, _ = transform_bound_s(traffic["n"], traffic["batch"], precision,
                                   traffic["ranks"])
    return one * len(traffic["step"])
