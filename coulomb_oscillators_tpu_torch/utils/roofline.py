"""The least time one NVIDIA H100 SXM could take for a piece of work.

Published peaks (NVIDIA's H100 data sheet, SXM part, dense rates, at the
full 700 W power limit): 67 TFLOP/s float32 and 33.5 TFLOP/s float64
outside the tensor cores, 3.35 TB/s of HBM.  The special-function units
(rsqrt) deliver 16 results a clock on each of the 132 SMs, at the 1.98 GHz
boost clock that the float32 peak assumes.  A card set below 700 W runs
slower under load, so every share of a bound is quoted beside the card's
``nvidia-smi`` power limit.

A pair of the softened Coulomb sum counts 20 flops in 3D (3 subtractions,
3 fused multiply-adds for |d|^2 + eps2, 2 multiplies for r^3, 3 fused
multiply-adds into the sum, 17 in all, and the rsqrt as 3, the usual
N-body convention) and 14 in 2D (11, and the reciprocal as 3).
"""

from __future__ import annotations

FP32_FLOPS = 67e12
FP64_FLOPS = 33.5e12
HBM_BYTES = 3.35e12
MUFU_PER_S = 132 * 16 * 1.98e9

FLOPS_PER_PAIR = {2: 14, 3: 20}


def bound(pairs: float, nbytes: float, dim: int = 3,
          double: bool = False) -> dict:
    """Bounds in ms of `pairs` pair evaluations that move `nbytes`: the
    flops over the float32 (or float64) peak, one special-function result
    a pair (float32 only; float64 has no such unit), the bytes over the
    HBM rate; `bound_ms` is the largest, and `bound_by` says whether
    operations or bytes set it."""
    flop_ms = pairs * FLOPS_PER_PAIR[dim] / (FP64_FLOPS if double
                                             else FP32_FLOPS) * 1e3
    mufu_ms = 0.0 if double else pairs / MUFU_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES * 1e3
    ops_ms = max(flop_ms, mufu_ms)
    return dict(flop_ms=flop_ms, mufu_ms=mufu_ms, byte_ms=byte_ms,
                bound_ms=max(ops_ms, byte_ms),
                bound_by="operations" if ops_ms >= byte_ms else "bytes")
