"""Error metrics and reductions.

Twin of ``coulomb_oscillators_tpu/ops/reductions.py`` (reference:
Simulation/reductions.cuh): the metric semantics, as torch reductions.
"""

from __future__ import annotations

import torch


def rel_diff1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row relative difference sqrt(|a-b|^2 / (|b|^2 + 1e-18))
    (reductions.cuh:37-42)."""
    d = a - b
    dist2 = torch.sum(d * d, dim=-1)
    ref2 = torch.sum(b * b, dim=-1) + 1e-18
    return torch.sqrt(torch.clamp(dist2 / ref2, min=0.0))


def rel_diff2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric relative difference 2*sqrt(|a-b|^2/|a+b|^2)
    (reductions.cuh:44-49)."""
    d = a - b
    s = a + b
    dist2 = torch.sum(d * d, dim=-1)
    div2 = torch.sum(s * s, dim=-1) + 1e-18
    return 2.0 * torch.sqrt(dist2 / div2)


def mean_rel_err(test: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Mean of per-particle relative errors (relerrReduce2,
    reductions.cuh:82-104)."""
    return torch.mean(rel_diff1(test, ref))


def rel_err_l2(test: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """L2-norm-ratio error ||test-ref|| / ||ref|| (relerrReduce3,
    reductions.cuh:106-153)."""
    return torch.linalg.vector_norm(test - ref) / torch.linalg.vector_norm(ref)


def minmax(pos: torch.Tensor):
    """Componentwise (min, max) over particles (minmaxReduce2,
    reductions.cuh:52-80)."""
    return torch.amin(pos, dim=0), torch.amax(pos, dim=0)


def pow_reduce(x: torch.Tensor, expo: float) -> torch.Tensor:
    """Sum of |x|^expo over all elements (powReduce,
    reductions.cuh:497-653)."""
    return torch.sum(torch.abs(x) ** expo)
