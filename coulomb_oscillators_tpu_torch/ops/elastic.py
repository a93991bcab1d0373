"""External harmonic-trap (elastic) force.

Twin of ``coulomb_oscillators_tpu/ops/elastic.py`` (reference:
Simulation/kernel.cuh:119-226): a = -k (.) p component-wise, with
k = omega0^2 per axis (main3.cu:689-691).
"""

from __future__ import annotations

import torch


def elastic(pos: torch.Tensor, omega0_sq) -> torch.Tensor:
    """a = -omega0^2 (.) pos  (kernel.cuh:175-196)."""
    k = torch.as_tensor(omega0_sq, dtype=pos.dtype, device=pos.device)
    return -pos * k


def add_elastic(pos: torch.Tensor, acc: torch.Tensor,
                omega0_sq) -> torch.Tensor:
    """acc - omega0^2 (.) pos  (kernel.cuh:119-152)."""
    k = torch.as_tensor(omega0_sq, dtype=pos.dtype, device=pos.device)
    return acc - pos * k
