"""External harmonic-trap (elastic) force.

Twin of ``coulomb_oscillators_tpu/ops/elastic.py`` (reference:
Simulation/kernel.cuh:119-226): a = -k (.) p component-wise, with
k = omega0^2 per axis (main3.cu:689-691).

The trap constant k is a tensor built once per (values, dtype, device) and
cached (:func:`trap_constant`), so a force evaluation makes no host-to-device
copy: that copy would wait for the card on every call, and a CUDA graph
cannot capture it.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=64)
def _trap(omega0_sq: tuple, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    return torch.tensor(omega0_sq, dtype=dtype, device=device)


def trap_constant(omega0_sq, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """omega0^2 per axis as a [dim] tensor of `dtype` on `device`, built at
    the first call for these values and reused after it.  A tensor given
    as `omega0_sq` is cast instead."""
    if isinstance(omega0_sq, torch.Tensor):
        return omega0_sq.to(dtype=dtype, device=device)
    return _trap(tuple(float(w) for w in omega0_sq), dtype,
                 torch.device(device))


def elastic(pos: torch.Tensor, omega0_sq) -> torch.Tensor:
    """a = -omega0^2 (.) pos  (kernel.cuh:175-196)."""
    return -pos * trap_constant(omega0_sq, pos.dtype, pos.device)


def add_elastic(pos: torch.Tensor, acc: torch.Tensor,
                omega0_sq) -> torch.Tensor:
    """acc - omega0^2 (.) pos  (kernel.cuh:119-152)."""
    return acc - pos * trap_constant(omega0_sq, pos.dtype, pos.device)
