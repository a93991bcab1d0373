"""Particle state.

Twin of ``coulomb_oscillators_tpu/state.py``: positions, velocities and
cached accelerations as ``[N, DIM]`` tensors on one device.  Host arrays
go to the card (``cuda:0``) unless the caller names another device; with
no card that default raises, as torch does, and never falls back to the
CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_DEVICE = "cuda:0"   # where host arrays go unless a device is named


class ParticleState(NamedTuple):
    """Positions, velocities and cached accelerations of N particles."""

    pos: torch.Tensor  # [N, DIM]
    vel: torch.Tensor  # [N, DIM]
    acc: torch.Tensor  # [N, DIM] — cached force from the last evaluation

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]

    @classmethod
    def create(cls, pos, vel, acc=None, device=None) -> "ParticleState":
        """State from tensors or host arrays.  Without `device`, a tensor
        `pos` keeps its device and host arrays go to ``cuda:0``."""
        if device is None and not isinstance(pos, torch.Tensor):
            device = DEFAULT_DEVICE
        pos = torch.as_tensor(pos, device=device)
        vel = torch.as_tensor(vel, device=pos.device)
        acc = (torch.zeros_like(pos) if acc is None
               else torch.as_tensor(acc, device=pos.device))
        return cls(pos=pos, vel=vel, acc=acc)


def particle_state_from_numpy(pos: np.ndarray, vel: np.ndarray,
                              acc: np.ndarray | None = None,
                              device=DEFAULT_DEVICE) -> ParticleState:
    """State from host arrays (copies; the arrays stay the caller's), on
    ``cuda:0`` unless `device` names another."""
    device = DEFAULT_DEVICE if device is None else device

    def up(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    return ParticleState(up(pos), up(vel),
                         torch.zeros_like(up(pos)) if acc is None else up(acc))
