"""The Coulomb-oscillator physics, plainly.

A particle at x_t feels, from every source x_s (itself included, where the
difference is 0), kappa * (x_t - x_s) * (|x_t - x_s|^2 + eps2)^(-3/2), with
kappa = xi / N, and the trap's -omega0^2 * x_t per axis (reference:
Simulation/kernel.cuh, main3.cu:686-691).  A leapfrog step is a half kick,
a drift, a force evaluation and a half kick (integrator.cuh).

:func:`coulomb` sums over all sources in float64 on whatever device it is
given, in blocks of targets, so that its temporaries stay near
``BLOCK_ELEMENTS`` values.  The ``dtype`` argument set to
``torch.bfloat16`` computes every operation in bfloat16 instead: that is
the control, the reference put in the program's place one precision below
the float32 the configurations state (TF32 does not apply to a sum of
elementwise terms).
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ELEMENTS = 1 << 26      # target x source values in one block


def _tensor(a, device, dtype) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    return a.to(device=device, dtype=dtype)


def coulomb(pos, targets, eps2: float, kappa: float, device,
            dtype=torch.float64) -> torch.Tensor:
    """The Coulomb acceleration [T, 3] at the particles `targets` (indices
    into `pos` [N, 3]) from all N particles, computed in `dtype` and
    returned in float64."""
    src = _tensor(pos, device, dtype)
    tgt = src[_tensor(targets, device, torch.int64)]
    n = src.shape[0]
    xs, ys, zs = src[:, 0], src[:, 1], src[:, 2]
    e2 = torch.tensor(eps2, dtype=dtype, device=device)
    block = max(1, BLOCK_ELEMENTS // max(n, 1))
    out = []
    for i in range(0, tgt.shape[0], block):
        t = tgt[i:i + block]
        dx = t[:, 0:1] - xs
        dy = t[:, 1:2] - ys
        dz = t[:, 2:3] - zs
        r2 = dx * dx + dy * dy + dz * dz + e2
        w = torch.rsqrt(r2)
        w = w * w * w
        out.append(torch.stack([(dx * w).sum(1), (dy * w).sum(1),
                                (dz * w).sum(1)], 1))
    k = torch.tensor(kappa, dtype=dtype, device=device)
    return (torch.cat(out) * k).to(torch.float64)


def trap(pos, omega0_sq, device, dtype=torch.float64) -> torch.Tensor:
    """The trap's acceleration -omega0^2 * x [.., 3], in `dtype`, returned
    in float64."""
    x = _tensor(pos, device, dtype)
    w = torch.tensor(tuple(omega0_sq), dtype=dtype, device=device)
    return (-x * w).to(torch.float64)


def drift(pos, vel, acc, dt: float, device,
          dtype=torch.float64) -> torch.Tensor:
    """The positions after a leapfrog step's half kick and drift:
    x + dt * (v + dt/2 * a), in `dtype`, returned in float64."""
    x, v, a = (_tensor(u, device, dtype) for u in (pos, vel, acc))
    h = torch.tensor(0.5 * dt, dtype=dtype, device=device)
    d = torch.tensor(dt, dtype=dtype, device=device)
    return (x + d * (v + h * a)).to(torch.float64)


def kicks(vel, acc0, acc1, dt: float, device,
          dtype=torch.float64) -> torch.Tensor:
    """The velocities after a whole leapfrog step: v + dt/2 * a0 + dt/2 *
    a1, where a0 is the acceleration the step starts from and a1 the one
    at the drifted positions, in `dtype`, returned in float64."""
    v, a0, a1 = (_tensor(u, device, dtype) for u in (vel, acc0, acc1))
    h = torch.tensor(0.5 * dt, dtype=dtype, device=device)
    return ((v + h * a0) + h * a1).to(torch.float64)
