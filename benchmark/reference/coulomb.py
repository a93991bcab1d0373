"""The Coulomb-oscillator physics, plainly, in 3 or 2 dimensions.

A particle at x_t feels, from every source x_s (itself included, where the
difference is 0, so it adds 0), kappa * (x_t - x_s) * w, with kappa = xi /
N, and the trap's -omega0^2 * x_t per axis.  In 3D w = (|x_t - x_s|^2 +
eps2)^(-3/2) (reference: Simulation/kernel.cuh, main3.cu:686-691); in 2D
w = (|x_t - x_s|^2 + eps2)^(-1), the gradient of -log r of the upstream 2D
program (Simulation/direct.cuh:23-35, kernel.cuh; kappa = xi / N at
main.cu:803-808).  A leapfrog step is a half kick, a drift, a force
evaluation and a half kick (integrator.cuh).  :func:`trap`, :func:`drift`
and :func:`kicks` act per axis, so they hold in either dimension.

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
    """The Coulomb acceleration [T, D] at the particles `targets` (indices
    into `pos` [N, D], D = 3 or 2) from all N particles, computed in
    `dtype` and returned in float64."""
    src = _tensor(pos, device, dtype)
    tgt = src[_tensor(targets, device, torch.int64)]
    n, dim = src.shape
    if dim not in (2, 3):
        raise ValueError(f"positions of dimension {dim}: only 2 and 3")
    axes = [src[:, a] for a in range(dim)]
    e2 = torch.tensor(eps2, dtype=dtype, device=device)
    block = max(1, BLOCK_ELEMENTS // max(n, 1))
    out = []
    for i in range(0, tgt.shape[0], block):
        t = tgt[i:i + block]
        d = [t[:, a:a + 1] - axes[a] for a in range(dim)]
        r2 = d[0] * d[0]
        for a in range(1, dim):
            r2 = r2 + d[a] * d[a]
        r2 = r2 + e2
        if dim == 3:
            w = torch.rsqrt(r2)
            w = w * w * w
        else:
            w = torch.reciprocal(r2)
        out.append(torch.stack([(da * w).sum(1) for da in d], 1))
    k = torch.tensor(kappa, dtype=dtype, device=device)
    return (torch.cat(out) * k).to(torch.float64)


def trap(pos, omega0_sq, device, dtype=torch.float64) -> torch.Tensor:
    """The trap's acceleration -omega0^2 * x [.., D] (one omega0 an axis),
    in `dtype`, returned in float64."""
    x = _tensor(pos, device, dtype)
    w = torch.tensor(tuple(omega0_sq), dtype=dtype, device=device)
    return (-x * w).to(torch.float64)


def drift(pos, vel, acc, dt: float, device,
          dtype=torch.float64) -> torch.Tensor:
    """The positions after a leapfrog step's half kick and drift:
    x + dt * (v + dt/2 * a) per axis, in `dtype`, returned in float64."""
    x, v, a = (_tensor(u, device, dtype) for u in (pos, vel, acc))
    h = torch.tensor(0.5 * dt, dtype=dtype, device=device)
    d = torch.tensor(dt, dtype=dtype, device=device)
    return (x + d * (v + h * a)).to(torch.float64)


def kicks(vel, acc0, acc1, dt: float, device,
          dtype=torch.float64) -> torch.Tensor:
    """The velocities after a whole leapfrog step: v + dt/2 * a0 + dt/2 *
    a1, where a0 is the acceleration the step starts from and a1 the one
    at the drifted positions, per axis, in `dtype`, returned in float64."""
    v, a0, a1 = (_tensor(u, device, dtype) for u in (vel, acc0, acc1))
    h = torch.tensor(0.5 * dt, dtype=dtype, device=device)
    return ((v + h * a0) + h * a1).to(torch.float64)
