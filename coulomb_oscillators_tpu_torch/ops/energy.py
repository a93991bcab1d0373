"""Total-energy diagnostic for drift measurements.

Twin of ``coulomb_oscillators_tpu/ops/energy.py``: the conserved
Hamiltonian of the model,

    H = 1/2 sum_i |v_i|^2  +  1/2 sum_i omega0^2 (.) x_i^2  +  U_coulomb

with the softened pair potential matching the force law
(direct.cuh:23-35 integrated):

    3D: U = kappa/2 * sum_{i != j} 1 / sqrt(r_ij^2 + eps2)
    2D: U = -kappa/4 * sum_{i != j} log(r_ij^2 + eps2)

:func:`total_energy_f64` is a numpy copy of the twin's host oracle; the
others run on tensors, on any device.  Pair sums are elementwise products
and reductions, never matmuls, so TF32 cannot reach them.
"""

from __future__ import annotations

import numpy as np
import torch


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def total_energy_f64(pos, vel, eps2: float, kappa: float, omega0_sq,
                     chunk: int = 4096) -> float:
    """Hamiltonian in float64 on host (numpy, BLAS-chunked pairwise sum).

    The north-star drift bound (<=1e-6 @10k steps) is below float32
    resolution, so the measurement itself must be f64.  A diagnostic, not a
    hot path: host f64 via the d^2 = |a|^2+|b|^2-2ab BLAS identity."""
    pos = _host64(pos)
    vel = _host64(vel)
    n, dim = pos.shape
    ke = 0.5 * float(np.sum(vel * vel))
    trap = 0.5 * float(np.sum(pos * pos * np.asarray(omega0_sq, np.float64)))
    sq = np.sum(pos * pos, axis=1)
    pot = 0.0
    for i0 in range(0, n, chunk):
        i1 = min(i0 + chunk, n)
        rows = pos[i0:i1]
        d2 = sq[i0:i1, None] + sq[None, :] - 2.0 * (rows @ pos.T)
        np.maximum(d2, 0.0, out=d2)
        d2 += eps2
        if dim == 3:
            phi = 1.0 / np.sqrt(d2)
        else:
            phi = -0.5 * np.log(d2)
        phi[np.arange(i1 - i0), np.arange(i0, i1)] = 0.0   # self terms
        pot += float(phi.sum())
    return ke + trap + 0.5 * kappa * pot


def _pair_phi(dist2: torch.Tensor, dim: int) -> torch.Tensor:
    if dim == 3:
        return torch.rsqrt(dist2)
    return -0.5 * torch.log(dist2)


def potential_rows_kahan(pos: torch.Tensor, eps2: float,
                         src_chunk: int = 512) -> torch.Tensor:
    """Per-particle softened pair-potential row sums, Kahan-compensated:
    phi_i = sum_{j != i} phi(|r_ij|) over source chunks with a compensation
    term, so each row is accurate to O(eps_f32) regardless of N (the twin
    sums each chunk in float32; here each chunk's sum accumulates in
    float64, which removes that sum's own rounding).  Self pairs are
    excluded inside the sum: phi(0) = 1/eps ~ 1e9 would obliterate a
    float32 row sum (~1e2) if subtracted after the fact."""
    n, dim = pos.shape
    rows = torch.arange(n, device=pos.device)
    acc = torch.zeros(n, dtype=pos.dtype, device=pos.device)
    comp = torch.zeros_like(acc)
    for j0 in range(0, n, src_chunk):
        s = pos[j0:j0 + src_chunk]
        d = pos[:, None, :] - s[None, :, :]                 # [N, C, D]
        dist2 = torch.sum(d * d, dim=-1) + eps2
        notself = rows[:, None] != (j0 + torch.arange(
            s.shape[0], device=pos.device))[None, :]
        # the chunk's row sums accumulate in float64, so each row carries
        # only the pair terms' own rounding, not a 512-term f32 sum's
        contrib = torch.sum(torch.where(notself, _pair_phi(dist2, dim), 0.0),
                            dim=1, dtype=torch.float64).to(pos.dtype)
        y = contrib - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return acc


def total_energy_kahan(pos, vel, eps2: float, kappa: float,
                       omega0_sq) -> float:
    """Hamiltonian: device Kahan pair rows + host float64 reduction
    (~1e-10 relative, enough to certify the <=1e-6 drift bound)."""
    rows = _host64(potential_rows_kahan(torch.as_tensor(pos), eps2))
    pos_h = _host64(pos)
    vel_h = _host64(vel)
    ke = 0.5 * float(np.sum(vel_h * vel_h))
    trap = 0.5 * float(np.sum(pos_h * pos_h
                              * np.asarray(omega0_sq, np.float64)))
    return ke + trap + 0.5 * kappa * float(rows.sum())


def coulomb_potential(pos: torch.Tensor, eps2: float, kappa: float,
                      row_chunk: int = 512) -> torch.Tensor:
    """Softened pairwise potential energy (i != j pairs, counted once),
    float32 chunk sums."""
    n, dim = pos.shape
    cols = torch.arange(n, device=pos.device)
    pots = []
    for i0 in range(0, n, row_chunk):
        rows = pos[i0:i0 + row_chunk]
        d = rows[:, None, :] - pos[None, :, :]
        dist2 = torch.sum(d * d, dim=-1) + eps2
        rid = i0 + torch.arange(rows.shape[0], device=pos.device)
        phi = torch.where(rid[:, None] != cols[None, :],
                          _pair_phi(dist2, dim), 0.0)
        pots.append(torch.sum(phi.to(torch.float32)))
    return 0.5 * kappa * torch.sum(torch.stack(pots))


def total_energy(pos: torch.Tensor, vel: torch.Tensor, eps2: float,
                 kappa: float, omega0_sq, row_chunk: int = 512) -> torch.Tensor:
    """Conserved Hamiltonian (per unit mass), float32 accumulators."""
    ke = 0.5 * torch.sum(torch.square(vel).to(torch.float32))
    k = torch.as_tensor(omega0_sq, dtype=torch.float32, device=pos.device)
    trap = 0.5 * torch.sum(torch.square(pos).to(torch.float32) * k)
    return ke + trap + coulomb_potential(pos, eps2, kappa,
                                         row_chunk=row_chunk)
