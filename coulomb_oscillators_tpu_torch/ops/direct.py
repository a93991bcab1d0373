"""Direct O(N^2) softened-Coulomb force: the plain PyTorch paths.

Twin of ``coulomb_oscillators_tpu/ops/direct.py``.  The pairwise law
matches the reference (Simulation/direct.cuh:23-35): for d = p_i - p_j and
dist2 = |d|^2 + eps2, a_i += d / dist2 (2D), d / dist2^(3/2) (3D) or
d / dist2^2 (4D), scaled by kappa = xi/N.  The j == i self term is d = 0.

  * :func:`direct_plain` — chunked broadcast, twin of ``direct_jnp``;
  * :func:`direct_kahan` — Kahan-compensated accuracy oracle (``direct3``,
    direct.cuh:192-245);
  * :func:`direct_kahan_targets` — the same oracle on a subset of targets,
    for large N.

The Pallas ``direct`` kernel of the reference has no Hopper twin yet; the
``direct`` engine is not part of the port (see ROADMAP.md).  The sums are
written as elementwise products and reductions, never as matmuls, so they
stay in full float32 on any device.
"""

from __future__ import annotations

import torch


def _pair_weight(dist2: torch.Tensor, dim: int) -> torch.Tensor:
    """w such that the force contribution is d * w (direct.cuh:23-35)."""
    inv = 1.0 / dist2
    if dim == 2:
        return inv
    if dim == 3:
        return inv * torch.rsqrt(dist2)
    if dim == 4:
        return inv * inv
    raise ValueError(f"unsupported dim {dim}")


def _acc_rows(rows: torch.Tensor, src: torch.Tensor, eps2: float,
              dim: int) -> torch.Tensor:
    d = rows[:, None, :] - src[None, :, :]                  # [R, N, D]
    dist2 = torch.sum(d * d, dim=-1) + eps2
    w = _pair_weight(dist2, dim)
    return torch.sum(w[..., None] * d, dim=1)


def direct_plain(pos: torch.Tensor, eps2: float, kappa: float,
                 row_chunk: int = 1024) -> torch.Tensor:
    """Chunked O(N^2) pairwise force; [N, D] -> [N, D]."""
    n, dim = pos.shape
    out = torch.cat([_acc_rows(pos[i:i + row_chunk], pos, eps2, dim)
                     for i in range(0, n, row_chunk)])
    return kappa * out


def _kahan(targets: torch.Tensor, pos: torch.Tensor, eps2: float,
           kappa: float, src_chunk: int) -> torch.Tensor:
    dim = targets.shape[1]
    acc = torch.zeros_like(targets)
    comp = torch.zeros_like(targets)
    for j in range(0, pos.shape[0], src_chunk):
        contrib = _acc_rows(targets, pos[j:j + src_chunk], eps2, dim)
        # Kahan update (direct.cuh:213-221)
        y = contrib - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return kappa * acc


def direct_kahan_targets(targets: torch.Tensor, pos: torch.Tensor,
                         eps2: float, kappa: float,
                         src_chunk: int = 2048) -> torch.Tensor:
    """Kahan-compensated forces of ALL `pos` sources on `targets` rows only
    — the subsampled oracle for large N, where a plain f32 direct sum
    carries ~1e-3 of its own accumulation noise.  A target that coincides
    with a source gets d = 0 from it."""
    return _kahan(targets, pos, eps2, kappa, src_chunk)


def direct_kahan(pos: torch.Tensor, eps2: float, kappa: float,
                 src_chunk: int = 512) -> torch.Tensor:
    """Kahan-compensated direct sum over all pairs — the accuracy oracle."""
    return _kahan(pos, pos, eps2, kappa, src_chunk)
