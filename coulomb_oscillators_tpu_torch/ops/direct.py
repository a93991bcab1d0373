"""Direct O(N^2) softened-Coulomb force: the Hopper kernel's wrapper, its
plain PyTorch version, and the Kahan oracles.

Twin of ``coulomb_oscillators_tpu/ops/direct.py``.  The pairwise law
matches the reference (Simulation/direct.cuh:23-35): for d = p_i - p_j and
dist2 = |d|^2 + eps2, a_i += d / dist2 (2D), d / dist2^(3/2) (3D) or
d / dist2^2 (4D), scaled by kappa = xi/N.  The j == i self term is d = 0.

  * :func:`direct` — dispatches on the device of ``pos``: a CPU tensor
    goes to :func:`direct_plain`, a CUDA tensor to the hand-written Hopper
    kernel ``csrc/direct.cu`` (the twin of the Pallas ``direct`` kernel,
    built with nvcc for sm_90a at first use, bound through ctypes) or
    raises.  There is no fallback between them;
  * :func:`direct_plain` — chunked broadcast, twin of ``direct_jnp``, and
    the kernel's plain version;
  * :func:`direct_kahan` — Kahan-compensated accuracy oracle (``direct3``,
    direct.cuh:192-245);
  * :func:`direct_kahan_targets` — the same oracle on a subset of targets,
    for large N.

The sums are written as elementwise products and reductions, never as
matmuls, so they stay in full float32 on any device.
"""

from __future__ import annotations

import ctypes
import os

import torch

from coulomb_oscillators_tpu_torch import native

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "direct.cu")

# kernel launches made through :func:`direct`; counted nowhere else
launches = 0

_TILE = 256                # sources per tile = targets per CUDA block
_BLOCKS_PER_SM = 8         # resident 256-thread blocks the splits aim at


def _bind(lib) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.co_direct_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, cf, cf, vp]
    lib.co_direct_launch.restype = ci


# csrc/direct.cu, built at first use
library = native.CudaLibrary(SRC, "co_direct", _bind)


def splits_for(n: int, sm_count: int) -> tuple:
    """(S, tiles_per_split): the source range of ceil(n/256) tiles cut
    into S splits, enough that the grid of ceil(n/256) x S blocks keeps
    about 8 blocks resident per SM."""
    tiles = -(-n // _TILE)
    want = max(1, -(-(sm_count * _BLOCKS_PER_SM) // tiles))
    per = -(-tiles // min(want, tiles))
    return -(-tiles // per), per


def direct(pos: torch.Tensor, eps2: float, kappa: float) -> torch.Tensor:
    """O(N^2) pairwise force [N, D] -> [N, D], D in {2, 3} (the reference
    kernel's dims; :func:`direct_plain` also takes 4D).  CPU tensors take
    :func:`direct_plain`; CUDA tensors take the kernel, float32 only."""
    global launches
    if pos.dim() != 2 or pos.shape[1] not in (2, 3):
        raise ValueError(f"unsupported dim: pos must be [N, 2] or [N, 3], "
                         f"got {tuple(pos.shape)}")
    if pos.device.type == "cpu":
        return direct_plain(pos, eps2, kappa)
    if pos.dtype != torch.float32:
        raise ValueError(f"the direct kernel takes float32, got {pos.dtype}")
    if pos.device.type != "cuda":
        raise ValueError(f"no direct path for device {pos.device}")
    n, dim = pos.shape
    pos = pos.contiguous()
    S, per = splits_for(
        n, torch.cuda.get_device_properties(pos.device).multi_processor_count)
    lib = library.get()
    out = torch.empty_like(pos)
    part = torch.empty((S, n, dim), dtype=pos.dtype, device=pos.device) \
        if S > 1 else None
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    rc = lib.co_direct_launch(pos.data_ptr(),
                              None if part is None else part.data_ptr(),
                              out.data_ptr(), n, dim, S, per, float(eps2),
                              float(kappa), stream)
    if rc != 0:
        raise RuntimeError(f"direct kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out


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
