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
  * :func:`direct_targets` — the same law for targets against another
    array of sources (a rank's rows against a visiting block, the
    block-on-block force of ``parallel/mesh.py``): the same kernel through
    its separate-targets entry on CUDA tensors, :func:`direct_targets_plain`
    on CPU tensors;
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
import functools
import os
import sys

import torch

from coulomb_oscillators_tpu_torch import native
from coulomb_oscillators_tpu_torch.utils import graphs

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "direct.cu")

# kernel launches made through :func:`launch` (which :func:`direct`
# calls); counted nowhere else (a CUDA graph's replay
# adds what its captured step launched, utils/graphs.py)
launches = 0
graphs.register_counter(sys.modules[__name__], "launches")

# a split's source range is a multiple of this
SPLIT_UNIT = 32


def _bind(lib) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.co_direct_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, cf, cf, vp]
    lib.co_direct_launch.restype = ci
    lib.co_direct_launch_ts.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                        cf, cf, vp]
    lib.co_direct_launch_ts.restype = ci
    lib.co_direct_geometry.argtypes = [ci, vp, vp]
    lib.co_direct_geometry.restype = ci


# csrc/direct.cu, built at first use
library = native.CudaLibrary(SRC, "co_direct", _bind)
_geometry = {}
_sm_count = {}


def geometry(dim: int, lib=None) -> tuple:
    """(targets per CUDA block, resident blocks a SM) of the kernel in
    `dim` on the current device, as the built library (or `lib`, another
    build) reports them."""
    key = (dim, lib)
    if key not in _geometry:
        src = library.get() if lib is None else lib
        t, b = ctypes.c_int(), ctypes.c_int()
        rc = src.co_direct_geometry(dim, ctypes.byref(t), ctypes.byref(b))
        if rc != 0 or b.value < 1:
            raise RuntimeError(f"direct kernel geometry query failed: "
                               f"cudaError_t {rc}")
        _geometry[key] = (t.value, b.value)
    return _geometry[key]


@functools.lru_cache(maxsize=256)
def splits_for(n: int, sm_count: int, targets_per_block: int,
               blocks_per_sm: int, n_targets: int | None = None) -> tuple:
    """(S, per): the n sources cut into S splits of `per` (a multiple of
    32; the last split shorter).  Of the split counts up to
    max(4, 4 x the card's resident slots / the target blocks), the one
    whose grid of ceil(n_targets / targets_per_block) x S blocks fills its
    last wave of resident slots (blocks_per_sm a SM) best; the fewest
    splits among equals.  `n_targets` is n unless given (the
    separate-targets entry)."""
    blocks = -(-(n if n_targets is None else n_targets) // targets_per_block)
    slots = sm_count * blocks_per_sm
    best = None
    for want in range(1, min(max(4, 4 * slots // blocks),
                             -(-n // SPLIT_UNIT)) + 1):
        per = -(-n // want)                          # ceil(n / want)
        per = -(-per // SPLIT_UNIT) * SPLIT_UNIT     # up to the unit
        S = -(-n // per)
        fill = blocks * S / (-(-(blocks * S) // slots) * slots)
        if best is None or fill > best[0] + 1e-12:
            best = (fill, S, per)
    return best[1], best[2]


def direct(pos: torch.Tensor, eps2: float, kappa: float) -> torch.Tensor:
    """O(N^2) pairwise force [N, D] -> [N, D], D in {2, 3} (the reference
    kernel's dims; :func:`direct_plain` also takes 4D).  CPU tensors take
    :func:`direct_plain`; CUDA tensors take the kernel, float32 only."""
    if pos.dim() != 2 or pos.shape[1] not in (2, 3):
        raise ValueError(f"unsupported dim: pos must be [N, 2] or [N, 3], "
                         f"got {tuple(pos.shape)}")
    if pos.device.type == "cpu":
        return direct_plain(pos, eps2, kappa)
    if pos.dtype != torch.float32:
        raise ValueError(f"the direct kernel takes float32, got {pos.dtype}")
    if pos.device.type != "cuda":
        raise ValueError(f"no direct path for device {pos.device}")
    return launch(pos, eps2, kappa)


def direct_targets(targets: torch.Tensor, src: torch.Tensor, eps2: float,
                   kappa: float) -> torch.Tensor:
    """Force of all `src` [Ns, D] on the `targets` rows [Nt, D]: [Nt, D].
    CPU tensors take :func:`direct_targets_plain`; float32 CUDA tensors in
    D = 2 or 3 take the kernel's separate-targets entry, or raise."""
    if (targets.dim() != 2 or src.dim() != 2
            or targets.shape[1] != src.shape[1]
            or targets.dtype != src.dtype or targets.device != src.device):
        raise ValueError(f"targets [Nt, D] and src [Ns, D] must share D, "
                         f"dtype and device, got {tuple(targets.shape)} "
                         f"{targets.dtype} {targets.device} and "
                         f"{tuple(src.shape)} {src.dtype} {src.device}")
    if targets.device.type == "cpu":
        return direct_targets_plain(targets, src, eps2, kappa)
    if targets.shape[1] not in (2, 3) or targets.dtype != torch.float32:
        raise ValueError(f"the direct kernel takes float32 [N, 2] or "
                         f"[N, 3], got {targets.dtype} "
                         f"{tuple(targets.shape)}")
    if targets.device.type != "cuda":
        raise ValueError(f"no direct path for device {targets.device}")
    return launch(src, eps2, kappa, targets=targets)


def launch(pos: torch.Tensor, eps2: float, kappa: float,
           splits: int | None = None,
           targets: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on a float32 CUDA tensor [N, D] that :func:`direct`
    accepted, with the source range cut into `splits` (None: the
    :func:`splits_for` rule); every split count gives the same sum to
    rounding.  `targets` [Nt, D] (None: `pos` itself) are the rows the
    force is taken on.  Counts the launch."""
    global launches
    n, dim = pos.shape
    pos = pos.contiguous()
    tgt = pos if targets is None else targets.contiguous()
    nt = tgt.shape[0]
    if splits is None:
        if pos.device not in _sm_count:
            _sm_count[pos.device] = torch.cuda.get_device_properties(
                pos.device).multi_processor_count
        S, per = splits_for(n, _sm_count[pos.device], *geometry(dim),
                            n_targets=None if targets is None else nt)
    else:
        per = -(-n // splits)
        S = -(-n // per)
        if S != splits:
            raise ValueError(f"{splits} splits of {n} sources leave one "
                             f"empty")
    lib = library.get()
    out = torch.empty_like(tgt)
    part = torch.empty((S, nt, dim), dtype=pos.dtype, device=pos.device) \
        if S > 1 else None
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    rc = lib.co_direct_launch_ts(tgt.data_ptr(), pos.data_ptr(),
                                 None if part is None else part.data_ptr(),
                                 out.data_ptr(), nt, n, dim, S, per,
                                 float(eps2), float(kappa), stream)
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
    return direct_targets_plain(pos, pos, eps2, kappa, row_chunk)


def direct_targets_plain(targets: torch.Tensor, src: torch.Tensor,
                         eps2: float, kappa: float,
                         row_chunk: int = 1024) -> torch.Tensor:
    """Chunked force of all `src` on the `targets` rows (the twin of the
    reference's ``_local_direct``, kappa-scaled), and the plain version of
    the kernel's separate-targets entry."""
    dim = targets.shape[1]
    out = torch.cat([_acc_rows(targets[i:i + row_chunk], src, eps2, dim)
                     for i in range(0, targets.shape[0], row_chunk)])
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
