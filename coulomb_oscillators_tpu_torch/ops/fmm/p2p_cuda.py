"""Near-field (P2P) pass: the Hopper kernel's wrapper, its plain PyTorch
version, and its launch counter.

Counterpart of ``coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py``: both of
its kernels (``p2p_leaf_pairs`` and ``p2p_leaf_pairs_streaming``) become
one CUDA kernel, ``csrc/p2p.cu``, built with ``nvcc`` for ``sm_90a`` at
first use and bound through ctypes.

Contract (both versions): ``pos`` [Gb, CB, 3] float32 or float64 padded
slots in block layout (nsub sub-leaves of C = CB/nsub slots per block, pads
at FAR);
``row_ptr`` [Gb*nsub + 1] int32 per-sub-leaf CSR degrees; ``col2d``
[Gb*nsub, dmax] int32 packed partner entries ``blk | bits << (32 - nsub)``
(bit q selects lane group q of source block ``blk``; block id Gb is the
all-FAR sentinel).  Returns the unscaled near-field acceleration
[Gb, CB, 3]: for every target, sum over its partners' selected sources of
d * (|d|^2 + eps2)^(-3/2), in the dtype of ``pos``.

:func:`p2p` dispatches on the device of ``pos``: a CPU tensor goes to
:func:`p2p_plain`; a CUDA tensor goes to the kernel's float32 or float64
instantiation or raises.  There is no fallback between them.
:func:`p2p_plain` also takes dim 2 (weight 1/dist2), which the kd engine
runs on every device.

Pads are not masked: a pad source at FAR adds d * w(FAR) to a real target,
as in the reference's near-field sum.  In float32 dim 3 that weight
underflows to exactly 0; in float64 it is r^3 = 1e-54, so each pad adds
about 1e-36, and in dim 2 about 1e-18 — in both versions, as in the
reference.
"""

from __future__ import annotations

import ctypes
import os

import torch

from coulomb_oscillators_tpu_torch import native

FAR = 1e18                 # pad-slot coordinate (the reference's FAR)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "p2p.cu")

# kernel launches made through :func:`p2p`; counted nowhere else
launches = 0

# pairs per chunk of the plain version (bounds its [k, C, CB] temporaries)
_PLAIN_PAIRS = 1 << 25


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, eps in ((lib.co_p2p_launch, ctypes.c_float),
                    (lib.co_p2p_launch_f64, ctypes.c_double)):
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, eps, vp]
        fn.restype = ci


# csrc/p2p.cu, built at first use
library = native.CudaLibrary(SRC, "co_p2p", _bind)


def _check(pos: torch.Tensor, row_ptr: torch.Tensor, col2d: torch.Tensor,
           nsub: int):
    if pos.dim() != 3 or pos.shape[2] != 3:
        raise ValueError(f"pos must be [Gb, CB, 3], got {tuple(pos.shape)}")
    Gb, CB, _ = pos.shape
    if pos.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pos must be float32 or float64, got {pos.dtype}")
    if nsub < 1 or CB % nsub:
        raise ValueError(f"CB={CB} is not a multiple of nsub={nsub}")
    if row_ptr.dtype != torch.int32 or row_ptr.shape != (Gb * nsub + 1,):
        raise ValueError(f"row_ptr must be int32 [{Gb * nsub + 1}], got "
                         f"{row_ptr.dtype} {tuple(row_ptr.shape)}")
    if (col2d.dtype != torch.int32 or col2d.dim() != 2
            or col2d.shape[0] != Gb * nsub):
        raise ValueError(f"col2d must be int32 [{Gb * nsub}, dmax], got "
                         f"{col2d.dtype} {tuple(col2d.shape)}")
    if not (row_ptr.device == col2d.device == pos.device):
        raise ValueError("pos, row_ptr and col2d must share a device")


def p2p(pos: torch.Tensor, row_ptr: torch.Tensor, col2d: torch.Tensor,
        nsub: int, eps2: float) -> torch.Tensor:
    """Near-field acceleration [Gb, CB, 3] (see the module contract)."""
    global launches
    _check(pos, row_ptr, col2d, nsub)
    if pos.device.type == "cpu":
        return p2p_plain(pos, row_ptr, col2d, nsub, eps2)
    if pos.device.type != "cuda":
        raise ValueError(f"no P2P path for device {pos.device}")
    Gb, CB, _ = pos.shape
    C = CB // nsub
    if C % 32 or nsub > 8:
        raise ValueError(f"the CUDA kernel takes C % 32 == 0 and nsub <= 8; "
                         f"got C={C}, CB={CB}, nsub={nsub}")
    if not (pos.is_contiguous() and row_ptr.is_contiguous()
            and col2d.is_contiguous()):
        raise ValueError("pos, row_ptr and col2d must be contiguous")
    lib = library.get()
    launch = (lib.co_p2p_launch if pos.dtype == torch.float32
              else lib.co_p2p_launch_f64)
    out = torch.empty_like(pos)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    rc = launch(pos.data_ptr(), row_ptr.data_ptr(), col2d.data_ptr(),
                out.data_ptr(), Gb, CB, nsub, col2d.shape[1], float(eps2),
                stream)
    if rc != 0:
        raise RuntimeError(f"P2P kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out


def p2p_plain(pos: torch.Tensor, row_ptr: torch.Tensor, col2d: torch.Tensor,
              nsub: int, eps2: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device, in dims 2 and 3.

    Walks the valid prefix of every sub-leaf's partner row (entries past
    the degree are never read by either version), gathers target sub-leaf
    and source block tiles in chunks, and evaluates the same pair weight
    r = rsqrt(dist2), w = r^3 (dim 3) or r^2 (dim 2) times the lane-group
    mask.  Source block id Gb reads an all-FAR sentinel block (zero weight
    in float32 dim 3).  Per-target sums accumulate with a sorted
    index_add_."""
    Gb, CB, dim = pos.shape
    C = CB // nsub
    G = Gb * nsub
    dev = pos.device
    shift = 32 - nsub
    deg = (row_ptr[1:] - row_ptr[:-1]).clamp(max=col2d.shape[1])
    cols = torch.arange(col2d.shape[1], device=dev)
    rows, ks = torch.nonzero(cols[None, :] < deg[:, None], as_tuple=True)
    v = col2d[rows, ks].to(torch.int64) & 0xFFFFFFFF   # uint32 view
    blk = v & ((1 << shift) - 1)
    bits = v >> shift
    src = torch.cat([pos, torch.full((1, CB, dim), FAR, dtype=pos.dtype,
                                     device=dev)])
    tgt = pos.reshape(G, C, dim)
    group = torch.arange(CB, device=dev) // C
    out = torch.zeros(G, C, dim, dtype=pos.dtype, device=dev)
    k = max(1, _PLAIN_PAIRS // (C * CB))
    for i in range(0, rows.shape[0], k):
        ti = rows[i:i + k]
        P_t = tgt[ti]                                     # [k, C, 3]
        P_s = src[blk[i:i + k]]                           # [k, CB, 3]
        mb = (bits[i:i + k, None] >> group[None, :]) & 1  # [k, CB]
        d = P_t[:, :, None, :] - P_s[:, None, :, :]       # [k, C, CB, 3]
        dist2 = eps2 + d[..., 0] * d[..., 0]
        for a in range(1, dim):
            dist2 = dist2 + d[..., a] * d[..., a]
        r = torch.rsqrt(dist2)
        w = (r * r * r if dim == 3 else r * r) * mb[:, None, :].to(pos.dtype)
        out.index_add_(0, ti, torch.sum(d * w[..., None], dim=2))
    return out.reshape(Gb, CB, dim)
