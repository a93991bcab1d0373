"""Near-field (P2P) pass: the Hopper kernels' wrapper, their plain PyTorch
version, and their launch counters.

Counterpart of ``coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py``: both of
its kernels (``p2p_leaf_pairs`` and ``p2p_leaf_pairs_streaming``), in both
of their dims (weight r^3 in dim 3, r^2 in dim 2), become two CUDA
kernels built with ``nvcc`` for ``sm_90a`` at first use and bound through
ctypes: ``csrc/p2p.cu`` in dim 3 (float32 and float64; a CUDA block per
target block, for long partner rows) and ``csrc/p2p2d.cu`` in dim 2
(float32 and float64; a warp per segment of a partner row, for fmm2_kd's
short, skewed rows).

Contract (both versions): ``pos`` [Gb, CB, dim] float32 or float64 padded
slots in block layout, dim 2 or 3 (nsub sub-leaves of C = CB/nsub slots
per block, pads at FAR);
``row_ptr`` [Gb*nsub + 1] int32 per-sub-leaf CSR degrees; ``col2d``
[Gb*nsub, dmax] int32 packed partner entries ``blk | bits << (32 - nsub)``
(bit q selects lane group q of source block ``blk``; block id Gb is the
all-FAR sentinel).  Returns the unscaled near-field acceleration
[Gb, CB, dim]: for every target, sum over its partners' selected sources
of d * (|d|^2 + eps2)^(-3/2) in dim 3, d * (|d|^2 + eps2)^-1 in dim 2, in
the dtype of ``pos``.

:func:`p2p` dispatches on the device of ``pos``: a CPU tensor goes to
:func:`p2p_plain`; a CUDA tensor goes to the kernel for its dim and
dtype, or raises.  There is no fallback between them.  In dim 3 the
wrapper first sorts the kernel's CUDA blocks by their partner entry count,
heaviest first (:func:`block_order`, a few small device ops, no host
sync), so the longest rows do not start last; the result does not depend
on that order (:func:`launch` takes any order, or none).  In dim 2
(:func:`launch_2d`) it makes the kernel's work plan instead
(:func:`segment_plan`: a cumsum over the rows' segment counts, no sort and
no host sync): each row is cut into segments of at most K =
``SEG_ENTRIES`` partner entries that run on different warps, and the
segments' partial sums are added in a fixed order.  On a CPU tensor the
kd engine runs the plain sum as :func:`p2p_plain_entries` over its padded
pair list: the same entries as the CSR's valid prefix, padded to the
list's capacity, so the sum has no data-dependent shape and no host wait.

Pads are not masked: a pad source at FAR adds d * w(FAR) to a real target,
as in the reference's near-field sum.  In float32 dim 3 that weight
underflows to exactly 0; in float64 dim 3 it is r^3 = 1e-54, so each pad
adds about 1e-36; in dim 2 it is r^2 = 5e-37, so each pad adds about
5e-19 in both dtypes.  The plain version adds every such term; the
kernels' float32 instantiations skip all-pad source packets, all-pad
target tiles and the sentinel block, which in dim 2 drops terms of at most
~5e-19 each, far below the float32 resolution of a real target's sum.
"""

from __future__ import annotations

import ctypes
import os
import sys

import torch

from coulomb_oscillators_tpu_torch import native
from coulomb_oscillators_tpu_torch.utils import graphs

FAR = 1e18                 # pad-slot coordinate (the reference's FAR)
PAD_X = 1e17               # x at or above it marks a pad slot (kPadX)
_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
SRC = os.path.join(_CSRC, "p2p.cu")
SRC_2D = os.path.join(_CSRC, "p2p2d.cu")

# kernel launches made through :func:`launch` and :func:`launch_2d`
# (:func:`p2p` on a CUDA tensor), in either dim, and those of the dim-2
# kernel alone; counted nowhere else (a CUDA graph's replay adds what its
# captured step launched, utils/graphs.py)
launches = 0
launches_2d = 0
graphs.register_counter(sys.modules[__name__], "launches")
graphs.register_counter(sys.modules[__name__], "launches_2d")

# pairs per chunk of the plain version (bounds its [k, C, CB] temporaries)
_PLAIN_PAIRS = 1 << 25

# target slots per CUDA block of the dim-3 kernel (kSlots in csrc/p2p.cu),
# and per warp tile (kTile in both kernels)
BLOCK_SLOTS = 128
TILE_SLOTS = 32

# K: the partner entries of one segment, the dim-2 kernel's unit of work
# (1..32; csrc/p2p2d.cu)
SEG_ENTRIES = 16


# the C entry point of each instantiation: dim 3 in csrc/p2p.cu, dim 2 in
# csrc/p2p2d.cu
_ENTRY = {(3, torch.float32): "co_p2p_launch",
          (3, torch.float64): "co_p2p_launch_f64"}
_ENTRY_2D = {torch.float32: "co_p2p2d_launch",
             torch.float64: "co_p2p2d_launch_f64"}


def _eps_type(dtype):
    return ctypes.c_float if dtype == torch.float32 else ctypes.c_double


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for (_, dtype), name in _ENTRY.items():
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 5 + [ci] * 4 + [_eps_type(dtype), vp]
        fn.restype = ci


def bind_2d(lib) -> None:
    """Declare the dim-2 entry points of a loaded build of p2p2d.cu."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for dtype, name in _ENTRY_2D.items():
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 6 + [ci] * 5 + [_eps_type(dtype), vp]
        fn.restype = ci


# csrc/p2p.cu and csrc/p2p2d.cu, each built at first use
library = native.CudaLibrary(SRC, "co_p2p", _bind)
library_2d = native.CudaLibrary(SRC_2D, "co_p2p2d", bind_2d)


def _check(pos: torch.Tensor, row_ptr: torch.Tensor, col2d: torch.Tensor,
           nsub: int):
    if pos.dim() != 3 or pos.shape[2] not in (2, 3):
        raise ValueError(f"pos must be [Gb, CB, 2] or [Gb, CB, 3], got "
                         f"{tuple(pos.shape)}")
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


def block_order(row_ptr: torch.Tensor, Gb: int, CB: int, nsub: int,
                dmax: int) -> torch.Tensor:
    """The kernel's CUDA blocks (Gb * ceil(CB / S) of S = min(CB, 128)
    target slots each, block-major) as int32 ids sorted by their partner
    entries, heaviest first: a block's work is the clamped degree of each
    32-slot tile's sub-leaf, summed.  A stable sort, on the device of
    `row_ptr`."""
    S = min(CB, BLOCK_SLOTS)
    nsc = -(-CB // S)
    dev = row_ptr.device
    deg = (row_ptr[1:] - row_ptr[:-1]).clamp(max=dmax).view(Gb, nsub)
    start = torch.arange(0, CB, TILE_SLOTS, device=dev)
    work = torch.zeros(Gb, nsc, dtype=deg.dtype, device=dev)
    work.index_add_(1, start // S, deg[:, start // (CB // nsub)])
    return torch.argsort(work.view(-1), descending=True,
                         stable=True).to(torch.int32)


def segment_plan(row_ptr: torch.Tensor, dmax: int, ntile: int = 1,
                 K: int = SEG_ENTRIES) -> torch.Tensor:
    """The dim-2 kernel's work plan, on the device of `row_ptr`, as the
    int32 buffer it takes (``work`` in csrc/p2p2d.cu): [R + 2 + R*ntile]
    for R = len(row_ptr) - 1 sub-leaf rows of `ntile` 32-target tiles.

    A row of degree d (clamped to `dmax`) is cut into n = max(1,
    ceil(d / K)) segments of at most K entries: segment s holds entries
    [sK, min(sK + K, d)).  An item is one segment of one tile.
    ``work[:R + 1]`` is the prefix (from 0) of each row's extra segments
    (n - 1) times `ntile`: the kernel's items [0, work[R]) are those, row
    by row, each row's from its last segment down to segment 1; items
    [work[R], work[R] + R*ntile) are segment 0 of each (row, tile) in
    order.  The rest (the kernel's item counter and its per-(row, tile)
    counts of committed segments) is zero.  Its shape depends on the
    shapes alone; no host sync, no sort."""
    R = row_ptr.shape[0] - 1
    extra = torch.diff(row_ptr).clamp_(1, dmax).sub_(1).div_(
        K, rounding_mode="floor")
    if ntile > 1:
        extra.mul_(ntile)
    work = torch.zeros(R + 2 + R * ntile, dtype=torch.int32,
                       device=row_ptr.device)
    torch.cumsum(extra, 0, out=work[1:R + 1])
    return work


def p2p(pos: torch.Tensor, row_ptr: torch.Tensor, col2d: torch.Tensor,
        nsub: int, eps2: float) -> torch.Tensor:
    """Near-field acceleration [Gb, CB, dim] (see the module contract)."""
    _check(pos, row_ptr, col2d, nsub)
    if pos.device.type == "cpu":
        return p2p_plain(pos, row_ptr, col2d, nsub, eps2)
    if pos.device.type != "cuda":
        raise ValueError(f"no P2P path for device {pos.device}")
    Gb, CB, dim = pos.shape
    if dim == 2:
        return launch_2d(pos, row_ptr, col2d, nsub, eps2)
    return launch(pos, row_ptr, col2d, nsub, eps2,
                  block_order(row_ptr, Gb, CB, nsub, col2d.shape[1]))


def _check_cuda(pos, row_ptr, col2d, nsub):
    """What both kernels take beyond :func:`_check`."""
    CB = pos.shape[1]
    C = CB // nsub
    if C % 32 or nsub > 8:
        raise ValueError(f"the CUDA kernel takes C % 32 == 0 and nsub <= 8; "
                         f"got C={C}, CB={CB}, nsub={nsub}")
    if not (pos.is_contiguous() and row_ptr.is_contiguous()
            and col2d.is_contiguous()):
        raise ValueError("pos, row_ptr and col2d must be contiguous")


def launch_2d(pos: torch.Tensor, row_ptr: torch.Tensor, col2d: torch.Tensor,
              nsub: int, eps2: float, K: int = SEG_ENTRIES) -> torch.Tensor:
    """The dim-2 kernel (csrc/p2p2d.cu) on CUDA tensors that :func:`_check`
    accepted, with segments of at most `K` entries: its plan
    (:func:`segment_plan`), the scratch of its segments' running sums and
    the output are allocated here.  Counts the launch in ``launches`` and
    ``launches_2d``."""
    global launches, launches_2d
    Gb, CB, dim = pos.shape
    if dim != 2:
        raise ValueError(f"launch_2d takes [Gb, CB, 2], got "
                         f"{tuple(pos.shape)}")
    _check_cuda(pos, row_ptr, col2d, nsub)
    if not 1 <= K <= 32:
        raise ValueError(f"K must be 1..32, got {K}")
    if Gb * CB * 2 >= 1 << 31:
        raise ValueError(f"pos has {Gb * CB * 2} values; the kernel takes "
                         f"< 2^31")
    fn = getattr(library_2d.get(), _ENTRY_2D[pos.dtype])
    if pos.data_ptr() % 16:              # the kernel copies 16-byte pieces
        pos = pos.clone()
    dmax = col2d.shape[1]
    work = segment_plan(row_ptr, dmax, CB // nsub // TILE_SLOTS, K)
    run = torch.empty_like(pos)
    out = torch.empty_like(pos)
    rc = fn(pos.data_ptr(), row_ptr.data_ptr(), col2d.data_ptr(),
            work.data_ptr(), run.data_ptr(), out.data_ptr(), Gb, CB, nsub,
            dmax, K, float(eps2),
            torch.cuda.current_stream(pos.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"P2P kernel launch failed: cudaError_t {rc}")
    launches += 1
    launches_2d += 1
    return out


def launch(pos: torch.Tensor, row_ptr: torch.Tensor, col2d: torch.Tensor,
           nsub: int, eps2: float, order: torch.Tensor | None):
    """The dim-3 kernel (csrc/p2p.cu) on CUDA tensors that :func:`_check`
    accepted, its CUDA blocks in `order` (:func:`block_order`) or, with
    None, in grid order: the same result either way.  Counts the
    launch."""
    global launches
    Gb, CB, dim = pos.shape
    if dim != 3:
        raise ValueError(f"launch takes [Gb, CB, 3] (dim 2: launch_2d), got "
                         f"{tuple(pos.shape)}")
    _check_cuda(pos, row_ptr, col2d, nsub)
    blocks = Gb * -(-CB // min(CB, BLOCK_SLOTS))
    if order is not None and (order.dtype != torch.int32
                              or order.shape != (blocks,)
                              or order.device != pos.device):
        raise ValueError(f"order must be int32 [{blocks}] on {pos.device}")
    lib = library.get()
    fn = getattr(lib, _ENTRY[dim, pos.dtype])
    if pos.data_ptr() % 16:              # the kernel copies 16-byte pieces
        pos = pos.clone()
    dmax = col2d.shape[1]
    out = torch.empty_like(pos)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    rc = fn(pos.data_ptr(), row_ptr.data_ptr(), col2d.data_ptr(),
            None if order is None else order.data_ptr(),
            out.data_ptr(), Gb, CB, nsub, dmax, float(eps2), stream)
    if rc != 0:
        raise RuntimeError(f"P2P kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out


def pair_counts(pos: torch.Tensor, row_ptr: torch.Tensor,
                col2d: torch.Tensor, nsub: int) -> dict:
    """The work of one call in either dim, counted from its inputs:
    `entries` (partner entries within the degrees, sentinel included),
    `pairs` (C targets x C sources for every set mask bit of a real block:
    every slot pair, pads included) and `real_pairs` (pairs whose target
    and source both are real, x < PAD_X), and `bytes` (positions read
    once, the output written once, the entries and row_ptr read once)."""
    Gb, CB, dim = pos.shape
    C = CB // nsub
    dev = pos.device
    shift = 32 - nsub
    deg = (row_ptr[1:] - row_ptr[:-1]).clamp(max=col2d.shape[1])
    cols = torch.arange(col2d.shape[1], device=dev)
    rows, ks = torch.nonzero(cols[None, :] < deg[:, None], as_tuple=True)
    v = col2d[rows, ks].to(torch.int64) & 0xFFFFFFFF
    blk = (v & ((1 << shift) - 1)).clamp(max=Gb)
    q = torch.arange(nsub, device=dev)
    sel = (((v >> shift)[:, None] >> q) & 1) * (blk < Gb)[:, None]
    real = (pos[..., 0] < PAD_X).reshape(Gb * nsub, C).sum(1)
    real = torch.cat([real, real.new_zeros(nsub)])       # the sentinel
    src = (sel * real[blk[:, None] * nsub + q]).sum(1)
    item = pos.element_size()
    return dict(entries=int(rows.shape[0]),
                pairs=C * C * int(sel.sum()),
                real_pairs=int((real[rows] * src).sum()),
                bytes=2 * pos.numel() * item + 4 * (rows.shape[0]
                                                    + row_ptr.shape[0]))


def p2p_plain(pos: torch.Tensor, row_ptr: torch.Tensor, col2d: torch.Tensor,
              nsub: int, eps2: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device, in dims 2 and 3
    (the oracle of every instantiation, and the CPU path):
    :func:`p2p_plain_entries` over the valid prefix of every sub-leaf's
    partner row, as flat entries in row-major order (entries past a row's
    degree are never read by either version).  That prefix's length
    depends on the data (one ``nonzero``, which waits for the device); the
    kd engine passes its padded pair list, which holds the same entries in
    the same order, to :func:`p2p_plain_entries` instead."""
    deg = (row_ptr[1:] - row_ptr[:-1]).clamp(max=col2d.shape[1])
    cols = torch.arange(col2d.shape[1], device=col2d.device)
    rows, ks = torch.nonzero(cols[None, :] < deg[:, None], as_tuple=True)
    return p2p_plain_entries(pos, rows, col2d[rows, ks], nsub, eps2)


def p2p_plain_entries(pos: torch.Tensor, tgt: torch.Tensor,
                      packed: torch.Tensor, nsub: int,
                      eps2: float) -> torch.Tensor:
    """The plain near-field sum over flat entries: `tgt` [K] target
    sub-leaf ids and `packed` [K] int32 partner entries (the module
    contract's ``blk | bits << (32 - nsub)``).  A target id of Gb * nsub
    (one past the last sub-leaf) with a packed entry of 0 is a pad entry:
    its lane mask is 0, so its pair weights are exactly 0 and its sums land
    in a dropped row.  The loop's shapes depend on K only, so a padded list
    makes no data-dependent shape.

    Gathers target sub-leaf and source block tiles in chunks and evaluates
    the same pair weight as the kernel, r = rsqrt(dist2), w = r^3 (dim 3)
    or r^2 (dim 2) times the lane-group mask.  Source block id Gb reads an
    all-FAR sentinel block (zero weight in float32 dim 3, ~5e-19 a slot in
    dim 2, as in the reference's sum).  Per-target sums
    accumulate with a sorted index_add_."""
    Gb, CB, dim = pos.shape
    C = CB // nsub
    G = Gb * nsub
    dev = pos.device
    shift = 32 - nsub
    tgt = tgt.long()
    v = packed.long() & 0xFFFFFFFF                        # uint32 view
    blk = v & ((1 << shift) - 1)
    bits = v >> shift
    src = torch.cat([pos, torch.full((1, CB, dim), FAR, dtype=pos.dtype,
                                     device=dev)])
    tiles = pos.reshape(G, C, dim)
    group = torch.arange(CB, device=dev) // C
    out = torch.zeros(G + 1, C, dim, dtype=pos.dtype, device=dev)
    k = max(1, _PLAIN_PAIRS // (C * CB))
    for i in range(0, tgt.shape[0], k):
        ti = tgt[i:i + k]
        P_t = tiles[ti.clamp(max=G - 1)]                  # [k, C, 3]
        P_s = src[blk[i:i + k]]                           # [k, CB, 3]
        mb = (bits[i:i + k, None] >> group[None, :]) & 1  # [k, CB]
        d = P_t[:, :, None, :] - P_s[:, None, :, :]       # [k, C, CB, 3]
        dist2 = eps2 + d[..., 0] * d[..., 0]
        for a in range(1, dim):
            dist2 = dist2 + d[..., a] * d[..., a]
        r = torch.rsqrt(dist2)
        w = (r * r * r if dim == 3 else r * r) * mb[:, None, :].to(pos.dtype)
        out.index_add_(0, ti, torch.sum(d * w[..., None], dim=2))
    return out[:G].reshape(Gb, CB, dim)
