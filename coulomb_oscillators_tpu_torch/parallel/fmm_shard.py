"""Multi-device kd-FMM force: pair-sharded hot loops over a device mesh.

Twin of ``coulomb_oscillators_tpu/parallel/fmm_shard.py``.  Positions and
the (small) tree are replicated on every rank; the two hot loops, the
far-field M2L entries and the near-field partner lists, are split over the
ranks, and their contributions are summed with one ``all_reduce_sum`` each
(the [Mheap, S_Lt] local heap and the [G, C, dim] near-field accumulator).
Upper-tree work (P2M, M2M, L2L, L2P) is replicated.

Two differences from the reference, both forced by the port's engine:

  * the near field reads the per-sub-leaf CSR (``p2p_row_ptr``,
    ``p2p_col2d``), not the flat pair list the reference shards, so the
    *rows* are split: rank d keeps the degrees of a contiguous run of
    sub-leaf rows (runs balanced by partner-entry count) and zero degrees
    elsewhere.  The unchanged near-field pass (the Hopper P2P kernel on
    CUDA tensors, in dims 2 and 3; the plain version on CPU tensors) then
    returns zeros outside the rank's run, and the sum
    over ranks is the whole near field;
  * the grouped M2L has no per-entry fallback, so the entry list is split
    on group boundaries: :func:`pad_pairs_for_mesh` pads it to a multiple
    of ``ndev * m2l_group`` with invalid entries whose target is Mheap.
"""

from __future__ import annotations

import torch

from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (FAR, FmmState,
                                                          KdFmmEngine)
from coulomb_oscillators_tpu_torch.parallel.mesh import Mesh


def pad_pairs_for_mesh(fs: FmmState, ndev: int, group: int = 1) -> FmmState:
    """Pad the M2L entry list to a multiple of ``ndev * group`` (the
    engine's power-of-two caps already are one for power-of-two meshes), so
    that an even split falls on boundaries of the `group`-entry runs; the
    grouped targets are padded alongside, and so is a stored fold, with the
    reference's fills (h2 0, w 1, which keeps ``w``'s powers finite, logc
    0).  The near field is split by rows (:func:`shard_rows`), so the flat
    P2P lists stay as they are."""
    Mheap = fs.center.shape[0]
    K = fs.m2l_tgt.shape[0]
    q = ndev * group
    pad = -(-K // q) * q - K
    if pad == 0:
        return fs

    def pad1(x, n, fill):
        return torch.cat([x, torch.full((n,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=x.device)])

    folded = fs.m2l_h2.shape[0] == K
    return fs._replace(
        m2l_tgt=pad1(fs.m2l_tgt, pad, Mheap), m2l_src=pad1(fs.m2l_src, pad, 0),
        m2l_valid=pad1(fs.m2l_valid, pad, False),
        m2l_h2=pad1(fs.m2l_h2, pad, 0.0) if folded else fs.m2l_h2,
        m2l_w=pad1(fs.m2l_w, pad, 1.0) if folded else fs.m2l_w,
        m2l_logc=pad1(fs.m2l_logc, pad, 0.0) if folded else fs.m2l_logc,
        m2l_gtgt=(pad1(fs.m2l_gtgt, pad // group, Mheap) if group > 1
                  else fs.m2l_gtgt))


def shard_rows(row_ptr: torch.Tensor, ndev: int, rank: int) -> torch.Tensor:
    """The CSR row pointer [G + 1] of rank `rank`'s share of the near
    field: the degrees of its contiguous run of rows, zero elsewhere.  Run
    d holds the rows whose entries start in the d-th of `ndev` equal parts
    of the entry count, so every row is in exactly one run."""
    rp = row_ptr.long()
    total = rp[-1]
    owner = torch.clamp(rp[:-1] * ndev // torch.clamp(total, min=1),
                        max=ndev - 1)
    deg = (rp[1:] - rp[:-1]) * (owner == rank)
    out = torch.zeros_like(rp)
    out[1:] = torch.cumsum(deg, 0)
    return out.to(row_ptr.dtype)


def make_sharded_force(eng: KdFmmEngine, mesh: Mesh, axis: str = "dp"):
    """pos [n, dim] (replicated) x FmmState -> acc [n, dim] (replicated).

    Every rank calls the returned function with the same arguments; the
    M2L entries and the near-field rows are this rank's share, everything
    else is replicated."""
    ndev, rank = mesh.ndev, mesh.rank
    g = eng.m2l_group

    def force(pos: torch.Tensor, fs: FmmState) -> torch.Tensor:
        fs = pad_pairs_for_mesh(fs, ndev, g)
        per = fs.m2l_tgt.shape[0] // ndev
        lo, hi = rank * per, (rank + 1) * per
        # a stored fold splits with its entries; fly-mode placeholders stay
        folded = fs.m2l_h2.shape[0] == fs.m2l_tgt.shape[0]
        fold = {f: getattr(fs, f)[lo:hi] if folded else getattr(fs, f)
                for f in ("m2l_h2", "m2l_w", "m2l_logc")}
        fs_d = fs._replace(
            m2l_tgt=fs.m2l_tgt[lo:hi], m2l_src=fs.m2l_src[lo:hi],
            m2l_valid=fs.m2l_valid[lo:hi], **fold,
            m2l_gtgt=(fs.m2l_gtgt[lo // g:hi // g] if g > 1
                      else fs.m2l_gtgt),
            p2p_row_ptr=shard_rows(fs.p2p_row_ptr, ndev, rank))
        ppad = eng.pad_array(pos, fs, fill=FAR)
        # replicated upper tree
        mpole_heap = eng._stage_multipoles(ppad, fs)
        # sharded far-field entries + sum of the local heap
        local_heap = mesh.all_reduce_sum(eng._stage_m2l(mpole_heap, fs_d))
        far_pad = eng._stage_local(ppad, local_heap, fs)
        # sharded near-field rows + sum of the block accumulator: the CSR
        # (whose rows are sharded), not the engine's pair-list stage
        pblk = ppad.reshape(eng.G_blk, eng.C_blk, eng.dim).contiguous()
        near_pad = mesh.all_reduce_sum(p2p_cuda.p2p(
            pblk, fs_d.p2p_row_ptr, fs_d.p2p_col2d, eng.nsub,
            eng.config.eps2).reshape(ppad.shape))
        acc_pad = (far_pad + near_pad) * eng._kappa(pos.dtype)
        return eng.unpad_array(acc_pad, fs)

    return force
