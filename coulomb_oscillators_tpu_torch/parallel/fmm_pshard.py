"""Particle-sharded multi-device kd-FMM: leaf blocks distributed over the
mesh.

Twin of ``coulomb_oscillators_tpu/parallel/fmm_pshard.py``.  The *state* is
sharded: of the padded leaf blocks [G, C, dim] (the particles, in tree
order) rank d holds the contiguous leaf run [d*G/P, (d+1)*G/P), which is
n/P particles because the kd tree is equal-count.  The tree and the pair
lists are replicated (every rank holds the same ``FmmState``).  Per force
evaluation the collectives are:

  * one ``all_gather`` of the leaf multipoles [G/P, S_M] feeding a
    replicated M2M / L2L upper tree, with one ``all_reduce_sum`` of the
    local heap to combine the rank's share of the M2L entries;
  * the near-field halo: P2P partner lists are grouped at build time by
    source-rank offset ("hop", :func:`shard_pair_lists`, the reference's
    host code); for every non-zero hop present the local position blocks
    travel that many places around the ring (``ring_shift``).  kd order is
    spatial, so almost all pairs are hop 0 and the halo is one or two
    neighbour blocks.

The reference processes each hop with a jnp scan against the visiting
block, a shape made for ``ppermute`` inside one XLA program.  The port does
not carry that over: its near field is the Hopper P2P kernel
(``ops.fmm.p2p_cuda``, dims 2 and 3; the plain version on CPU tensors),
whose contract is
one position array that is both targets and sources plus a per-sub-leaf
CSR.  So a rank concatenates ``[own blocks | visiting blocks of the hops
present]`` into one [Glb * (1 + n_halo), CB, dim] array, and at list time
(:meth:`PShardedKdFmm.localize`) builds one CSR from its rows of the hop
lists: the rows are its own Gl sub-leaves (the halo's rows have degree 0)
and the entries name source blocks by their index in the concatenation.
One kernel launch per force evaluation; the output's first Glb blocks are
the answer.

No geometry refresh: the sharded window loop evaluates the force against
the frozen ``FmmState``, as the reference's does
(``make_psharded_scan``); the single-device window loop refreshes node
geometry from the live positions before every evaluation.  The mesh mode
is the twin of the reference's mesh mode, not of the single-device window.

A stored M2L fold (``CO_M2L_FLY=0``) splits with its entries; fly mode
carries the reference's per-rank placeholders.  With no geometry refresh
the slices taken at :meth:`PShardedKdFmm.localize` stay those of the
adopted state.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.models import integrators as I
from coulomb_oscillators_tpu_torch.ops.elastic import add_elastic
from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (FmmState,
                                                          KdFmmEngine)
from coulomb_oscillators_tpu_torch.parallel.mesh import Mesh


def _build_col2d(p2p: np.ndarray, row_ptr: np.ndarray, G: int, Gblk: int,
                 dmax: int) -> np.ndarray:
    """Dense per-target partner table [G, dmax] of a rank's CSR from its
    target-sorted pair list; padding entries hold the sentinel block id
    Gblk (the engine builds its own table with ``kdtree.layout_fill``)."""
    col = np.full((G + 1, dmax), Gblk, np.int32)
    tgt = p2p[:, 0].astype(np.int64)
    ranks = np.clip(np.arange(tgt.shape[0]) - row_ptr[tgt], 0, dmax - 1)
    col[tgt, ranks] = p2p[:, 1]
    return col[:G]


class PShardLists(NamedTuple):
    """The sharded pair lists of all ranks (leading axis = mesh).  The
    near-field lists are host arrays; the M2L lists are views of the
    ``FmmState``'s tensors, on their device."""
    # near-field, per hop h: targets as LOCAL sub-leaf ids in [0, Gl)
    # (Gl = dummy row), sources as packed LOCAL block ids of the source rank
    p2p_tgt: Tuple[np.ndarray, ...]   # each [ndev, Kh] int32
    p2p_src: Tuple[np.ndarray, ...]
    p2p_val: Tuple[np.ndarray, ...]   # bool
    # far-field: even split of the directed M2L list (sum-combined)
    m2l_tgt: torch.Tensor             # [ndev, Km]
    m2l_src: torch.Tensor
    m2l_val: torch.Tensor
    m2l_h2: torch.Tensor              # [ndev, Km, S_H] stored fold (fly
                                      # mode: [ndev, 1, 1] zeros)
    m2l_w: torch.Tensor               # [ndev, Km] ([ndev, 1])
    m2l_logc: torch.Tensor            # [ndev, Km] ([ndev, 1])
    m2l_gtgt: torch.Tensor            # [ndev, Km/g] grouped-M2L targets
                                      # (group runs never straddle the even
                                      # split: Km is a chunk multiple)


class PShardLocal(NamedTuple):
    """One rank's share of the lists, on its device: everything a force
    evaluation reads, so that its body reads no host array."""
    hops: Tuple[int, ...]             # the non-zero hops, in halo order
    row_ptr: torch.Tensor             # [Gl * (1 + n_halo) + 1] int32
    col2d: torch.Tensor               # [Gl * (1 + n_halo), dmax] int32
    m2l_tgt: torch.Tensor             # [Km]
    m2l_src: torch.Tensor
    m2l_val: torch.Tensor
    m2l_h2: torch.Tensor              # the stored fold's rows, or the
    m2l_w: torch.Tensor               # placeholders
    m2l_logc: torch.Tensor
    m2l_gtgt: torch.Tensor
    # the CSR's entries as a padded flat list for the plain near-field sum
    # (a CPU rank; else empty): the target row of each entry,
    # Gl * (1 + n_halo) at a pad, and the packed entry, 0 at a pad
    p2p_tgt: torch.Tensor             # [Ke] int32
    p2p_src: torch.Tensor             # [Ke] int32


def _signed_hop(dev_src: np.ndarray, dev_tgt: np.ndarray, ndev: int):
    """Shortest-way-around device offset in [-ndev/2, ndev/2)."""
    return ((dev_src - dev_tgt + ndev // 2) % ndev) - ndev // 2


def shard_pair_lists(eng: KdFmmEngine, fs: FmmState, ndev: int,
                     ) -> Tuple[PShardLists, Tuple[int, ...]]:
    """Host-side regrouping of fs's pair lists for an ndev-way mesh.

    Returns (lists, hops) where hops is the sorted tuple of signed source
    offsets present in the near field (always includes 0).  Rebuild-time
    only: O(pairs) numpy work."""
    G = 1 << eng.L
    assert G % ndev == 0, f"sub-leaf count {G} not divisible by mesh {ndev}"
    Gl = G // ndev
    Gb = eng.G_blk
    assert Gb % ndev == 0, f"block count {Gb} not divisible by mesh {ndev}"
    Glb = Gb // ndev

    shift = eng.mask_shift
    blkmask = (1 << shift) - 1
    p2p_t = fs.p2p_tgt.cpu().numpy()
    p2p_s = fs.p2p_src.cpu().numpy()
    p2p_v = fs.p2p_valid.cpu().numpy()
    t = p2p_t[p2p_v]
    s_u = p2p_s[p2p_v].view(np.uint32).astype(np.int64)  # packed blk|mask
    s = s_u & blkmask                  # source BLOCK ids
    mbits = s_u >> shift
    dev_t = t // Gl
    hop = _signed_hop(s // Glb, dev_t, ndev)
    hops = sorted(set(np.unique(hop).tolist()) | {0})

    # per-hop capacities never shrink across rebuilds (the reference keeps
    # its jitted scan from retracing; kept so the integers stay equal)
    caps = eng.__dict__.setdefault("_pshard_caps", {})

    tgt_h, src_h, val_h = [], [], []
    for h in hops:
        sel = hop == h
        th, sh, dh = t[sel], s[sel], dev_t[sel]
        mh = mbits[sel]
        counts = np.bincount(dh, minlength=ndev)
        Kh = max(int(counts.max()) if counts.size else 0, 1)
        Kh = -(-Kh // 8) * 8
        Kh = caps[h] = max(Kh, caps.get(h, 0))
        tt = np.full((ndev, Kh), Gl, np.int32)     # Gl = dummy row
        ss = np.zeros((ndev, Kh), np.int32)
        vv = np.zeros((ndev, Kh), bool)
        order = np.argsort(dh, kind="stable")
        th, sh, dh, mh = th[order], sh[order], dh[order], mh[order]
        starts = np.searchsorted(dh, np.arange(ndev))
        ranks = np.arange(th.size) - starts[dh]
        tt[dh, ranks] = th % Gl
        ss[dh, ranks] = ((sh % Glb) | (mh << shift)).astype(
            np.uint32).view(np.int32)
        vv[dh, ranks] = True
        # each rank's row sorted by local target
        rowo = np.argsort(tt + (~vv) * G, axis=1, kind="stable")
        tgt_h.append(np.take_along_axis(tt, rowo, 1))
        src_h.append(np.take_along_axis(ss, rowo, 1))
        val_h.append(np.take_along_axis(vv, rowo, 1))

    # M2L split: the fs tensors are cap-padded on the device; split them
    # as views, without a host round trip
    Km = fs.m2l_tgt.shape[0]
    assert Km % ndev == 0, f"m2l cap {Km} not divisible by mesh {ndev}"
    Kml = Km // ndev
    # fly mode: per-rank placeholders (the loop folds from center/lam)
    folded = fs.m2l_h2.shape[0] == Km
    lists = PShardLists(
        p2p_tgt=tuple(tgt_h), p2p_src=tuple(src_h), p2p_val=tuple(val_h),
        m2l_tgt=fs.m2l_tgt.reshape(ndev, Kml),
        m2l_src=fs.m2l_src.reshape(ndev, Kml),
        m2l_val=fs.m2l_valid.reshape(ndev, Kml),
        m2l_h2=(fs.m2l_h2.reshape(ndev, Kml, -1) if folded
                else fs.m2l_h2.new_zeros(ndev, 1, 1)),
        m2l_w=(fs.m2l_w.reshape(ndev, Kml) if folded
               else fs.m2l_w.new_zeros(ndev, 1)),
        m2l_logc=(fs.m2l_logc.reshape(ndev, Kml) if folded
                  else fs.m2l_logc.new_zeros(ndev, 1)),
        m2l_gtgt=fs.m2l_gtgt.reshape(ndev, -1)
        if fs.m2l_gtgt.shape[0] % ndev == 0 and fs.m2l_gtgt.shape[0] > 1
        else torch.zeros((ndev, 1), dtype=torch.int32,
                         device=fs.m2l_gtgt.device))
    return lists, tuple(hops)


def local_csr(eng: KdFmmEngine, lists: PShardLists, hops: Tuple[int, ...],
              ndev: int, rank: int):
    """Rank `rank`'s near-field CSR over the concatenation ``[own blocks |
    visiting blocks of each non-zero hop, in the order of `hops`]``, from
    its rows of the hop lists.  Returns (halo hops, row_ptr
    [Gl * (1 + n_halo) + 1] int32, col2d [Gl * (1 + n_halo), dmax] int32):
    the first Gl rows are the rank's sub-leaves, the halo's rows have
    degree 0; an entry is ``blk' | bits << mask_shift`` with blk' the
    source block's index in the concatenation, and the sentinel block id
    is the concatenation's block count.  dmax is a multiple of 128 and
    never shrinks (``eng._pshard_caps``)."""
    Gl = (1 << eng.L) // ndev
    Glb = eng.G_blk // ndev
    shift = eng.mask_shift
    blkmask = (1 << shift) - 1
    halo = tuple(h for h in hops if h != 0)
    slot = {0: 0, **{h: 1 + i for i, h in enumerate(halo)}}
    tgt, ent = [], []
    for i, h in enumerate(hops):
        v = lists.p2p_val[i][rank]
        s_u = lists.p2p_src[i][rank][v].view(np.uint32).astype(np.int64)
        packed = ((s_u & blkmask) + slot[h] * Glb) | (s_u >> shift << shift)
        tgt.append(lists.p2p_tgt[i][rank][v].astype(np.int64))
        ent.append(packed.astype(np.uint32).view(np.int32).astype(np.int64))
    tgt, ent = np.concatenate(tgt), np.concatenate(ent)
    order = np.argsort(tgt, kind="stable")
    p2p = np.stack([tgt[order], ent[order]], axis=1)
    rows, blocks = Gl * (1 + len(halo)), Glb * (1 + len(halo))
    row_ptr = np.searchsorted(p2p[:, 0], np.arange(rows + 1),
                              side="left").astype(np.int32)
    deg = int(np.diff(row_ptr).max()) if p2p.shape[0] else 0
    caps = eng.__dict__.setdefault("_pshard_caps", {})
    dmax = caps["dmax"] = max(128, -(-deg // 128) * 128, caps.get("dmax", 0))
    return halo, row_ptr, _build_col2d(p2p, row_ptr, rows, blocks, dmax)


def local_entries(eng: KdFmmEngine, row_ptr: np.ndarray,
                  col2d: np.ndarray):
    """The entries of a rank's CSR (:func:`local_csr`) as a padded flat
    list for ``p2p_cuda.p2p_plain_entries``: (target row [Ke] int32, packed
    entry [Ke] int32), the valid prefix of every row in row-major order
    (the entries the CSR form reads, in its order), then pads with the
    target row count and a packed 0 (lane mask 0, so their pair weights
    are exactly 0 and their sums land in a dropped row).  Ke is 1.25 x the
    count rounded up to 1024 and never shrinks (``eng._pshard_caps``), so
    the sum's shapes stay put across adoptions."""
    rows = col2d.shape[0]
    deg = np.diff(row_ptr).clip(max=col2d.shape[1])
    tgt = np.repeat(np.arange(rows, dtype=np.int32), deg)
    ent = col2d[np.arange(col2d.shape[1])[None, :] < deg[:, None]]
    caps = eng.__dict__.setdefault("_pshard_caps", {})
    ke = caps["entries"] = max(-(-int(tgt.size * 1.25) // 1024) * 1024,
                               1024, caps.get("entries", 0))
    t = np.full(ke, rows, np.int32)
    e = np.zeros(ke, np.int32)
    t[:tgt.size], e[:ent.size] = tgt, ent
    return t, e


class PShardedKdFmm:
    """Particle-sharded force on padded leaf blocks; one object per rank.

    Usage (every rank):
        ps = PShardedKdFmm(eng, mesh)
        ppad = ps.shard_padded(eng.pad_array(pos, fs, fill=FAR))
        lists, hops = shard_pair_lists(eng, fs, ps.ndev)
        acc_l = ps.force_padded(ppad, fs, lists, hops)   # [G/P, C, dim]
        acc_pad = ps.gather_padded(acc_l)                # [G, C, dim]
    """

    def __init__(self, eng: KdFmmEngine, mesh: Mesh, axis: str = "dp"):
        self.eng = eng
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.ndev
        self.rank = mesh.rank
        G = 1 << eng.L
        assert G % self.ndev == 0
        self.Gl = G // self.ndev
        assert eng.G_blk % self.ndev == 0, \
            f"block count {eng.G_blk} not divisible by mesh {self.ndev}"
        self.Glb = eng.G_blk // self.ndev
        self._local = (None, None)     # (the lists localized last, result)

    def shard_padded(self, xpad: torch.Tensor) -> torch.Tensor:
        """This rank's leaf run [G/P, C, k] of a padded [G, C, k] array."""
        lo = self.rank * self.Gl
        return xpad[lo:lo + self.Gl].contiguous()

    def gather_padded(self, x_l: torch.Tensor) -> torch.Tensor:
        """The padded [G, C, k] array from every rank's run (one
        all_gather)."""
        return self.mesh.all_gather(x_l)

    def localize(self, lists: PShardLists, hops: Tuple[int, ...],
                 device) -> PShardLocal:
        """This rank's rows of `lists` on `device`, with its near-field
        CSR, and the CSR's padded entry list where the plain near-field
        sum reads it (a CPU device); kept for the `lists` object it was
        made from.  Host work, once a list adoption."""
        if self._local[0] is lists:
            return self._local[1]
        d = self.rank
        device = torch.device(device)
        halo, row_ptr, col2d = local_csr(self.eng, lists, hops, self.ndev, d)
        if device.type != "cpu":
            tgt = ent = np.zeros(0, np.int32)      # the kernel reads the CSR
        else:
            tgt, ent = local_entries(self.eng, row_ptr, col2d)
        loc = PShardLocal(
            hops=halo,
            row_ptr=torch.from_numpy(row_ptr).to(device),
            col2d=torch.from_numpy(col2d).to(device),
            m2l_tgt=lists.m2l_tgt[d].to(device),
            m2l_src=lists.m2l_src[d].to(device),
            m2l_val=lists.m2l_val[d].to(device),
            m2l_h2=lists.m2l_h2[d].to(device),
            m2l_w=lists.m2l_w[d].to(device),
            m2l_logc=lists.m2l_logc[d].to(device),
            m2l_gtgt=lists.m2l_gtgt[d].to(device),
            p2p_tgt=torch.from_numpy(tgt).to(device),
            p2p_src=torch.from_numpy(ent).to(device))
        self._local = (lists, loc)
        return loc

    def force_padded(self, ppad_l: torch.Tensor, fs: FmmState,
                     lists: PShardLists,
                     hops: Tuple[int, ...]) -> torch.Tensor:
        """Coulomb acceleration (kappa-scaled) on this rank's leaf run
        [G/P, C, dim] of the padded positions.  Every rank calls it with
        the same `fs`, `lists` and `hops` (the reference's signature; the
        lists are localized at their first use)."""
        return self.force_local(ppad_l, fs,
                                self.localize(lists, hops, ppad_l.device))

    def force_local(self, ppad_l: torch.Tensor, fs: FmmState,
                    loc: PShardLocal) -> torch.Tensor:
        """:meth:`force_padded` on lists already localized: it reads device
        tensors only, so a CUDA graph can capture it between its
        collectives (``utils/graphs.py``)."""
        far = self.far_padded(ppad_l, fs, loc)
        near = self.near_padded(self.halo_blocks(ppad_l, loc), loc)
        return (far + near.reshape(ppad_l.shape)) \
            * self.eng._kappa(ppad_l.dtype)

    # ---- the force's parts (each callable alone, for profiling) ----

    def far_padded(self, ppad_l: torch.Tensor, fs: FmmState,
                   loc: PShardLocal) -> torch.Tensor:
        """Far field on the rank's leaves, unscaled: local P2M, the leaf
        multipoles gathered, the replicated upper tree with this rank's
        share of the M2L entries (summed over ranks), local L2P."""
        eng, mesh = self.eng, self.mesh
        lo = self.rank * self.Gl
        V, leafl = eng._leaf_frame(ppad_l, fs, lo)
        mp_leaf = mesh.all_gather(eng._p2m(V, lo))            # [G, S_M]
        mpole_heap = eng.m2m_up(mp_leaf, fs)
        fs_m2l = fs._replace(m2l_tgt=loc.m2l_tgt, m2l_src=loc.m2l_src,
                             m2l_valid=loc.m2l_val, m2l_h2=loc.m2l_h2,
                             m2l_w=loc.m2l_w, m2l_logc=loc.m2l_logc,
                             m2l_gtgt=loc.m2l_gtgt)
        local_heap = mesh.all_reduce_sum(eng._stage_m2l(mpole_heap, fs_m2l))
        leaf_local = eng.l2l_down(local_heap, fs)             # [G, S_Lt]
        return eng._l2p(V, leafl, leaf_local[lo:lo + self.Gl], lo)

    def halo_blocks(self, ppad_l: torch.Tensor,
                    loc: PShardLocal) -> torch.Tensor:
        """``[own blocks | visiting blocks of each halo hop]``
        [Glb * (1 + n_halo), CB, dim]: one ring_shift per hop present.
        Each visiting block is copied into its slot as it arrives, so that
        work separates two ring_shifts (a CUDA graph's segment between two
        collectives is never empty, ``utils/graphs.py``)."""
        Glb = self.Glb
        own = ppad_l.reshape(Glb, self.eng.C_blk, self.eng.dim)
        cat = own.new_empty((Glb * (1 + len(loc.hops)),) + own.shape[1:])
        cat[:Glb] = own
        for i, h in enumerate(loc.hops, 1):
            cat[i * Glb:(i + 1) * Glb] = self.mesh.ring_shift(own, h)
        return cat

    def near_padded(self, cat: torch.Tensor,
                    loc: PShardLocal) -> torch.Tensor:
        """Near field of the rank's own blocks [Glb, CB, dim], unscaled,
        from :meth:`halo_blocks`: one pass over the concatenation.  The
        Hopper kernel on the CSR for a CUDA tensor, in dim 2 or 3 (as the
        single-device ``_stage_p2p``); the plain sum over the padded entry
        list for a CPU tensor, whose shapes never depend on the data and
        which is bitwise the plain sum over the CSR."""
        eng = self.eng
        if cat.device.type != "cpu":
            near = p2p_cuda.p2p(cat, loc.row_ptr, loc.col2d, eng.nsub,
                                eng.config.eps2)
        else:
            near = p2p_cuda.p2p_plain_entries(cat, loc.p2p_tgt, loc.p2p_src,
                                              eng.nsub, eng.config.eps2)
        return near[:self.Glb]


def _trap_force(ps: PShardedKdFmm, omega0_sq):
    """force(ppad_l, fs, loc): the sharded Coulomb force with the trap
    term, pads zeroed, on this rank's shard, from localized lists."""
    eng = ps.eng
    lo = ps.rank * ps.Gl

    def force(ppad_l, fs, loc):
        acc = add_elastic(ppad_l, ps.force_local(ppad_l, fs, loc),
                          omega0_sq)
        mask3 = eng.mask3(ppad_l.device)[lo:lo + ps.Gl]
        return torch.where(mask3[..., None], acc, 0.0)

    return force


def make_psharded_body(eng: KdFmmEngine, mesh: Mesh, config, omega0_sq,
                       axis: str = "dp"):
    """(ps, body): body(pstate, (fs, loc)) advances this rank's shard one
    integrator step against the frozen `fs` and the rank's localized lists
    `loc` (:meth:`PShardedKdFmm.localize`).  It reads device tensors only
    and its Python statics (the halo hops) sit in `loc`, so
    ``utils.graphs.StepGraph`` captures it, cut at its collectives: the
    twin of the step inside the reference's jitted ``fori_loop``, whose
    compile is cached per ``hops``."""
    ps = PShardedKdFmm(eng, mesh, axis)
    step = I.make_step(_trap_force(ps, omega0_sq), config.integrator,
                       config.dt)

    def body(pstate, frozen):
        fs, loc = frozen
        return step(pstate, fs, loc)

    return ps, body


def make_psharded_scan(eng: KdFmmEngine, mesh: Mesh, config, omega0_sq,
                       axis: str = "dp"):
    """(ps, scan_fn): the window loop on the SHARDED padded state.

    scan_fn(pstate, fs, lists, hops, k) advances this rank's shard k
    integrator steps against the frozen `fs` (no geometry refresh, see the
    module docstring): the lists are localized once, then the step body of
    :func:`make_psharded_body` runs k times eagerly.  The Simulator runs
    that body as CUDA graphs on CUDA tensors (``simulate.py``)."""
    ps, body = make_psharded_body(eng, mesh, config, omega0_sq, axis)

    def scan_fn(pstate, fs, lists, hops, k):
        frozen = (fs, ps.localize(lists, hops, pstate.pos.device))
        for _ in range(k):
            pstate = body(pstate, frozen)
        return pstate

    return ps, scan_fn


def make_psharded_step(eng: KdFmmEngine, mesh: Mesh, config, omega0_sq,
                       axis: str = "dp"):
    """(ps, step_fn): step_fn(pstate, fs, lists, hops) advances one
    leapfrog (or configured) step; pstate is a ParticleState of this rank's
    padded blocks.  The trap force is applied on the shard; pad slots
    (parked at FAR) are masked so they stay put."""
    ps, scan_fn = make_psharded_scan(eng, mesh, config, omega0_sq, axis)

    def step_fn(pstate, fs, lists, hops):
        return scan_fn(pstate, fs, lists, hops, 1)

    return ps, step_fn
