"""kd-tree FMM force engine on tensors.

Twin of ``coulomb_oscillators_tpu/ops/fmm/kdtree.py`` (reference
capability: fmm_cart3_kdtree.cuh), dim 3, float32.  The design is the
twin's: equal-count median splits make every segment boundary static, so
leaves pad to a fixed capacity C; the native C++ library builds the kd
order and runs the dual-tree MAC traversal on the host at rebuild time; the
near field is resolved at sub-leaf granularity and computed on directed
(target sub-leaf) x (source block) tiles with packed lane-group masks.

One layout on every device: C is always padded to the reference's lane
quantum ``max(128 >> sub_depth, 8)`` and the per-sub-leaf CSR
(``p2p_row_ptr``, ``p2p_col2d``) is always built, so the integer state
equals the reference engine's ``use_pallas=True`` build and the CPU and
CUDA paths never differ in layout.  On a CUDA tensor the P2P stage runs the
hand-written kernel (``p2p_cuda``); the far field is plain PyTorch.

Not ported here (see ROADMAP.md): the numpy ``_traverse_raw`` fallback and
the device Morton / kd builders, ``potential``, dim 2, float64, and the
reference's TPU-only workarounds (flattened P2P operand, optimization
barriers, the three-program force split, stored-fold M2L).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import List, NamedTuple

import numpy as np
import torch

from coulomb_oscillators_tpu_torch import native
from coulomb_oscillators_tpu_torch.config import SimConfig
from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
from coulomb_oscillators_tpu_torch.ops.multipole import operators as mop
from coulomb_oscillators_tpu_torch.ops.multipole.tables import build_tables

FAR = p2p_cuda.FAR

# Reference defaults, fixed here (the reference's env overrides and
# constructor knobs are not ported): ~32-particle sub-leaves, grouped M2L
# with g = 8, M2L list capacity quantum 65536 (the reference's m2l_chunk),
# and the M2L entries processed per chunk of the eager loop (bounds the
# [chunk, terms] temporaries).
LEAF_TARGET = 32
M2L_GROUP = 8
M2L_CAP_QUANTUM = 65536
M2L_LOOP_CHUNK = 1 << 19


def auto_level(n: int, p: int, dens_inhom: float = 1.0,
               tree_L: int = 0, leaf_target: int = 0) -> int:
    """Level heuristic (reference formula fmm_cart3_kdtree.cuh:1502-1515,
    aimed at `leaf_target` particles per leaf when given)."""
    if tree_L > 0:
        L = tree_L
    else:
        tgt = leaf_target if leaf_target > 0 else p * p
        L = int(round(math.log2(max(dens_inhom * n / tgt, 1.0))))
    L = max(2, min(L, 30))
    while (1 << L) > max(n, 2):
        L -= 1
    return max(L, 1)


class FmmState(NamedTuple):
    """Device state frozen between tree rebuilds (the reference's fields
    minus the stored-fold M2L geometry, which fly mode never reads)."""
    perm: torch.Tensor        # [n] sorted slot -> original particle index
    inv_perm: torch.Tensor    # [n] original particle index -> sorted slot
    center: torch.Tensor      # [Mheap, dim] expansion centers
    lam: torch.Tensor         # [Mheap] node length scales (half-diagonal)
    p2p_tgt: torch.Tensor     # [Kp] sub-leaf index of target
    p2p_src: torch.Tensor     # [Kp] packed source block entry
    p2p_valid: torch.Tensor   # [Kp] bool
    m2l_tgt: torch.Tensor     # [Km] heap index of target (directed)
    m2l_src: torch.Tensor     # [Km] heap index of source (directed)
    m2l_valid: torch.Tensor   # [Km] bool
    p2p_row_ptr: torch.Tensor  # [Gsub+1] CSR over the valid prefix
    p2p_col2d: torch.Tensor    # [Gsub, Dmax] packed partner entries
    m2l_gtgt: torch.Tensor     # [Km/g] target heap index per group of g


def _upload(a, device) -> torch.Tensor:
    """Host array (or tensor) -> tensor on `device`.  CUDA uploads go
    through pinned memory without blocking, so a background rebuild never
    waits for the kernels queued ahead of it."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if torch.device(device).type == "cuda":
        t = torch.from_numpy(np.array(a, order="C"))
        return t.pin_memory().to(device, non_blocking=True)
    return torch.tensor(a)


def fmm_state_from_numpy(d: dict, device) -> FmmState:
    """FmmState from host arrays keyed by field name (extra keys, such as
    the reference's stored-fold fields, are not read)."""
    return FmmState(**{k: _upload(np.asarray(d[k]), device)
                       for k in FmmState._fields})


@dataclasses.dataclass
class _Static:
    """Host-side static structure for a given (n, L)."""
    n: int
    L: int
    beg: List[np.ndarray]          # beg[l][i], len 2^l + 1
    seg: List[np.ndarray]          # seg[l][slot] -> segment id (int32)
    C: int                         # leaf capacity
    pad_gather: np.ndarray         # [2^L * C] -> slot (clamped)
    pad_mask: np.ndarray           # [2^L * C] bool
    unpad_gather: np.ndarray       # [n] -> padded slot
    mult: np.ndarray               # [Mheap] node particle counts


@functools.lru_cache(maxsize=32)
def _static_structure(n: int, L: int, pad_to: int = 1) -> _Static:
    beg = []
    seg = []
    for l in range(L + 1):
        m = 1 << l
        b = (np.arange(m + 1, dtype=np.int64) * n) // m
        beg.append(b)
        seg.append(np.repeat(np.arange(m, dtype=np.int32), np.diff(b)))
    C = -(-n // (1 << L))
    C = -(-C // pad_to) * pad_to
    G = 1 << L
    slot = beg[L][:-1][:, None] + np.arange(C)[None, :]      # [G, C]
    mask = slot < beg[L][1:][:, None]
    pad_gather = np.minimum(slot, n - 1).reshape(-1).astype(np.int32)
    pad_mask = mask.reshape(-1)
    unpad = np.zeros(n, dtype=np.int32)
    padded_ids = np.arange(G * C)[pad_mask]
    unpad[slot.reshape(-1)[pad_mask]] = padded_ids
    mult = np.concatenate([np.diff(beg[l]) for l in range(L + 1)]
                          ).astype(np.int32)
    return _Static(n=n, L=L, beg=beg, seg=seg, C=C,
                   pad_gather=pad_gather, pad_mask=pad_mask,
                   unpad_gather=unpad, mult=mult)


def _heap_off(l: int) -> int:
    return (1 << l) - 1


def _pad_pairs(pairs: np.ndarray, cap: int, dummy_tgt: int):
    k = pairs.shape[0]
    tgt = np.full(cap, dummy_tgt, dtype=np.int32)
    src = np.zeros(cap, dtype=np.int32)
    valid = np.zeros(cap, dtype=bool)
    tgt[:k] = pairs[:, 0]
    src[:k] = pairs[:, 1]
    valid[:k] = True
    return tgt, src, valid


def _round_cap(k: int, quantum: int = 8192, headroom: float = 1.25) -> int:
    """Padded list capacity: headroom rounded to `quantum`."""
    return max(quantum, -(-int(k * headroom) // quantum) * quantum)


def _pick_chunk(K: int, target: int, mult: int = 1) -> int:
    """Largest divisor-of-K chunk size near `target`; `mult` constrains the
    chunk to a multiple (grouped-M2L run size)."""
    if K <= target:
        return max(K, 1)
    nch = max(1, -(-K // target))
    while K % nch or (K // nch) % mult:
        nch += 1
    return K // nch


def _build_col2d(p2p: np.ndarray, row_ptr: np.ndarray, G: int, Gblk: int,
                 dmax: int) -> np.ndarray:
    """Dense per-target partner table [G, dmax] from the target-sorted
    pair list; padding entries hold the sentinel block id Gblk (the twin
    builds the same table with one device scatter)."""
    col = np.full((G + 1, dmax), Gblk, np.int32)
    tgt = p2p[:, 0].astype(np.int64)
    ranks = np.clip(np.arange(tgt.shape[0]) - row_ptr[tgt], 0, dmax - 1)
    col[tgt, ranks] = p2p[:, 1]
    return col[:G]


class _DeviceStatic:
    """The static structure's index tensors on one device."""

    def __init__(self, st: _Static, G: int, device):
        self.pad_gather = torch.as_tensor(st.pad_gather.astype(np.int64),
                                          device=device)
        self.unpad_gather = torch.as_tensor(
            st.unpad_gather.astype(np.int64), device=device)
        self.pad_mask = torch.as_tensor(st.pad_mask, device=device)
        self.mask3 = self.pad_mask.reshape(G, st.C)
        self.multf = torch.as_tensor(
            np.maximum(st.mult, 1).astype(np.float32), device=device)


class KdFmmEngine:
    """kd-tree FMM engine for a fixed particle count (dim 3, float32).

    Usage:
        eng = KdFmmEngine(config, n)
        fstate = eng.build(pos)          # at t=0 and every tree_steps steps
        acc = eng.force(pos, fstate)
    """

    def __init__(self, config: SimConfig, n: int, sub_depth: int = 2):
        if config.dim != 3:
            raise NotImplementedError(
                "the port's kd engine is dim 3 only; fmm2_kd is a "
                "ROADMAP.md item (queue 1, item 9)")
        if config.precision != "float32":
            raise NotImplementedError(
                "the port's kd engine is float32 only; float64 is a "
                "ROADMAP.md item (queue 1, item 9)")
        self.config = config
        self.n = n
        self.dim = config.dim
        # p=1 is monopole-only (PM=0), matching the reference's fmm_order=1
        self.p = max(config.fmm_order, 1)
        self.L = auto_level(n, self.p, config.dens_inhom, config.tree_L,
                            LEAF_TARGET)
        # dual granularity only on the auto-level geometry (the twin
        # explains why a forced coarser tree falls back to leaf MAC)
        auto_L = auto_level(n, self.p, config.dens_inhom, 0, LEAF_TARGET)
        self.sub_depth = max(0, min(sub_depth, self.L)) \
            if self.L >= auto_L else 0
        # MAC multiplicity floor at block occupancy (see the twin)
        self.mac_mult_floor = (-(-n // (1 << (self.L - self.sub_depth)))
                               if self.sub_depth else 1)
        # sub-block acceptance-radius boost: explicit config > accuracy-
        # grade auto (2.0 below a 1e-4 bound) > throughput default 1.5
        if not self.sub_depth:
            self.mac_sub_boost = 1.0
        elif config.mac_sub_boost > 0.0:
            self.mac_sub_boost = float(config.mac_sub_boost)
        elif 0.0 < config.accuracy < 1e-4:
            self.mac_sub_boost = 2.0
        else:
            self.mac_sub_boost = 1.5
        # COC centers: the dipole is identically zero -> no order-1 slots
        self.tables = build_tables(self.dim, self.p, no_dipole=True)
        self.m2l_group = M2L_GROUP
        self.st = _static_structure(n, self.L,
                                    pad_to=max(128 >> self.sub_depth, 8))
        self.caps = {"p2p": 8192, "m2l": M2L_CAP_QUANTUM}
        self.stale_margin_abs = 0.0
        self._dev = {}

    @property
    def G_sub(self) -> int:
        return 1 << self.L

    @property
    def G_blk(self) -> int:
        return 1 << (self.L - self.sub_depth)

    @property
    def C_blk(self) -> int:
        return self.st.C << self.sub_depth

    @property
    def nsub(self) -> int:
        return 1 << self.sub_depth

    @property
    def mask_shift(self) -> int:
        """Bit position of the sub-leaf group mask inside packed source
        block ids (top 2^sub_depth bits of the int32)."""
        return 32 - (1 << self.sub_depth)

    def dev(self, device) -> _DeviceStatic:
        device = torch.device(device)
        if device not in self._dev:
            self._dev[device] = _DeviceStatic(self.st, self.G_sub, device)
        return self._dev[device]

    def mask3(self, device) -> torch.Tensor:
        """[G, C] validity of padded slots."""
        return self.dev(device).mask3

    # ---------------- build (host) ----------------
    def build(self, pos: torch.Tensor) -> FmmState:
        """Tree (re)build: native kd sort + geometry + traversal on the
        host, lists uploaded to the device of `pos`."""
        return self.adopt(self.build_host(pos), pos.device)

    def build_host(self, pos: torch.Tensor) -> tuple:
        """The whole host side of a rebuild from original-order positions;
        returns the ingredients for :meth:`adopt`."""
        bt = {}
        t0 = time.perf_counter()
        pos_h = pos.detach().to("cpu", torch.float32).numpy()
        bt["fetch"] = time.perf_counter() - t0
        return self._build_host_from(pos_h, bt)

    def build_host_padded(self, ppad_h: np.ndarray,
                          inv_perm_old: np.ndarray) -> tuple:
        """:meth:`build_host` fed from a host copy of the PADDED positions
        and the inverse permutation they are padded under."""
        bt = {}
        t0 = time.perf_counter()
        flat = np.asarray(ppad_h, dtype=np.float32).reshape(-1, self.dim)
        # particle o sits at sorted slot inv[o], padded slot unpad[inv[o]]
        pos_h = flat[self.st.unpad_gather[np.asarray(inv_perm_old)]]
        bt["unpad_host"] = time.perf_counter() - t0
        return self._build_host_from(pos_h, bt)

    def _build_host_from(self, pos_h: np.ndarray, bt: dict) -> tuple:
        t0 = time.perf_counter()
        perm = native.kdtree_build(pos_h, self.L)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.n, dtype=perm.dtype)
        bt["kd"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        c_h, lb_h, rb_h, lam_h = native.node_geometry(pos_h[perm], self.L)
        bt["geom"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        m2l, p2p = self._traverse(c_h, lb_h, rb_h)
        bt["traverse"] = time.perf_counter() - t0
        return (perm, inv, c_h, lam_h, m2l, p2p, bt)

    def adopt(self, built: tuple, device) -> FmmState:
        """Upload a :meth:`build_host` result to `device`."""
        perm, inv, c_h, lam_h, m2l, p2p, bt = built
        return self._lists_to_state(perm, inv, c_h, lam_h, m2l, p2p,
                                    dict(bt), device)

    def _traverse(self, c_h, lb_h, rb_h):
        """Native dual-granularity traversal with the temporal MAC slack
        (node bounds inflated by `stale_margin_abs`, a scalar or a per-axis
        vector, so frozen lists stay admissible for the reuse window).
        Returns (m2l_directed, near), target-sorted."""
        sm = self.stale_margin_abs
        if np.any(np.asarray(sm) > 0.0):
            lb_h = (lb_h - sm).astype(lb_h.dtype)
            rb_h = (rb_h + sm).astype(rb_h.dtype)
        # seed capacities from the previous traversal
        last = getattr(self, "last_raw_counts", None) or {}
        caps = {k: max(1 << 20, int(last.get(k, 0) * 1.3))
                for k in ("m2l", "near")}
        m2l_d, near = native.traverse_fine(
            c_h, lb_h, rb_h, self.st.mult, self.L, self.sub_depth, self.n,
            self.dim, self.p, float(self.config.tree_radius),
            self.config.coll, mult_floor=self.mac_mult_floor,
            sub_boost=self.mac_sub_boost,
            m2l_cap=caps["m2l"], near_cap=caps["near"])
        self.last_raw_counts = {"m2l": int(m2l_d.shape[0]),
                                "near": int(near.shape[0])}
        return m2l_d, near

    def _lists_to_state(self, perm, inv_perm, center, lam, m2l, p2p, bt,
                        device) -> FmmState:
        """Pad pair lists to caps, build the grouped M2L layout and the P2P
        CSR, upload, assemble FmmState (the twin's logic, with the CSR
        always built)."""
        t0 = time.perf_counter()
        self.last_counts = {"m2l": int(m2l.shape[0]),
                            "p2p": int(p2p.shape[0])}
        Mheap = _heap_off(self.L + 1)
        g = self.m2l_group
        # grouped layout: each target's (sorted, contiguous) entry run is
        # padded to a multiple of g; caps["m2l"] tracks the grouped length
        tgt = m2l[:, 0].astype(np.int64)
        deg = np.bincount(tgt, minlength=Mheap)
        pdeg = -(-deg // g) * g
        off = np.zeros(Mheap + 1, np.int64)
        np.cumsum(pdeg, out=off[1:])
        rp = np.zeros(Mheap + 1, np.int64)
        np.cumsum(deg, out=rp[1:])
        posn = np.arange(m2l.shape[0], dtype=np.int64)
        posn += np.repeat(off[:-1] - rp[:-1], deg)
        k2 = int(off[-1])
        # caps: quantized, headroom, geometric overflow growth (the twin's
        # policy; equal caps keep the state equal to the twin's)
        for name, klen, q, hr in (("m2l", k2, M2L_CAP_QUANTUM, 1.08),
                                  ("p2p", p2p.shape[0], 8192, 1.25)):
            if klen > self.caps[name]:
                grown = -(-(self.caps[name] * 5 // 4) // q) * q
                self.caps[name] = max(_round_cap(klen, q, hr),
                                      grown if self.caps[name] else 0)
        G = self.G_sub
        cap = self.caps["m2l"]
        m2l_t = np.full(cap, Mheap, dtype=np.int32)
        m2l_s = np.zeros(cap, dtype=np.int32)
        m2l_v = np.zeros(cap, dtype=bool)
        m2l_t[posn] = m2l[:, 0]
        m2l_s[posn] = m2l[:, 1]
        m2l_v[posn] = True
        # group target = min over the group (pad slots carry the Mheap
        # sentinel; all-pad tail groups stay at the sentinel)
        m2l_gt = m2l_t.reshape(-1, g).min(axis=1)
        p2p_t, p2p_s, p2p_v = _pad_pairs(p2p, self.caps["p2p"], G)
        row_ptr = np.searchsorted(p2p[:, 0], np.arange(G + 1),
                                  side="left").astype(np.int32)
        degrees = np.diff(row_ptr)
        dmax = int(degrees.max()) if degrees.size else 1
        if dmax > self.caps.get("dmax", 0):
            grown = self.caps.get("dmax", 0) * 5 // 4
            dmax = max(128, -(-max(int(dmax * 1.25), grown) // 128) * 128)
            self.caps["dmax"] = dmax
        dmax = self.caps["dmax"]
        col2d = _build_col2d(p2p, row_ptr, G, self.G_blk, dmax)
        bt["lists"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = FmmState(
            perm=_upload(perm, device), inv_perm=_upload(inv_perm, device),
            center=_upload(center, device), lam=_upload(lam, device),
            p2p_tgt=_upload(p2p_t, device), p2p_src=_upload(p2p_s, device),
            p2p_valid=_upload(p2p_v, device),
            m2l_tgt=_upload(m2l_t, device), m2l_src=_upload(m2l_s, device),
            m2l_valid=_upload(m2l_v, device),
            p2p_row_ptr=_upload(row_ptr, device),
            p2p_col2d=_upload(col2d, device),
            m2l_gtgt=_upload(m2l_gt, device))
        bt["upload"] = time.perf_counter() - t0
        self.last_build_times = bt
        return out

    def refresh(self, ppad: torch.Tensor, fs: FmmState,
                perm=None, inv_perm=None) -> FmmState:
        """Exact geometry + pair-list rebuild for an existing padded
        layout: node bounds/centers from on-device leaf stats, MAC
        re-traversal on the host, lists re-uploaded.  Pass perm/inv_perm
        when ppad was padded under a new permutation."""
        bt = {}
        t0 = time.perf_counter()
        h = torch.stack(self._leaf_stats(ppad)).cpu().numpy()  # [3, G, dim]
        bt["geom_dev"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        L, dim = self.L, self.dim
        G = 1 << L
        M = (1 << (L + 1)) - 1
        mn = np.empty((M, dim), np.float32)
        mx = np.empty((M, dim), np.float32)
        sm = np.empty((M, dim), np.float64)
        mn[G - 1:] = h[0]
        mx[G - 1:] = h[1]
        sm[G - 1:] = h[2]
        for l in range(L - 1, -1, -1):
            off, offc, m = (1 << l) - 1, (1 << (l + 1)) - 1, 1 << l
            mn[off:off + m] = np.minimum(mn[offc:offc + 2 * m:2],
                                         mn[offc + 1:offc + 2 * m:2])
            mx[off:off + m] = np.maximum(mx[offc:offc + 2 * m:2],
                                         mx[offc + 1:offc + 2 * m:2])
            sm[off:off + m] = (sm[offc:offc + 2 * m:2]
                               + sm[offc + 1:offc + 2 * m:2])
        cnt = self.st.mult.astype(np.float64)[:, None]
        center = (sm / cnt).astype(np.float32)
        lam = np.maximum(0.5 * np.linalg.norm(mx - mn, axis=1),
                         1e-30).astype(np.float32)
        bt["geom_host"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        m2l, p2p = self._traverse(center, mn, mx)
        bt["traverse"] = time.perf_counter() - t0
        return self._lists_to_state(
            fs.perm if perm is None else perm,
            fs.inv_perm if inv_perm is None else inv_perm,
            center, lam, m2l, p2p, bt, ppad.device)

    def _leaf_stats(self, ppad: torch.Tensor):
        """Per-leaf (min, max, sum) over valid slots: 3 x [G, dim]."""
        mask = self.mask3(ppad.device)[..., None]
        big = 3e38
        mn = torch.where(mask, ppad, big).amin(dim=1)
        mx = torch.where(mask, ppad, -big).amax(dim=1)
        sm = torch.where(mask, ppad, 0.0).sum(dim=1)
        return mn, mx, sm

    def geom_refresh(self, ppad: torch.Tensor, fs: FmmState) -> FmmState:
        """Node centers / length scales from the CURRENT padded positions
        (one leaf reduce + heap sweep on device), lists and permutation
        frozen.  Fly-mode M2L reads geometry straight from center/lam, so
        nothing else needs refreshing."""
        mn, mx, sm = self._leaf_stats(ppad)
        lmn, lmx, lsm = [mn], [mx], [sm]
        for _ in range(self.L):
            a, b, c = lmn[-1], lmx[-1], lsm[-1]
            lmn.append(torch.minimum(a[0::2], a[1::2]))
            lmx.append(torch.maximum(b[0::2], b[1::2]))
            lsm.append(c[0::2] + c[1::2])
        mnh = torch.cat(lmn[::-1])
        mxh = torch.cat(lmx[::-1])
        smh = torch.cat(lsm[::-1])
        center = smh / self.dev(ppad.device).multf[:, None]
        lam = torch.clamp(0.5 * torch.linalg.vector_norm(mxh - mnh, dim=1),
                          min=1e-30)
        return fs._replace(center=center, lam=lam)

    # ---------------- padded layout ----------------
    def pad_array(self, x: torch.Tensor, fs: FmmState,
                  fill: float = 0.0) -> torch.Tensor:
        """Original-order [n, k] -> padded leaf blocks [G, C, k]."""
        d = self.dev(x.device)
        x_s = x[fs.perm.long()]
        flat = torch.where(d.pad_mask[:, None], x_s[d.pad_gather], fill)
        return flat.reshape(self.G_sub, self.st.C, x.shape[1])

    def unpad_array(self, xpad: torch.Tensor, fs: FmmState) -> torch.Tensor:
        """Padded [G, C, k] -> original-order [n, k]."""
        d = self.dev(xpad.device)
        xs = xpad.reshape(-1, xpad.shape[-1])[d.unpad_gather]
        return xs[fs.inv_perm.long()]

    def make_repad(self, fs_old: FmmState, fs_new: FmmState) -> torch.Tensor:
        """[G*C] gather map: new padded slot -> old padded slot.  Original
        particle o = perm_new[pad_gather[i]] sits at old sorted slot
        inv_old[o], old padded slot unpad_gather[inv_old[o]]."""
        d = self.dev(fs_new.perm.device)
        o = fs_new.perm.long()[d.pad_gather]
        return d.unpad_gather[fs_old.inv_perm.long()[o]]

    def repad_triple(self, ppos, pvel, pacc, remap):
        """Apply a :meth:`make_repad` map to the padded (pos, vel, acc)."""
        d = self.dev(ppos.device)
        G, C, dim = self.G_sub, self.st.C, self.dim

        def g(x, fill):
            flat = x.reshape(G * C, dim)[remap]
            return torch.where(d.pad_mask[:, None], flat,
                               fill).reshape(G, C, dim)

        return g(ppos, FAR), g(pvel, 0.0), g(pacc, 0.0)

    # ---------------- force ----------------
    def force(self, pos: torch.Tensor, fs: FmmState) -> torch.Tensor:
        """Coulomb acceleration (kappa-scaled) in the ORIGINAL particle
        order: pad, padded force, unpad."""
        ppad = self.pad_array(pos, fs, fill=FAR)
        return self.unpad_array(self.force_padded(ppad, fs), fs)

    def force_padded(self, ppad: torch.Tensor, fs: FmmState) -> torch.Tensor:
        """Coulomb acceleration on padded blocks [G, C, dim], kappa-scaled
        (twin of ``force_padded_in_jit``).  Pad slots (pos = FAR) receive
        ~0; mask before integrating."""
        t = self.tables
        G, C, dim = self.G_sub, self.st.C, self.dim
        leaf0 = _heap_off(self.L)
        d = self.dev(ppad.device)
        mask = d.mask3[..., None]
        kappa = float(np.float32(self.config.kappa(self.n)))

        # leaf frames: normalized offsets, 0 at pads
        leafc = fs.center[leaf0:leaf0 + G]
        leafl = fs.lam[leaf0:leaf0 + G]
        e = (ppad - leafc[:, None, :]) / leafl[:, None, None]
        e = torch.where(mask, e, 0.0)
        V = mop.eval_monomial_cols(e, t.PL, dim)           # [G, C, S_Lf]

        # P2M: masked offsets are 0, so only the order-0 column needs the
        # static leaf count; layouts nest, so m_slots index V's layout
        slots = torch.as_tensor(t.m_slots[1:].astype(np.int64),
                                device=ppad.device)
        coef = torch.as_tensor(t.p2m_coef[1:], dtype=ppad.dtype,
                               device=ppad.device)
        counts = d.multf[leaf0:][:, None]
        mpole_leaf = torch.cat(
            [counts, V.index_select(2, slots).sum(dim=1) * coef], dim=1)

        mpole_heap = self.m2m_up(mpole_leaf, fs)
        local_heap = self._stage_m2l(mpole_heap, fs)
        leaf_local = self.l2l_down(local_heap, fs)

        # L2P: fold the derivative table into the per-leaf locals first,
        # W[g, a, k] = sum_j D[a, j, k] Lf[g, j], then contract against the
        # particle monomials
        Lf = mop.expand_L(t, leaf_local)                    # [G, S_Lf]
        W = (Lf @ self._l2p_matrix(ppad.dtype, ppad.device)).reshape(
            G, dim, t.S_Lf)
        far = -torch.bmm(V, W.transpose(1, 2)) / leafl[:, None, None]
        far = far * mask

        near = self._stage_p2p(ppad, fs)
        return (far + near) * kappa

    def _l2p_matrix(self, dtype, device) -> torch.Tensor:
        """[S_Lf, dim*S_Lf] with D[j, a*S_Lf + k] = coef of Lf[j]*V[k] in
        the field's axis a (the twin's ``_l2p_terms``), cached per device."""
        key = ("l2p", dtype, torch.device(device))
        if key not in self._dev:
            t = self.tables
            D = np.zeros((t.S_Lf, t.dim, t.S_Lf))
            for a, row in enumerate(mop._l2p_terms(t.dim, t.PL)):
                for (j, k, c) in row:
                    D[j, a, k] = c
            self._dev[key] = torch.as_tensor(D.reshape(t.S_Lf, -1),
                                             dtype=dtype, device=device)
        return self._dev[key]

    def m2m_up(self, mpole_leaf: torch.Tensor, fs: FmmState) -> torch.Tensor:
        """M2M sweep: leaf multipoles [G, S_M] -> full heap [Mheap, S_M]."""
        t = self.tables
        L = self.L
        mpoles = [None] * (L + 1)
        mpoles[L] = mpole_leaf
        for l in range(L - 1, -1, -1):
            m = 1 << l
            off_c, off_p = _heap_off(l + 1), _heap_off(l)
            cc = fs.center[off_c:off_c + 2 * m]
            cl = fs.lam[off_c:off_c + 2 * m]
            parent_c = fs.center[off_p:off_p + m].repeat_interleave(2, dim=0)
            parent_l = fs.lam[off_p:off_p + m].repeat_interleave(2, dim=0)
            s = (cc - parent_c) / parent_l[:, None]
            rho = cl / parent_l
            shifted = mop.m2m(t, mpoles[l + 1], s, rho)       # [2m, S_M]
            mpoles[l] = shifted.reshape(m, 2, -1).sum(dim=1)
        return torch.cat(mpoles, dim=0)

    def _stage_m2l(self, mpole_heap: torch.Tensor,
                   fs: FmmState) -> torch.Tensor:
        """Grouped fly-mode M2L over the directed entry list (t <- s):
        per chunk, gather source multipoles and the entries' geometry from
        center/lam, apply m2l_fold_geo -> m2l_sparse_pre, dense-reduce each
        group of g same-target entries, and add the groups into an
        [Mheap+1, S_Lt] accumulator with a sorted index_add_ (the twin's
        segment_sum).  Returns local_heap [Mheap, S_Lt]."""
        t = self.tables
        Mheap = _heap_off(self.L + 1)
        g = self.m2l_group
        K = fs.m2l_tgt.shape[0]
        if fs.m2l_gtgt.shape[0] * g != K:
            raise ValueError("M2L lists are not in the grouped layout")
        chunk = _pick_chunk(K, M2L_LOOP_CHUNK, g)
        center, lam = fs.center, fs.lam
        acc = torch.zeros(Mheap + 1, t.S_Lt, dtype=mpole_heap.dtype,
                          device=mpole_heap.device)
        for c0 in range(0, K, chunk):
            bi = fs.m2l_src[c0:c0 + chunk].long()
            vv = fs.m2l_valid[c0:c0 + chunk]
            a_cl = fs.m2l_tgt[c0:c0 + chunk].long().clamp(max=Mheap - 1)
            R = tuple(torch.where(vv, center[a_cl, k] - center[bi, k], 1.0)
                      for k in range(self.dim))
            H2, w, logc = mop.m2l_fold_geo(t, R, lam[a_cl], lam[bi])
            La = mop.m2l_sparse_pre(t, mpole_heap[bi], H2, w, logc)
            La = (La * vv[:, None]).reshape(-1, g, t.S_Lt).sum(dim=1)
            gta = fs.m2l_gtgt[c0 // g:(c0 + chunk) // g].long()
            acc.index_add_(0, gta, La)
        return acc[:Mheap]

    def l2l_down(self, local_heap: torch.Tensor,
                 fs: FmmState) -> torch.Tensor:
        """L2L sweep: local heap [Mheap, S_Lt] -> leaf locals [G, S_Lt]."""
        t = self.tables
        locs = local_heap[0:1]
        for l in range(1, self.L + 1):
            m = 1 << l
            off, off_p = _heap_off(l), _heap_off(l - 1)
            cc = fs.center[off:off + m]
            cl = fs.lam[off:off + m]
            pc = fs.center[off_p:off_p + m // 2].repeat_interleave(2, dim=0)
            pl = fs.lam[off_p:off_p + m // 2].repeat_interleave(2, dim=0)
            s = (cc - pc) / pl[:, None]
            rho = cl / pl
            shifted = mop.l2l(t, locs.repeat_interleave(2, dim=0), s, rho)
            locs = shifted + local_heap[off:off + m]
        return locs                                           # [G, S_Lt]

    def _stage_p2p(self, ppad: torch.Tensor, fs: FmmState) -> torch.Tensor:
        """Near-field pass on padded blocks: [G, C, dim], unscaled.  CUDA
        tensors run the Hopper kernel, CPU tensors its plain version."""
        pblk = ppad.reshape(self.G_blk, self.C_blk, self.dim)
        out = p2p_cuda.p2p(pblk.contiguous(), fs.p2p_row_ptr, fs.p2p_col2d,
                           self.nsub, self.config.eps2)
        return out.reshape(self.G_sub, self.st.C, self.dim)
