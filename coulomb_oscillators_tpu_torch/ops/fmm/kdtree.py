"""kd-tree FMM force engine on tensors.

Twin of ``coulomb_oscillators_tpu/ops/fmm/kdtree.py`` (reference
capability: fmm_cart3_kdtree.cuh), dims 2 and 3, float32 and float64.  The
design is the twin's: equal-count median splits make every segment
boundary static, so leaves pad to a fixed capacity C; the tree order comes
from the native C++ kd builder on the host or from a device builder (Morton
or per-level kd sort), the dual-tree MAC traversal runs at rebuild time on
the card for particles on a card (``traverse.py``, the native library's
decisions bit for bit) and on the host for particles on the CPU (the
native library, or the numpy ``_traverse_raw`` where the library is
absent); the near field is resolved at sub-leaf granularity and
computed on directed (target sub-leaf) x (source block) tiles with packed
lane-group masks.  The pair lists are laid out into the state's list
fields (caps, grouped M2L, CSR, dense partner table) by one tensor
implementation on the device the lists are on: a card's traversal leaves
them on the card, where they are laid out on its side stream and never
copied to the host (see :meth:`KdFmmEngine._lists_to_state`).

One layout on every device and in both dims: C is always padded to the
reference's lane quantum ``max(128 >> sub_depth, 8)`` and the per-sub-leaf
CSR (``p2p_row_ptr``, ``p2p_col2d``) is always built, so the integer state
equals the reference engine's ``use_pallas=True`` build and the CPU and
CUDA paths never differ in layout.  A CUDA tensor's P2P stage runs the
hand-written kernel (``p2p_cuda``, float32 or float64) in both dims, as the
reference's kernel computes both (its ``dim`` argument).  The reference's
engine keeps dim 2 on its jnp scan for TPU reasons (the FAR pads' 1/r^2
weight does not underflow, and its block SoA has a VMEM budget); on the
card the dim-2 kernel's float32 pad skip drops terms of ~5e-19 a pad,
below the float32 resolution of a real target's sum (``csrc/p2p.cu``,
"Pads").  A CPU tensor's P2P stage is the plain sum.  The far field is
plain PyTorch.  Geometry stays in the working dtype; the native builder and
traversal take float32 copies, as in the reference.

The M2L geometry has the reference's two modes, chosen by ``CO_M2L_FLY``
at engine init: fly mode (the default) folds each entry's geometry from
``center``/``lam`` inside the M2L loop at every force evaluation; stored
mode (``CO_M2L_FLY=0``) folds it once per list adoption (and again at each
geometry refresh) into ``m2l_h2``/``m2l_w``/``m2l_logc``, which the loop
reads.

Not ported (TPU-only workarounds, see ROADMAP.md): the flattened P2P
operand, optimization barriers and the three-program force split.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import threading
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from coulomb_oscillators_tpu_torch import native
from coulomb_oscillators_tpu_torch.config import SimConfig, round_to_dtype
from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda, traverse
from coulomb_oscillators_tpu_torch.ops.multipole import operators as mop
from coulomb_oscillators_tpu_torch.ops.multipole.tables import build_tables
from coulomb_oscillators_tpu_torch.utils import profiling as P

FAR = p2p_cuda.FAR

# Reference defaults, fixed here: M2L list capacity quantum 65536 (the
# reference's m2l_chunk), and the M2L entries processed per chunk of the
# eager loop (bounds the [chunk, terms] temporaries).
M2L_CAP_QUANTUM = 65536
M2L_LOOP_CHUNK = 1 << 19
# pairs per chunk of the near-field potential (bounds its [k, C, CB]
# temporaries)
_NEAR_PAIRS = 1 << 25


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
    """Device state frozen between tree rebuilds (the reference's fields,
    in its order)."""
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
    m2l_h2: torch.Tensor      # [Km, S_H] folded per-entry harmonics
                              # (stored mode; [1, 1] zeros in fly mode)
    m2l_w: torch.Tensor       # [Km] lam_src/lam_tgt scale ratio ([1])
    m2l_logc: torch.Tensor    # [Km] 2D monopole log correction, zeros in
                              # 3D ([1])
    p2p_row_ptr: torch.Tensor  # [Gsub+1] CSR over the valid prefix
    p2p_col2d: torch.Tensor    # [Gsub, Dmax] packed partner entries
    m2l_gtgt: torch.Tensor     # [Km/g] target heap index per group of g


def fmm_state_from_numpy(d: dict, device) -> FmmState:
    """FmmState from host arrays keyed by field name (a reference state's
    fields convert directly, stored-fold or fly-mode)."""
    return FmmState(**{k: torch.from_numpy(np.array(d[k])).to(device)
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


# --------------------------------------------------------------------------- #
# List layout: the traversal's pair lists -> the state's list fields
# --------------------------------------------------------------------------- #

# list layouts by where they ran: on a card (the lists of the card's
# traversal) or on the host (the native or numpy traversal's lists); a run
# that must show where its layouts ran reads these
device_layouts = 0
host_layouts = 0


def layout_sizes(m2l: torch.Tensor, near: torch.Tensor, Mheap: int, G: int,
                 g: int):
    """The layout's first half, on the device of the target-sorted lists
    m2l [Km, 2] (heap target, source) and near [Q, 2] (target sub-leaf,
    packed source block): (posn [Km] int64, each M2L entry's slot in the
    grouped layout, where each target's run is padded to a multiple of g;
    row_ptr [G + 1] int32, the near list's CSR; sizes [2] int64, the
    grouped M2L length and the longest near row, what the caps need)."""
    dev = m2l.device
    tgt = m2l[:, 0].long().contiguous()
    rp = torch.searchsorted(tgt, torch.arange(Mheap + 1, device=dev))
    deg = rp[1:] - rp[:-1]
    off = torch.cat([rp.new_zeros(1), torch.cumsum((deg + g - 1) // g * g,
                                                   0)])
    posn = torch.arange(tgt.shape[0], device=dev) + (off - rp)[tgt]
    del tgt, deg, rp
    ntgt = near[:, 0].long().contiguous()
    row_ptr = torch.searchsorted(ntgt, torch.arange(G + 1, device=dev))
    del ntgt
    sizes = torch.stack([off[-1], (row_ptr[1:] - row_ptr[:-1]).max()])
    return posn, row_ptr.to(torch.int32), sizes


def layout_fill(m2l: torch.Tensor, near: torch.Tensor, posn: torch.Tensor,
                row_ptr: torch.Tensor, Mheap: int, G: int, G_blk: int, g: int,
                m2l_cap: int, p2p_cap: int, dmax: int) -> dict:
    """The layout's second half, on the lists' device (:func:`layout_sizes`
    gave `posn` and `row_ptr`): the state's list fields at their caps.
    Pad slots hold the sentinels: target Mheap in the M2L list (and in
    all-pad groups of ``m2l_gtgt``, a group's minimum target), target G in
    the P2P list, block G_blk in the dense partner table ``p2p_col2d``
    [G, dmax], built at its cap with one scatter; ungrouped lists (g = 1)
    carry the reference's one-element ``m2l_gtgt``.  `posn` is the only
    temporary of the M2L half, freed before the P2P fields are made."""
    dev, i32 = m2l.device, torch.int32
    m2l_t = torch.full((m2l_cap,), Mheap, dtype=i32, device=dev)
    m2l_t.index_copy_(0, posn, m2l[:, 0].to(i32))
    m2l_s = torch.zeros(m2l_cap, dtype=i32, device=dev).index_copy_(
        0, posn, m2l[:, 1].to(i32))
    m2l_v = torch.zeros(m2l_cap, dtype=torch.bool, device=dev).index_fill_(
        0, posn, True)
    del posn
    m2l_gt = (m2l_t.view(-1, g).amin(dim=1) if g > 1
              else torch.zeros(1, dtype=i32, device=dev))
    q = near.shape[0]
    p2p_t = torch.full((p2p_cap,), G, dtype=i32, device=dev)
    p2p_t[:q] = near[:, 0]
    p2p_s = torch.zeros(p2p_cap, dtype=i32, device=dev)
    p2p_s[:q] = near[:, 1]
    p2p_v = torch.zeros(p2p_cap, dtype=torch.bool, device=dev)
    p2p_v[:q] = True
    # each entry's flat slot in the table: its row, and its rank in the row
    at = near[:, 0].to(torch.int64, copy=True)
    at.mul_(dmax).sub_(row_ptr[near[:, 0].long()])
    at.add_(torch.arange(q, device=dev))
    col2d = torch.full((G, dmax), G_blk, dtype=i32, device=dev)
    col2d.view(-1).index_copy_(0, at, near[:, 1].to(i32))
    del at
    return dict(m2l_tgt=m2l_t, m2l_src=m2l_s, m2l_valid=m2l_v,
                m2l_gtgt=m2l_gt, p2p_tgt=p2p_t, p2p_src=p2p_s,
                p2p_valid=p2p_v, p2p_row_ptr=row_ptr, p2p_col2d=col2d)


def layout_stream(device):
    """A context that makes `device`'s list-layout stream, the card
    traversal's side stream (``traverse.side_stream``), this thread's
    current stream; nothing on a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(traverse.side_stream(device))


def layout_event(device):
    """An event after the work queued so far on `device`'s list-layout
    stream (None on a CPU device)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(traverse.side_stream(device))
    return ev


def hand_over(tensors, event, device) -> None:
    """Make the calling thread's current stream on `device` wait for
    `event` (a :func:`layout_event`) without blocking the host, and mark
    every CUDA tensor of `tensors` as used on that stream, so that the
    caching allocator hands none of their blocks back to the layout stream
    while this stream may still read them.  Nothing for event None."""
    if event is None:
        return
    stream = torch.cuda.current_stream(device)
    stream.wait_event(event)
    for t in tensors:
        if t.device.type == "cuda":
            t.record_stream(stream)


# --------------------------------------------------------------------------- #
# Device tree build (sorting + geometry)
# --------------------------------------------------------------------------- #

SORT_MODES = ("auto", "kd_native", "morton", "kd_device")

# traversals run by path: the numpy one (the host fallback where the
# native library is absent), the native library's on the host, and the
# card's (ops/fmm/traverse.py); a run that must show which path its
# rebuilds took reads these
raw_traversals = 0
native_traversals = 0
device_traversals = 0
_raw_lock = threading.Lock()


@functools.lru_cache(maxsize=8)
def _segments(n: int, L: int, device: torch.device):
    """Per level: (segment id of each sorted slot [n] int64, segment
    particle counts [2^l] float32) on `device`."""
    st = _static_structure(n, L)
    return [(torch.as_tensor(st.seg[l].astype(np.int64), device=device),
             torch.as_tensor(np.diff(st.beg[l]).astype(np.float32),
                             device=device)) for l in range(L + 1)]


def _level_geometry(pos_s: torch.Tensor, seg: torch.Tensor,
                    cnt: torch.Tensor):
    """Per-segment (mean, lam, min, max) of sorted positions; segments are
    contiguous and non-empty."""
    m, dim = cnt.shape[0], pos_s.shape[1]
    idx = seg[:, None].expand(-1, dim)
    mn = pos_s.new_empty(m, dim).scatter_reduce_(0, idx, pos_s, "amin",
                                                 include_self=False)
    mx = pos_s.new_empty(m, dim).scatter_reduce_(0, idx, pos_s, "amax",
                                                 include_self=False)
    mean = pos_s.new_zeros(m, dim).index_add_(0, seg, pos_s) / cnt[:, None]
    lam = torch.clamp(0.5 * torch.linalg.vector_norm(mx - mn, dim=1),
                      min=1e-30)
    return mean, lam, mn, mx


def _heap_geometry(levels):
    """Concatenate per-level (mean, lam, min, max) into the heap arrays
    (center, lam, lb, rb)."""
    return tuple(torch.cat(parts, dim=0) for parts in zip(*levels))


def _morton_key(pos: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """Morton (Z-order) keys from box-normalized coordinates (the
    reference's uint32 keys, held in int64)."""
    mn = pos.amin(dim=0)
    mx = pos.amax(dim=0)
    extent = torch.clamp(mx - mn, min=1e-30)
    q = ((pos - mn) / extent * (1 << bits)).to(torch.int64).clamp(
        0, (1 << bits) - 1)                                 # [n, dim]
    key = torch.zeros(pos.shape[0], dtype=torch.int64, device=pos.device)
    for b in range(bits):
        for a in range(dim):
            key = key | (((q[:, a] >> b) & 1) << (b * dim + a))
    return key


def _build_device_morton(pos: torch.Tensor, n: int, L: int, dim: int):
    """One stable Morton sort; the tree is the equal-count split of the
    sorted order.  The MAC uses the true per-node bounds computed
    afterwards, so only pair counts change against the exact kd order.
    Returns (perm int32, center, lam, lb, rb) on the device of `pos`."""
    key = _morton_key(pos, 10 if dim == 3 else 16, dim)
    perm = torch.argsort(key, stable=True)
    pos_s = pos[perm]
    geo = [_level_geometry(pos_s, seg, cnt)
           for seg, cnt in _segments(n, L, pos.device)]
    return (perm.to(torch.int32),) + _heap_geometry(geo)


def _build_device(pos: torch.Tensor, n: int, L: int, dim: int):
    """The exact equal-count kd order on the device: per level, sort every
    segment by its widest axis — a (segment, coordinate) two-key sort, done
    as a stable sort by coordinate and then by segment.  Returns (perm
    int32, center, lam, lb, rb).  Ties may order differently from the
    reference's unstable sort; a leaf holds the same set of particles
    either way."""
    pos_s = pos
    perm = torch.arange(n, device=pos.device)
    geo = []
    for l, (seg, cnt) in enumerate(_segments(n, L, pos.device)):
        geo.append(_level_geometry(pos_s, seg, cnt))
        if l == L:
            break
        mn, mx = geo[-1][2], geo[-1][3]
        splitdim = torch.argmax(mx - mn, dim=1)            # [2^l]
        key = pos_s.gather(1, splitdim[seg][:, None])[:, 0]
        order = torch.argsort(key, stable=True)
        order = order[torch.argsort(seg[order], stable=True)]
        pos_s = pos_s[order]
        perm = perm[order]
    return (perm.to(torch.int32),) + _heap_geometry(geo)


# --------------------------------------------------------------------------- #
# Host dual-tree traversal (numpy copy of the reference's)
# --------------------------------------------------------------------------- #


def _traverse_raw(center: np.ndarray, lb: np.ndarray, rb: np.ndarray,
                  mult: np.ndarray, L: int, n: int, p: int,
                  radius: float, mult_floor: int = 1,
                  boost_from: Optional[int] = None, sub_boost: float = 1.0):
    """Vectorized dual-tree traversal (reference :569-611 semantics).

    Returns (m2l [K,2] unordered heap pairs, p2p [Q,2] unordered
    LEAF-RELATIVE pairs incl. self pairs) — the native co_traverse's
    format.  mult_floor: Mf uses max(mult, mult_floor).  Nodes at heap
    index >= boost_from accept with radius*sub_boost (stricter)."""
    leaf0 = _heap_off(L)
    M = center.shape[0]
    sz = np.sum((rb - lb) ** 2, axis=1)                      # squared diagonal
    mult = np.maximum(mult, np.int32(mult_floor))
    # per-node pair value (rad_i * (mult_i/n)^expo)^2; the pair acceptance
    # takes the max over the two nodes (same as the native pm2 table)
    expo = 1.0 / (3 * p + 6)
    rad = np.full(M, radius, dtype=np.float64)
    if boost_from is not None and sub_boost != 1.0:
        rad[boost_from:] = radius * sub_boost
    pm2 = (rad * (mult[:M] / float(n)) ** expo) ** 2

    frontier = np.array([[0, 0]], dtype=np.int64)
    m2l = []
    p2p = []
    while frontier.size:
        i, j = frontier[:, 0], frontier[:, 1]
        d = center[i] - center[j]
        dist2 = np.sum(d * d, axis=1)
        parM2 = np.maximum(pm2[i], pm2[j])
        adm = (parM2 * np.maximum(sz[i], sz[j]) < dist2) & (i != j)
        if np.any(adm):
            m2l.append(frontier[adm])
        rest = frontier[~adm]
        if rest.size == 0:
            break
        i, j = rest[:, 0], rest[:, 1]
        both = (i >= leaf0) & (j >= leaf0)
        if np.any(both):
            p2p.append(rest[both])
        rest = rest[~both]
        if rest.size == 0:
            break
        # self pairs split into (l,l), (l,r), (r,r) so each unordered pair
        # is emitted exactly once; non-self pairs split the larger non-leaf
        # side only
        selfp = rest[:, 0] == rest[:, 1]
        sp = rest[selfp]
        rest = rest[~selfp]
        i, j = rest[:, 0], rest[:, 1]
        leaf_i = i >= leaf0
        leaf_j = j >= leaf0
        split_i = (~leaf_i) & (leaf_j | (sz[i] >= sz[j]))
        si = rest[split_i]
        sj = rest[~split_i]
        nxt = []
        if sp.size:
            a = sp[:, 0]
            l, r = 2 * a + 1, 2 * a + 2
            nxt.append(np.stack([l, l], axis=1))
            nxt.append(np.stack([l, r], axis=1))
            nxt.append(np.stack([r, r], axis=1))
        if si.size:
            a, b = si[:, 0], si[:, 1]
            nxt.append(np.stack([2 * a + 1, b], axis=1))
            nxt.append(np.stack([2 * a + 2, b], axis=1))
        if sj.size:
            a, b = sj[:, 0], sj[:, 1]
            nxt.append(np.stack([a, 2 * b + 1], axis=1))
            nxt.append(np.stack([a, 2 * b + 2], axis=1))
        frontier = (np.concatenate(nxt, axis=0) if nxt
                    else np.zeros((0, 2), np.int64))

    m2l = np.concatenate(m2l, axis=0) if m2l else np.zeros((0, 2), np.int64)
    p2p = np.concatenate(p2p, axis=0) if p2p else np.zeros((0, 2), np.int64)
    return m2l, p2p - leaf0


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
    """kd-tree FMM engine for a fixed particle count (dims 2 and 3,
    float32 and float64).

    Usage:
        eng = KdFmmEngine(config, n)
        fstate = eng.build(pos)          # at t=0 and every tree_steps steps
        acc = eng.force(pos, fstate)

    sort_mode (the ``CO_SORT_MODE`` environment variable overrides it, as
    in the reference): "auto" builds the exact kd order with the native
    library where it is available and with the device Morton sort where
    not; "kd_native", "morton" and "kd_device" force a builder
    ("kd_native" falls back to Morton without the library, as the
    reference does).

    `L` forces the tree level; `leaf_target` is the particle count a
    sub-leaf aims at when the level is derived.  The reference's tuning
    knobs are read at the reference's moments: ``CO_SUB_BOOST``,
    ``CO_M2L_GROUP`` and ``CO_M2L_FLY`` here, ``CO_STALE_MARGIN`` at each
    traversal.
    """

    def __init__(self, config: SimConfig, n: int, L: Optional[int] = None,
                 leaf_target: int = 32, sort_mode: str = "auto",
                 sub_depth: int = 2):
        self.config = config
        self.n = n
        self.dim = config.dim
        self.dtype = config.dtype
        self.sort_mode = os.environ.get("CO_SORT_MODE", sort_mode)
        if self.sort_mode not in SORT_MODES:
            raise ValueError(f"sort_mode must be one of {SORT_MODES}, got "
                             f"{self.sort_mode!r}")
        # p=1 is monopole-only (PM=0), matching the reference's fmm_order=1
        self.p = max(config.fmm_order, 1)
        self.L = L or auto_level(n, self.p, config.dens_inhom,
                                 config.tree_L, leaf_target)
        # dual granularity only on the auto-level geometry (the twin
        # explains why a forced coarser tree falls back to leaf MAC)
        auto_L = auto_level(n, self.p, config.dens_inhom, 0, leaf_target)
        self.sub_depth = max(0, min(sub_depth, self.L)) \
            if self.L >= auto_L else 0
        # MAC multiplicity floor at block occupancy (see the twin)
        self.mac_mult_floor = (-(-n // (1 << (self.L - self.sub_depth)))
                               if self.sub_depth else 1)
        # sub-block acceptance-radius boost: explicit config > the
        # CO_SUB_BOOST environment variable > accuracy-grade auto (2.0
        # below a 1e-4 bound) > throughput default 1.5
        if not self.sub_depth:
            self.mac_sub_boost = 1.0
        elif config.mac_sub_boost > 0.0:
            self.mac_sub_boost = float(config.mac_sub_boost)
        elif os.environ.get("CO_SUB_BOOST"):
            self.mac_sub_boost = float(os.environ["CO_SUB_BOOST"])
        elif 0.0 < config.accuracy < 1e-4:
            self.mac_sub_boost = 2.0
        else:
            self.mac_sub_boost = 1.5
        # COC centers: the dipole is identically zero -> no order-1 slots
        self.tables = build_tables(self.dim, self.p, no_dipole=True)
        # grouped M2L: per-target entry runs padded to multiples of g
        # (1 disables grouping)
        self.m2l_group = int(os.environ.get("CO_M2L_GROUP", "8"))
        # M2L geometry folded in the loop at every force evaluation (fly,
        # the default) or once per adoption and refresh into the state
        # (stored, CO_M2L_FLY=0); see the module docstring
        self.m2l_fly = os.environ.get("CO_M2L_FLY", "1") != "0"
        self.st = _static_structure(n, self.L,
                                    pad_to=max(128 >> self.sub_depth, 8))
        self.caps = {"p2p": 8192, "m2l": M2L_CAP_QUANTUM}
        # entries the plain near-field sum covers on a CPU tensor: the pair
        # lists' longest valid prefix with 1.25 headroom at a quantum of
        # 256, grow-only as the caps are (see _stage_p2p)
        self.near_cap = 0
        self.stale_margin_abs = 0.0
        self._dev = {}
        self._card = None         # traverse.DeviceTraversal, at first use
        # a card's pinned buffers: the staging of the host arrays a state
        # takes (grow-only, reused once the copies of the last state ended)
        # and the layout's two sizes
        self._stage_buf = self._staged = self._sizes_h = None
        self._stage_lock = threading.Lock()

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

    # ---------------- build ----------------
    def build(self, pos: torch.Tensor) -> FmmState:
        """Tree (re)build by `sort_mode`: the native kd sort and geometry
        on the host, or a device builder; the traversal and the list
        layout on the device of `pos` (the host's for a CPU tensor)."""
        if self.sort_mode in ("auto", "kd_native") and native.available():
            return self.build_host(pos, pos.device)
        return self.build_device_async(pos)

    def build_device_async(self, pos: torch.Tensor) -> FmmState:
        """Rebuild with a device builder (the Morton sort, or the exact kd
        sort for sort_mode="kd_device"): the O(N) work runs on the device of
        `pos`, only the node geometry crosses to the host for the MAC
        traversal, and perm/inv never leave the device."""
        bt = {}
        with P.span("kd.device_build", bt):
            fn = (_build_device if self.sort_mode == "kd_device"
                  else _build_device_morton)
            perm, center, lam, lb, rb = fn(pos.detach(), self.n, self.L,
                                           self.dim)
            c_h, lb_h, rb_h = (x.cpu().numpy() for x in (center, lb, rb))
        with P.span("kd.traverse", bt):
            m2l, p2p = self._traverse(c_h, lb_h, rb_h, pos.device)
        inv = torch.empty_like(perm)
        inv[perm.long()] = torch.arange(self.n, dtype=perm.dtype,
                                        device=perm.device)
        return self._lists_to_state(perm, inv, center, lam, m2l, p2p, bt)

    def build_host(self, pos: torch.Tensor, device) -> FmmState:
        """Rebuild with the native host builder from original-order
        positions.  `device` is where the lists and the state will live: a
        card there runs the traversal."""
        bt = {}
        with P.span("kd.fetch", bt):
            pos_h = pos.detach().to("cpu", torch.float32).numpy()
        return self._build_host_from(pos_h, bt, device)

    def build_host_padded(self, ppad_h: np.ndarray,
                          inv_perm_old: np.ndarray, device) -> FmmState:
        """:meth:`build_host` fed from a host copy of the PADDED positions
        and the inverse permutation they are padded under; `device` as
        there."""
        bt = {}
        with P.span("kd.unpad_host", bt):
            flat = np.asarray(ppad_h, dtype=np.float32).reshape(-1,
                                                                self.dim)
            # particle o sits at sorted slot inv[o], padded slot
            # unpad[inv[o]]
            pos_h = flat[self.st.unpad_gather[np.asarray(inv_perm_old)]]
        return self._build_host_from(pos_h, bt, device)

    def _build_host_from(self, pos_h: np.ndarray, bt: dict,
                         device) -> FmmState:
        with P.span("kd.sort", bt, "kd"):
            perm = native.kdtree_build(pos_h, self.L)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(self.n, dtype=perm.dtype)
        with P.span("kd.geom", bt):
            c_h, lb_h, rb_h, lam_h = native.node_geometry(pos_h[perm],
                                                          self.L)
        with P.span("kd.traverse", bt):
            m2l, p2p = self._traverse(c_h, lb_h, rb_h, device)
        return self._lists_to_state(perm, inv, c_h, lam_h, m2l, p2p, bt)

    def _traverse(self, c_h, lb_h, rb_h, device=None):
        """Dual-granularity traversal with the temporal MAC slack (node
        bounds inflated by `stale_margin_abs`, a scalar or a per-axis
        vector, or by the ``CO_STALE_MARGIN`` environment variable when
        set, so frozen lists stay admissible for the reuse window).  For
        lists bound for a CUDA `device`: the card's frontier on the native
        library's tables (``traverse.py``; M2L entries ordered by source
        within a target).  Otherwise the native single pass, or without
        the native library the numpy ``_traverse_raw`` and
        :meth:`_fine_lists`, as in the reference; a card never falls back
        to the host: without the native library its tables raise.
        Returns (m2l_directed, near), target-sorted: int32 tensors on a
        card, made on its side stream (``traverse.DeviceTraversal.run``),
        host int64 arrays otherwise."""
        global raw_traversals, native_traversals, device_traversals
        L, S = self.L, self.sub_depth
        lb_h, rb_h = self.inflated_bounds(lb_h, rb_h)
        if device is not None and torch.device(device).type == "cuda":
            sz, pm2 = native.traverse_tables(
                lb_h, rb_h, self.st.mult, L, S, self.n, self.dim, self.p,
                float(self.config.tree_radius),
                mult_floor=self.mac_mult_floor, sub_boost=self.mac_sub_boost)
            if self._card is None:
                self._card = traverse.DeviceTraversal()
            m2l_d, near, _ = self._card.run(c_h, sz, pm2, L, S,
                                            self.config.coll, device)
            with _raw_lock:
                device_traversals += 1
            return m2l_d, near
        if not native.available():
            with _raw_lock:
                raw_traversals += 1
            m2l_u, p2p_u = _traverse_raw(
                c_h, lb_h, rb_h, self.st.mult, L, self.n, self.p,
                float(self.config.tree_radius),
                mult_floor=self.mac_mult_floor,
                boost_from=_heap_off(L - S + 1) if S else None,
                sub_boost=self.mac_sub_boost)
            near, m2l_d = self._fine_lists(m2l_u, p2p_u)
            return m2l_d, near
        with _raw_lock:
            native_traversals += 1
        # seed capacities from the previous traversal
        last = getattr(self, "last_raw_counts", None) or {}
        caps = {k: max(1 << 20, int(last.get(k, 0) * 1.3))
                for k in ("m2l", "near")}
        m2l_d, near = native.traverse_fine(
            c_h, lb_h, rb_h, self.st.mult, L, S, self.n,
            self.dim, self.p, float(self.config.tree_radius),
            self.config.coll, mult_floor=self.mac_mult_floor,
            sub_boost=self.mac_sub_boost,
            m2l_cap=caps["m2l"], near_cap=caps["near"])
        self.last_raw_counts = {"m2l": int(m2l_d.shape[0]),
                                "near": int(near.shape[0])}
        return m2l_d, near

    def inflated_bounds(self, lb_h, rb_h):
        """Node bounds as the traversal sees them: inflated by
        `stale_margin_abs` or ``CO_STALE_MARGIN`` (see :meth:`_traverse`)."""
        sm_env = os.environ.get("CO_STALE_MARGIN")
        sm = float(sm_env) if sm_env is not None else self.stale_margin_abs
        if np.any(np.asarray(sm) > 0.0):
            lb_h = (lb_h - sm).astype(lb_h.dtype)
            rb_h = (rb_h + sm).astype(rb_h.dtype)
        return lb_h, rb_h

    def _fine_lists(self, m2l_u: np.ndarray, p2p_dir: np.ndarray):
        """Dual-granularity lists from the numpy traversal's output (the
        native library builds the same lists in its single pass).

        Input: m2l_u [K, 2] unordered admissible heap pairs; p2p_dir [Q, 2]
        unordered near sub-leaf pairs (leaf-relative, self included).
        Output: near [Qb, 2] directed (target sub-leaf, packed source
        block) pairs — blk | mask << mask_shift, one mask bit per near
        sub-leaf of the block — and m2l [Kd, 2] directed (t <- s) entries,
        both directions of every pair; both target-sorted."""
        S = self.sub_depth
        G_blk = self.G_blk
        shift = self.mask_shift
        if p2p_dir.size and self.config.coll:
            a = p2p_dir[:, 0].astype(np.int64)
            b = p2p_dir[:, 1].astype(np.int64)
            t = np.concatenate([a, b])
            s = np.concatenate([b, a])
            key = t * G_blk + (s >> S)
            bit = np.int64(1) << (s & ((1 << S) - 1))
            order = np.argsort(key, kind="stable")
            key, bit = key[order], bit[order]
            uniq, start = np.unique(key, return_index=True)
            mask = np.bitwise_or.reduceat(bit, start)
            packed = ((uniq % G_blk) | (mask << shift))
            # int32 wrap-around semantics (the mask may hold the sign bit)
            packed = packed.astype(np.uint32).view(np.int32).astype(np.int64)
            near = np.stack([uniq // G_blk, packed], axis=1)
        else:
            near = np.zeros((0, 2), np.int64)
        if m2l_u.size == 0:
            return near, np.zeros((0, 2), np.int64)
        m2l_d = np.concatenate([m2l_u, m2l_u[:, ::-1]], axis=0)
        return near, m2l_d[np.argsort(m2l_d[:, 0], kind="stable")]

    def _lists_to_state(self, perm, inv_perm, center, lam, m2l, p2p,
                        bt) -> FmmState:
        """Lay the target-sorted pair lists out at their caps (the grouped
        M2L layout, the P2P lists and CSR, the dense partner table: the
        twin's logic, with the CSR always built) and assemble the FmmState
        on the device the lists are on.

        One implementation on either device (:func:`layout_sizes`,
        :func:`layout_fill`): the lists of a card's traversal are laid out
        on the card, on its side stream (:func:`layout_stream`), and never
        leave it; host lists (numpy arrays) are laid out on the host.  The
        caps need two sizes, which a card reads back in one small pinned
        copy: the layout's only wait for the device.  Host arrays of perm,
        inv_perm, center and lam go to a card through one grow-only pinned
        buffer, on the same stream.  A caller whose current stream is not
        that stream gets the state handed over (:func:`hand_over`): its
        stream waits for the layout without blocking the host.  Counted in
        ``device_layouts`` or ``host_layouts``."""
        global device_layouts, host_layouts
        m2l, p2p = (x if isinstance(x, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(x))
                    for x in (m2l, p2p))
        device = m2l.device
        with layout_stream(device):
            with P.span("kd.upload", bt):
                perm, inv_perm, center, lam = self._stage(
                    (perm, inv_perm, center, lam), device)
                center, lam = center.to(self.dtype), lam.to(self.dtype)
            with P.span("kd.lists", bt):
                fields = self._lay_out(m2l, p2p)
                del m2l, p2p
            out = FmmState(
                perm=perm, inv_perm=inv_perm, center=center, lam=lam,
                # the reference's placeholders: fly mode folds in the loop
                m2l_h2=center.new_zeros(1, 1), m2l_w=center.new_zeros(1),
                m2l_logc=center.new_zeros(1), **fields)
            ready = layout_event(device)
        if ready is not None and (torch.cuda.current_stream(device)
                                  != traverse.side_stream(device)):
            hand_over(out, ready, device)
        with _raw_lock:
            if device.type == "cuda":
                device_layouts += 1
            else:
                host_layouts += 1
        if not self.m2l_fly:
            with P.span("kd.m2l_fold", bt):
                h2, w, logc = self._m2l_geo(out.center, out.lam, out.m2l_tgt,
                                            out.m2l_src, out.m2l_valid)
                out = out._replace(m2l_h2=h2, m2l_w=w, m2l_logc=logc)
                if device.type == "cuda":
                    # the fold is queued on the calling thread's stream (the
                    # rebuild thread's, for a background rebuild); wait for it
                    # here, so that no consumer on any stream or thread adopts
                    # a fold that has not finished
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(device))
                    done.synchronize()
        self.last_build_times = bt
        return out

    def _lay_out(self, m2l: torch.Tensor, near: torch.Tensor) -> dict:
        """The list fields of the state from the lists on their device:
        the sizes, the caps (quantized, headroom, geometric overflow
        growth: the twin's policy, so that the state stays equal to the
        twin's and the shapes change at the same builds), then the
        fields."""
        self.last_counts = {"m2l": int(m2l.shape[0]),
                            "p2p": int(near.shape[0])}
        Mheap, G, g = _heap_off(self.L + 1), self.G_sub, self.m2l_group
        posn, row_ptr, sizes = layout_sizes(m2l, near, Mheap, G, g)
        if sizes.device.type == "cuda":
            if self._sizes_h is None:
                self._sizes_h = torch.empty(2, dtype=torch.int64,
                                            pin_memory=True)
            self._sizes_h.copy_(sizes, non_blocking=True)
            got = torch.cuda.Event()
            got.record()
            got.synchronize()
            sizes = self._sizes_h
        k2, dmax = (int(x) for x in sizes.tolist())
        q = near.shape[0]
        for name, klen, quantum, hr in (("m2l", k2, M2L_CAP_QUANTUM, 1.08),
                                        ("p2p", q, 8192, 1.25)):
            if klen > self.caps[name]:
                grown = -(-(self.caps[name] * 5 // 4) // quantum) * quantum
                self.caps[name] = max(_round_cap(klen, quantum, hr),
                                      grown if self.caps[name] else 0)
        if q > self.near_cap:
            self.near_cap = min(self.caps["p2p"],
                                -(-int(q * 1.25) // 256) * 256)
        if P.recording():
            P.count("kd.lists.near_entries", q)
            P.count("kd.lists.near_rows", G)
            P.count("kd.lists.near_row_max", dmax)
        # first sizing even for an empty list (coll=False): the CSR and
        # col2d are built on every device
        if "dmax" not in self.caps or dmax > self.caps["dmax"]:
            grown = self.caps.get("dmax", 0) * 5 // 4
            self.caps["dmax"] = max(
                128, -(-max(int(dmax * 1.25), grown) // 128) * 128)
        return layout_fill(m2l, near, posn, row_ptr, Mheap, G, self.G_blk, g,
                           self.caps["m2l"], self.caps["p2p"],
                           self.caps["dmax"])

    def _stage(self, arrays, device) -> list:
        """Host arrays (or tensors) as tensors on `device`.  Host arrays
        bound for a card are copied into the engine's one grow-only pinned
        buffer and from there on the current stream without blocking;
        tensors already on `device` pass as they are."""
        device = torch.device(device)
        arrays = [a if isinstance(a, torch.Tensor)
                  else np.ascontiguousarray(a) for a in arrays]
        if device.type != "cuda":
            return [a.to(device) if isinstance(a, torch.Tensor)
                    else torch.from_numpy(a.copy()) for a in arrays]
        host = [a for a in arrays if not isinstance(a, torch.Tensor)]
        offs, nbytes = [], 0
        for a in host:
            offs.append(nbytes)
            nbytes += -(-a.nbytes // 256) * 256
        with self._stage_lock:
            if self._staged is not None and not self._staged.query():
                self._staged.synchronize()
            if self._stage_buf is None or self._stage_buf.numel() < nbytes:
                self._stage_buf = torch.empty(nbytes, dtype=torch.uint8,
                                              pin_memory=True)
            out = []
            for a in arrays:
                if isinstance(a, torch.Tensor):
                    out.append(a.to(device))
                    continue
                o, t = offs.pop(0), torch.from_numpy(a)
                h = self._stage_buf[o:o + a.nbytes].view(t.dtype).view(
                    t.shape)
                h.copy_(t)
                out.append(h.to(device, non_blocking=True))
            self._staged = torch.cuda.Event()
            self._staged.record()
        return out

    def refresh(self, ppad: torch.Tensor, fs: FmmState,
                perm=None, inv_perm=None) -> FmmState:
        """Exact geometry + pair-list rebuild for an existing padded
        layout: node bounds/centers from on-device leaf stats, the MAC
        re-traversal (on the card for a card's `ppad`), the lists laid out
        again.  Pass perm/inv_perm when ppad was padded under a new
        permutation."""
        bt = {}
        with P.span("kd.refresh.geom_dev", bt):
            # [3, G, dim]
            h = torch.stack(self._leaf_stats(ppad)).cpu().numpy()
        with P.span("kd.refresh.geom_host", bt):
            L, dim = self.L, self.dim
            G = 1 << L
            M = (1 << (L + 1)) - 1
            mn = np.empty((M, dim), h.dtype)
            mx = np.empty((M, dim), h.dtype)
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
            center = (sm / cnt).astype(h.dtype)
            lam = np.maximum(0.5 * np.linalg.norm(mx - mn, axis=1),
                             1e-30).astype(h.dtype)
        with P.span("kd.traverse", bt):
            m2l, p2p = self._traverse(center, mn, mx, ppad.device)
        return self._lists_to_state(
            fs.perm if perm is None else perm,
            fs.inv_perm if inv_perm is None else inv_perm,
            center, lam, m2l, p2p, bt)

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
        nothing else needs refreshing; stored mode folds the M2L geometry
        again from the new center/lam (twin of ``geom_refresh_in_jit``)."""
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
        if self.m2l_fly:
            return fs._replace(center=center, lam=lam)
        h2, w, logc = self._m2l_geo(center, lam, fs.m2l_tgt, fs.m2l_src,
                                    fs.m2l_valid)
        return fs._replace(center=center, lam=lam, m2l_h2=h2, m2l_w=w,
                           m2l_logc=logc)

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
        ~0; mask before integrating.  The leaf-frame monomials are
        evaluated once and shared by the P2M and the L2P; the stage methods
        below run the same operations one stage at a time.  The stages
        are timed as ``fmm.upward``, ``fmm.m2l``, ``fmm.downward`` and
        ``fmm.p2p`` (``utils/profiling.stage``)."""
        dev = ppad.device
        P.stage("fmm.upward", dev)
        V, leafl = self._leaf_frame(ppad, fs)
        mpole_heap = self._multipoles_from(V, fs)
        P.stage("fmm.m2l", dev)
        local_heap = self._stage_m2l(mpole_heap, fs)
        P.stage("fmm.downward", dev)
        far = self._l2p(V, leafl, self.l2l_down(local_heap, fs))
        P.stage("fmm.p2p", dev)
        near = self._stage_p2p(ppad, fs)
        P.stage(None, dev)
        return (far + near) * self._kappa(ppad.dtype)

    def _kappa(self, dtype) -> float:
        """kappa rounded to the working dtype (the reference's
        dtype.type(kappa)), once per value and dtype."""
        return round_to_dtype(self.config.kappa(self.n), dtype)

    # ---- pipeline stages (each callable alone, for profiling) ----

    # The three leaf stages take a run of leaves: `ppad` (or V) holds the
    # Gl leaves [lo, lo + Gl), all G of them by default; a rank of the
    # particle-sharded force (parallel/fmm_pshard.py) passes its own run.

    def _leaf_frame(self, ppad: torch.Tensor, fs: FmmState, lo: int = 0):
        """Leaf-frame monomials V [Gl, C, S_Lf] of the normalized offsets
        (0 at pads) and the leaf length scales [Gl].  Layouts nest, so the
        P2M reads its slots from the L2P monomials."""
        Gl = ppad.shape[0]
        leaf0 = _heap_off(self.L) + lo
        leafc = fs.center[leaf0:leaf0 + Gl]
        leafl = fs.lam[leaf0:leaf0 + Gl]
        e = (ppad - leafc[:, None, :]) / leafl[:, None, None]
        mask3 = self.dev(ppad.device).mask3[lo:lo + Gl]
        e = torch.where(mask3[..., None], e, 0.0)
        return mop.eval_monomial_cols(e, self.tables.PL, self.dim), leafl

    def _p2m(self, V: torch.Tensor, lo: int = 0) -> torch.Tensor:
        """P2M from the leaf monomials: leaf multipoles [Gl, S_M]."""
        mask3 = self.dev(V.device).mask3[lo:lo + V.shape[0]]
        return mop.p2m_from_cols(self.tables, V, mask3)

    def _multipoles_from(self, V: torch.Tensor, fs: FmmState) -> torch.Tensor:
        """P2M from the leaf monomials, then M2M up: [Mheap, S_M]."""
        return self.m2m_up(self._p2m(V), fs)

    def _l2p(self, V: torch.Tensor, leafl: torch.Tensor,
             leaf_local: torch.Tensor, lo: int = 0) -> torch.Tensor:
        """L2P: far-field acceleration [Gl, C, dim] (unscaled, 0 at pads)
        from the leaf locals [Gl, S_Lt]."""
        Lf = mop.expand_L(self.tables, leaf_local)          # [Gl, S_Lf]
        far = mop.l2p_field_cols(self.tables, Lf, V, leafl)
        mask3 = self.dev(V.device).mask3[lo:lo + V.shape[0]]
        return far * mask3[..., None]

    def _stage_multipoles(self, ppad: torch.Tensor,
                          fs: FmmState) -> torch.Tensor:
        """P2M at the leaves + M2M up; mpole_heap [Mheap, S_M]."""
        return self._multipoles_from(self._leaf_frame(ppad, fs)[0], fs)

    def _stage_local(self, ppad: torch.Tensor, local_heap: torch.Tensor,
                     fs: FmmState) -> torch.Tensor:
        """L2L down + L2P; far-field acceleration on padded blocks
        (unscaled)."""
        V, leafl = self._leaf_frame(ppad, fs)
        return self._l2p(V, leafl, self.l2l_down(local_heap, fs))

    def _leaf_expansions(self, ppad: torch.Tensor, fs: FmmState):
        """The far-field pipeline up to the leaf locals: P2M, M2M up, M2L,
        L2L down.  Returns (V, leaf locals [G, S_Lt], leaf length scales
        [G])."""
        V, leafl = self._leaf_frame(ppad, fs)
        local_heap = self._stage_m2l(self._multipoles_from(V, fs), fs)
        return V, self.l2l_down(local_heap, fs), leafl

    def potential(self, pos: torch.Tensor, fs: FmmState) -> torch.Tensor:
        """Per-particle softened Coulomb potential (kappa-scaled), original
        order [n] (twin of ``potential``): the far field from the leaf
        local expansions (which include the monopole term), the near field
        over the P2P list as plain PyTorch.  Self pairs and pad sources
        are dropped inside the near-field sum: the twin subtracts the self
        term phi(0) (1/eps = 1e9 in 3D, which would swamp a float32 row
        sum) after it, and in 2D its sum also takes the pads' -log(FAR)."""
        t = self.tables
        G, C = self.G_sub, self.st.C
        ppad = self.pad_array(pos, fs, fill=FAR)
        V, leaf_local, _ = self._leaf_expansions(ppad, fs)
        Lf = mop.expand_L(t, leaf_local)                    # [G, S_Lf]
        multv = torch.as_tensor(t.l2p_mult, dtype=pos.dtype,
                                device=pos.device)
        pot_far = torch.sum(V * (Lf * multv)[:, None, :], dim=2)   # [G, C]
        pot = (pot_far + self._potential_near(ppad, fs)) \
            * self.dev(pos.device).mask3 * self._kappa(pos.dtype)
        return self.unpad_array(pot.reshape(G, C, 1), fs)[:, 0]

    def _potential_near(self, ppad: torch.Tensor,
                        fs: FmmState) -> torch.Tensor:
        """Near-field potential [G, C], unscaled: for every valid P2P entry
        (target sub-leaf, packed source block), sum the pair potential
        (rsqrt(dist2) in 3D, -log(dist2)/2 in 2D) over the selected lane
        groups' real sources, self pairs and pad sources excluded."""
        G, C, dim = self.G_sub, self.st.C, self.dim
        Gb, CB = self.G_blk, self.C_blk
        dev = ppad.device
        shift = self.mask_shift
        valid = fs.p2p_valid
        tgt = fs.p2p_tgt[valid].long()
        v = fs.p2p_src[valid].long() & 0xFFFFFFFF          # uint32 view
        blk = v & ((1 << shift) - 1)
        bits = v >> shift
        pblk = ppad.reshape(Gb, CB, dim)
        real = self.dev(dev).pad_mask.reshape(Gb, CB)
        group = torch.arange(CB, device=dev) // C
        tslot = torch.arange(C, device=dev)
        sslot = torch.arange(CB, device=dev)
        out = torch.zeros(G, C, dtype=ppad.dtype, device=dev)
        k = max(1, _NEAR_PAIRS // (C * CB))
        for i in range(0, tgt.shape[0], k):
            ti, bi = tgt[i:i + k], blk[i:i + k]
            d = ppad[ti][:, :, None, :] - pblk[bi][:, None, :, :]
            dist2 = self.config.eps2 + d[..., 0] * d[..., 0]
            for a in range(1, dim):
                dist2 = dist2 + d[..., a] * d[..., a]
            keep = (((bits[i:i + k, None] >> group[None, :]) & 1) > 0) \
                & real[bi]                                    # [k, CB]
            notself = (ti[:, None, None] * C + tslot[None, :, None]
                       != bi[:, None, None] * CB + sslot[None, None, :])
            phi = torch.rsqrt(dist2) if dim == 3 else -0.5 * torch.log(dist2)
            phi = torch.where(keep[:, None, :] & notself, phi, 0.0)
            out.index_add_(0, ti, phi.sum(dim=2))
        return out

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

    def _m2l_chunk(self, K: int) -> int:
        """Entries per chunk of the M2L loop over K entries (and of the
        stored fold): M2L_LOOP_CHUNK, or for the dense forms (p >
        SPARSE_P_MAX), which hold a [chunk, S_Lt, S_M] operator per entry,
        ~2^26 elements; a multiple of the group size."""
        t, g = self.tables, self.m2l_group
        target = (M2L_LOOP_CHUNK if t.p <= mop.SPARSE_P_MAX
                  else max(g, (1 << 26) // (t.S_Lt * t.S_M)))
        return _pick_chunk(K, target, g)

    def _fold(self, center, lam, a_cl, bi, vv):
        """(H2, w, logc) of a run of M2L entries (target heap index a_cl
        clamped below Mheap, source bi, validity vv) from center/lam; pad
        entries take R = 1, so none is inf or NaN."""
        R = tuple(torch.where(vv, center[a_cl, k] - center[bi, k], 1.0)
                  for k in range(self.dim))
        return mop.m2l_fold_geo(self.tables, R, lam[a_cl], lam[bi])

    def _m2l_geo(self, center, lam, m2l_tgt, m2l_src, m2l_valid):
        """Stored-mode fold of every M2L entry's geometry (twin of the
        reference's ``m2l_geo``): (H2 [Km, S_H], w [Km], logc [Km]), folded
        chunk by chunk into preallocated tensors (the unchunked fold's
        temporaries are several times its result), each entry as the fly
        loop folds it."""
        Mheap = _heap_off(self.L + 1)
        K = m2l_tgt.shape[0]
        h2 = center.new_empty(K, self.tables.S_H)
        w = center.new_empty(K)
        logc = center.new_empty(K)
        chunk = self._m2l_chunk(K)
        for c0 in range(0, K, chunk):
            s = slice(c0, c0 + chunk)
            h2[s], w[s], logc[s] = self._fold(
                center, lam, m2l_tgt[s].long().clamp(max=Mheap - 1),
                m2l_src[s].long(), m2l_valid[s])
        return h2, w, logc

    def _stage_m2l(self, mpole_heap: torch.Tensor,
                   fs: FmmState) -> torch.Tensor:
        """Grouped M2L over the directed entry list (t <- s): per chunk,
        gather source multipoles and the entries' geometry (fly mode: fold
        it from center/lam; stored mode: read the chunk of the stored
        fold), apply m2l_sparse_pre, dense-reduce each group of g
        same-target entries (g = 1: none), and add the groups into an
        [Mheap+1, S_Lt] accumulator with a sorted index_add_ (the twin's
        segment_sum).  Returns local_heap [Mheap, S_Lt]."""
        t = self.tables
        Mheap = _heap_off(self.L + 1)
        g = self.m2l_group
        K = fs.m2l_tgt.shape[0]
        if g > 1 and fs.m2l_gtgt.shape[0] * g != K:
            raise ValueError("M2L lists are not in the grouped layout")
        if not self.m2l_fly and fs.m2l_h2.shape[0] != K:
            raise ValueError("stored-mode M2L needs a state with the stored "
                             "fold (this one was built in fly mode)")
        chunk = self._m2l_chunk(K)
        acc = torch.zeros(Mheap + 1, t.S_Lt, dtype=mpole_heap.dtype,
                          device=mpole_heap.device)
        for c0 in range(0, K, chunk):
            bi = fs.m2l_src[c0:c0 + chunk].long()
            vv = fs.m2l_valid[c0:c0 + chunk]
            if self.m2l_fly:
                a_cl = fs.m2l_tgt[c0:c0 + chunk].long().clamp(max=Mheap - 1)
                H2, w, logc = self._fold(fs.center, fs.lam, a_cl, bi, vv)
            else:
                H2, w, logc = (fs.m2l_h2[c0:c0 + chunk],
                               fs.m2l_w[c0:c0 + chunk],
                               fs.m2l_logc[c0:c0 + chunk])
            La = mop.m2l_sparse_pre(t, mpole_heap[bi], H2, w, logc)
            La = (La * vv[:, None]).reshape(-1, g, t.S_Lt).sum(dim=1)
            # g = 1: every entry is its own group (pads carry Mheap)
            gta = (fs.m2l_gtgt[c0 // g:(c0 + chunk) // g] if g > 1
                   else fs.m2l_tgt[c0:c0 + chunk]).long()
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
        """Near-field pass on padded blocks: [G, C, dim], unscaled.  A CUDA
        tensor runs the Hopper kernel on the CSR, in dim 2 or 3 (see the
        module docstring); a layout it cannot take raises.  A CPU tensor
        runs the plain sum over the padded pair list (``p2p_tgt``,
        ``p2p_src``), which holds the CSR's valid entries in order and pad
        entries with the dummy target and a zero lane mask after them: its
        grow-only prefix ``near_cap``, or the state's own valid count where
        that is longer (a state built elsewhere), since the capacity's
        8192-entry floor would multiply the work at small N.  The plain sum
        reads the pair list, not the CSR: a caller that shards the CSR's
        rows calls ``p2p_cuda`` on it (``parallel/fmm_shard.py``)."""
        pblk = ppad.reshape(self.G_blk, self.C_blk, self.dim).contiguous()
        if pblk.device.type != "cpu":
            out = p2p_cuda.p2p(pblk, fs.p2p_row_ptr, fs.p2p_col2d, self.nsub,
                               self.config.eps2)
        else:
            k = max(self.near_cap, int(fs.p2p_row_ptr.numpy()[-1]))
            out = p2p_cuda.p2p_plain_entries(pblk, fs.p2p_tgt[:k],
                                             fs.p2p_src[:k], self.nsub,
                                             self.config.eps2)
        return out.reshape(self.G_sub, self.st.C, self.dim)
