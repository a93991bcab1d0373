"""The kd engine's dual-tree MAC traversal on tensors: the card's kernel
(``csrc/traverse.cu``), its plain PyTorch version, and the engine's lists
made from their pairs.

Replaces no TPU kernel: the reference traverses on the host at rebuild
time (``native/co_native.cpp`` ``co_traverse_fine``, a serial depth-first
stack), and the kd engine still does so for particles on the CPU.  For
particles on a card the engine runs this module instead
(``KdFmmEngine._traverse``), because at N = 1M that host stack was the
largest part of the re-sort that paces the production window.

The traversal is a level-synchronous frontier of node pairs, one level at
a time from the root pair.  Every pair is classified as the native
traversal classifies it: M2L when i != j and max(pm2) * max(sz) < dist2;
near when both nodes are leaves; else split (a self pair into (l,l),
(l,r), (r,r), any other pair on its larger non-leaf side).  The per-node
tables ``sz`` and ``pm2`` are the native library's
(``native.traverse_tables``) and ``dist2`` is summed over the axes in the
native order, in float32 without fused multiply-adds, so every decision is
the native one bit for bit.

:func:`frontier` dispatches on the device of its tensors: a CPU tensor
goes to :func:`frontier_plain`; a CUDA tensor goes to the kernel
(:func:`frontier_cuda`), or raises.  There is no fallback between them.
Both return the unordered pairs: M2L heap pairs [K, 2] and near sub-leaf
pairs [Q, 2] (leaf-relative, self pairs included), int32, in no fixed
order.  :func:`directed_lists` turns them into what ``native.traverse_fine``
returns, with plain tensor ops (sorts, a cumulative sum) on either device:

  * m2l [Kd, 2]: both directions of every pair, sorted by (target,
    source).  The native within-target order is its depth-first emission
    order, which a frontier does not reproduce; this canonical order holds
    the same entries;
  * near [Qb, 2]: (target sub-leaf, packed source block) sorted by target
    and block, the block id in the low bits and the OR of the sub-leaf
    group bits in the top 2^S bits: the native list element for element.

:class:`DeviceTraversal` is what an engine keeps between its traversals on
the card: a high-priority side stream of its own (the traversal waits on
that stream alone, never on the windows queued on the main stream) and
the buffer sizes from the last traversal's counts x 1.3.  The lists stay
on the card: the engine lays them out there, on the same stream
(``KdFmmEngine._lists_to_state``).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from coulomb_oscillators_tpu_torch import native

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "traverse.cu")

# kernel launches (one a frontier level) made through :func:`frontier_cuda`,
# and its overflow reruns; counted nowhere else
launches = 0
reruns = 0
_count_lock = threading.Lock()

# buffer headroom over the last traversal's counts (the native caps' own)
HEADROOM = 1.3


def _bind(lib) -> None:
    vp = ctypes.c_void_p
    lib.co_traverse_run.argtypes = (
        [vp, vp, vp, ctypes.c_int, ctypes.c_int, vp, vp, ctypes.c_longlong,
         vp, ctypes.c_longlong, vp, ctypes.c_longlong, vp, vp, vp, vp])
    lib.co_traverse_run.restype = ctypes.c_int


# csrc/traverse.cu, built at first use
library = native.CudaLibrary(SRC, "co_traverse", _bind)


def _check(center: torch.Tensor, sz: torch.Tensor, pm2: torch.Tensor,
           L: int) -> None:
    M = (1 << (L + 1)) - 1
    if center.dim() != 2 or center.shape[0] != M or center.shape[1] not in (
            2, 3):
        raise ValueError(f"center must be [{M}, 2] or [{M}, 3], got "
                         f"{tuple(center.shape)}")
    for name, t in (("center", center), ("sz", sz), ("pm2", pm2)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != center.device:
            raise ValueError("center, sz and pm2 must share a device")
    if sz.shape != (M,) or pm2.shape != (M,):
        raise ValueError(f"sz and pm2 must be [{M}]")


def frontier(center: torch.Tensor, sz: torch.Tensor, pm2: torch.Tensor,
             L: int, caps: dict = None):
    """The traversal's unordered pairs (module docstring) and a dict of
    its counts (``m2l``, ``near``, ``levels``, ``largest`` frontier, pairs
    ``visited``, ``reruns``).  `caps`: buffer sizes in pairs for the
    kernel (``front``, ``m2l``, ``near``); it grows them in place where
    they were short."""
    _check(center, sz, pm2, L)
    if center.device.type == "cpu":
        return frontier_plain(center, sz, pm2, L)
    if center.device.type == "cuda":
        return frontier_cuda(center, sz, pm2, L, caps)
    raise ValueError(f"no traversal for device {center.device}")


def frontier_plain(center: torch.Tensor, sz: torch.Tensor,
                   pm2: torch.Tensor, L: int):
    """:func:`frontier` in plain PyTorch, one level at a time: the kernel's
    decisions in the same float32 arithmetic."""
    leaf0 = (1 << L) - 1
    dim = center.shape[1]
    front = torch.zeros((1, 2), dtype=torch.int64, device=center.device)
    m2l, near = [], []
    levels = largest = visited = 0
    while front.shape[0]:
        levels += 1
        largest = max(largest, front.shape[0])
        visited += front.shape[0]
        i, j = front[:, 0], front[:, 1]
        d = center[i] - center[j]
        dist2 = d[:, 0] * d[:, 0]
        for a in range(1, dim):
            dist2 = dist2 + d[:, a] * d[:, a]
        szi, szj = sz[i], sz[j]
        adm = ((torch.maximum(pm2[i], pm2[j]) * torch.maximum(szi, szj)
                < dist2) & (i != j))
        leaf_i, leaf_j = i >= leaf0, j >= leaf0
        nr = ~adm & leaf_i & leaf_j
        m2l.append(front[adm])
        near.append(front[nr] - leaf0)
        rest = ~adm & ~nr
        selfp = rest & (i == j)
        split_i = rest & ~selfp & ~leaf_i & (leaf_j | (szi >= szj))
        split_j = rest & ~selfp & ~split_i
        a = i[selfp]
        b, c = i[split_i], j[split_i]
        e, f = i[split_j], j[split_j]
        front = torch.cat([
            torch.stack([2 * a + 1, 2 * a + 1], 1),
            torch.stack([2 * a + 1, 2 * a + 2], 1),
            torch.stack([2 * a + 2, 2 * a + 2], 1),
            torch.stack([2 * b + 1, c], 1), torch.stack([2 * b + 2, c], 1),
            torch.stack([e, 2 * f + 1], 1), torch.stack([e, 2 * f + 2], 1)])
    m2l = torch.cat(m2l).to(torch.int32)
    near = torch.cat(near).to(torch.int32)
    return m2l, near, {"m2l": m2l.shape[0], "near": near.shape[0],
                       "levels": levels, "largest": largest,
                       "visited": visited, "reruns": 0}


def initial_caps(L: int) -> dict:
    """Buffer sizes (pairs) for an engine's first traversal on the card,
    before any counts: a first traversal that outgrows them runs again."""
    M = (1 << (L + 1)) - 1
    return {"front": max(1 << 16, 4 * M), "m2l": max(1 << 16, 8 * M),
            "near": max(1 << 16, 8 * M)}


def frontier_cuda(center: torch.Tensor, sz: torch.Tensor, pm2: torch.Tensor,
                  L: int, caps: dict = None):
    """:func:`frontier` on the card (``csrc/traverse.cu``): one kernel a
    level on the current stream, buffers allocated here and sized by
    `caps` (:func:`initial_caps` when None).  A buffer too small for the
    pairs runs the traversal again with larger ones (counted in
    ``reruns``); `caps` ends at the sizes that held them.  The returned
    pairs are views into the buffers."""
    global launches, reruns
    if not (center.is_contiguous() and sz.is_contiguous()
            and pm2.is_contiguous()):
        raise ValueError("center, sz and pm2 must be contiguous")
    if caps is None:
        caps = initial_caps(L)
    lib = library.get()
    dev = center.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    hcount = torch.empty(3, dtype=torch.int64, pin_memory=True)
    dcount = torch.empty(3, dtype=torch.int64, device=dev)
    info = np.zeros(6, dtype=np.int64)
    runs = 0
    while True:
        fa = torch.empty((caps["front"], 2), dtype=torch.int32, device=dev)
        fb = torch.empty((caps["front"], 2), dtype=torch.int32, device=dev)
        m2l = torch.empty((caps["m2l"], 2), dtype=torch.int32, device=dev)
        near = torch.empty((caps["near"], 2), dtype=torch.int32, device=dev)
        rc = lib.co_traverse_run(
            center.data_ptr(), sz.data_ptr(), pm2.data_ptr(),
            center.shape[1], L, fa.data_ptr(), fb.data_ptr(), caps["front"],
            m2l.data_ptr(), caps["m2l"], near.data_ptr(), caps["near"],
            dcount.data_ptr(), hcount.data_ptr(),
            info.ctypes.data_as(ctypes.c_void_p), stream)
        del fa, fb
        with _count_lock:
            launches += int(info[2])
        if rc != 0:
            raise RuntimeError(f"traversal kernel failed: cudaError_t {rc}")
        nm, nq, levels, largest, overflow, visited = (int(x) for x in info)
        if not overflow and nm <= caps["m2l"] and nq <= caps["near"]:
            break
        del m2l, near
        # the frontier's counts are whole; after a frontier overflow the
        # pair counts are those of the levels run, so grow those at least 2x
        grow = 2 if overflow else 1
        for k, v in (("front", largest), ("m2l", nm), ("near", nq)):
            if v > caps[k] or (overflow and k != "front"):
                caps[k] = max(caps[k] * grow, int(v * HEADROOM))
        runs += 1
        with _count_lock:
            reruns += 1
    return m2l[:nm], near[:nq], {"m2l": nm, "near": nq, "levels": levels,
                                 "largest": largest, "visited": visited,
                                 "reruns": runs}


def _int32_wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 of the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def directed_lists(m2l_u: torch.Tensor, near_u: torch.Tensor, L: int,
                   S: int, coll: bool):
    """(m2l [Kd, 2], near [Qb, 2]) int32 on the device of the pairs, from
    :func:`frontier`'s unordered pairs (module docstring).  `near_u` is
    overwritten: it becomes the directed near keys."""
    dev = m2l_u.device
    M = (1 << (L + 1)) - 1
    a, b = m2l_u[:, 0].long(), m2l_u[:, 1].long()
    # every key is distinct, so unique is a sort of the keys alone
    key = torch.unique(torch.cat([a * M + b, b * M + a]))
    del a, b
    m2l = torch.stack([key // M, key % M], 1).to(torch.int32)
    del key
    if not coll or near_u.shape[0] == 0:
        return m2l, torch.zeros((0, 2), dtype=torch.int32, device=dev)
    return m2l, _packed_near(near_u, L, S)


# directed near keys that one bucket of the near list's packing sorts at
# most (bounds its temporaries: ~20 bytes a key)
BUCKET_KEYS = 1 << 22
# the deepest tree whose directed near keys (2L bits) are int32
INT32_KEYS_MAX_L = 15


def _packed_near(near_u: torch.Tensor, L: int, S: int) -> torch.Tensor:
    """The native near list from the unordered sub-leaf pairs: each pair
    (a, b) gives the directed keys a << L | b and b << L | a (a self pair
    the same key twice, kept once), sorted; one packed entry a run of keys
    with the same target and source block.  Targets are cut into
    power-of-two ranges of at most ~BUCKET_KEYS keys each, sorted and
    packed one range at a time."""
    G = 1 << L
    if L <= INT32_KEYS_MAX_L:
        # int32 keys, in place: the pair buffer becomes the key buffer
        a, b = near_u[:, 0], near_u[:, 1]
        b.bitwise_left_shift_(L).bitwise_or_(a)
        a.bitwise_left_shift_(L).bitwise_or_(b >> L)
        keys = near_u.reshape(-1)
    else:
        a, b = near_u[:, 0].long(), near_u[:, 1].long()
        keys = torch.cat([(a << L) | b, (b << L) | a])
        del a, b
    nb = 1
    while nb < G and keys.shape[0] > nb * BUCKET_KEYS:
        nb *= 2
    step = G // nb
    out = []
    for q in range(nb):
        kb = keys
        if nb > 1:
            lo, hi = (q * step) << L, ((q + 1) * step) << L
            kb = keys[(keys >= lo) & (keys < hi)]
        out.append(_pack(torch.unique(kb), L, S))
        del kb
    return torch.cat(out) if nb > 1 else out[0]


def _pack(key: torch.Tensor, L: int, S: int) -> torch.Tensor:
    """Sorted distinct directed keys -> [(target, packed block)]: the block
    id in the low bits, the OR of the sub-leaf group bits in the top 2^S
    bits (as int32)."""
    nsub = 1 << S
    blk = key >> S                          # target << (L - S) | block
    head = torch.ones_like(blk, dtype=torch.bool)
    head[1:] = blk[1:] != blk[:-1]
    run = torch.cumsum(head, 0, dtype=torch.int32) - 1
    # the group bits of one (target, block) are distinct: their sum is
    # their OR
    bits = torch.ones_like(key, dtype=torch.int32) << (key & (nsub - 1)).to(
        torch.int32)
    heads = blk[head].long()
    del blk, head
    mask = torch.zeros(heads.shape[0], dtype=torch.int32, device=key.device)
    mask.index_add_(0, run, bits)
    del run, bits
    G_blk = 1 << (L - S)
    packed = _int32_wrap((heads & (G_blk - 1)) | (mask.long() << (32 - nsub)))
    return torch.stack([(heads >> (L - S)).to(torch.int32), packed], 1)


def traverse(center: torch.Tensor, sz: torch.Tensor, pm2: torch.Tensor,
             L: int, S: int, coll: bool, caps: dict = None):
    """:func:`frontier` then :func:`directed_lists`: (m2l, near, counts)
    on the device of `center`, the frontier's buffers freed before the
    lists are made."""
    m2l_u, near_u, info = frontier(center, sz, pm2, L, caps)
    m2l, near = directed_lists(m2l_u, near_u, L, S, coll)
    return m2l, near, info


class DeviceTraversal:
    """What one kd engine keeps between its traversals on the card (module
    docstring).  :meth:`run` takes the host geometry and tables and
    returns the lists on the card, where the engine lays them out."""

    def __init__(self):
        self.caps = None          # buffer sizes (pairs) for the next run
        self._lock = threading.Lock()

    def run(self, center: np.ndarray, sz: np.ndarray, pm2: np.ndarray,
            L: int, S: int, coll: bool, device):
        """(m2l [Kd, 2], near [Qb, 2]) int32 tensors on `device` and the
        counts, computed on the device's side stream (:func:`side_stream`):
        their last kernels may still be queued there, so a reader on
        another stream waits for that stream first.  The frontier's
        buffers are freed before this returns."""
        device = torch.device(device)
        with self._lock, torch.cuda.device(device):
            with torch.cuda.stream(side_stream(device)):
                tab = torch.from_numpy(np.concatenate(
                    [np.ascontiguousarray(center, np.float32).reshape(-1),
                     sz, pm2])).to(device)
                M = sz.shape[0]
                c = tab[:center.size].view(M, -1)
                caps = self.caps or initial_caps(L)
                m2l, near, info = traverse(c, tab[c.numel():c.numel() + M],
                                           tab[c.numel() + M:], L, S, coll,
                                           caps)
                del tab, c
        self.caps = {"front": max(1 << 16, int(info["largest"] * HEADROOM)),
                     "m2l": max(1 << 16, int(info["m2l"] * HEADROOM)),
                     "near": max(1 << 16, int(info["near"] * HEADROOM))}
        return m2l, near, info


_streams = {}
_streams_lock = threading.Lock()


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The traversal's stream on `device`: high priority, and apart from
    the streams the windows run on."""
    with _streams_lock:
        if device not in _streams:
            _streams[device] = torch.cuda.Stream(device, priority=-1)
        return _streams[device]
