"""Uniform-grid octree/quadtree FMM engines (2D and 3D) on tensors.

Twin of ``coulomb_oscillators_tpu/ops/fmm/octree.py`` (reference
capability: fmm_cart.cuh, fmm_cart3_symmetric.cuh / fmm_cart3_traceless.cuh).
Everything about the uniform grid is static, so there is no traversal:

  * cells are Morton-indexed (parent = id >> dim) over a bounding cube;
    particles bin with one stable sort per rebuild;
  * M2M/L2L use 2^dim constant sibling matrices, applied as one matmul per
    level;
  * M2L is the parent-neighbourhood-minus-own-neighbourhood stencil
    (fmm_cart.cuh:214-286): per offset class o in [-(2R+1), 2R+1]^dim with
    |o|_inf > R, a constant [S_M, S_Lt] matrix;
  * P2P runs over the (2R+1)^dim neighbour shifts on fixed-capacity padded
    cell blocks (capacity = next pow2 of the observed max occupancy).

The M2L stencil runs per target parity class instead of per offset class.
The reference's per-axis mask valid(i) = |floor((i+o)/2) - floor(i/2)| <= R
depends on i only through i mod 2, so for the cells of one parity
c in {0,1}^dim the set of valid offsets is fixed: the level's M2L is 2^dim
gathers of strided views of the zero-padded multipole grid (one per valid
offset, stacked) and 2^dim matmuls against the stacked class matrices —
the same terms as the reference's masked grid shifts, summed in another
order, with tens of kernel launches per level instead of thousands.
Cells outside the grid read the zero pad, which the reference's bounds
mask zeroes the same way.

The operator matrices are built in float32, as the reference builds them,
and cast to the working dtype at use.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.config import SimConfig, round_to_dtype
from coulomb_oscillators_tpu_torch.ops.multipole import operators as mop
from coulomb_oscillators_tpu_torch.ops.multipole import packing as pk
from coulomb_oscillators_tpu_torch.ops.multipole.tables import build_tables

FAR = 1e18
# elements per stacked M2L / P2P temporary (bounds device memory per chunk)
_CHUNK_ELEMS = 1 << 27


def auto_level_octree(n: int, p: int, dim: int, dens_inhom: float = 1.0,
                      tree_L: int = 0) -> int:
    """L = round(log2(dens*n/p^2)/dim) (fmm_cart3_symmetric.cuh:435),
    clamped so the grid stays moderate."""
    if tree_L > 0:
        return max(1, tree_L)
    L = int(round(math.log2(max(dens_inhom * n / (p * p), 1.0)) / dim))
    return max(2, min(L, 8 if dim == 3 else 11))


# --------------------------------------------------------------------------- #
# static structure (numpy copies of the reference's)
# --------------------------------------------------------------------------- #


def _morton_decode(ids: np.ndarray, bits: int, dim: int) -> np.ndarray:
    out = np.zeros((ids.shape[0], dim), dtype=np.int64)
    for b in range(bits):
        for a in range(dim):
            out[:, a] |= ((ids >> (b * dim + a)) & 1) << b
    return out


@functools.lru_cache(maxsize=32)
def _grid_level(dim: int, l: int) -> dict:
    """Level l's cell coordinates and morton <-> row-major maps."""
    side = 1 << l
    cells = side ** dim
    ids = np.arange(cells, dtype=np.int64)
    coords = _morton_decode(ids, l, dim) if l else np.zeros((1, dim), np.int64)
    flat = np.zeros(cells, dtype=np.int64)
    for a in range(dim):
        flat = flat * side + coords[:, a]
    inv = np.empty(cells, dtype=np.int64)
    inv[flat] = ids
    return {"coords": coords, "to_grid": flat, "from_grid": inv}


@functools.lru_cache(maxsize=16)
def _grid_static(dim: int, L: int, R: int = 1):
    """Per-level static maps: morton<->row-major grid, M2L offset classes,
    P2P neighbour offsets.  R is the integer interaction radius (the
    reference's `tree_radius`, appel.cuh:260-381, 420-467)."""
    levels = [_grid_level(dim, l) for l in range(L + 1)]
    offsets = []
    rng = range(-(2 * R + 1), 2 * R + 2)
    for o in itertools.product(*([rng] * dim)):
        if max(abs(x) for x in o) > R:
            offsets.append(o)
    nbrs = [o for o in itertools.product(*([range(-R, R + 1)] * dim))]
    return levels, tuple(offsets), tuple(nbrs)


def _axis_mask(side: int, o: int, R: int = 1) -> np.ndarray:
    """valid(i) = |floor((i+o)/2) - floor(i/2)| <= R and 0 <= i+o < side
    (the per-axis children-of-parent-neighbours condition)."""
    i = np.arange(side)
    j = i + o
    ok = (j >= 0) & (j < side) & (np.abs(j // 2 - i // 2) <= R)
    return ok.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _parity_classes(dim: int, R: int):
    """For each target parity c in {0,1}^dim (morton sibling order): the
    indices into the offset classes of `_grid_static` that are valid for
    cells of that parity, i.e. |floor((c_a + o_a)/2)| <= R on every axis."""
    _, offsets, _ = _grid_static(dim, 1, R)
    out = []
    for c in _morton_decode(np.arange(1 << dim), 1, dim):
        out.append(tuple(k for k, o in enumerate(offsets)
                         if all(abs((c[a] + o[a]) // 2) <= R
                                for a in range(dim))))
    return out


def _strided(start, half: int, r0: int, r1: int):
    """Per-axis stride-2 slices of `half` cells from `start`, cut to rows
    [r0, r1) on axis 0: one parity class's cells (or their sources) in a
    chunk of rows."""
    return (slice(start[0] + 2 * r0, start[0] + 2 * r1, 2),) + tuple(
        slice(s, s + 2 * half, 2) for s in start[1:])


@functools.lru_cache(maxsize=64)
def _grid_maps(dim: int, l: int, device: torch.device):
    """Level l's (morton -> row-major, row-major -> morton) index maps on
    `device`."""
    lv = _grid_level(dim, l)
    return (torch.as_tensor(lv["from_grid"], device=device),
            torch.as_tensor(lv["to_grid"], device=device))


# --------------------------------------------------------------------------- #
# state and binning
# --------------------------------------------------------------------------- #


class OctState(NamedTuple):
    """Frozen between rebuilds (the reference's fields and dtypes)."""
    perm: torch.Tensor       # [n] int32 sorted order
    key: torch.Tensor        # [n] int32 leaf morton id per sorted particle
    origin: torch.Tensor     # [dim] box origin
    cw: torch.Tensor         # [] leaf cell width
    rank: torch.Tensor       # [n] int32 rank of particle within its cell
    counts: torch.Tensor     # [cells_L] int32 occupancy


def oct_state_from_numpy(d: dict, device) -> OctState:
    """OctState from host arrays keyed by field name (the reference's
    OctState converted with np.asarray)."""
    return OctState(**{k: torch.as_tensor(np.array(d[k])).to(device)
                       for k in OctState._fields})


def _bin_particles(pos: torch.Tensor, L: int, dim: int):
    """Morton keys of the leaf cells over the bounding cube, and the stable
    sort by key: (sorted keys int32, perm int32, origin [dim], cw [])."""
    mn = pos.amin(dim=0)
    mx = pos.amax(dim=0)
    extent = (mx - mn).max() * 1.0001
    origin = 0.5 * (mn + mx) - 0.5 * extent
    cw = extent / (1 << L)
    # int32 keys: dim*L <= 24 bits by the level clamp in auto_level_octree
    q = ((pos - origin) / cw).to(torch.int32).clamp(0, (1 << L) - 1)
    key = torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device)
    for b in range(L):
        for a in range(dim):
            key = key | (((q[:, a] >> b) & 1) << (b * dim + a))
    perm = torch.argsort(key, stable=True)
    return key[perm], perm.to(torch.int32), origin, cw


def build_state(pos: torch.Tensor, L: int, dim: int, cell_cap: int):
    """Bin `pos` into the 2^(dim*L) leaf cells: (OctState, cell capacity);
    the capacity grows to the next power of two of the largest occupancy
    (at least 4) when that exceeds `cell_cap`."""
    key, perm, origin, cw = _bin_particles(pos, L, dim)
    keyl = key.long()
    counts = torch.bincount(keyl, minlength=1 << (dim * L)).to(torch.int32)
    starts = torch.cumsum(counts, 0) - counts
    rank = (torch.arange(pos.shape[0], device=pos.device)
            - starts[keyl]).to(torch.int32)
    maxocc = int(counts.max())
    if cell_cap == 0 or maxocc > cell_cap:
        cell_cap = 1 << int(math.ceil(math.log2(max(maxocc, 4))))
    return OctState(perm=perm, key=key, origin=origin, cw=cw, rank=rank,
                    counts=counts), cell_cap


class _NearField:
    """P2P over the (2R+1)^dim neighbour shifts of padded leaf cells
    (the reference's loop, shared by the octree and Appel engines): pads
    park at FAR with no mask, so a pad adds d * w(FAR) exactly as the
    reference's sum does (0 in float32 3D; ~1e-18 per pad in 2D, ~1e-36
    per pad in float64 3D)."""

    def __init__(self, levels, nbrs, L: int, dim: int):
        self.levels, self.nbrs, self.L, self.dim = levels, nbrs, L, dim
        self.cells = (1 << L) ** dim
        self._dev = {}

    def _tensors(self, device):
        """Per neighbour shift: the source cell of every cell (clamped) and
        whether it lies inside the grid, built at first use."""
        device = torch.device(device)
        if device not in self._dev:
            coords = self.levels[self.L]["coords"]
            side, cells = 1 << self.L, self.cells
            src, valid = [], []
            for o in self.nbrs:
                nb = coords + np.asarray(o)
                ok = np.all((nb >= 0) & (nb < side), axis=1)
                fl = np.zeros(cells, dtype=np.int64)
                for a in range(self.dim):
                    fl = fl * side + np.clip(nb[:, a], 0, side - 1)
                nb_m = np.asarray(self.levels[self.L]["from_grid"])[fl]
                src.append(np.minimum(np.where(ok, nb_m, cells), cells - 1))
                valid.append(ok)
            self._dev[device] = (torch.as_tensor(np.stack(src), device=device),
                                 torch.as_tensor(np.stack(valid),
                                                 device=device))
        return self._dev[device]

    def __call__(self, pos_s: torch.Tensor, pad_slot: torch.Tensor,
                 cap: int, eps2: float) -> torch.Tensor:
        """Near-field acceleration (unscaled) of the sorted particles."""
        dim, cells = self.dim, self.cells
        src, valid = self._tensors(pos_s.device)
        pos_pad = torch.full((cells * cap, dim), FAR, dtype=pos_s.dtype,
                             device=pos_s.device)
        pos_pad[pad_slot] = pos_s
        pos_pad = pos_pad.reshape(cells, cap, dim)
        out = torch.zeros_like(pos_pad)
        chunk = max(1, _CHUNK_ELEMS // (cap * cap * dim))
        for c0 in range(0, cells, chunk):
            tgt = pos_pad[c0:c0 + chunk]
            acc = torch.zeros_like(tgt)
            for k in range(src.shape[0]):
                P_s = pos_pad[src[k, c0:c0 + chunk]]
                d = tgt[:, :, None, :] - P_s[:, None, :, :]
                dist2 = eps2 + d[..., 0] * d[..., 0]
                for a in range(1, dim):
                    dist2 = dist2 + d[..., a] * d[..., a]
                inv = 1.0 / dist2
                wgt = inv * torch.rsqrt(dist2) if dim == 3 else inv
                wgt = wgt * valid[k, c0:c0 + chunk, None, None]
                acc = acc + torch.sum(d * wgt[..., None], dim=2)
            out[c0:c0 + chunk] = acc
        return out.reshape(cells * cap, dim)[pad_slot]


def _kappa(config: SimConfig, n: int, dtype: torch.dtype) -> float:
    """kappa rounded to the working dtype, as the reference's
    dtype.type(kappa), once per value and dtype."""
    return round_to_dtype(config.kappa(n), dtype)


def _unsort(acc_s: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(acc_s)
    out[perm.long()] = acc_s
    return out


class OctreeFmmEngine:
    """Uniform-grid FMM engine for quasi-uniform distributions.

    Engine names: "fmm2" (dim=2 quadtree), "fmm3" (3D octree, symmetric
    multipoles), "fmm3_traceless" / "fmm2_traceless" (harmonic-projected
    multipole storage: the same far field with smaller multipole arrays).
    """

    def __init__(self, config: SimConfig, n: int, L: Optional[int] = None,
                 cell_cap: int = 0, multipole_storage: str = "symmetric"):
        self.config = config
        self.n = n
        self.dim = config.dim
        self.p = max(config.fmm_order, 2)
        self.L = L or auto_level_octree(n, self.p, self.dim,
                                        config.dens_inhom, config.tree_L)
        self.tables = build_tables(self.dim, self.p)
        # integer interaction radius (the -r flag), any R >= 1
        self.R = max(int(round(config.tree_radius)), 1)
        self.levels, self.offsets, self.nbrs = _grid_static(self.dim, self.L,
                                                            self.R)
        self.cell_cap = cell_cap  # 0 = choose at build
        self.multipole_storage = multipole_storage
        self._k = None            # (m2m, m2l, l2l, p2m projection), float32
        self._dev = {}
        self._near = _NearField(self.levels, self.nbrs, self.L, self.dim)

    # ---------- constant operator matrices ----------
    def _sibling_geometry(self):
        """Normalized sibling shift vectors and rho for M2M/L2L: child
        centers sit +-1/4 parent widths from the parent center, and
        lam_parent = sqrt(dim)/2 parent widths."""
        sib = self.levels[1]["coords"]                     # [2^dim, dim]
        off = (sib.astype(np.float64) - 0.5) / 2.0
        s = off / (math.sqrt(self.dim) / 2.0)
        return torch.as_tensor(s, dtype=torch.float32), 0.5

    def _build_matrices(self):
        """The reference's constant matrices, [in, out] (apply as
        vec @ K), built in float32 as the reference builds them."""
        t = self.tables
        dim = self.dim
        nsib = 1 << dim
        f32 = torch.float32
        s, rho = self._sibling_geometry()

        def per_sibling(op, S):
            eye = torch.eye(S, dtype=f32)
            return torch.stack([op(t, eye, s[c].expand(S, dim),
                                   torch.full((S,), rho, dtype=f32))
                                for c in range(nsib)])

        k_m2m = per_sibling(mop.m2m, t.S_M)                # [nsib, S_M, S_M]
        k_l2l = per_sibling(mop.l2l, t.S_Lt)               # [nsib, S_Lt, S_Lt]
        # M2L per offset class at unit cell width, R = x_tgt - x_src =
        # -offset; in 2D the -log r monopole correction is evaluated at unit
        # width (the per-level -log(cw) shift changes only the potential)
        lam = math.sqrt(dim) / 2.0
        O = torch.as_tensor(np.array(self.offsets, np.float64), dtype=f32)
        eyeM = torch.eye(t.S_M, dtype=f32)
        full = torch.full((t.S_M,), lam, dtype=f32)
        k_m2l = torch.stack([mop.m2l(t, eyeM, (-O[c]).expand(t.S_M, dim),
                                     full, full)
                             for c in range(O.shape[0])])  # [nO, S_M, S_Lt]
        proj = None
        if self.multipole_storage == "traceless":
            R = torch.as_tensor(pk.traceless_extend_layout(t.PM, dim),
                                dtype=f32)                 # [S_Mf, S_Mt]
            P = torch.as_tensor(pk.traceless_project_layout(t.PM, dim),
                                dtype=f32)                 # [S_Mt, S_Mf]
            proj = P.T                                     # fold after p2m
            k_m2m = torch.einsum("fa,cfj,bj->cab", R, k_m2m, P)
            k_m2l = torch.einsum("fa,cfl->cal", R, k_m2l)
        self._k = (k_m2m, k_m2l, k_l2l, proj)

    def _mats(self, dtype, device):
        """The matrices in the layout the force applies them, cast to
        `dtype` on `device`: M2M as one [nsib*SM, SM] matmul, L2L as one
        [S_Lt, nsib*S_Lt] matmul, M2L stacked per target parity class."""
        key = (dtype, torch.device(device))
        if key not in self._dev:
            if self._k is None:
                self._build_matrices()
            k_m2m, k_m2l, k_l2l, proj = (
                None if k is None else k.to(device=device, dtype=dtype)
                for k in self._k)
            nsib, SM = k_m2m.shape[0], k_m2m.shape[1]
            S_Lt = k_l2l.shape[1]
            m2l = [(cls, k_m2l[list(cls)].reshape(len(cls) * SM, -1))
                   for cls in _parity_classes(self.dim, self.R)]
            self._dev[key] = dict(
                m2m=k_m2m.reshape(nsib * SM, SM),
                l2l=k_l2l.permute(1, 0, 2).reshape(S_Lt, nsib * S_Lt),
                m2l=m2l, proj=proj, SM=SM)
        return self._dev[key]

    # ---------- build ----------
    def build(self, pos: torch.Tensor) -> OctState:
        st, self.cell_cap = build_state(pos, self.L, self.dim, self.cell_cap)
        return st

    # ---------- force ----------
    def force(self, pos: torch.Tensor, st: OctState) -> torch.Tensor:
        """Coulomb acceleration (kappa-scaled), original particle order:
        the stage methods below, in order."""
        mats = self._mats(pos.dtype, pos.device)
        pos_s, e, lam_L = self._frame(pos, st)
        M_lvl = self._stage_m2m(self._stage_p2m(e, st, mats), mats)
        L_leaf = self._stage_l2l(self._stage_m2l(M_lvl, st, mats), mats)
        acc_far = self._stage_l2p(L_leaf, e, st, lam_L)
        acc_near = self._stage_p2p(pos_s, st)
        acc_s = (acc_far + acc_near) * _kappa(self.config, self.n, pos.dtype)
        return _unsort(acc_s, st.perm)

    # ---- pipeline stages (each callable alone, for profiling) ----

    def _frame(self, pos: torch.Tensor, st: OctState):
        """Sorted positions [n, dim], their offsets from the leaf-cell
        centers normalized by the leaf length scale, and that scale."""
        dim = self.dim
        pos_s = pos[st.perm.long()]
        coordsL = self._coords(pos.device, pos.dtype)
        center_of = st.origin[None, :] + (coordsL + 0.5) * st.cw
        lam_L = 0.5 * math.sqrt(dim) * st.cw
        return pos_s, (pos_s - center_of[st.key.long()]) / lam_L, lam_L

    def _stage_p2m(self, e: torch.Tensor, st: OctState, mats) -> torch.Tensor:
        """P2M at the leaves: [cells_L, SM]."""
        contrib = mop.p2m_contrib(self.tables, e)
        if mats["proj"] is not None:
            contrib = contrib @ mats["proj"]
        return torch.zeros(1 << (self.dim * self.L), mats["SM"],
                           dtype=e.dtype, device=e.device).index_add_(
            0, st.key.long(), contrib)

    def _stage_m2m(self, M_leaf: torch.Tensor, mats) -> list:
        """M2M up; the nsib children of a parent are consecutive.  Returns
        the multipoles per level."""
        L, nsib, SM = self.L, 1 << self.dim, mats["SM"]
        M_lvl = [None] * (L + 1)
        M_lvl[L] = M_leaf
        for l in range(L - 1, -1, -1):
            M_lvl[l] = M_lvl[l + 1].reshape(-1, nsib * SM) @ mats["m2m"]
        return M_lvl

    def _stage_m2l(self, M_lvl: list, st: OctState, mats) -> list:
        """M2L per level: the locals per level before the downward pass."""
        t, dim, L = self.tables, self.dim, self.L
        dtype, dev = M_lvl[L].dtype, M_lvl[L].device
        L_lvl = [torch.zeros((1 << (dim * l), t.S_Lt), dtype=dtype,
                             device=dev) for l in range(L + 1)]
        for l in range(2, L + 1):
            from_grid, to_grid = _grid_maps(dim, l, dev)
            Lg = self._m2l_level(M_lvl[l][from_grid], l, mats)
            scale = (1.0 / (st.cw * (1 << (L - l)))) if dim == 3 else 1.0
            L_lvl[l] = L_lvl[l] + scale * Lg[to_grid]
        return L_lvl

    def _stage_l2l(self, L_lvl: list, mats) -> torch.Tensor:
        """L2L down: the leaf locals [cells_L, S_Lt]."""
        S_Lt = self.tables.S_Lt
        loc = L_lvl[0]
        for l in range(1, self.L + 1):
            loc = L_lvl[l] + (loc @ mats["l2l"]).reshape(-1, S_Lt)
        return loc

    def _stage_l2p(self, L_leaf: torch.Tensor, e: torch.Tensor,
                   st: OctState, lam_L: torch.Tensor) -> torch.Tensor:
        """L2P: far-field acceleration of the sorted particles, unscaled."""
        return mop.l2p_field(self.tables, L_leaf[st.key.long()], e,
                             lam_L.expand(self.n).to(e.dtype))

    def _stage_p2p(self, pos_s: torch.Tensor, st: OctState) -> torch.Tensor:
        """P2P over the neighbour shifts (int64 pad slots), unscaled."""
        cap = self.cell_cap
        pad_slot = st.key.long() * cap + st.rank.long()
        return self._near(pos_s, pad_slot, cap, self.config.eps2)

    # the reference's traceable entry point; the port runs eagerly
    force_in_jit = force

    def _coords(self, device, dtype):
        key = ("coords", torch.device(device), dtype)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self.levels[self.L]["coords"],
                                             dtype=dtype, device=device)
        return self._dev[key]

    def _m2l_level(self, Mg_flat: torch.Tensor, l: int, mats) -> torch.Tensor:
        """M2L of one level on the row-major grid: [side^dim, SM] ->
        [side^dim, S_Lt], per target parity class (module docstring)."""
        dim, R = self.dim, self.R
        side, half = 1 << l, 1 << (l - 1)
        SM = mats["SM"]
        pad = 2 * R + 1
        Mp = Mg_flat.new_zeros((side + 2 * pad,) * dim + (SM,))
        Mp[(slice(pad, pad + side),) * dim] = Mg_flat.reshape(
            (side,) * dim + (SM,))
        S_Lt = mats["l2l"].shape[0]
        Lg = Mg_flat.new_zeros((side,) * dim + (S_Lt,))
        sib = self.levels[1]["coords"]
        for c, (cls, K) in zip(sib, mats["m2l"]):
            offs = [self.offsets[k] for k in cls]
            row = half ** (dim - 1) * len(cls) * SM
            rows = max(1, _CHUNK_ELEMS // row)
            for r0 in range(0, half, rows):
                r1 = min(half, r0 + rows)
                X = torch.stack([Mp[_strided(c + o + pad, half, r0, r1)]
                                 for o in offs], dim=dim)  # [.., nc, SM]
                out = X.reshape(-1, len(offs) * SM) @ K
                Lg[_strided(c, half, r0, r1)] = out.reshape(
                    (r1 - r0,) + (half,) * (dim - 1) + (S_Lt,))
        return Lg.reshape(-1, S_Lt)
