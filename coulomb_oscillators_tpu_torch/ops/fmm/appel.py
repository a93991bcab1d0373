"""Appel monopole tree engine (2D and 3D) on tensors.

Twin of ``coulomb_oscillators_tpu/ops/fmm/appel.py`` (reference capability:
appel.cuh:529-673): a uniform-grid tree with a monopole-only far field —
per-cell charge and center of charge (centerLeaves, appel.cuh:226-258),
cell-cell interactions over the parent-neighbourhood stencil accumulating a
constant field per cell (c2c2, :420-467), pushed down by plain addition
(pushl, :469-489) and applied to particles (pushLeaves, :491-504); the near
field runs over the (2R+1)^dim neighbour cells (p2p2/p2p3, :260-381).

The far-field interaction uses the actual centers of charge, so stencil
classes carry no constant matrix: each class is an elementwise field
evaluation F += q_src * R / |R|^dim over the level grid.  As in the octree
engine (octree.py), the classes run per target parity, every valid source
of a parity gathered at once from the zero-padded grids.
"""

from __future__ import annotations

from typing import Optional

import torch

from coulomb_oscillators_tpu_torch.config import SimConfig
from coulomb_oscillators_tpu_torch.ops.fmm import octree as oc
from coulomb_oscillators_tpu_torch.ops.fmm.octree import OctState


class AppelEngine:
    """Monopole tree-code engine (engine name: "appel").

    The near-field neighbourhood and the c2c exclusion window scale with
    the integer interaction radius R = round(config.tree_radius), any
    R >= 1 (the reference's ``-radius``)."""

    def __init__(self, config: SimConfig, n: int, L: Optional[int] = None,
                 cell_cap: int = 0):
        self.config = config
        self.n = n
        self.dim = config.dim
        # level heuristic as the octree engine at p=2
        self.L = L or oc.auto_level_octree(n, 2, self.dim,
                                           config.dens_inhom, config.tree_L)
        self.R = max(int(round(config.tree_radius)), 1)
        self.levels, self.offsets, self.nbrs = oc._grid_static(
            self.dim, self.L, self.R)
        self.cell_cap = cell_cap
        self._near = oc._NearField(self.levels, self.nbrs, self.L, self.dim)

    # ---------- build ----------
    def build(self, pos: torch.Tensor) -> OctState:
        st, self.cell_cap = oc.build_state(pos, self.L, self.dim,
                                           self.cell_cap)
        return st

    # ---------- force ----------
    def force(self, pos: torch.Tensor, st: OctState) -> torch.Tensor:
        """Coulomb acceleration (kappa-scaled), original particle order:
        the stage methods below, in order."""
        pos_s = self._sorted(pos, st)
        q_lvl, coc_lvl = self._stage_monopoles(pos_s, st)
        F_leaf = self._stage_push_down(self._stage_c2c(q_lvl, coc_lvl))
        acc_far = F_leaf[st.key.long()]       # L2P: the leaf field
        acc_near = self._stage_p2p(pos_s, st)
        acc_s = (acc_far + acc_near) * oc._kappa(self.config, self.n,
                                                 pos.dtype)
        return oc._unsort(acc_s, st.perm)

    # ---- pipeline stages (each callable alone, for profiling) ----

    def _sorted(self, pos: torch.Tensor, st: OctState) -> torch.Tensor:
        """Positions in cell order.  The reference indexes pad slots in
        int32 and refuses a slot space of 2^31 or more; the port indexes in
        int64 and refuses the same configurations."""
        cellsL = 1 << (self.dim * self.L)
        if cellsL * self.cell_cap >= 2 ** 31:
            raise ValueError(f"padded slot space {cellsL}*{self.cell_cap} "
                             f"overflows int32; lower tree_L or cell_cap")
        return pos[st.perm.long()]

    def _stage_monopoles(self, pos_s: torch.Tensor, st: OctState):
        """Per-level monopoles: charge counts and centers of charge."""
        n, dim, L = self.n, self.dim, self.L
        dtype, dev = pos_s.dtype, pos_s.device
        cellsL = 1 << (dim * L)
        nsib = 1 << dim
        key = st.key.long()
        q_lvl = [None] * (L + 1)
        s_lvl = [None] * (L + 1)          # charge-weighted position sums
        q_lvl[L] = torch.zeros(cellsL, dtype=dtype, device=dev).index_add_(
            0, key, torch.ones(n, dtype=dtype, device=dev))
        s_lvl[L] = torch.zeros(cellsL, dim, dtype=dtype,
                               device=dev).index_add_(0, key, pos_s)
        for l in range(L - 1, -1, -1):
            q_lvl[l] = q_lvl[l + 1].reshape(-1, nsib).sum(dim=1)
            s_lvl[l] = s_lvl[l + 1].reshape(-1, nsib, dim).sum(dim=1)
        coc_lvl = [s / torch.clamp(q, min=1.0)[:, None]
                   for q, s in zip(q_lvl, s_lvl)]
        return q_lvl, coc_lvl

    def _stage_c2c(self, q_lvl: list, coc_lvl: list) -> list:
        """c2c: per level, the field of the stencil's source monopoles at
        each target's center of charge."""
        dim, L = self.dim, self.L
        dtype, dev = coc_lvl[L].dtype, coc_lvl[L].device
        F_lvl = [torch.zeros((1 << (dim * l), dim), dtype=dtype, device=dev)
                 for l in range(L + 1)]
        for l in range(2, L + 1):
            from_grid, to_grid = oc._grid_maps(dim, l, dev)
            Fg = self._c2c_level(q_lvl[l][from_grid], coc_lvl[l][from_grid],
                                 l, self.config.eps2)
            F_lvl[l] = F_lvl[l] + Fg[to_grid]
        return F_lvl

    def _stage_push_down(self, F_lvl: list) -> torch.Tensor:
        """Push the constant field down to the leaves: [cells_L, dim]."""
        nsib = 1 << self.dim
        F = F_lvl[min(2, self.L)]
        for l in range(3, self.L + 1):
            F = F_lvl[l] + F.repeat_interleave(nsib, dim=0)
        return F

    def _stage_p2p(self, pos_s: torch.Tensor, st: OctState) -> torch.Tensor:
        """P2P over the neighbour shifts, unscaled."""
        cap = self.cell_cap
        pad_slot = st.key.long() * cap + st.rank.long()
        return self._near(pos_s, pad_slot, cap, self.config.eps2)

    # the reference's traceable entry point; the port runs eagerly
    force_in_jit = force

    def _c2c_level(self, q_flat: torch.Tensor, c_flat: torch.Tensor, l: int,
                   eps2: float) -> torch.Tensor:
        """One level's cell-cell field on the row-major grid: charges
        [side^dim] and centers [side^dim, dim] -> field [side^dim, dim]."""
        dim, R = self.dim, self.R
        side, half = 1 << l, 1 << (l - 1)
        pad = 2 * R + 1
        psz = (side + 2 * pad,) * dim
        inner = (slice(pad, pad + side),) * dim
        qp = q_flat.new_zeros(psz)
        qp[inner] = q_flat.reshape((side,) * dim)
        cp = c_flat.new_zeros(psz + (dim,))
        cp[inner] = c_flat.reshape((side,) * dim + (dim,))
        cg = c_flat.reshape((side,) * dim + (dim,))
        Fg = torch.zeros_like(cg)
        sib = self.levels[1]["coords"]
        for c, cls in zip(sib, oc._parity_classes(dim, R)):
            offs = [self.offsets[k] for k in cls]
            rows = max(1, oc._CHUNK_ELEMS // (half ** (dim - 1) * len(offs)
                                               * (dim + 1)))
            for r0 in range(0, half, rows):
                r1 = min(half, r0 + rows)
                src = [oc._strided(c + o + pad, half, r0, r1) for o in offs]
                q_src = torch.stack([qp[s] for s in src], dim=dim)  # [.., nc]
                c_src = torch.stack([cp[s] for s in src], dim=dim)
                tsl = oc._strided(c, half, r0, r1)
                Rv = cg[tsl].unsqueeze(dim) - c_src
                r = torch.rsqrt(torch.sum(Rv * Rv, dim=-1) + eps2)
                w = (r * r * r if dim == 3 else r * r) * q_src
                Fg[tsl] = torch.sum(Rv * w[..., None], dim=dim)
        return Fg.reshape(-1, dim)
