"""Precomputed coefficient/gather tables for the FMM operators.

Numpy copy of ``coulomb_oscillators_tpu/ops/multipole/tables.py``; its
tables equal the twin's bit for bit.

Built once per (dim, p) on host in float64 numpy; applied at runtime as
batched gathers + einsums (operators.py).  This replaces the reference's
template-recursive per-element contraction kernels (fmm_cart_base3.cuh:
P2M :896, M2M :1006, M2L :1181, L2L :1348, L2P :1456) with static tables —
the TPU-idiomatic formulation (SURVEY.md §7 hard part 1).

Order conventions follow the reference kd-tree engine
(fmm_cart3_kdtree.cuh:207-217, 613-661): multipoles are stored for orders
0..p-1 (symmetric packed), locals for orders 0..p (traceless packed), and
M2L is truncated at total gradient order m = |gamma| + |delta| <= p, which
bounds the harmonic tables at order max(p, PM+1) = p.

Value conventions (self-consistent, validated against direct summation):

  * Cell c has center x_c and length scale lam_c.  Normalized offsets
    e = (x - x_c)/lam_c keep every stored quantity O(1) in float32 (the
    scale-invariant replacement for the reference's r^(m+1) rescale at
    fmm_cart_base3.cuh:1194).
  * Multipoles:  M~_m[g] = (-1)^m/m! * sum_j q_j e_j^g
  * Locals (tensor-normalized Taylor):
        Phi(x) = sum_n sum_{|d|=n} mult(d) T_n[d] w^d,   w = (x-x_T)/lam_T
  * M2L:  T_n[d] = u^n/(r^eta n!) sum_m v^m sum_g mult(g) M~_m[g]
                    * H_{m+n}[g+d](Rhat)
    with u = lam_T/r, v = lam_S/r, eta = 1 (3D) or 0 (2D).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from coulomb_oscillators_tpu_torch.ops.multipole import harmonics as hm
from coulomb_oscillators_tpu_torch.ops.multipole import packing as pk


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _valid(idx) -> bool:
    return all(x >= 0 for x in idx)


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: build_tables is cached
class FmmTables:
    dim: int
    p: int           # expansion order
    PM: int          # multipole orders 0..PM = p-1
    PL: int          # local orders 0..PL = p
    no_dipole: bool  # order-1 multipole slots dropped (COC centers)
    # sizes
    S_M: int         # multipole layout size (sym orders 0..PM, minus the
                     # dim order-1 slots when no_dipole)
    S_Mfull: int     # full sym layout size, orders 0..PM (m2m V-slot space)
    S_Lt: int        # traceless layout size, orders 0..PL (locals, stored)
    S_Lf: int        # sym layout size, orders 0..PL (locals, expanded)
    S_H: int         # sym layout size, orders 0..maxH (harmonics)
    maxH: int
    # per-slot orders
    m_order: np.ndarray   # [S_M]
    m_slots: np.ndarray   # [S_M] slot -> index in the FULL sym layout
                          # (identity when no_dipole=False; layouts nest, so
                          # these also index any sym layout of order >= PM)
    nt_order: np.ndarray  # [S_Lt]
    nf_order: np.ndarray  # [S_Lf]
    # tables
    p2m_coef: np.ndarray       # [S_M] (-1)^m/m!
    extend_L: np.ndarray       # [S_Lf, S_Lt] traceless -> full
    m2l_idx: np.ndarray        # [S_Lt, S_M] -> H slot
    m2l_coef: np.ndarray       # [S_Lt, S_M] (0 where m+n > p: truncation)
    m2m_idx: np.ndarray        # [S_M, S_M] -> V slot (orders 0..PM)
    m2m_coef: np.ndarray       # [S_M, S_M]
    l2l_idx: np.ndarray        # [S_Lt, S_Lf] -> VL slot (orders 0..PL)
    l2l_coef: np.ndarray       # [S_Lt, S_Lf]
    l2p_D: np.ndarray          # [dim, S_Lf, S_Lf]
    l2p_mult: np.ndarray       # [S_Lf] mult(d) (potential eval)
    m2p_idx: np.ndarray        # [dim, S_M] -> H slot
    m2p_coef: np.ndarray       # [S_M] mult(g)
    numcoef: np.ndarray        # [S_H, S_H] monomials -> H
    # dense matmul forms (W[k, i, j] = coef[i, j] iff idx[i, j] == k) so the
    # per-pair operator construction is ONE MXU matmul instead of a gather.
    m2l_W: np.ndarray          # [S_H, S_Lt, S_M]
    m2m_W: np.ndarray          # [S_M, S_M, S_M]   (V slot, out, in)
    l2l_W: np.ndarray          # [S_Lf, S_Lt, S_Lf]
    m2p_W: np.ndarray          # [S_H, dim, S_M]


@functools.lru_cache(maxsize=None)
def build_tables(dim: int, p: int, truncate: bool = True,
                 no_dipole: bool = False) -> FmmTables:
    """Tables for expansion order p.  truncate=False keeps all m+n <= PM+PL
    M2L couplings (full Taylor, used by tests); the engine default mirrors
    the reference's maxm = p truncation.

    no_dipole=True drops the dim order-1 multipole slots from the layout:
    with center-of-charge expansion centers the dipole is identically zero
    at every level, so P2M/M2M/M2L never need those slots (the reference's
    P2M-from-order-2 + no_dipole M2L skip, fmm_cart3_kdtree.cuh:231-269,
    fmm_cart_base3.cuh:1203-1212).  Only valid for engines whose centers
    are COC.  The m2m V-slot space stays the FULL sym layout (shift-vector
    monomials s^b with |b| = 1 are geometry, not multipoles)."""
    PM = p - 1
    PL = p
    maxH = max(PM + PL if not truncate else p, PM + 1)

    symMf, mf_order, symMf_idx = pk.sym_layout(PM, dim)
    keep = [j for j in range(len(symMf))
            if not (no_dipole and mf_order[j] == 1)]
    symM = tuple(symMf[j] for j in keep)
    m_order = np.asarray([mf_order[j] for j in keep])
    m_slots = np.asarray(keep, dtype=np.int32)
    symM_idx = {e: j for j, e in enumerate(symM)}
    trcL, nt_order, _ = pk.trc_layout(PL, dim)
    symL, nf_order, symL_idx = pk.sym_layout(PL, dim)
    symH, _, symH_idx = pk.sym_layout(maxH, dim)

    S_M, S_Lt, S_Lf, S_H = len(symM), len(trcL), len(symL), len(symH)
    S_Mfull = len(symMf)

    p2m_coef = np.array([(-1.0) ** n / math.factorial(n) for n in m_order])

    extend_L = pk.traceless_extend_layout(PL, dim)

    # M2L
    m2l_idx = np.zeros((S_Lt, S_M), dtype=np.int32)
    m2l_coef = np.zeros((S_Lt, S_M))
    for i, d in enumerate(trcL):
        n = sum(d)
        for j, g in enumerate(symM):
            m = sum(g)
            if truncate and (m + n > p):
                continue
            tot = tuple(a + b for a, b in zip(d, g))
            m2l_idx[i, j] = symH_idx[tot]
            m2l_coef[i, j] = pk.multinomial(g) / math.factorial(n)

    # M2M: M'_n[a] = sum_{b<=a} [binom(a,b) g!/n!] (-s)^b rho^g M_g[a-b]
    m2m_idx = np.zeros((S_M, S_M), dtype=np.int32)
    m2m_coef = np.zeros((S_M, S_M))
    for i, a in enumerate(symM):
        n = sum(a)
        for j, g in enumerate(symM):
            b = _sub(a, g)
            if not _valid(b):
                continue
            m2m_idx[i, j] = symMf_idx[b]   # V slot: FULL layout (s^b)
            m2m_coef[i, j] = (pk.binom_multi(a, b)
                              * math.factorial(sum(g)) / math.factorial(n))

    # L2L: T'_n[a] = sum_g binom(n+|g|,|g|) mult(g) s^g rho^n T_{n+|g|}[a+g]
    l2l_idx = np.zeros((S_Lt, S_Lf), dtype=np.int32)
    l2l_coef = np.zeros((S_Lt, S_Lf))
    for i, a in enumerate(trcL):
        n = sum(a)
        for j, dl in enumerate(symL):
            g = _sub(dl, a)
            if not _valid(g):
                continue
            m = sum(dl)
            l2l_idx[i, j] = symL_idx[g]
            l2l_coef[i, j] = math.comb(m, m - n) * pk.multinomial(g)

    # L2P field: F_i = -(1/lam) sum_d mult(d) d_i Tfull[d] w^(d - e_i)
    l2p_D = np.zeros((dim, S_Lf, S_Lf))
    for j, dl in enumerate(symL):
        for ax in range(dim):
            if dl[ax] == 0:
                continue
            tgt = list(dl)
            tgt[ax] -= 1
            k = symL_idx[tuple(tgt)]
            l2p_D[ax, k, j] = pk.multinomial(dl) * dl[ax]
    l2p_mult = np.array([pk.multinomial(d) for d in symL], dtype=np.float64)

    # M2P field: F_i = -(1/r^(eta+1)) sum_g mult(g) v^m M~[g] H_{m+1}[g+e_i]
    m2p_idx = np.zeros((dim, S_M), dtype=np.int32)
    m2p_coef = np.array([pk.multinomial(g) for g in symM], dtype=np.float64)
    for j, g in enumerate(symM):
        for ax in range(dim):
            tgt = list(g)
            tgt[ax] += 1
            m2p_idx[ax, j] = symH_idx[tuple(tgt)]

    numcoef = hm.numerator_matrix(maxH, dim)

    def densify(idx, coef, K):
        out = np.zeros((K,) + coef.shape)
        it = np.nditer(coef, flags=["multi_index"])
        for c in it:
            if c != 0:
                out[(idx[it.multi_index],) + it.multi_index] = c
        return out

    m2l_W = densify(m2l_idx, m2l_coef, S_H)
    m2m_W = densify(m2m_idx, m2m_coef, S_Mfull)
    l2l_W = densify(l2l_idx, l2l_coef, S_Lf)
    m2p_W = densify(m2p_idx, np.broadcast_to(m2p_coef, (dim, S_M)), S_H)

    return FmmTables(
        dim=dim, p=p, PM=PM, PL=PL, no_dipole=no_dipole,
        S_M=S_M, S_Mfull=S_Mfull, S_Lt=S_Lt, S_Lf=S_Lf, S_H=S_H, maxH=maxH,
        m_order=np.asarray(m_order), m_slots=m_slots,
        nt_order=np.asarray(nt_order),
        nf_order=np.asarray(nf_order),
        p2m_coef=p2m_coef, extend_L=extend_L,
        m2l_idx=m2l_idx, m2l_coef=m2l_coef,
        m2m_idx=m2m_idx, m2m_coef=m2m_coef,
        l2l_idx=l2l_idx, l2l_coef=l2l_coef,
        l2p_D=l2p_D, l2p_mult=l2p_mult,
        m2p_idx=m2p_idx, m2p_coef=m2p_coef,
        numcoef=numcoef,
        m2l_W=m2l_W, m2m_W=m2m_W, l2l_W=l2l_W, m2p_W=m2p_W,
    )
