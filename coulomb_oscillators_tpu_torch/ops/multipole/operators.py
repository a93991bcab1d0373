"""Batched FMM operators on tensors.

Twin of ``coulomb_oscillators_tpu/ops/multipole/operators.py``: every
operator of the reference, each taking the reference's arguments in its
layout and returning the same values.  Where the reference takes or returns
a list of monomial columns (``eval_monomial_cols``, ``p2m_from_cols``,
``l2p_field_cols``), the port stacks them on the last axis.

The reference writes its sparse forms (p <= SPARSE_P_MAX) as one traced
multiply-add per table term, which XLA fuses.  Run eagerly that would be
thousands of kernel launches per call, so here every sparse contraction
``out[b, i] = sum_t coef_t * A[b, j_t] * B[b, h_t]`` is two gathers and one
matmul against a [T, S_out] coefficient matrix: the same terms, summed in
another order.  Above SPARSE_P_MAX the dense W-matrix forms are ported as
they are.

Every matmul here must run in full float32.  PyTorch's defaults do so on
CUDA (``torch.backends.cuda.matmul.allow_tf32`` False, float32 matmul
precision "highest"); TF32 would floor the far field near 1e-3, as the
TPU's bf16 passes did before the reference pinned Precision.HIGHEST.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.ops.multipole import harmonics as hm
from coulomb_oscillators_tpu_torch.ops.multipole import packing as pk
from coulomb_oscillators_tpu_torch.ops.multipole.tables import FmmTables

# Above this order the reference switches to the dense W-matrix forms.
SPARSE_P_MAX = 6


@functools.lru_cache(maxsize=None)
def _const(t: FmmTables, name: str, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A float table of `t`, cached on the device."""
    return torch.as_tensor(getattr(t, name), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _ix(t: FmmTables, name: str, device: torch.device) -> torch.Tensor:
    """A per-slot order table of `t` (or the harmonics' "ord_h") as an
    index tensor cached on the device."""
    a = (pk.sym_layout(t.maxH, t.dim)[1] if name == "ord_h"
         else getattr(t, name))
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


# the index and coefficient tables of each sparse operator
_TABLES = {"m2l": ("m2l_idx", "m2l_coef"), "m2l_neg": ("m2l_idx", "m2l_coef"),
           "m2m": ("m2m_idx", "m2m_coef"), "l2l": ("l2l_idx", "l2l_coef")}


@functools.lru_cache(maxsize=None)
def term_list(t: FmmTables, which: str):
    """The terms of a sparse operator table as numpy arrays (i [T], j [T],
    h [T], c [T]): out[i] += c * A[j] * B[h].  The (i, j) order and the
    skipped zero coefficients are the reference's term lists
    (``_m2l_terms``, ``_m2m_terms``, ``_l2l_terms``): row-major nonzeros,
    so grouped by i in ascending order."""
    idx, coef = (getattr(t, name) for name in _TABLES[which])
    ii, jj = np.nonzero(coef)
    c = coef[ii, jj]
    if which == "m2l_neg":
        # the opposite direction: H_k(-Rhat) = (-1)^k H_k(Rhat), k = n + m
        c = c * (-1.0) ** (np.asarray(t.nt_order)[ii]
                           + np.asarray(t.m_order)[jj])
    return ii, jj, idx[ii, jj].astype(np.int64), c


@functools.lru_cache(maxsize=None)
def _terms(t: FmmTables, which: str, dtype: torch.dtype,
           device: torch.device):
    """:func:`term_list` as tensors on the device: (j [T], h [T], coef
    matrix [T, S_out]) with coef[t, i_t] = c_t."""
    ii, jj, hh, c = term_list(t, which)
    S = np.zeros((ii.size, getattr(t, _TABLES[which][1]).shape[0]))
    S[np.arange(ii.size), ii] = c
    return (torch.as_tensor(jj, device=device),
            torch.as_tensor(hh, device=device),
            torch.as_tensor(S, dtype=dtype, device=device))


def _contract(t: FmmTables, which: str, A: torch.Tensor,
              B: torch.Tensor) -> torch.Tensor:
    """out[b, i] = sum over the table's terms (i, j, h, c) of
    c * A[b, j] * B[b, h]."""
    j, h, S = _terms(t, which, A.dtype, A.device)
    return (A.index_select(1, j) * B.index_select(1, h)) @ S


def eval_monomial_cols(u: torch.Tensor, max_order: int,
                       dim: int) -> torch.Tensor:
    """Monomials of u [..., dim] over the sym layout, stacked on the last
    axis: [..., S].  The reference returns the same columns as a list."""
    return hm.eval_monomials(u, max_order, dim)


def _pows(x: torch.Tensor, orders: torch.Tensor, max_order: int,
          dense: bool):
    """x[:, None] ** orders (orders <= max_order): by repeated
    multiplication on the sparse branch, by ``**`` on the dense one (each
    branch's rounding in the reference)."""
    if dense:
        return x[:, None] ** orders.to(x.dtype)[None, :]
    return hm.pow_stack(x, max_order).index_select(1, orders)


def m2l_sparse(t: FmmTables, M: torch.Tensor, H: torch.Tensor,
               v: torch.Tensor, u: torch.Tensor,
               sign: int = 1) -> torch.Tensor:
    """Directed M2L core: source multipoles M [B, S_M], harmonics H
    [B, S_H] at Rhat (R = x_tgt - x_src), v = lam_src/r, u = lam_tgt/r.
    Returns L [B, S_Lt] before the 1/r^eta factor and the 2D monopole
    log-correction.  sign=-1 evaluates the opposite direction through the
    parity H_k(-Rhat) = (-1)^k H_k(Rhat)."""
    dense = t.p > SPARSE_P_MAX
    m_ord = _ix(t, "m_order", M.device)
    n_ord = _ix(t, "nt_order", M.device)
    Mv = M * _pows(v, m_ord, t.PM, dense)
    if dense:
        W = _const(t, "m2l_W", M.dtype, M.device).reshape(t.S_H, -1)
        K = (H @ W).reshape(-1, t.S_Lt, t.S_M)
        if sign == -1:
            par = (-1.0) ** (n_ord[:, None] + m_ord[None, :]).to(M.dtype)
            K = K * par[None]
        L = torch.sum(K * Mv[:, None, :], dim=2)
    else:
        L = _contract(t, "m2l" if sign == 1 else "m2l_neg", Mv, H)
    return L * _pows(u, n_ord, t.PL, dense)


def _r_hat(R: torch.Tensor):
    r = torch.linalg.vector_norm(R, dim=-1)
    return r, R / r[:, None]


def _log_corr(t: FmmTables, L: torch.Tensor, M: torch.Tensor,
              r: torch.Tensor) -> torch.Tensor:
    """1/r in 3D; in 2D the kernel is -log r, and the order-0 harmonic
    H_0 = 1 stands in for G_0: correct the monopole -> L_0 term."""
    if t.dim == 3:
        return L / r[:, None]
    return torch.cat([L[:, :1] + (M[:, 0] * (-torch.log(r) - 1.0))[:, None],
                      L[:, 1:]], 1)


def m2l(t: FmmTables, M: torch.Tensor, R: torch.Tensor,
        lam_src: torch.Tensor, lam_tgt: torch.Tensor) -> torch.Tensor:
    """Multipoles -> traceless locals for a batch of interacting pairs.
    R = x_tgt - x_src (unnormalized); returns [B, S_Lt] contributions."""
    r, Rh = _r_hat(R)
    H = hm.eval_H(Rh, t.maxH, t.dim)
    return _log_corr(t, m2l_sparse(t, M, H, lam_src / r, lam_tgt / r), M, r)


def m2l_both(t: FmmTables, M1: torch.Tensor, M2: torch.Tensor,
             R: torch.Tensor, lam1: torch.Tensor, lam2: torch.Tensor):
    """Both directions of an unordered M2L pair from one harmonic
    evaluation: R = x_1 - x_2; returns (L1 from M2, L2 from M1)."""
    r, Rh = _r_hat(R)
    H = hm.eval_H(Rh, t.maxH, t.dim)
    v1, v2 = lam1 / r, lam2 / r
    L1 = m2l_sparse(t, M2, H, v2, v1, sign=1)
    L2 = m2l_sparse(t, M1, H, v1, v2, sign=-1)
    return _log_corr(t, L1, M2, r), _log_corr(t, L2, M1, r)


def m2l_fold_geo(t: FmmTables, R, lam_tgt: torch.Tensor,
                 lam_src: torch.Tensor):
    """Per-entry M2L geometry (H2, w, logc) with
      H2[b, h] = H_h(Rhat) * u^ord(h) / r^eta   (u = lam_tgt/r)
      w[b]     = v/u                            (v = lam_src/r)
      logc[b]  = -log r - 1 (2D monopole correction; zeros in 3D).
    `R` is [B, dim] or a tuple of dim [B] components."""
    if not isinstance(R, (tuple, list)):
        R = tuple(R[:, d] for d in range(t.dim))
    r2 = R[0] * R[0]
    for rd in R[1:]:
        r2 = r2 + rd * rd
    r = torch.sqrt(r2)
    H = hm.eval_H(tuple(rd / r for rd in R), t.maxH, t.dim)
    u = lam_tgt / r
    v = lam_src / r
    ord_h = _ix(t, "ord_h", u.device)
    H2 = H * hm.pow_stack(u, t.maxH).index_select(1, ord_h)
    if t.dim == 3:
        H2 = H2 / r[:, None]
        logc = torch.zeros_like(r)
    else:
        logc = -torch.log(r) - 1.0
    return H2, v / u, logc


def m2l_sparse_pre(t: FmmTables, M: torch.Tensor, H2: torch.Tensor,
                   w: torch.Tensor, logc: torch.Tensor) -> torch.Tensor:
    """M2L against folded geometry (see :func:`m2l_fold_geo`):
    [B, S_M] x [B, S_H] x [B] -> [B, S_Lt]."""
    m_ord = _ix(t, "m_order", M.device)
    if t.p > SPARSE_P_MAX:
        W = _const(t, "m2l_W", M.dtype, M.device).reshape(t.S_H, -1)
        K = (H2 @ W).reshape(-1, t.S_Lt, t.S_M)
        Mv = M * w[:, None] ** m_ord.to(M.dtype)[None, :]
        L = torch.sum(K * Mv[:, None, :], dim=2)
    else:
        Mv = M * hm.pow_stack(w, t.PM).index_select(1, m_ord)
        L = _contract(t, "m2l", Mv, H2)
    if t.dim == 2:
        L = torch.cat([L[:, :1] + (M[:, 0] * logc)[:, None], L[:, 1:]], 1)
    return L


def m2m(t: FmmTables, M: torch.Tensor, s: torch.Tensor,
        rho: torch.Tensor) -> torch.Tensor:
    """Shift multipoles to a new center: [B,S_M],[B,dim],[B] -> [B,S_M].
    s = (x_child - x_parent)/lam_parent ; rho = lam_child/lam_parent."""
    m_ord = _ix(t, "m_order", M.device)
    Vs = hm.eval_monomials(-s, t.PM, t.dim)               # full layout
    if t.p > SPARSE_P_MAX:
        W = _const(t, "m2m_W", M.dtype, M.device).reshape(t.S_Mfull, -1)
        K = (Vs @ W).reshape(-1, t.S_M, t.S_M)
        Mpre = M * rho[:, None] ** m_ord.to(M.dtype)[None, :]
        return torch.sum(K * Mpre[:, None, :], dim=2)
    Mv = M * hm.pow_stack(rho, t.PM).index_select(1, m_ord)
    return _contract(t, "m2m", Mv, Vs)


def expand_L(t: FmmTables, Lt: torch.Tensor) -> torch.Tensor:
    """Traceless-stored locals -> full symmetric layout [B, S_Lf]
    (the detrace recurrence, fmm_cart_base3.cuh:234-241)."""
    return Lt @ _const(t, "extend_L", Lt.dtype, Lt.device).T


@functools.lru_cache(maxsize=None)
def _l2p_terms(dim: int, p: int):
    """Static term list of the L2P field: per axis a, tuples (j, k, coef)
    with F_a = -(1/lam) sum coef * Lf[:, j] * V[:, k], where
    coef = mult(j) * j_a and k = slot(j - e_a)."""
    symL, _, symL_idx = pk.sym_layout(p, dim)
    out = []
    for a in range(dim):
        row = []
        for j, dl in enumerate(symL):
            if dl[a] == 0:
                continue
            tgt = list(dl)
            tgt[a] -= 1
            row.append((j, symL_idx[tuple(tgt)],
                        float(pk.multinomial(dl) * dl[a])))
        out.append(tuple(row))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _l2p_matrix(t: FmmTables, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """[S_Lf, dim*S_Lf] with D[j, a*S_Lf + k] = the coefficient of
    Lf[j]*V[k] in the field's axis a (the terms of :func:`_l2p_terms`)."""
    D = np.zeros((t.S_Lf, t.dim, t.S_Lf))
    for a, row in enumerate(_l2p_terms(t.dim, t.PL)):
        for (j, k, c) in row:
            D[j, a, k] = c
    return torch.as_tensor(D.reshape(t.S_Lf, -1), dtype=dtype, device=device)


def l2p_field_cols(t: FmmTables, Lf: torch.Tensor, Vcols: torch.Tensor,
                   lam: torch.Tensor) -> torch.Tensor:
    """Leaf-blocked L2P from monomial columns: Lf [G, S_Lf] expanded
    locals, Vcols = eval_monomial_cols of w [G, C, dim] (order PL), lam
    [G] -> F [G, C, dim].  The derivative table folds into the per-leaf
    locals first, then one batched product against the columns."""
    G = Lf.shape[0]
    W = (Lf @ _l2p_matrix(t, Lf.dtype, Lf.device)).reshape(G, t.dim, t.S_Lf)
    return -torch.bmm(Vcols, W.transpose(1, 2)) / lam[:, None, None]


def p2m_from_cols(t: FmmTables, Vcols: torch.Tensor,
                  mask3: torch.Tensor) -> torch.Tensor:
    """Leaf multipoles from the monomial columns of the normalized offsets
    (any sym layout of order >= PM), masked by mask3 [G, C]: [G, S_M]."""
    slots = _ix(t, "m_slots", Vcols.device)
    V = torch.where(mask3[..., None], Vcols.index_select(-1, slots), 0.0)
    return V.sum(dim=1) * _const(t, "p2m_coef", Vcols.dtype, Vcols.device)


def eval_monomials_M(t: FmmTables, e: torch.Tensor) -> torch.Tensor:
    """Monomials over the multipole layout: [B, S_M] (no_dipole layouts
    gather their kept slots from the full evaluation)."""
    V = hm.eval_monomials(e, t.PM, t.dim)
    if t.no_dipole:
        V = V.index_select(-1, _ix(t, "m_slots", V.device))
    return V


def eval_monomials_L(t: FmmTables, e: torch.Tensor) -> torch.Tensor:
    """Monomials over the local layout (orders 0..PL): [B, S_Lf]."""
    return hm.eval_monomials(e, t.PL, t.dim)


def p2m_contrib(t: FmmTables, e: torch.Tensor, q=None) -> torch.Tensor:
    """Per-particle multipole contributions [B, S_M] of normalized offsets
    e = (x_j - x_c)/lam_c with optional weights q [B]; the per-cell sum is
    the caller's."""
    out = eval_monomials_M(t, e) * _const(t, "p2m_coef", e.dtype, e.device)
    return out if q is None else out * q[:, None]


def l2p_field(t: FmmTables, Lt: torch.Tensor, w: torch.Tensor,
              lam: torch.Tensor) -> torch.Tensor:
    """Field -grad(Phi) at particles: [B,S_Lt],[B,dim],[B] -> [B,dim];
    w = (x - x_cell)/lam normalized offsets."""
    Lf = expand_L(t, Lt)
    V = eval_monomials_L(t, w)                               # [B, S_Lf]
    D = _const(t, "l2p_D", Lf.dtype, Lf.device)              # [dim, S, S]
    U = torch.einsum("bk,akj->baj", V, D)
    return -torch.einsum("bj,baj->ba", Lf, U) / lam[:, None]


def l2p_field_blocked(t: FmmTables, Lt: torch.Tensor, w: torch.Tensor,
                      lam: torch.Tensor) -> torch.Tensor:
    """Leaf-blocked L2P: Lt [G, S_Lt], w [G, C, dim], lam [G] ->
    [G, C, dim]; the derivative tables fold into the per-leaf locals
    before the contraction against the particle monomials."""
    G, C, dim = w.shape
    Lf = expand_L(t, Lt)
    V = hm.eval_monomials(w.reshape(G * C, dim), t.PL, t.dim).reshape(
        G, C, -1)
    D = _const(t, "l2p_D", Lf.dtype, Lf.device)
    W = torch.einsum("akj,gj->gak", D, Lf)                   # [G, dim, S]
    return -torch.einsum("gck,gak->gca", V, W) / lam[:, None, None]


def l2p_potential(t: FmmTables, Lt: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Phi at particles from the local expansion: [B]."""
    Lf = expand_L(t, Lt)
    mult = _const(t, "l2p_mult", Lf.dtype, Lf.device)
    return torch.sum(Lf * mult[None] * eval_monomials_L(t, w), dim=-1)


def _m2p_core(t: FmmTables, M: torch.Tensor, R: torch.Tensor,
              lam_src: torch.Tensor):
    r, Rh = _r_hat(R)
    H = hm.eval_H(Rh, t.maxH, t.dim)
    m_ord = _ix(t, "m_order", M.device).to(M.dtype)
    return r, H, M * (lam_src / r)[:, None] ** m_ord[None, :]


def m2p_field(t: FmmTables, M: torch.Tensor, R: torch.Tensor,
              lam_src: torch.Tensor) -> torch.Tensor:
    """Far field of a cell's multipoles at points R = x - x_src: [B,dim]."""
    r, H, Mv = _m2p_core(t, M, R, lam_src)
    W = _const(t, "m2p_W", M.dtype, M.device).reshape(t.S_H, -1)
    K = (H @ W).reshape(-1, t.dim, t.S_M)
    F = -torch.sum(K * Mv[:, None, :], dim=2)
    eta = 1 if t.dim == 3 else 0
    return F / r[:, None] ** (eta + 1)


def m2p_potential(t: FmmTables, M: torch.Tensor, R: torch.Tensor,
                  lam_src: torch.Tensor) -> torch.Tensor:
    """Far potential of a cell's multipoles at points R = x - x_src: [B]
    (H slots of the multipole layout: layouts nest, m_slots skips dropped
    dipole slots)."""
    r, H, Mv = _m2p_core(t, M, R, lam_src)
    Mv = Mv * _const(t, "m2p_coef", M.dtype, M.device)[None]
    pot = torch.sum(Mv * H.index_select(1, _ix(t, "m_slots", M.device)),
                    dim=-1)
    if t.dim == 3:
        return pot / r
    return pot + M[:, 0] * (-torch.log(r) - 1.0)


def l2l(t: FmmTables, Lt_parent: torch.Tensor, s: torch.Tensor,
        rho: torch.Tensor) -> torch.Tensor:
    """Recenter locals from parent to child: [B,S_Lt],[B,dim],[B] ->
    [B,S_Lt].  s = (x_child - x_parent)/lam_parent ;
    rho = lam_child/lam_parent."""
    Lf = expand_L(t, Lt_parent)
    nt_ord = _ix(t, "nt_order", Lf.device)
    Vs = hm.eval_monomials(s, t.PL, t.dim)
    if t.p > SPARSE_P_MAX:
        W = _const(t, "l2l_W", Lf.dtype, Lf.device).reshape(t.S_Lf, -1)
        K = (Vs @ W).reshape(-1, t.S_Lt, t.S_Lf)
        out = torch.sum(K * Lf[:, None, :], dim=2)
        return out * rho[:, None] ** nt_ord.to(Lf.dtype)[None, :]
    out = _contract(t, "l2l", Lf, Vs)
    return out * hm.pow_stack(rho, t.PL).index_select(1, nt_ord)
