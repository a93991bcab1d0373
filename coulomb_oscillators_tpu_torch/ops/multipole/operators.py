"""Batched FMM operators on tensors: the subset the kd engine calls.

Twin of ``coulomb_oscillators_tpu/ops/multipole/operators.py``:
``eval_monomial_cols``, ``m2m``, ``m2l_fold_geo``, ``m2l_sparse_pre``,
``expand_L``, ``_l2p_terms`` and ``l2l``.  Each takes the reference's
arguments in its layout and returns the same values.

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


@functools.lru_cache(maxsize=None)
def _terms(t: FmmTables, which: str, dtype: torch.dtype,
           device: torch.device):
    """Flattened term list of a sparse operator table: (j [T], h [T],
    coef matrix [T, S_out]) with coef[t, i_t] = c_t.  The (i, j) order and
    the skipped zero coefficients are the reference's term lists
    (``_m2l_terms``, ``_m2m_terms``, ``_l2l_terms``)."""
    idx, coef = {"m2l": (t.m2l_idx, t.m2l_coef),
                 "m2m": (t.m2m_idx, t.m2m_coef),
                 "l2l": (t.l2l_idx, t.l2l_coef)}[which]
    ii, jj = np.nonzero(coef)                   # row-major: grouped by i
    S = np.zeros((ii.size, coef.shape[0]))
    S[np.arange(ii.size), ii] = coef[ii, jj]
    return (torch.as_tensor(jj, device=device),
            torch.as_tensor(idx[ii, jj].astype(np.int64), device=device),
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
