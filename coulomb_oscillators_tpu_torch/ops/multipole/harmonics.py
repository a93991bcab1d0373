"""Derivative tensors of the interaction kernel as polynomial tables.

Twin of ``coulomb_oscillators_tpu/ops/multipole/harmonics.py``: the
polynomial generation is the same numpy code; ``eval_monomials`` and
``eval_H`` have torch bodies.

The FMM needs G_k = grad^k phi where phi = 1/r in 3D and -log r in 2D
(reference: gradient3 / gradient_exact3, fmm_cart_base3.cuh:661-766; 2D
gradient, fmm_cart_base.cuh:345-420).  Each packed entry G_k[alpha] is a
homogeneous polynomial NUM_k[alpha] of degree k divided by a power of r:

    3D:  G_k[alpha](R) = NUM_k[alpha](R) * r^-(2k+1)  = H_k[alpha](Rhat) * r^-(k+1)
    2D (k>=1):  G_k[alpha](R) = NUM_k[alpha](R) * r^-2k = H_k[alpha](Rhat) * r^-k

where H evaluates NUM at the unit vector (numerically safe for float32 —
the same rescaling trick the reference uses at fmm_cart_base3.cuh:1194).

The NUM polynomials are generated ONCE per (dim, max_order) by exact
differentiation of the numerator representation:

    d/dx_i [num * r^-k] = [(d num/dx_i) * r^2  -  k * x_i * num] * r^-(k+2)

with integer coefficients (float64 storage).  At runtime, H for a batch of
unit vectors is ONE dense matmul: H = V @ NUMCOEF, where V are the monomials
of Rhat — no recursion, no per-order branching.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.ops.multipole import packing as pk

Poly = Dict[Tuple[int, ...], float]  # monomial exponents -> coefficient


def _poly_dx(poly: Poly, axis: int) -> Poly:
    out: Poly = {}
    for mono, c in poly.items():
        if mono[axis] > 0:
            m2 = list(mono)
            m2[axis] -= 1
            m2 = tuple(m2)
            out[m2] = out.get(m2, 0.0) + c * mono[axis]
    return out


def _poly_mul_r2(poly: Poly, dim: int) -> Poly:
    out: Poly = {}
    for mono, c in poly.items():
        for axis in range(dim):
            m2 = list(mono)
            m2[axis] += 2
            m2 = tuple(m2)
            out[m2] = out.get(m2, 0.0) + c
    return out


def _poly_mul_x(poly: Poly, axis: int) -> Poly:
    out: Poly = {}
    for mono, c in poly.items():
        m2 = list(mono)
        m2[axis] += 1
        out[tuple(m2)] = c
    return out


def _poly_add(a: Poly, b: Poly, cb: float = 1.0) -> Poly:
    out = dict(a)
    for mono, c in b.items():
        out[mono] = out.get(mono, 0.0) + cb * c
    return out


@functools.lru_cache(maxsize=None)
def _derivative_polys(max_order: int, dim: int):
    """NUM polynomials for every packed entry of G_0..G_max_order.

    Returns dict multi-index -> Poly.  The r-power bookkeeping is implicit
    in |alpha| (see module docstring).  In 2D the alpha=() order-0 entry is
    special (-log r); we store NUM=1 for it and let callers special-case.
    """
    polys: Dict[Tuple[int, ...], Poly] = {}
    zero = (0,) * dim
    polys[zero] = {zero: 1.0}
    # r^-k exponent of the stored representation per order
    def kpow(n):
        return 2 * n + 1 if dim == 3 else 2 * n

    for n in range(1, max_order + 1):
        for alpha in pk.sym_entries(n, dim):
            # differentiate from a parent entry alpha - e_axis
            axis = next(a for a in range(dim) if alpha[a] > 0)
            parent = list(alpha)
            parent[axis] -= 1
            parent = tuple(parent)
            num = polys[parent]
            if dim == 2 and n == 1:
                # d/dx_i (-log r) = -x_i * r^-2 ; parent NUM=1 with k=0
                polys[alpha] = {_one_hot(axis, dim): -1.0}
                continue
            k = kpow(n - 1)
            d = _poly_dx(num, axis)
            term1 = _poly_mul_r2(d, dim)
            term2 = _poly_mul_x(num, axis)
            polys[alpha] = _poly_add(term1, term2, cb=-float(k))
    return polys


def _one_hot(axis: int, dim: int) -> Tuple[int, ...]:
    m = [0] * dim
    m[axis] = 1
    return tuple(m)


@functools.lru_cache(maxsize=None)
def numerator_matrix(max_order: int, dim: int) -> np.ndarray:
    """NUMCOEF: [S_mono, S_H] with S_mono = sym_layout(max_order) monomials
    and S_H = sym_layout(max_order) packed G entries (same layout).

    H[:, j] = sum_k V[:, k] * NUMCOEF[k, j] evaluated at unit vectors gives
    H_k[alpha](Rhat).
    """
    entries, _, index_of = pk.sym_layout(max_order, dim)
    polys = _derivative_polys(max_order, dim)
    S = len(entries)
    out = np.zeros((S, S))
    for j, alpha in enumerate(entries):
        for mono, c in polys[alpha].items():
            # homogeneity: NUM of order-n entry has degree n monomials only;
            # evaluated at unit vector all contribute at their own slot.
            out[index_of[mono], j] = c
    return out


def pow_stack(x: torch.Tensor, max_order: int) -> torch.Tensor:
    """[...] -> [..., max_order+1] powers [1, x, x^2, ..] by repeated
    multiplication (the rounding of the reference's ``_pow_cols``)."""
    cols = [torch.ones_like(x)]
    for _ in range(max_order):
        cols.append(cols[-1] * x)
    return torch.stack(cols, dim=-1)


@functools.lru_cache(maxsize=None)
def _exponent_index(max_order: int, dim: int, device: torch.device):
    exps = pk.monomial_exponents(max_order, dim)            # [S, dim]
    return tuple(torch.as_tensor(exps[:, a], device=device)
                 for a in range(dim))


def eval_monomials(u, max_order: int, dim: int) -> torch.Tensor:
    """Monomials of u over the sym_layout: V [..., S].

    `u` is a [..., dim] tensor or a tuple/list of dim [...] components.
    Each slot is the product of per-axis power columns in axis order, as
    in the reference (a zero exponent multiplies by an exact 1)."""
    comps = list(u) if isinstance(u, (tuple, list)) else list(u.unbind(-1))
    idx = _exponent_index(max_order, dim, comps[0].device)
    V = pow_stack(comps[0], max_order).index_select(-1, idx[0])
    for a in range(1, dim):
        V = V * pow_stack(comps[a], max_order).index_select(-1, idx[a])
    return V


@functools.lru_cache(maxsize=None)
def _numerator_tensor(max_order: int, dim: int, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    return torch.as_tensor(numerator_matrix(max_order, dim), dtype=dtype,
                           device=device)


def eval_H(u, max_order: int, dim: int) -> torch.Tensor:
    """H entries for a batch of unit vectors: [..., S_H].  `u` is
    [..., dim] or a tuple of dim components (see eval_monomials).  The
    matmul runs in full float32 (TF32 stays off, see operators)."""
    V = eval_monomials(u, max_order, dim)
    return V @ _numerator_tensor(max_order, dim, V.dtype, V.device)
