"""Packed symmetric / traceless tensor index algebra (host-side, numpy).

Numpy copy of ``coulomb_oscillators_tpu/ops/multipole/packing.py``; its
outputs equal the twin's bit for bit.

Layout convention matches the reference's documentation
(fmm_cart_base3.cuh:35-168): a symmetric 3D tensor of order n stores its
(n+1)(n+2)/2 independent entries ordered by z ascending then x descending;
a traceless tensor stores only the 2n+1 entries with z <= 1, the rest being
recovered by A[x,y,z] = -A[x+2,y,z-2] - A[x,y+2,z-2] (:157).  In 2D
(fmm_cart_base.cuh:56-119) order n has n+1 entries (x descending) and the
traceless form keeps the y <= 1 entries with A[x,y] = -A[x+2,y-2].

Everything here runs once per (dim, order) on host and is cached.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import numpy as np

MultiIndex = Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def sym_entries(n: int, dim: int) -> Tuple[MultiIndex, ...]:
    """Multi-indices of the packed symmetric tensor of order n."""
    if dim == 2:
        return tuple((x, n - x) for x in range(n, -1, -1))
    if dim == 3:
        out = []
        for z in range(n + 1):
            for x in range(n - z, -1, -1):
                out.append((x, n - x - z, z))
        return tuple(out)
    raise ValueError(dim)


@functools.lru_cache(maxsize=None)
def trc_entries(n: int, dim: int) -> Tuple[MultiIndex, ...]:
    """Multi-indices of the stored (independent) entries of a traceless tensor."""
    return tuple(e for e in sym_entries(n, dim) if e[-1] <= min(1, n))


def sym_size(n: int, dim: int) -> int:
    return len(sym_entries(n, dim))


def trc_size(n: int, dim: int) -> int:
    return len(trc_entries(n, dim))


@functools.lru_cache(maxsize=None)
def sym_layout(max_order: int, dim: int):
    """Concatenated layout for orders 0..max_order (inclusive).

    Returns (entries, order_of, index_of) where `entries` is the tuple of
    multi-indices, `order_of[j]` the order of slot j, and `index_of` a dict
    multi-index -> slot.
    """
    entries: List[MultiIndex] = []
    order_of: List[int] = []
    for n in range(max_order + 1):
        for e in sym_entries(n, dim):
            entries.append(e)
            order_of.append(n)
    index_of: Dict[MultiIndex, int] = {e: j for j, e in enumerate(entries)}
    return tuple(entries), np.asarray(order_of), index_of


@functools.lru_cache(maxsize=None)
def trc_layout(max_order: int, dim: int):
    entries: List[MultiIndex] = []
    order_of: List[int] = []
    for n in range(max_order + 1):
        for e in trc_entries(n, dim):
            entries.append(e)
            order_of.append(n)
    index_of = {e: j for j, e in enumerate(entries)}
    return tuple(entries), np.asarray(order_of), index_of


def multinomial(alpha: MultiIndex) -> int:
    """|alpha|! / alpha! — number of distinct index permutations."""
    n = sum(alpha)
    out = math.factorial(n)
    for a in alpha:
        out //= math.factorial(a)
    return out


def binom_multi(alpha: MultiIndex, beta: MultiIndex) -> int:
    """Componentwise product of binomials C(alpha_i, beta_i)."""
    out = 1
    for a, b in zip(alpha, beta):
        if b < 0 or b > a:
            return 0
        out *= math.comb(a, b)
    return out


@functools.lru_cache(maxsize=None)
def traceless_extend_matrix(n: int, dim: int) -> np.ndarray:
    """R: [sym_size(n), trc_size(n)] such that full = R @ stored for a
    traceless tensor (recurrence fmm_cart_base3.cuh:157, 2D :330-343)."""
    syms = sym_entries(n, dim)
    trcs = trc_entries(n, dim)
    trc_idx = {e: i for i, e in enumerate(trcs)}
    size_t = len(trcs)

    memo: Dict[MultiIndex, np.ndarray] = {}

    def row(e: MultiIndex) -> np.ndarray:
        if e in memo:
            return memo[e]
        if e[-1] <= min(1, n):
            r = np.zeros(size_t)
            r[trc_idx[e]] = 1.0
        elif dim == 3:
            x, y, z = e
            r = -row((x + 2, y, z - 2)) - row((x, y + 2, z - 2))
        else:
            x, y = e
            r = -row((x + 2, y - 2))
        memo[e] = r
        return r

    return np.stack([row(e) for e in syms], axis=0)


@functools.lru_cache(maxsize=None)
def traceless_extend_layout(max_order: int, dim: int) -> np.ndarray:
    """Block-diagonal extend matrix over concatenated orders 0..max_order."""
    blocks = [traceless_extend_matrix(n, dim) for n in range(max_order + 1)]
    rows = sum(b.shape[0] for b in blocks)
    cols = sum(b.shape[1] for b in blocks)
    out = np.zeros((rows, cols))
    r = c = 0
    for b in blocks:
        out[r:r + b.shape[0], c:c + b.shape[1]] = b
        r += b.shape[0]
        c += b.shape[1]
    return out


@functools.lru_cache(maxsize=None)
def traceless_project_matrix(n: int, dim: int) -> np.ndarray:
    """P: [trc_size(n), sym_size(n)] harmonic projection in packed form.

    Decomposes a symmetric tensor S = R h + (delta o T) (harmonic part plus
    trace part, a direct sum); returns the stored traceless coordinates h.
    Contractions against traceless harmonics (the FMM's M2L) see only h, so
    projecting multipoles is lossless — this is the basis of the reference's
    traceless-multipole variant (fmm_cart3_traceless.cuh).
    """
    syms = sym_entries(n, dim)
    S = len(syms)
    idx = {e: i for i, e in enumerate(syms)}
    R = traceless_extend_matrix(n, dim)            # [S, 2n+1]
    # trace-subspace basis: delta_(ab) o e_k for sym entries of order n-2
    cols = []
    if n >= 2:
        for k in sym_entries(n - 2, dim):
            v = np.zeros(S)
            for a in range(dim):
                e = list(k)
                e[a] += 2
                # packed symmetric convention stores the tensor VALUE at a
                # representative index; (delta o T)[alpha] = sum over ways:
                # value contribution pattern derived from symmetrization:
                # (delta o T)[alpha] = sum_a T[alpha - 2 e_a] * m(alpha, a)
                v[idx[tuple(e)]] += math.comb(e[a], 2)
            cols.append(v)
    if cols:
        T = np.stack(cols, axis=1)                 # [S, S(n-2)]
        A = np.concatenate([R, T], axis=1)         # [S, S] (full rank)
        coeffs = np.linalg.solve(A, np.eye(S))
        return coeffs[: R.shape[1], :]
    return R.T.copy() if R.shape[0] == R.shape[1] else np.linalg.pinv(R)


# sym(delta o T)[alpha] = sum_a [C(alpha_a, 2)/C(n, 2)] T[alpha - 2 e_a]
# (value-at-representative packing); the per-column overall scale is
# irrelevant for the span, the relative weights C(alpha_a, 2) are not.


@functools.lru_cache(maxsize=None)
def traceless_project_layout(max_order: int, dim: int) -> np.ndarray:
    """Block-diagonal projection over concatenated orders 0..max_order."""
    blocks = [traceless_project_matrix(n, dim) for n in range(max_order + 1)]
    rows = sum(b.shape[0] for b in blocks)
    cols = sum(b.shape[1] for b in blocks)
    out = np.zeros((rows, cols))
    r = c = 0
    for b in blocks:
        out[r:r + b.shape[0], c:c + b.shape[1]] = b
        r += b.shape[0]
        c += b.shape[1]
    return out


@functools.lru_cache(maxsize=None)
def monomial_exponents(max_order: int, dim: int) -> np.ndarray:
    """Exponent table [S, dim] for the sym_layout of orders 0..max_order."""
    entries, _, _ = sym_layout(max_order, dim)
    return np.asarray(entries, dtype=np.int64)
