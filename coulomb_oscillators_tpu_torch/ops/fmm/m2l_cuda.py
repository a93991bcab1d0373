"""The kd engine's M2L stage on a card: the Hopper kernel's wrapper, the
code of its tables, and its launch counter.

Replaces no TPU kernel: the reference's M2L is jnp that XLA fuses.  The
kernel (``csrc/m2l.cu``) does what ``KdFmmEngine.m2l_plain`` does, in one
pass over the directed entry list: fold each entry's geometry (fly mode)
or read the stored fold, gather the source multipole, contract against the
operator's sparse term table, sum each run of same-target entries and add
it into the local heap.  ``m2l_plain`` is the kernel's plain version (the
CPU path and the card tests' oracle); there is no fallback between them.
The kernel's tables are code: :func:`source` writes a (dim, p) layout's
tables as straight-line CUDA in front of ``csrc/m2l.cu``, and
:func:`library_for` builds that with ``nvcc`` for ``sm_90a`` at first use,
one library a layout, scalar type and mode, bound through ctypes.

Contract: ``mpole`` [Mheap, S_M] float32 or float64; the list ``tgt``,
``src`` [K] int32 (pad entries: target Mheap), ``valid`` [K] bool and, for
a grouped layout of g > 1, ``gtgt`` [K / g] int32 (each group's target);
fly mode ``center`` [Mheap, dim] and ``lam`` [Mheap], stored mode ``h2``
[K, S_H], ``w`` [K], ``logc`` [K], in the dtype of ``mpole``; every tensor
contiguous on one CUDA device.  Returns the local heap [Mheap, S_Lt]: for
every valid entry (t, s), the M2L of source s's multipoles at target t,
summed over the entries of t (``ops/multipole/operators.py``
``m2l_fold_geo`` and ``m2l_sparse_pre``).  The sparse forms alone (p <=
``SPARSE_P_MAX``): the engine keeps the dense W-matrix forms on the plain
path.  The kernel adds with float atomics, so the sum's order varies from
run to run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import sys
import threading

import numpy as np
import torch

from coulomb_oscillators_tpu_torch import native
from coulomb_oscillators_tpu_torch.ops.multipole import harmonics as hm
from coulomb_oscillators_tpu_torch.ops.multipole import operators as mop
from coulomb_oscillators_tpu_torch.ops.multipole import packing as pk
from coulomb_oscillators_tpu_torch.ops.multipole.tables import FmmTables
from coulomb_oscillators_tpu_torch.utils import graphs

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "m2l.cu")

# kernel launches made through :func:`m2l`; counted nowhere else (a CUDA
# graph's replay adds what its captured step launched, utils/graphs.py)
launches = 0
graphs.register_counter(sys.modules[__name__], "launches")

# the kernel's scalar type for each tensor dtype it takes
_CTYPE = {torch.float32: "float", torch.float64: "double"}


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.co_m2l_launch.argtypes = [vp] * 10 + [ci] * 3 + [vp] * 2
    lib.co_m2l_launch.restype = ci


@functools.lru_cache(maxsize=None)
def kernel_tables(t: FmmTables) -> dict:
    """The tables of `t` that :func:`source` writes into the kernel, as
    numpy arrays: the M2L terms (``term_i``, ``term_j``, ``term_h``,
    ``term_c``: the plain version's ``operators.term_list(t, "m2l")``),
    NUM's nonzeros by harmonic slot (``num_h``, ``num_k``, ``num_c``: those
    of ``harmonics.numerator_matrix``), the monomials' exponents ``exps``
    [S_H, dim] (``packing.monomial_exponents``), each harmonic's order
    ``h_ord`` and each multipole slot's ``m_ord``."""
    if t.p > mop.SPARSE_P_MAX:
        raise ValueError(f"the kernel takes the sparse forms (p <= "
                         f"{mop.SPARSE_P_MAX}), got p = {t.p}")
    ii, jj, hh, cc = mop.term_list(t, "m2l")
    num = hm.numerator_matrix(t.maxH, t.dim)
    kz, hz = np.nonzero(num)
    by_h = np.lexsort((kz, hz))
    h_ord = pk.sym_layout(t.maxH, t.dim)[1]
    if (h_ord[kz] != h_ord[hz]).any():
        raise ValueError("NUM is not homogeneous: the kernel's harmonics "
                         "read each order's monomials alone")
    return dict(term_i=ii, term_j=jj, term_h=hh, term_c=cc,
                num_h=hz[by_h], num_k=kz[by_h], num_c=num[kz, hz][by_h],
                exps=pk.monomial_exponents(t.maxH, t.dim),
                h_ord=h_ord,
                m_ord=np.asarray(t.m_order))


def source(t: FmmTables) -> str:
    """The tables of `t` as the straight-line CUDA code ``csrc/m2l.cu``
    expects in front of it: the ``M2L_*`` sizes; ``m2l_harmonics`` (H[h] =
    sum of NUM's nonzeros of column h times the monomials, one order at a
    time, times ``up[ord(h)]``; each monomial the product of its per-axis
    powers ``pw[axis][exponent]`` in axis order, exponents 0 left out);
    ``m2l_scale`` (Mv[j] *= wp[m_ord(j)]); and ``m2l_contract`` (for each
    output i, the FMAs of its terms in the table's order, then
    ``emit(i, sum)``).  Every coefficient is written with the float64
    value's shortest repr and converted to the kernel's type."""
    k = kernel_tables(t)
    out = [f"// generated by coulomb_oscillators_tpu_torch/ops/fmm/"
           f"m2l_cuda.py: the M2L tables of dim {t.dim}, p = {t.p}"
           f"{', no dipole' if t.no_dipole else ''}",
           "#include <cuda_runtime.h>", "",
           f"#define M2L_DIM {t.dim}", f"#define M2L_SM {t.S_M}",
           f"#define M2L_SH {t.S_H}", f"#define M2L_SLT {t.S_Lt}",
           f"#define M2L_MAXH {t.maxH}", f"#define M2L_PM {t.PM}",
           "", "template <typename T>",
           "__device__ __forceinline__ void m2l_harmonics(",
           "    const T (&pw)[M2L_DIM][M2L_MAXH + 1],",
           "    const T (&up)[M2L_MAXH + 1], T (&H)[M2L_SH]) {"]
    for n in range(t.maxH + 1):
        slots = np.flatnonzero(k["h_ord"] == n)
        out.append(f"  {{  // order {n}")
        for m in slots:
            f = [f"pw[{a}][{e}]" for a, e in enumerate(k["exps"][m]) if e]
            out.append(f"    const T v{m} = {' * '.join(f) or 'T(1)'};")
        for h in slots:
            sel = k["num_h"] == h
            out.append("    {")
            out.append("      T s = T(0);")
            for m, c in zip(k["num_k"][sel], k["num_c"][sel]):
                out.append(f"      s = fma(T({float(c)!r}), v{m}, s);")
            out.append(f"      H[{h}] = s * up[{n}];")
            out.append("    }")
        out.append("  }")
    out += ["}", "", "template <typename T>",
            "__device__ __forceinline__ void m2l_scale(",
            "    const T (&wp)[M2L_PM + 1], T (&Mv)[M2L_SM]) {"]
    out += [f"  Mv[{j}] = Mv[{j}] * wp[{m}];"
            for j, m in enumerate(k["m_ord"]) if m]
    out += ["}", "", "template <typename T, class E>",
            "__device__ __forceinline__ void m2l_contract(",
            "    const T (&Mv)[M2L_SM], const T (&H)[M2L_SH], E&& emit) {"]
    for i in range(t.S_Lt):
        sel = k["term_i"] == i
        out.append("  {")
        out.append("    T s = T(0);")
        for j, h, c in zip(k["term_j"][sel], k["term_h"][sel],
                           k["term_c"][sel]):
            out.append(f"    s = fma(T({float(c)!r}), Mv[{j}] * H[{h}], s);")
        out.append(f"    emit({i}, s);")
        out.append("  }")
    out += ["}", ""]
    return "\n".join(out)


@functools.lru_cache(maxsize=None)
def library_for(t: FmmTables, dtype: torch.dtype = torch.float32,
                fly: bool = True) -> native.CudaLibrary:
    """The kernel library of `t`'s layout in one scalar type and one mode:
    :func:`source` and the instantiation's two defines (``M2L_T``,
    ``M2L_FLY``) in front of ``csrc/m2l.cu``, written into the build
    directory (``native.BUILD_DIR``) at first use and built there at the
    library's first ``get()``.  Each instantiation builds alone, so a run
    builds only what it launches."""
    with open(SRC) as f:
        text = (source(t) + f"#define M2L_T {_CTYPE[dtype]}\n"
                f"#define M2L_FLY {int(fly)}\n" + '#line 1 "m2l.cu"\n'
                + f.read())
    key = hashlib.sha256(text.encode()).hexdigest()[:12]
    name = (f"co_m2l_d{t.dim}_p{t.p}_{_CTYPE[dtype]}_"
            f"{'fly' if fly else 'stored'}")
    path = os.path.join(native.BUILD_DIR, f"{name}_{key}.cu")
    if not os.path.exists(path):
        os.makedirs(native.BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return native.CudaLibrary(path, name, _bind)


def work(t: FmmTables, fs, fly: bool = True) -> dict:
    """The work of one stage on the state `fs`, counted from its inputs:
    ``entries`` (the valid ones); ``flops``, the kernel's arithmetic for
    each of them: 3 a term (a product and an FMA), one add a local slot for
    the group sum, and the scale of Mv with w's powers; in fly mode also 2
    a nonzero of NUM and 1 a harmonic (its power of u), the monomials'
    products, the powers by repeated multiplication and the fold's ~20
    scalar operations; ``bytes``, every input read once and the output
    written once: the valid entries' target, source and flag, the
    multipole heap, the local heap, and center and lam (fly) or the valid
    entries' H2, w and logc (stored)."""
    k = kernel_tables(t)
    per = (3 * k["term_c"].size + t.S_Lt + int((k["m_ord"] > 0).sum())
           + t.PM)
    if fly:
        mono = sum(max(int((e > 0).sum()) - 1, 0) for e in k["exps"])
        per += (2 * k["num_c"].size + t.S_H + mono + t.dim * t.maxH
                + 2 * (t.maxH + 1) + 4 * t.dim + 6)
    entries = int(fs.m2l_valid.sum())
    item = fs.center.element_size()
    Mheap = fs.center.shape[0]
    nbytes = entries * 9 + item * Mheap * (t.S_M + t.S_Lt) + item * (
        Mheap * (t.dim + 1) if fly else entries * (t.S_H + 2))
    return dict(entries=entries, flops=entries * per, bytes=nbytes)


def _check(t: FmmTables, mpole, tgt, src, valid, gtgt, g, center, lam, h2, w,
           logc) -> None:
    """Raise on what the kernel does not take; the device last, so that a
    CPU tensor's other faults show first."""
    fly = center is not None
    if fly == (h2 is not None):
        raise ValueError("give center and lam (fly mode) or h2, w and logc "
                         "(stored mode)")
    if mpole.dtype not in _CTYPE:
        raise ValueError(f"mpole must be float32 or float64, got "
                         f"{mpole.dtype}")
    if t.p > mop.SPARSE_P_MAX:
        raise ValueError(f"the kernel takes p <= {mop.SPARSE_P_MAX}, got "
                         f"p = {t.p}")
    Mheap, K = mpole.shape[0], tgt.shape[0]
    if g < 1 or K % g:
        raise ValueError(f"K = {K} is not a multiple of g = {g}")
    want = {"mpole": (mpole, mpole.dtype, (Mheap, t.S_M)),
            "tgt": (tgt, torch.int32, (K,)),
            "src": (src, torch.int32, (K,)),
            "valid": (valid, torch.bool, (K,))}
    if g > 1:
        want["gtgt"] = (gtgt, torch.int32, (K // g,))
    if fly:
        want.update(center=(center, mpole.dtype, (Mheap, t.dim)),
                    lam=(lam, mpole.dtype, (Mheap,)))
    else:
        want.update(h2=(h2, mpole.dtype, (K, t.S_H)),
                    w=(w, mpole.dtype, (K,)),
                    logc=(logc, mpole.dtype, (K,)))
    for name, (x, dtype, shape) in want.items():
        if x is None or x.dtype != dtype or tuple(x.shape) != shape:
            got = None if x is None else f"{x.dtype} {list(x.shape)}"
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                             f"{got}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != mpole.device:
            raise ValueError(f"{name} is on {x.device}, mpole on "
                             f"{mpole.device}")
    if mpole.device.type != "cuda":
        raise ValueError(f"the M2L kernel takes CUDA tensors, got "
                         f"{mpole.device}")


def m2l(t: FmmTables, mpole: torch.Tensor, tgt: torch.Tensor,
        src: torch.Tensor, valid: torch.Tensor, gtgt: torch.Tensor, g: int,
        *, center: torch.Tensor = None, lam: torch.Tensor = None,
        h2: torch.Tensor = None, w: torch.Tensor = None,
        logc: torch.Tensor = None) -> torch.Tensor:
    """The local heap [Mheap, S_Lt] of one M2L stage (the module contract),
    by one launch of the kernel on the current stream.  Allocates the
    zeroed output alone; counts the launch."""
    global launches
    _check(t, mpole, tgt, src, valid, gtgt, g, center, lam, h2, w, logc)
    fn = library_for(t, mpole.dtype, center is not None).get().co_m2l_launch
    Mheap, K = mpole.shape[0], tgt.shape[0]
    acc = torch.zeros(Mheap, t.S_Lt, dtype=mpole.dtype, device=mpole.device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    rc = fn(mpole.data_ptr(), ptr(center), ptr(lam), ptr(h2), ptr(w),
            ptr(logc), tgt.data_ptr(), src.data_ptr(), valid.data_ptr(),
            ptr(gtgt) if g > 1 else None, K, g, Mheap, acc.data_ptr(),
            torch.cuda.current_stream(mpole.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"M2L kernel launch failed: cudaError_t {rc}")
    launches += 1
    return acc

