"""What the CPU reaches of the M2L kernel (ops/fmm/m2l_cuda.py; the kernel
itself runs on the card, tests/test_torch_m2l_cuda.py).

The tables the wrapper writes into the kernel (``kernel_tables``),
evaluated by a plain PyTorch loop in the kernel's order of operations,
equal the plain version (``operators.m2l_fold_geo`` and
``m2l_sparse_pre``, which ``KdFmmEngine.m2l_plain`` runs) at p = 3, 4, 6
in dims 2 and 3; the generated code (``source``) holds exactly those
tables; the wrapper's checks raise, before any build or launch, on a CPU,
non-contiguous or wrong-dtype tensor; and a CPU engine's M2L stage is the
plain loop.
"""

import re

import numpy as np
import pytest
import torch

from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.ops.fmm import m2l_cuda
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
from coulomb_oscillators_tpu_torch.ops.multipole import operators as mop
from coulomb_oscillators_tpu_torch.ops.multipole.tables import build_tables

torch.set_num_threads(1)

LAYOUTS = [(d, p) for d in (3, 2) for p in (3, 4, 6)]
IDS = [f"{d}d_p{p}" for d, p in LAYOUTS]


def _kernel_order(t, R, lam_t, lam_s, M):
    """The kernel's arithmetic on the kernel's tables, entry by entry in
    plain PyTorch (float64): the fold (fly mode) and the contraction.
    Returns (H2 [B, S_H], L [B, S_Lt])."""
    k = m2l_cuda.kernel_tables(t)
    r = torch.sqrt(sum(R[:, d] * R[:, d] for d in range(t.dim)))
    u = lam_t / r
    w = (lam_s / r) / u
    pw = []
    for d in range(t.dim):
        cols = [torch.ones_like(r)]
        for _ in range(t.maxH):
            cols.append(cols[-1] * (R[:, d] / r))
        pw.append(torch.stack(cols, 1))
    up = torch.stack([u ** n / (r if t.dim == 3 else 1.0)
                      for n in range(t.maxH + 1)], 1)
    V = torch.ones(R.shape[0], t.S_H, dtype=R.dtype)
    for m, e in enumerate(k["exps"]):
        for a in range(t.dim):
            V[:, m] = V[:, m] * pw[a][:, e[a]]
    H = torch.zeros(R.shape[0], t.S_H, dtype=R.dtype)
    for h, m, c in zip(k["num_h"], k["num_k"], k["num_c"]):
        H[:, h] += c * V[:, m]
    H = H * up[:, k["h_ord"]]
    Mv = M * torch.stack([w ** n for n in k["m_ord"]], 1)
    L = torch.zeros(R.shape[0], t.S_Lt, dtype=R.dtype)
    for i, j, h, c in zip(k["term_i"], k["term_j"], k["term_h"],
                          k["term_c"]):
        L[:, i] += c * Mv[:, j] * H[:, h]
    if t.dim == 2:
        L[:, 0] += M[:, 0] * (-torch.log(r) - 1.0)
    return H, L


@pytest.mark.parametrize("dim,p", LAYOUTS, ids=IDS)
def test_kernel_tables_equal_the_plain_m2l(dim, p):
    t = build_tables(dim, p, no_dipole=True)
    rng = np.random.default_rng(p)
    B = 64
    R = torch.from_numpy(rng.normal(size=(B, dim)) * 2.0 + 3.0)
    lam_t = torch.from_numpy(rng.uniform(0.2, 1.0, B))
    lam_s = torch.from_numpy(rng.uniform(0.2, 1.0, B))
    M = torch.from_numpy(rng.normal(size=(B, t.S_M)))
    H, L = _kernel_order(t, R, lam_t, lam_s, M)
    H2, w, logc = mop.m2l_fold_geo(t, R, lam_t, lam_s)
    ref = mop.m2l_sparse_pre(t, M, H2, w, logc)
    assert float((H - H2).abs().max() / H2.abs().max()) <= 1e-13
    assert float((L - ref).abs().max() / ref.abs().max()) <= 1e-13


@pytest.mark.parametrize("dim,p", LAYOUTS, ids=IDS)
def test_source_holds_the_tables(dim, p):
    """Every term and every nonzero of NUM appears in the generated code,
    in the tables' order, with its coefficient to the last bit."""
    t = build_tables(dim, p, no_dipole=True)
    k = m2l_cuda.kernel_tables(t)
    src = m2l_cuda.source(t)
    assert src == m2l_cuda.source(t)
    for name, v in (("DIM", dim), ("SM", t.S_M), ("SH", t.S_H),
                    ("SLT", t.S_Lt), ("MAXH", t.maxH), ("PM", t.PM)):
        assert f"#define M2L_{name} {v}\n" in src
    harm, rest = src.split("void m2l_scale(")
    scale, contract = rest.split("void m2l_contract(")
    terms, pending = [], []
    for line in contract.splitlines():
        if m := re.search(r"fma\(T\(([^)]*)\), Mv\[(\d+)\] \* H\[(\d+)\]",
                          line):
            pending.append((int(m[2]), int(m[3]), float(m[1])))
        if m := re.search(r"emit\((\d+), s\)", line):
            terms += [(int(m[1]),) + x for x in pending]
            pending = []
    assert terms == list(zip(k["term_i"].tolist(), k["term_j"].tolist(),
                             k["term_h"].tolist(), k["term_c"].tolist()))
    nums = []
    for body, h in re.findall(r"T s = T\(0\);\n(.*?)H\[(\d+)\] = s \* up",
                              harm, re.S):
        nums += [(int(h), int(m), float(c)) for c, m in re.findall(
            r"fma\(T\(([^)]*)\), v(\d+), s\)", body)]
    assert nums == list(zip(k["num_h"].tolist(), k["num_k"].tolist(),
                            k["num_c"].tolist()))
    assert scale.count("* wp[") == int((k["m_ord"] > 0).sum())


def _cpu_state(p=3, n=2048):
    cfg = SimConfig(fmm_order=p, tree_radius=1.2)
    x_std = (0.003, 0.001, 0.01)
    u = tuple(w * x for w, x in zip(cfg.omega0, x_std))
    pos, _ = ID.init_gaussian(n, x_std, u, seed=3)
    eng = KdFmmEngine(cfg, n)
    post = torch.from_numpy(pos)
    fs = eng.build(post)
    return eng, fs, eng._stage_multipoles(eng.pad_array(post, fs, fill=FAR),
                                          fs)


@pytest.mark.parametrize("fault", ["cpu", "non_contiguous", "mpole_dtype",
                                   "list_dtype", "center_dtype", "mode",
                                   "dense_p"])
def test_wrapper_checks_raise(fault):
    eng, fs, mh = _cpu_state()
    t, g = eng.tables, eng.m2l_group
    args = dict(t=t, mpole=mh, tgt=fs.m2l_tgt, src=fs.m2l_src,
                valid=fs.m2l_valid, gtgt=fs.m2l_gtgt, g=g)
    geo = dict(center=fs.center, lam=fs.lam)
    match = {"cpu": "CUDA tensors", "non_contiguous": "contiguous",
             "mpole_dtype": "float32 or float64", "list_dtype": "src must",
             "center_dtype": "center must", "mode": "fly mode",
             "dense_p": "p <= 6"}[fault]
    if fault == "non_contiguous":
        args["mpole"] = mh.t().contiguous().t()
    elif fault == "mpole_dtype":
        args["mpole"] = mh.half()
    elif fault == "list_dtype":
        args["src"] = fs.m2l_src.long()
    elif fault == "center_dtype":
        geo["center"] = fs.center.double()
    elif fault == "mode":
        geo.update(h2=mh, w=fs.lam, logc=fs.lam)
    elif fault == "dense_p":
        args["t"] = build_tables(3, 7, no_dipole=True)
    before = m2l_cuda.launches
    with pytest.raises(ValueError, match=match):
        m2l_cuda.m2l(*args.values(), **geo)
    assert m2l_cuda.launches == before


def test_cpu_stage_is_the_plain_loop():
    """A CPU engine's M2L stage is ``m2l_plain``, bit for bit, and
    launches nothing."""
    eng, fs, mh = _cpu_state()
    before = m2l_cuda.launches
    got = eng._stage_m2l(mh, fs)
    assert m2l_cuda.launches == before
    assert torch.equal(got, eng.m2l_plain(mh, fs))


@pytest.mark.parametrize("fly", [True, False], ids=["fly", "stored"])
def test_work_counts_the_valid_entries(fly):
    """``work`` counts the valid entries, 3 flops a term at least, the
    fold's arithmetic in fly mode alone, and the heaps' bytes."""
    eng, fs, _ = _cpu_state()
    t = eng.tables
    w = m2l_cuda.work(t, fs, fly)
    nv = int(fs.m2l_valid.sum())
    terms = m2l_cuda.kernel_tables(t)["term_c"].size
    assert w["entries"] == nv > 0
    assert w["flops"] >= 3 * terms * nv
    assert (w["flops"] > m2l_cuda.work(t, fs, not fly)["flops"]) == fly
    assert w["bytes"] > 4 * fs.center.shape[0] * (t.S_M + t.S_Lt)
