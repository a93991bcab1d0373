"""L2P and L2L by part at the N=1M leaf shapes: G = 8192 leaves of C = 128
particles.

Twin of ``scripts/l2p_micro.py``, on the reference's ``default_rng(0)``
inputs (w [G, C, 3] * 0.3, Lt [G, S_Lt], lam = |N(0,1)| + 0.5, then the
L2L shifts s [G, 3] * 0.1 and rho = 0.7).  Stages, in its order:

  monomials          ``harmonics.eval_monomials`` of the G*C offsets
  expand+W           ``expand_L`` and the derivative-table contraction W
  final einsum       F = -einsum("gck,gak->gca", V, W)
  final batchmatmul  the same as ``torch.matmul(V, W^T)``
  l2p_field_blocked  the whole leaf-blocked L2P
  l2l (G nodes)      one ``l2l`` over G nodes

Held, max |dev| / max |ref| <= 1e-5, a miss raises: the batched product
against the einsum, and ``l2p_field_blocked`` against the einsum over
lam.  Each row carries the bytes of its inputs and its output (each read
or written once) and their floor at the card's HBM rate
(``utils/roofline.py``).

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.l2p_micro [p]
      [--reps R] [--out FILE] [--device cpu]
The rows go on lines of their own, then one ``@@`` JSON line with the rows
and the card.  On the CPU the times are the host's (``host_ms``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.scripts import _common as C

LEAVES, C_LEAF = 8192, 128       # G and C of the reference
TOL = 1e-5


def inputs(S_Lt: int, G: int, c: int) -> dict:
    """The reference's seeded inputs at G leaves of c particles, host
    float32, in its draw order."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(G, c, 3)).astype(np.float32) * 0.3
    Lt = rng.normal(size=(G, S_Lt)).astype(np.float32)
    lam = np.abs(rng.normal(size=(G,)).astype(np.float32)) + 0.5
    s = rng.normal(size=(G, 3)).astype(np.float32) * 0.1
    rho = np.full(G, 0.7, np.float32)
    return {"w": w, "Lt": Lt, "lam": lam, "s": s, "rho": rho}


def stages(t, x: dict) -> dict:
    """Each stage as (nullary function, bytes in, bytes out) on the
    tensors of `x` (one device)."""
    from coulomb_oscillators_tpu_torch.ops.multipole import harmonics as hm
    from coulomb_oscillators_tpu_torch.ops.multipole import operators as mop
    w, Lt, lam, s, rho = (x[k] for k in ("w", "Lt", "lam", "s", "rho"))
    Gn, Cn, dim = w.shape
    D = mop._const(t, "l2p_D", Lt.dtype, Lt.device)      # [dim, S, S]

    def mono():
        return hm.eval_monomials(w.reshape(Gn * Cn, dim), t.PL, dim) \
            .reshape(Gn, Cn, -1)

    def expand_w():
        return torch.einsum("akj,gj->gak", D, mop.expand_L(t, Lt))

    V, W = mono(), expand_w()

    def nb(*a):
        return sum(y.numel() * y.element_size() for y in a)

    nF = Gn * Cn * dim * w.element_size()
    return {
        "monomials": (mono, nb(w), nb(V)),
        "expand+W": (expand_w, nb(Lt), nb(W)),
        "final einsum": (lambda: -torch.einsum("gck,gak->gca", V, W),
                         nb(V, W), nF),
        "final batchmatmul": (lambda: -torch.matmul(V, W.transpose(1, 2)),
                              nb(V, W), nF),
        "l2p_field_blocked": (lambda: mop.l2p_field_blocked(t, Lt, w, lam),
                              nb(Lt, w, lam), nF),
        "l2l (G nodes)": (lambda: mop.l2l(t, Lt, s, rho), nb(Lt, s, rho),
                          nb(Lt)),
    }


def study(p: int, device, reps: int = 5) -> dict:
    """The whole study at order p on LEAVES leaves of C_LEAF particles:
    every stage timed, the two identities held, each row printed.  Returns
    the configuration and the rows; raises after the last row if a trace
    lost its kernels (``_common.check_traces``) or a stage missed TOL."""
    from coulomb_oscillators_tpu_torch.ops.multipole.tables import (
        build_tables)
    from coulomb_oscillators_tpu_torch.utils import roofline
    G, c = LEAVES, C_LEAF
    t = build_tables(3, p)
    print(f"p={p} S_Lt={t.S_Lt} S_Lf={t.S_Lf} PL={t.PL}", flush=True)
    x = {k: torch.from_numpy(v).to(device)
         for k, v in inputs(t.S_Lt, G, c).items()}
    st = stages(t, x)
    times = C.time_variants({k: v[0] for k, v in st.items()}, device, reps)
    ein = st["final einsum"][0]().double()
    checks = {"final batchmatmul": ein,
              "l2p_field_blocked": ein / x["lam"].double()[:, None, None]}
    rows, missed = [], []
    for name, (fn, b_in, b_out) in st.items():
        nbytes = b_in + b_out
        got = fn()
        row = {"name": name, **times[name], "bytes": nbytes,
               "floor_ms": nbytes / roofline.HBM_BYTES * 1e3,
               "finite": bool(torch.isfinite(got).all())}
        if name in checks:
            ref = checks[name]
            row["rel_dev"] = float((got.double() - ref).abs().max()
                                   / ref.abs().max())
        if not (row["finite"] and row.get("rel_dev", 0.0) <= TOL):
            missed.append(f"{name} {row.get('rel_dev')} finite "
                          f"{row['finite']}")
        rows.append(row)
        t_s = (f"{row['event_ms']:9.3f} ms events {row['kernel_ms']:9.3f} "
               f"ms kernels" if "event_ms" in row
               else f"{row['host_ms']:9.3f} ms (host clock)")
        print(f"{name:<17s}: {t_s}  bytes {nbytes / 1e6:8.1f} MB floor "
              f"{row['floor_ms']:7.3f} ms"
              + (f"  max rel dev {row['rel_dev']:.2e}" if "rel_dev" in row
                 else ""), flush=True)
    C.check_traces(times)
    if missed:
        raise RuntimeError(f"L2P stages off their identity by more than "
                           f"{TOL}: {missed}")
    return {"config": {"p": p, "G": G, "C": c, "S_Lt": t.S_Lt,
                       "S_Lf": t.S_Lf, "PL": t.PL, "reps": reps},
            "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("p", nargs="?", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="write the rows to this JSON file")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = C.pick_device(args.device)
    out = dict(study(args.p, device, args.reps),
               device=C.device_info(device))
    C.emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
