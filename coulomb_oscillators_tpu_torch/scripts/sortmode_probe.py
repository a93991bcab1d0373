"""The tree builders side by side: the native kd sort on the host, the
exact kd sort on the device and the device Morton sort.

Twin of ``scripts/sortmode_probe.py``.  For each builder it builds the
engine twice on the production beam (the first build warms up), and
records the second build's seconds, its pair counts (the tree's quality:
``eng.last_counts``), its parts (``eng.last_build_times``) and the force's
mean relative error against the Kahan oracle on the seeded targets.  Each
row also has the leaves' shape (:func:`leaf_shape`), which sets how close
an accepted far-field pair comes to the MAC's worst case.

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.sortmode_probe
      [n] [p] [r] [--out FILE] [--device cpu]
The rows go on lines of their own, then one ``@@`` JSON line with the rows
and the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.scripts import _common as C

MODES = ("kd_native", "kd_device", "morton")


def leaf_shape(eng, fs, pos: torch.Tensor) -> dict:
    """The shape of the built leaves: `aspect`, the median over leaves of
    the longest side of the leaf's box over its shortest, and `rho_p1`, the
    mean over leaves of (rho / lam)^(p+1), where rho is the farthest
    particle from the leaf's expansion centre and lam its half-diagonal,
    the length the MAC accepts a pair by.  A truncated expansion's error at
    a given distance grows as rho^(p+1), so `rho_p1` is the error of the
    accepted pairs relative to those of leaves whose particles all lie
    within lam of the centre."""
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (_heap_off,
                                                              _segments)
    L = eng.L
    seg = _segments(eng.n, L, pos.device)[L][0]
    ps = pos[fs.perm.long()]
    G, dim = 1 << L, ps.shape[1]
    idx = seg[:, None].expand(-1, dim)
    mn = ps.new_empty(G, dim).scatter_reduce_(0, idx, ps, "amin",
                                              include_self=False)
    mx = ps.new_empty(G, dim).scatter_reduce_(0, idx, ps, "amax",
                                              include_self=False)
    side = mx - mn
    aspect = side.amax(dim=1) / side.amin(dim=1).clamp(min=1e-30)
    center = fs.center[_heap_off(L):][:G]
    lam = fs.lam[_heap_off(L):][:G]
    d = torch.linalg.vector_norm(ps - center[seg], dim=1)
    rho = ps.new_zeros(G).scatter_reduce_(0, seg, d, "amax",
                                          include_self=False)
    return {"aspect": float(torch.quantile(aspect.double(), 0.5)),
            "rho_p1": float(((rho / lam) ** (eng.p + 1)).mean())}


def probe(n: int, p: int, r: float, device, modes=MODES, pos=None) -> list:
    """One row a builder of `modes`: {"mode", "build_s", "counts",
    "build_times", "err", "aspect", "rho_p1"}.  `pos` (a host float32
    array) replaces the production beam."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine
    from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err

    cfg = SimConfig(fmm_order=p, tree_radius=r)
    if pos is None:
        pos, _ = C.beam(n, cfg)
    pos = torch.from_numpy(np.ascontiguousarray(pos)).to(device)
    sub = torch.from_numpy(C.oracle_targets(n)).to(device)
    ref = D.direct_kahan_targets(pos[sub], pos, cfg.eps2, cfg.kappa(n))
    rows = []
    for mode in modes:
        eng = KdFmmEngine(cfg, n, sort_mode=mode)
        eng.build(pos)                   # warm-up: caches, library builds
        C.sync(device)
        t0 = time.perf_counter()
        fs = eng.build(pos)
        C.sync(device)
        row = {"mode": mode, "build_s": time.perf_counter() - t0,
               "counts": dict(eng.last_counts),
               "build_times": dict(eng.last_build_times)}
        acc = eng.force(pos, fs)
        row["err"] = float(mean_rel_err(acc[sub], ref))
        row.update(leaf_shape(eng, fs, pos))
        rows.append(row)
        print("  " + json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("p", nargs="?", type=int, default=3)
    ap.add_argument("r", nargs="?", type=float, default=1.7)
    ap.add_argument("--out", default=None,
                    help="write the rows to this JSON file")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = C.pick_device(args.device)
    rows = probe(args.n, args.p, args.r, device)
    out = {"config": {"n": args.n, "p": args.p, "r": args.r},
           "device": C.device_info(device), "rows": rows}
    C.emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
