"""The kd FMM's force-error floor at N=1M: the metric's tail, and the
near field's float32 accumulation noise.

Twin of ``scripts/err_diag.py``.  It separates:

  * the oracle's own noise: the plain direct sum (``ops.direct.direct``,
    the Hopper direct kernel on the card) against the Kahan oracle;
  * the metric's tail: percentiles of the per-target relative error, the
    error over the larger and the smaller half of |a| (the mean relative
    error amplifies targets whose net force nearly cancels), and the
    L2-norm ratio;
  * the near field's float32 cancellation: the plain near-field pass
    (``KdFmmEngine._stage_p2p``, the Hopper P2P kernel on the card)
    against :func:`p2p_kahan`, a compensated pass over the same lists.

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.err_diag [n] [p] [r]
      [--out FILE] [--device cpu]
The rows go on lines of their own, then one ``@@`` JSON line with every
number and the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.scripts import _common as C

N_TARGETS = 8192        # the reference's oracle targets, default_rng(0)
# partner entries per compensated chunk: one inner chunk of the plain sum
# at C = 32, CB = 128 (ops/fmm/p2p_cuda.py:_PLAIN_PAIRS)
KAHAN_CHUNK = 8192
QUANTILES = (50, 90, 99, 99.9)


def p2p_kahan(eng, ppad: torch.Tensor, fs,
              chunk: int = KAHAN_CHUNK) -> torch.Tensor:
    """The near-field sum of ``eng._stage_p2p`` ([G, C, dim], unscaled)
    over the same pair list, with a Kahan-compensated running sum: the
    plain PyTorch oracle of the P2P kernel's accumulation.  Plain PyTorch
    on any device; never on the Simulator's path.

    Each chunk's contribution is ``p2p_plain_entries`` over a run of the
    list's valid entries, and the chunks add with compensation, as the
    reference's closure does.  The reference's chunks are runs of
    consecutive entries, so a target's partner row mostly falls in one
    chunk and adds plainly; here a chunk holds entries of one rank within
    their rows (the k-th partner of each target), so every partner block
    of a target adds with compensation.  The sum over one block's sources
    stays plain."""
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    pblk = ppad.reshape(eng.G_blk, eng.C_blk, eng.dim).contiguous()
    k = int(fs.p2p_row_ptr[-1])
    tgt = fs.p2p_tgt[:k].long()
    src = fs.p2p_src[:k]
    rank = torch.arange(k, device=tgt.device) - fs.p2p_row_ptr.long()[tgt]
    order = torch.argsort(rank, stable=True)
    counts = torch.bincount(rank).tolist() if k else []
    acc = torch.zeros_like(pblk)
    comp = torch.zeros_like(pblk)
    lo = 0
    for c in counts:
        for i in range(lo, lo + c, chunk):
            idx = order[i:min(i + chunk, lo + c)]
            contrib = p2p_cuda.p2p_plain_entries(pblk, tgt[idx], src[idx],
                                                 eng.nsub, eng.config.eps2)
            y = contrib - comp
            t = acc + y
            comp = (t - acc) - y
            acc = t
        lo += c
    return acc.reshape(eng.G_sub, eng.st.C, eng.dim)


def _dist(e: np.ndarray) -> dict:
    return {"mean": float(e.mean()),
            **{f"p{q:g}": float(np.percentile(e, q)) for q in QUANTILES},
            "max": float(e.max())}


def diag(n: int, p: int, r: float, device, n_targets: int = N_TARGETS,
         pos=None) -> dict:
    """The probe's numbers: {"oracle_noise": {mean, p99}, "force": {mean,
    p50, p90, p99, p99.9, max}, "top_half", "bottom_half", "l2",
    "p2p_noise": {mean, p99, max}, "config"}.  `pos` (a host float32
    array) replaces the production beam."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
    from coulomb_oscillators_tpu_torch.ops.reductions import (rel_diff1,
                                                              rel_err_l2)

    cfg = SimConfig(fmm_order=p, tree_radius=r)
    if pos is None:
        pos, _ = C.beam(n, cfg)
    pos = torch.from_numpy(np.ascontiguousarray(pos)).to(device)
    eng = KdFmmEngine(cfg, n)
    fs = eng.build(pos)
    acc = eng.force(pos, fs)
    sub = torch.from_numpy(np.random.default_rng(0).choice(
        n, min(n_targets, n), replace=False)).to(device)
    ref = D.direct_kahan_targets(pos[sub], pos, cfg.eps2, cfg.kappa(n))
    # the plain float32 direct sum's own noise against the Kahan oracle
    ref_plain = D.direct(pos, cfg.eps2, cfg.kappa(n))
    e_oracle = rel_diff1(ref_plain[sub], ref).cpu().numpy()
    out = {"config": {"n": n, "p": p, "r": r, "targets": int(sub.numel())},
           "oracle_noise": {"mean": float(e_oracle.mean()),
                            "p99": float(np.percentile(e_oracle, 99))}}
    print(f"plain-direct oracle noise: {json.dumps(out['oracle_noise'])}",
          flush=True)
    e = rel_diff1(acc[sub], ref).cpu().numpy()
    order = np.argsort(torch.linalg.vector_norm(ref, dim=1).cpu().numpy())
    out["force"] = _dist(e)
    out["top_half"] = float(e[order[len(order) // 2:]].mean())
    out["bottom_half"] = float(e[order[:len(order) // 2]].mean())
    out["l2"] = float(rel_err_l2(acc[sub], ref))
    print(f"p={p} r={r} n={n}: {json.dumps(out['force'])}", flush=True)
    print(f"  mean err | top-half |a|: {out['top_half']:.3e}   "
          f"bottom-half |a|: {out['bottom_half']:.3e}   "
          f"L2-norm ratio: {out['l2']:.3e}", flush=True)

    # near-field accumulation: the plain pass against the compensated one
    ppad = eng.pad_array(pos, fs, fill=FAR)
    near_plain = eng._stage_p2p(ppad, fs)
    near_kahan = p2p_kahan(eng, ppad, fs)
    mask = eng.mask3(pos.device)
    d = torch.linalg.vector_norm(near_plain - near_kahan, dim=-1)[mask]
    nk = torch.linalg.vector_norm(near_kahan, dim=-1)[mask]
    reln = (d / nk.clamp(min=1e-30)).cpu().numpy()
    out["p2p_noise"] = {"mean": float(reln.mean()),
                        "p99": float(np.percentile(reln, 99)),
                        "max": float(reln.max())}
    print(f"  P2P plain-vs-Kahan: {json.dumps(out['p2p_noise'])}",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("p", nargs="?", type=int, default=5)
    ap.add_argument("r", nargs="?", type=float, default=2.5)
    ap.add_argument("--out", default=None,
                    help="write the result to this JSON file")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = C.pick_device(args.device)
    out = diag(args.n, args.p, args.r, device)
    out["device"] = C.device_info(device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    print("@@ " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
