"""Staleness anatomy of one production reuse window: which frozen part of
the tree makes the window's force error.

Twin of ``scripts/stale_anatomy.py``.  A Simulator at the production
cadence (``geom_refresh`` off, so the frozen state is what the window
reads) is primed to production staleness; then, at every step of one
window, the force is evaluated against selectively fresh state:

  prod : the frozen ``FmmState`` the window's steps read
  geo  : ``KdFmmEngine.geom_refresh`` of the live padded positions: node
         centers and length scales fresh, lists and permutation frozen
  rfsh : ``eng.refresh(ppad, fs)``: fresh exact bounds AND fresh MAC lists
         (host traversal), permutation frozen       [first and last step]
  fresh: ``eng.build(pos)``: a full rebuild          [last step only]

Each is the mean relative error, against the Kahan direct oracle on the
seeded targets, of ``eng.force`` on the current positions.  If geo ~
fresh, the error is the expansion geometry; if rfsh ~ fresh and geo ~
prod, it is the lists; if only fresh is low, the permutation.

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.stale_anatomy
      [n] [p] [r] [boost] [--out FILE] [--device cpu]
  cadence via env CO_TS / CO_RESORT / CO_PIPE (default 16/2/2)
The rows go on lines of their own, then one ``@@`` JSON line: the config,
``geom_refresh_ms``, the window means and the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.scripts import _common as C

PRIME_WINDOWS = 3       # windows run before the measured one


def anatomy(n: int, p: int, r: float, boost: float, ts: int, resort: int,
            pipeline: int, device, min_loop: float = 2.0,
            pos=None, vel=None) -> dict:
    """The probe: returns {"config", "geom_refresh_ms", "ladder" (ts + 1
    rows), "window_mean_prod", "window_mean_geo", "force_evals"}, the last
    the force evaluations it made: init_acc, the Simulator's steps, and
    prod and geo at every row, rfsh twice and fresh once.  `pos`, `vel`
    (host float32 arrays) replace the production beam; `min_loop` is the
    geometry refresh's timing loop in seconds."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models.integrators import FORCE_EVALS
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
    from coulomb_oscillators_tpu_torch.utils.timing import test_time_chained

    # geom_refresh off: "prod" is the FROZEN state the window reads; the
    # sub-leaf boost goes in through the config (the reference sets
    # CO_SUB_BOOST, which the config's value overrides)
    cfg = SimConfig(fmm_order=p, tree_radius=r, tree_steps=ts,
                    tree_resort_every=resort, tree_pipeline=pipeline,
                    geom_refresh=False, mac_sub_boost=boost)
    if pos is None:
        pos, vel = C.beam(n, cfg)
    sub = torch.from_numpy(C.oracle_targets(n)).to(device)
    sim = Simulator(cfg, n, engine="fmm3_kd")
    try:
        eng = sim._fmm
        st = sim.init_acc(particle_state_from_numpy(pos, vel,
                                                    device=device))
        sim.run(st, 2)
        # prime the pipeline to production staleness
        for _ in range(PRIME_WINDOWS):
            sim.advance_padded(ts)
            C.sync(device)

        def err_vs_oracle(fs):
            cur = sim.current_state()
            acc = eng.force(cur.pos, fs)
            ref = D.direct_kahan_targets(cur.pos[sub], cur.pos, cfg.eps2,
                                         cfg.kappa(n))
            return float(mean_rel_err(acc[sub], ref))

        # cost of the device geometry refresh (the production lever)
        fs0 = sim._fstate
        gcost = test_time_chained(
            lambda pp: pp + eng.geom_refresh(pp, fs0).center.sum() * 1e-30,
            sim._padded.pos, min_loop=min_loop)
        print(f"geom_refresh: {gcost * 1e3:.4f} ms/call", flush=True)

        rows = []
        for i in range(ts + 1):
            row = {"step": i, "prod": err_vs_oracle(sim._fstate)}
            row["geo"] = err_vs_oracle(eng.geom_refresh(sim._padded.pos,
                                                        sim._fstate))
            if i in (0, ts):
                t0 = time.perf_counter()
                fs_r = eng.refresh(sim._padded.pos, sim._fstate)
                row["rfsh"] = err_vs_oracle(fs_r)
                row["rfsh_s"] = time.perf_counter() - t0
            if i == ts:
                row["fresh"] = err_vs_oracle(
                    eng.build(sim.current_state().pos))
            rows.append(row)
            print("  " + json.dumps(row), flush=True)
            if i < ts:
                sim.advance_padded(1)
                C.sync(device)
    finally:
        sim.close()
    return {"config": {"n": n, "p": p, "r": r, "boost": boost, "ts": ts,
                       "resort_every": resort, "pipeline": pipeline},
            "geom_refresh_ms": gcost * 1e3, "ladder": rows,
            "window_mean_prod": float(np.mean([x["prod"] for x in rows])),
            "window_mean_geo": float(np.mean([x["geo"] for x in rows])),
            "force_evals": (1 + (2 + (PRIME_WINDOWS + 1) * ts)
                            * FORCE_EVALS[cfg.integrator]
                            + 2 * (ts + 1) + 2 + 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("p", nargs="?", type=int, default=6)
    ap.add_argument("r", nargs="?", type=float, default=1.43)
    ap.add_argument("boost", nargs="?", type=float, default=1.5)
    ap.add_argument("--out", default=None,
                    help="write the result (rows included) to this JSON "
                         "file")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = C.pick_device(args.device)
    out = anatomy(args.n, args.p, args.r, args.boost,
                  int(os.environ.get("CO_TS", "16")),
                  int(os.environ.get("CO_RESORT", "2")),
                  int(os.environ.get("CO_PIPE", "2")), device)
    out["device"] = C.device_info(device)
    C.emit(out, args.out, omit=("ladder",))
    return 0


if __name__ == "__main__":
    sys.exit(main())
