"""Rebuild-cadence probe: tree_steps x tree_resort_every x tree_pipeline
(x geom_refresh x builder) at one kd-FMM configuration.

Twin of ``scripts/cadence_probe.py``.  The knobs it turns:

  * tree_steps (ts): the reuse window's length; a longer window hides more
    of the background rebuild and ends on staler lists;
  * tree_resort_every (K): FULL re-sorts every K boundaries, with refreshes
    (exact bounds and a re-traversal on the current permutation) between;
  * tree_pipeline (D): boundaries between a full job's position snapshot
    and its adoption;
  * geom_refresh: expansion geometry recomputed from the live positions at
    every force evaluation;
  * builder: "host" (the native kd sort in a background thread) or
    "kd_device" (the exact kd sort on the device, host traversal).

For each combo: the median s/step over `--windows` timed windows of
2 * tree_steps steps (each closed by a device synchronize), the boundary
wait of each window, and the force error at the END of the last window
(the lists at their oldest) against the Kahan oracle on the seeded
targets, measured on the force the production loop computes.

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.cadence_probe
      [n] [p] [r] [boost] [--windows 5] [--out FILE] [--device cpu]
  combos: the defaults below, or env
  CO_CADENCE_COMBOS="8,4,2,1,host;16,4,2,0,kd_device"
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from coulomb_oscillators_tpu_torch.scripts import _common as C
from coulomb_oscillators_tpu_torch.scripts import stale_margin_probe as SP

# (tree_steps, resort_every, pipeline, geom_refresh, builder): the
# reference probe's five, then the config defaults
COMBOS = (
    (16, 2, 2, 1, "host"),
    (16, 2, 2, 0, "host"),
    (16, 1, 2, 1, "kd_device"),
    (8, 1, 2, 1, "kd_device"),
    (8, 1, 1, 1, "kd_device"),
    (8, 1, 1, 1, "host"),
)


def parse_combos(text: str) -> tuple:
    """"ts,K,D[,geo[,builder]];..." -> combos (geo 1, builder host when
    left out)."""
    out = []
    for c in text.split(";"):
        v = c.split(",")
        if len(v) < 3:
            raise ValueError(f"combo {c!r}: ts,K,D[,geo[,builder]]")
        out.append((int(v[0]), int(v[1]), int(v[2]),
                    int(v[3]) if len(v) > 3 else 1,
                    v[4] if len(v) > 4 else "host"))
    return tuple(out)


def combos_from_env() -> tuple:
    text = os.environ.get("CO_CADENCE_COMBOS")
    return parse_combos(text) if text else COMBOS


def run_combo(combo, n, p, r, boost, device, windows=5) -> dict:
    """Warm up across six boundaries, time `windows` windows of 2 * ts
    steps, then measure the window-end error."""
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

    ts, K, Dp, geo, builder = combo
    cfg = SP.cadence_config(p, r, ts, K, Dp, builder,
                            geom_refresh=bool(geo), mac_sub_boost=boost)
    pos, vel = C.beam(n, cfg)
    sub = torch.from_numpy(C.oracle_targets(n)).to(device)
    with SP.builder_env(builder):
        sim = Simulator(cfg, n, engine="fmm3_kd")
        try:
            st = sim.init_acc(particle_state_from_numpy(pos, vel,
                                                        device=device))
            st = sim.run(st, 2)
            st = sim.run(st, 2)
            # cross enough boundaries for the list caps to settle
            for _ in range(3):
                sim.advance_padded(2 * ts)
                C.sync(device)
            times, waits = [], []
            for w in range(windows):
                w0 = sim.rebuild_wait_total
                t0 = time.perf_counter()
                sim.advance_padded(2 * ts)
                C.sync(device)
                times.append((time.perf_counter() - t0) / (2 * ts))
                waits.append(sim.rebuild_wait_total - w0)
                print(f"  ts={ts} K={K} D={Dp} geo={geo} {builder} window "
                      f"{w}: {times[-1]:.4f} s/step boundary_wait="
                      f"{waits[-1]:.3f} caps={sim._fmm.caps}", flush=True)
            err = SP.force_error(sim, sub)
            rebuilds = dict(sim.rebuilds)
            bt = dict(sim._fmm.last_build_times)
        finally:
            sim.close()
    med = statistics.median(times)
    return {"ts": ts, "resort_every": K, "pipeline": Dp, "geom": geo,
            "builder": builder, "median_s_per_step": med,
            "psteps_per_s": n / med, "stale_err": err, "times": times,
            "boundary_wait_s": waits, "rebuilds": rebuilds,
            "last_rebuild_breakdown_s": bt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("p", nargs="?", type=int, default=6)
    ap.add_argument("r", nargs="?", type=float, default=1.67)
    ap.add_argument("boost", nargs="?", type=float, default=1.5)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="write the rows to this JSON file")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = C.pick_device(args.device)
    out = {"config": {"n": args.n, "p": args.p, "r": args.r,
                      "boost": args.boost,
                      "stale_margin": os.environ.get("CO_STALE_MARGIN")},
           "device": C.device_info(device), "rows": []}
    for combo in combos_from_env():
        row = run_combo(combo, args.n, args.p, args.r, args.boost, device,
                        args.windows)
        out["rows"].append(row)
        print("@@ " + json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
    if args.out:
        print(f"wrote {args.out}", flush=True)
    else:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
