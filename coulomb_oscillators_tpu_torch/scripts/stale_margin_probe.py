"""Window certification: the force error at every step of one reuse
window, and a sweep of the temporal MAC slack at a production cadence.

Twin of ``scripts/stale_margin_probe.py``.  Frozen pair lists go stale as
particles drift inside a reuse window; the traversal-time slack (node
bounds inflated by the expected drift) keeps every accepted pair
admissible for the window.  :func:`window_ladder` advances a running
Simulator through one window and measures, at every step, the mean
relative error of the force the production loop computes (geometry
refreshed when ``geom_refresh`` is on) against the Kahan direct oracle on
the seeded targets.  The sweep builds a Simulator per margin through the
engine's knobs (``CO_STALE_MARGIN``, ``CO_STALE_MARGIN_FACTOR``) and
records the window's errors, the pair counts and the s/step.

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.stale_margin_probe
      [n] [p] [r] [margins csv] [--every K] [--out FILE] [--device cpu]
  margins: numbers (a flat slack), "auto" (the per-axis rms margin at the
  shipped factor) or "autoF<f>" (auto at factor f); default 0,1e-4,3e-4,1e-3
  cadence via env CO_TS / CO_RESORT / CO_PIPE (default 16/2/2), builder via
  CO_BUILDER (host | kd_device)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.scripts import _common as C


def force_error(sim, sub: torch.Tensor) -> float:
    """Mean relative error, against the Kahan oracle on the targets `sub`
    (original particle indices), of the force the production loop would
    compute now: the frozen lists, and the geometry refreshed from the
    live positions when the configuration does so.  Reads the Simulator's
    padded state and changes nothing in it."""
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err
    eng, cfg = sim._fmm, sim.config
    ppad, fs = sim._padded.pos, sim._fstate
    if cfg.geom_refresh and cfg.tree_steps > 1:
        fs = eng.geom_refresh(ppad, fs)
    acc = eng.unpad_array(eng.force_padded(ppad, fs), fs)
    pos = eng.unpad_array(ppad, fs)
    ref = D.direct_kahan_targets(pos[sub], pos, cfg.eps2, cfg.kappa(sim.n))
    return float(mean_rel_err(acc[sub], ref))


def window_ladder(sim, sub: torch.Tensor, every: int = 1) -> dict:
    """Advance `sim` (a kd-engine Simulator in an active padded run)
    through one whole reuse window and return {step: error} with
    :func:`force_error` at step 0 (the lists just adopted at the
    boundary), every `every`-th step and the window's last step (the lists
    at their oldest).  A run that is inside a window first advances to its
    end.  The run goes on as if nothing had been measured: one force
    evaluation per measurement happens beside it."""
    ts = max(sim.config.tree_steps, 1)
    if 0 < sim._steps_since_build < ts:
        sim.advance_padded(ts - sim._steps_since_build)
    sim.start_window()
    errs = {0: force_error(sim, sub)}
    done = 0
    for stp in sorted(set(range(every, ts, every)) | {ts}):
        sim.advance_padded(stp - done)
        done = stp
        errs[stp] = force_error(sim, sub)
    return errs


def ladder_evals(tree_steps: int, every: int) -> int:
    """Force evaluations :func:`window_ladder` makes beside the run's
    own."""
    ts = max(tree_steps, 1)
    return 1 + len(set(range(every, ts, every)) | {ts})


@contextlib.contextmanager
def margin_env(margin):
    """The engine's margin knobs set for one sweep entry: a number is a
    flat ``CO_STALE_MARGIN``; "auto" clears both knobs (the Simulator
    derives the per-axis margin); "autoF<f>" sets the factor."""
    names = ("CO_STALE_MARGIN", "CO_STALE_MARGIN_FACTOR")
    saved = {k: os.environ.pop(k, None) for k in names}
    try:
        if isinstance(margin, str):
            if margin.startswith("autoF"):
                os.environ["CO_STALE_MARGIN_FACTOR"] = margin[5:]
        else:
            os.environ["CO_STALE_MARGIN"] = str(margin)
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def parse_margins(text: str) -> list:
    out = []
    for v in text.split(","):
        if v.startswith("auto"):
            if v != "auto" and not v.startswith("autoF"):
                raise ValueError(f"margin {v!r}: auto or autoF<factor>")
            out.append(v)
        else:
            out.append(float(v))
    return out


def cadence_config(p, r, ts, resort, pipeline, builder="host", **kw):
    """SimConfig of one cadence; builder "kd_device" rebuilds with the
    device kd sort (``tree_async_build="device"``)."""
    from coulomb_oscillators_tpu_torch import SimConfig
    return SimConfig(fmm_order=p, tree_radius=r, tree_steps=ts,
                     tree_resort_every=resort, tree_pipeline=pipeline,
                     tree_async_build=("device" if builder != "host"
                                       else "host"), **kw)


@contextlib.contextmanager
def builder_env(builder: str):
    """``CO_SORT_MODE`` for the engines made inside: "kd_device" forces the
    device kd sort, anything else leaves the engine's own choice."""
    saved = os.environ.pop("CO_SORT_MODE", None)
    try:
        if builder == "kd_device":
            os.environ["CO_SORT_MODE"] = "kd_device"
        yield
    finally:
        os.environ.pop("CO_SORT_MODE", None)
        if saved is not None:
            os.environ["CO_SORT_MODE"] = saved


def sweep(n, p, r, margins, ts, resort, pipeline, builder, device,
          every=1) -> list:
    """One row per margin: the window's errors, the resolved margin, the
    pair counts and caps, and the s/step of one clean window after it."""
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

    cfg = cadence_config(p, r, ts, resort, pipeline, builder)
    pos, vel = C.beam(n, cfg)
    sub = torch.from_numpy(C.oracle_targets(n)).to(device)
    rows = []
    for m in margins:
        with margin_env(m), builder_env(builder):
            sim = Simulator(cfg, n, engine="fmm3_kd")
            try:
                eng = sim._fmm
                st = sim.init_acc(particle_state_from_numpy(pos, vel,
                                                            device=device))
                sim.run(st, 2)
                for _ in range(3):
                    sim.advance_padded(ts)
                    C.sync(device)
                errs = window_ladder(sim, sub, every)
                for stp, e in errs.items():
                    print(f"  margin={m} step={stp}: err={e:.3e}",
                          flush=True)
                counts, caps = dict(eng.last_counts), dict(eng.caps)
                # one clean timed window after the error evaluations
                C.sync(device)
                t0 = time.perf_counter()
                sim.advance_padded(ts)
                C.sync(device)
                sps = (time.perf_counter() - t0) / ts
                resolved = (float(os.environ["CO_STALE_MARGIN"])
                            if "CO_STALE_MARGIN" in os.environ
                            else np.asarray(eng.stale_margin_abs).tolist())
            finally:
                sim.close()
        row = {"margin": m, "errs": errs, "resolved_margin": resolved,
               "window_mean": float(np.mean(list(errs.values()))),
               "window_max": float(max(errs.values())),
               "counts": counts, "caps": caps, "s_per_step": sps,
               "psteps_per_s": n / sps}
        rows.append(row)
        print("@@ " + json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("p", nargs="?", type=int, default=6)
    ap.add_argument("r", nargs="?", type=float, default=1.43)
    ap.add_argument("margins", nargs="?", default="0,1e-4,3e-4,1e-3")
    ap.add_argument("--every", type=int, default=1,
                    help="measure every K-th step of the window")
    ap.add_argument("--out", default=None,
                    help="write the rows to this JSON file")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = C.pick_device(args.device)
    ts = int(os.environ.get("CO_TS", "16"))
    resort = int(os.environ.get("CO_RESORT", "2"))
    pipeline = int(os.environ.get("CO_PIPE", "2"))
    builder = os.environ.get("CO_BUILDER", "host")
    rows = sweep(args.n, args.p, args.r, parse_margins(args.margins), ts,
                 resort, pipeline, builder, device, args.every)
    out = {"config": {"n": args.n, "p": args.p, "r": args.r, "ts": ts,
                      "resort_every": resort, "pipeline": pipeline,
                      "builder": builder, "every": args.every},
           "device": C.device_info(device), "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    else:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
