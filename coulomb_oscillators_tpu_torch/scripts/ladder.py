"""The BASELINE.json config ladder on one CUDA card — one JSON line per
config.

Twin of ``scripts/ladder.py``:

  1. direct O(N^2) P2P + trap, N=4096, leapfrog, 3D
  2. 2D kd FMM (fmm2_kd), N=100k, p=4, r=2, leapfrog
  3. 3a: 3D kd FMM on the Gaussian beam, N=1M, p=3, r=1.7;
     3b: 3D traceless-multipole octree on a uniform box, N=1M, p=3
  4. 3D kd FMM at p=8 + Forest-Ruth (4th order), N=100k
  5. 3D kd FMM, N=10M, a tree rebuild every step

Each row is min over 2 timed repeats of `steps` steps after two 2-step
warm-up runs, timed on the host clock around work that ends in
``torch.cuda.synchronize()``, and carries the card's name and power limit.

Usage:  python -m coulomb_oscillators_tpu_torch.scripts.ladder [configs]
        [--out FILE]   (default configs: 1 2 3 4; --out writes the rows as
        one JSON artifact)
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def card() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in smi.split(","))
    return {"device": name, "power_limit": limit}


def _state(config, n, device, uniform=False):
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

    dim = config.dim
    if uniform:
        pos = ID.init_uniform(n, (-0.01,) * dim, (0.01,) * dim, dim=dim)
        vel = np.zeros_like(pos)
    else:
        x = (0.003, 0.001, 0.01)[:dim]
        u = tuple(w * xs for w, xs in zip(config.omega0, x))
        pos, vel = ID.init_gaussian(n, x, u, dim=dim, dtype=np.float32)
    return particle_state_from_numpy(pos, vel, device=device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(tag, config, n, engine, device, steps=12, uniform=False,
        repeats=2) -> dict:
    """One ladder row: s/step of `engine` at `n` on `device`."""
    from coulomb_oscillators_tpu_torch.simulate import Simulator

    t_setup = time.perf_counter()
    state = _state(config, n, device, uniform)
    sim = Simulator(config, n, engine=engine)
    try:
        state = sim.init_acc(state)
        state = sim.run(state, 2)
        state = sim.run(state, 2)
        _sync(device)
        setup_s = time.perf_counter() - t_setup
        dt = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            state = sim.run(state, steps)
            _sync(device)
            dt = min(dt, (time.perf_counter() - t0) / steps)
        finite = bool(torch.isfinite(state.pos).all())
    finally:
        sim.close()
    return {"config": tag, "engine": engine, "n": n, "sec_per_step": dt,
            "particle_steps_per_s": n / dt, "integrator": config.integrator,
            "p": config.fmm_order, "r": config.tree_radius,
            "tree_steps": config.tree_steps, "setup_s": setup_s,
            "finite": finite}


def configs(which):
    """(tag, config, n, engine, run kwargs) of the selected ladder rows."""
    from coulomb_oscillators_tpu_torch import SimConfig

    out = []
    if 1 in which:
        out.append(("1_direct_N4096", SimConfig(), 4096, "direct",
                    dict(steps=500)))
    if 2 in which:
        out.append(("2_fmm2d_N100k_p4",
                    SimConfig(dim=2, omega0=(1.095, 1.0), fmm_order=4,
                              tree_radius=2.0), 100_000, "fmm2_kd", {}))
    if 3 in which:
        out.append(("3a_kd_N1M_beam", SimConfig(fmm_order=3, tree_radius=1.7),
                    1_000_000, "fmm3_kd", {}))
        out.append(("3b_octree_traceless_N1M_uniform",
                    SimConfig(fmm_order=3), 1_000_000, "fmm3_traceless",
                    dict(steps=6, uniform=True)))
    if 4 in which:
        out.append(("4_p8_forestruth_N100k",
                    SimConfig(fmm_order=8, tree_radius=2.0,
                              integrator="forestruth"), 100_000, "fmm3_kd",
                    {}))
    if 5 in which:
        out.append(("5_kd_N10M_rebuild_every_step",
                    SimConfig(fmm_order=3, tree_radius=1.7, tree_steps=1),
                    10_000_000, "fmm3_kd", dict(steps=3)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="*", type=int, default=[1, 2, 3, 4])
    ap.add_argument("--out", default=None,
                    help="write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ladder: no CUDA device; the ladder measures the card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    info = card()
    rows = []
    for tag, cfg, n, engine, kw in configs(set(args.configs)):
        row = dict(run(tag, cfg, n, engine, device, **kw), **info)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"note": "config ladder of the PyTorch + CUDA "
                                   "port (coulomb_oscillators_tpu_torch."
                                   "scripts.ladder): sec_per_step is min "
                                   "over 2 timed repeats after warm-up",
                           "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
