"""North-star metric: relative energy drift over 10k leapfrog steps
(BASELINE.md: target <= 1e-6), on one CUDA card.

Twin of ``scripts/energy_drift.py`` (``run_one``, ``sweep``,
``midscale``).  The Hamiltonian is ``ops.energy.total_energy_kahan``
(device Kahan pair rows + a float64 host reduction); above n = 200k the
O(N^2) rows are impractical and the O(N) kd-FMM potential is used instead
(diagnostic-grade).  Always quote drift with dt.

Usage:  python -m coulomb_oscillators_tpu_torch.scripts.energy_drift \\
            [n] [steps] [engine] [p] [r] [dt]
        ... energy_drift sweep [steps]       # the drift ladder, n=30001
        ... energy_drift midscale [steps] [--out FILE]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch


def run_one(n, steps, engine, p_order, radius, dt=5e-4, block=1000,
            integrator="leapfrog", quiet=False, device=None, **config_kw):
    """Drift of one configuration: (final drift, max drift, M
    particle-steps/s).  `device` defaults to cuda:0."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    from coulomb_oscillators_tpu_torch.models import oscillator as M
    from coulomb_oscillators_tpu_torch.ops import energy as E
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

    device = torch.device("cuda", 0) if device is None else device
    config = SimConfig(fmm_order=p_order, tree_radius=radius, dt=dt,
                       integrator=integrator, **config_kw)
    x = (0.003, 0.001, 0.01)
    u = tuple(w * xs for w, xs in zip(config.omega0, x))
    pos, vel = ID.init_gaussian(n, x, u, dtype=np.float32)
    state = particle_state_from_numpy(pos, vel, device=device)

    sim = Simulator(config, n, engine=engine)
    try:
        state = sim.init_acc(state)
        kappa = config.kappa(n)
        om2 = config.omega0_sq()

        def energy(st):
            if n > 200_000 and sim._fmm is not None:
                return float(M.total_energy_fmm(config, st, sim._fmm,
                                                sim._fmm.build(st.pos)))
            return E.total_energy_kahan(st.pos, st.vel, config.eps2, kappa,
                                        om2)

        e0 = energy(state)
        if not quiet:
            print(f"n={n} engine={engine} p={p_order} r={radius} dt={dt} "
                  f"integ={integrator} E0={e0:.12e}", flush=True)
        t0 = time.perf_counter()
        done = 0
        drift = max_drift = 0.0
        while done < steps:
            k = min(block, steps - done)
            state = sim.run(state, k)
            done += k
            e = energy(state)
            drift = abs(e - e0) / abs(e0)
            max_drift = max(max_drift, drift)
            if not quiet:
                wall = time.perf_counter() - t0
                print(f"step {done:6d}  E={e:.12e}  drift={drift:.3e}  "
                      f"({done * n / wall / 1e6:.2f} M psteps/s incl. "
                      f"energies)", flush=True)
    finally:
        sim.close()
    wall = time.perf_counter() - t0
    psteps = steps * n / wall / 1e6
    print(f"RESULT n={n} engine={engine} p={p_order} r={radius} dt={dt} "
          f"integ={integrator}: final_drift={drift!r} "
          f"max_drift={max_drift!r} ({psteps!r} M psteps/s incl. "
          f"energies)", flush=True)
    return drift, max_drift, psteps


# the drift ladder: at the reference default dt=5e-4 drift is dominated by
# unresolved close encounters (eps=1e-9 is effectively unsoftened), for
# exact forces too; at dt=2e-5 encounters are resolved
SWEEP = [
    ("direct", 3, 2.0, 5e-4),     # exact forces, default dt
    ("fmm3_kd", 4, 2.0, 5e-4),    # engine accuracy irrelevant
    ("direct", 3, 2.0, 2e-5),     # exact forces, resolved dt
    ("fmm3_kd", 6, 2.5, 2e-5),    # the north-star configuration
]


def sweep(steps=10_000, n=30001, device=None):
    """The drift ladder at n=30001 (north star: <= 1e-6 at 10k steps);
    returns one (engine, p, r, dt, final, max, psteps) row per config."""
    rows = []
    for engine, p, r, dt in SWEEP:
        rows.append((engine, p, r, dt) + run_one(
            n, steps, engine, p, r, dt, quiet=True, device=device))
    return rows


def midscale(steps=2000, device=None) -> dict:
    """Mid-scale twin of the north star: n=16384 at the production
    rebuild cadence (tree_steps=8), p=6, r=2.5, dt=2e-5, accuracy=1e-6;
    passes at max drift <= 1e-6."""
    n, p, r, dt = 16384, 6, 2.5, 2e-5
    drift, max_drift, psteps = run_one(n, steps, "fmm3_kd", p, r, dt,
                                       quiet=True, device=device,
                                       accuracy=1e-6, tree_steps=8)
    return {"metric": "rel_energy_drift_midscale", "value": drift,
            "max_drift": max_drift, "steps": steps, "bound": 1e-6,
            "pass": bool(max_drift <= 1e-6),
            "config": {"n": n, "engine": "fmm3_kd", "p": p, "r": r,
                       "dt": dt, "tree_steps": 8, "accuracy": 1e-6,
                       "integrator": "leapfrog"},
            "psteps_per_s": psteps * 1e6}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out = None
    if "--out" in argv:
        i = argv.index("--out")
        out = argv[i + 1]
        del argv[i:i + 2]
    if not torch.cuda.is_available():
        print("energy_drift: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    if argv and argv[0] == "midscale":
        res = midscale(steps=int(argv[1]) if len(argv) > 1 else 2000)
        print(json.dumps(res))
        if out:
            with open(out, "w") as f:
                json.dump(res, f, indent=1)
        return 0 if res["pass"] else 1
    if argv and argv[0] == "sweep":
        sweep(int(argv[1]) if len(argv) > 1 else 10_000)
        return 0
    n = int(argv[0]) if len(argv) > 0 else 30001
    steps = int(argv[1]) if len(argv) > 1 else 10_000
    engine = argv[2] if len(argv) > 2 else "fmm3_kd"
    p_order = int(argv[3]) if len(argv) > 3 else 4
    radius = float(argv[4]) if len(argv) > 4 else 2.0
    dt = float(argv[5]) if len(argv) > 5 else 5e-4
    run_one(n, steps, engine, p_order, radius, dt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
