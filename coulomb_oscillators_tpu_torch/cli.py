"""Command-line driver.

Twin of ``coulomb_oscillators_tpu/cli.py`` (reference CLI `nbco3 [options]
[input]`, Simulation/main3.cu:247-623): the same flags, defaults, run modes
(simulate / -test / -test2 / -accuracy) and snapshot bytes.  Run it as
``python -m coulomb_oscillators_tpu_torch.cli`` or ``nbco3-torch``.

Devices: the run goes to the CUDA device cuda:0, or to the CPU with
``-cpu``; without a CUDA device and without ``-cpu`` it exits non-zero and
never carries on on the CPU.  The 2D program (main.cu, reached via -dim 2,
default engine ``fmm2``) computes in float64 only with ``-cpu``, as the
twin does on a CPU backend; on the card it computes in float32.  2D
snapshots are float64 and 3D ones float32 either way.

Not ported (ROADMAP.md): ``-chips`` (queue 1, item 10); the twin's JAX
compile cache has no counterpart.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nbco3-torch",
        description="N-body Coulomb oscillators — PyTorch + CUDA port.",
        prefix_chars="-",
    )
    p.add_argument("input", nargs="?", default=None,
                   help="binary state file (positions then velocities); "
                        "if absent, sample a gaussian distribution")
    p.add_argument("-o", dest="out", default="out",
                   help="output folder (must exist). Default ./out")
    p.add_argument("-n", dest="nbodies", type=int, default=30001,
                   help="number of particles (ignored with [input])")
    p.add_argument("-ds", dest="dt", type=float, default=5e-4, help="time step")
    p.add_argument("-iters", dest="iters", type=int, default=30000,
                   help="total simulation iterations")
    p.add_argument("-steps", dest="steps", type=int, default=200,
                   help="steps between snapshots")
    p.add_argument("-integ", dest="integ", default="leapfrog",
                   choices=["eu", "fr", "pefrl", "leapfrog"],
                   help="symplectic integrator")
    p.add_argument("-p", dest="fmm_order", type=int, default=3,
                   help="FMM expansion order (reference default: "
                        "constants.cuh:42)")
    p.add_argument("-r", dest="tree_radius", type=float, default=1.0,
                   help="interaction radius (>= 1)")
    p.add_argument("-eps", dest="eps", type=float, default=1e-9,
                   help="softening factor (> 0)")
    p.add_argument("-i", dest="dens_inhom", type=float, default=1.0,
                   help="density inhomogeneity factor for auto tree level")
    p.add_argument("-maxlevel", dest="tree_L", type=int, default=0,
                   help="max kd-tree level (default: auto)")
    p.add_argument("-ncoll", dest="ncoll", action="store_true",
                   help="skip the near-field P2P pass")
    p.add_argument("-accuracy", dest="accuracy", type=float, default=None,
                   help="auto-tune (p, r) for this error bound")
    p.add_argument("-cpu", dest="cpu", action="store_true",
                   help="run on the CPU (default: the CUDA device cuda:0)")
    p.add_argument("-cpu-threads", dest="cpu_threads", type=int, default=None,
                   help="(accepted for compatibility)")
    p.add_argument("-cacheline", dest="cacheline", type=int, default=None,
                   help="(accepted for compatibility)")
    p.add_argument("-test", dest="test", action="store_true",
                   help="print relative error (p=1..10) and timing, no simulation")
    p.add_argument("-test2", dest="test2", action="store_true",
                   help="error drift over tree_steps+1 euler steps")
    p.add_argument("-xi", dest="xi", type=float, default=2e-6, help="coupling")
    p.add_argument("-omega0", dest="omega0", type=float, nargs=2, default=None,
                   help="trap frequencies (x y); z stays at default")
    p.add_argument("-x", dest="x_std", type=float, nargs=3, default=None,
                   help="position std.dev. (ignored with [input])")
    p.add_argument("-u", dest="u_std", type=float, nargs=3, default=None,
                   help="velocity std.dev. (ignored with [input])")
    p.add_argument("-engine", dest="engine", default=None,
                   help="force engine: direct | direct_ref | fmm3_kd | fmm3 "
                        "| fmm3_traceless | fmm2 | fmm2_kd | appel "
                        "(default: kd FMM, matching the reference driver)")
    p.add_argument("-dim", dest="dim", type=int, default=3, choices=[2, 3])
    p.add_argument("-seed", dest="seed", type=int, default=None,
                   help="RNG seed for initial sampling")
    # 2D beam options (reference main.cu:294-315)
    p.add_argument("-ga", dest="ga", action="store_true",
                   help="2D: gaussian beam rms-matched to the KV beam "
                        "(default for dim=2 is the KV distribution)")
    p.add_argument("-emit", dest="emit", type=float, nargs=2,
                   default=[0.03e-3, 0.01e-3],
                   help="2D: emittances (ex ey)")
    p.add_argument("-tune", dest="tune", type=float, default=0.8,
                   help="2D: y tune depression for the matched beam")
    p.add_argument("-A", dest="kv_A", type=float, nargs=2, default=None,
                   help="2D: KV semi-axes override (skips envelope matching)")
    p.add_argument("-omega", dest="kv_omega", type=float, nargs=2,
                   default=None,
                   help="2D: KV depressed phase advances override")
    p.add_argument("-chips", dest="chips", type=int, default=0,
                   help="run particle-sharded over this many devices "
                        "(not ported yet)")
    # accepted for reference-CLI compatibility
    p.add_argument("-gpu", dest="gpu_blocksize", type=int, default=None,
                   help="(compat; each kernel picks its block size)")
    p.add_argument("-gridsize", dest="gridsize", type=int, default=None,
                   help="(compat)")
    return p


def main(argv: Optional[list] = None) -> int:
    print("N-body coulomb oscillators (PyTorch + CUDA port)\n"
          "Type 'nbco3-torch -h' for a brief documentation.\n")
    args = build_parser().parse_args(argv)
    if args.chips:
        raise NotImplementedError(
            "-chips (particle-sharded runs) is not ported yet: ROADMAP.md "
            "queue 1, item 10")

    import torch
    if not args.cpu and not torch.cuda.is_available():
        print("nbco3-torch: no CUDA device is available; pass -cpu to run "
              "on the CPU", file=sys.stderr)
        return 1
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)

    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
    from coulomb_oscillators_tpu_torch.utils import io as SIO

    dim = args.dim
    # defaults mirror main3.cu:241 (3D) / main.cu:272 (2D)
    if dim == 3:
        omega0 = [1.095, 1.0, 1.0]
    else:
        twopi = 2 * np.pi
        omega0 = [6.22 * twopi, 6.21 * twopi]
    if args.omega0 is not None:
        omega0[0], omega0[1] = args.omega0
    integ_name = {"eu": "euler", "fr": "forestruth"}.get(args.integ, args.integ)

    beam = None
    if dim == 2:
        from coulomb_oscillators_tpu_torch.models.beams import matched_beam_2d
        beam = matched_beam_2d(omega0, args.emit, args.tune)
        if args.kv_A is not None:
            beam["A"] = np.asarray(args.kv_A, dtype=np.float64)
            beam["x_std"] = beam["A"] / 2.0
        if args.kv_omega is not None:
            beam["omega"] = np.asarray(args.kv_omega, dtype=np.float64)
        beam["u_std"] = beam["omega"] * beam["A"] / 2.0
        if args.xi == 2e-6:  # not overridden on the command line
            args.xi = beam["xi"]
        print(f"dep. phase adv.: {beam['omega'][0]}, {beam['omega'][1]}")
        print(f"semi-axes: {beam['A'][0]}, {beam['A'][1]}")

    # the reference 2D driver uses double (main.cu:34); honour that on the
    # CPU, as the twin does on its CPU backend; the card computes in f32
    use_f64 = dim == 2 and args.cpu
    config = SimConfig(
        dim=dim, eps=args.eps, xi=args.xi, omega0=tuple(omega0),
        fmm_order=args.fmm_order, tree_radius=args.tree_radius,
        tree_L=args.tree_L, dens_inhom=args.dens_inhom,
        coll=not args.ncoll, dt=args.dt, integrator=integ_name,
        precision="float64" if use_f64 else "float32",
    )
    dtype = np.float64 if use_f64 else np.float32
    # snapshot byte format follows the reference drivers: 2D files are
    # float64, 3D files float32 (constants.cuh:22-28, main.cu:34)
    file_dtype = np.float64 if dim == 2 else np.float32

    # --- initial state (main3.cu:629-667) ---------------------------------
    if args.input:
        pos, vel = SIO.read_state(args.input, dim=dim, dtype=file_dtype)
        pos = pos.astype(dtype)
        vel = vel.astype(dtype)
        n = pos.shape[0]
    else:
        n = args.nbodies
        seed = args.seed if args.seed is not None else ID.DEFAULT_SEED
        if dim == 2 and not args.ga:
            # 2D default: KV beam (main.cu:752)
            pos, vel = ID.init_kv(n, beam["A"], beam["omega"], seed=seed,
                                  dtype=dtype)
        else:
            if dim == 2:
                x = tuple(beam["x_std"])
                u = tuple(beam["u_std"])
            else:
                x = tuple(args.x_std) if args.x_std else (0.003, 0.001, 0.01)
                u = tuple(args.u_std) if args.u_std else tuple(
                    w * xs for w, xs in zip(config.omega0, x))
            pos, vel = ID.init_gaussian(n, x, u, dim=dim, seed=seed,
                                        dtype=dtype)
        if args.test:
            pos = ID.init_uniform(n, (-1,) * dim, (1,) * dim, dim=dim,
                                  seed=seed, dtype=dtype)

    engine = args.engine or default_engine(config)
    state = particle_state_from_numpy(pos, vel, device=device)

    # --- run modes ---------------------------------------------------------
    if args.accuracy is not None:
        # record the requested bound in the config: the kd engine stiffens
        # its sub-leaf MAC automatically for accuracy-grade bounds
        config = config.replace(accuracy=args.accuracy)
        config, err = autotune(config, n, state.pos, engine, args.accuracy)
        if config is None:
            print("\nOptimization failed!")
            return -1

    if args.test:
        return run_test_mode(config, n, state, engine)
    if args.test2:
        return run_test2_mode(config, n, state, engine)

    # --- simulation loop (main3.cu:832-874) --------------------------------
    from coulomb_oscillators_tpu_torch.simulate import Simulator

    os.makedirs(args.out, exist_ok=True)
    SIO.write_args(args.out, sys.argv if argv is None
                   else ["nbco3-torch"] + list(argv))

    sim = Simulator(config, n, engine=engine)
    try:
        state = sim.init_acc(state)

        # reference cadence (main3.cu:841-873): snapshot out<iter> written
        # when iter % steps == 0, after stepping at that iter.
        def snapshot(it):
            print(it, end=" ", flush=True)
            SIO.write_state(SIO.snapshot_name(args.out, it, config.dt),
                            state.pos.cpu().numpy().astype(file_dtype),
                            state.vel.cpu().numpy().astype(file_dtype))

        state = sim.run(state, 1)
        snapshot(0)
        it = 1
        while it <= args.iters:
            k = min(args.steps, args.iters + 1 - it)
            state = sim.run(state, k)
            it += k
            if (it - 1) % args.steps == 0:
                snapshot(it - 1)
    finally:
        sim.close()
    print()
    return 0


def default_engine(config) -> str:
    """Default engine mirrors the reference programs: the kd-tree FMM in 3D
    (main3.cu), the quadtree FMM in 2D (main.cu)."""
    return "fmm3_kd" if config.dim == 3 else "fmm2"


def autotune(config, n, pos, engine, bound):
    """Grid search (p, r) keeping the fastest config under the error bound
    (main3.cu:737-788)."""
    from coulomb_oscillators_tpu_torch.models import oscillator as M
    from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err
    from coulomb_oscillators_tpu_torch.utils import timing

    if engine.startswith("direct"):
        print("autotune: direct engine has no (p, r); skipping")
        return config, 0.0

    search_p = [1, 2, 3, 4, 5, 6]
    search_r = [1.11, 1.25, 1.43, 1.67, 2.0, 2.5, 3.0]
    ref_acc = M.make_coulomb_force(config, n, "direct_ref")(pos)
    best = None
    print("Parameter optimization in progress, please wait", end="", flush=True)
    for r in search_r:
        for p in search_p:
            cand = config.replace(fmm_order=p, tree_radius=r, coll=True)
            try:
                f = M.make_coulomb_force(cand, n, engine)
                err = float(mean_rel_err(f(pos), ref_acc))
                if err < bound:
                    t = timing.test_time(lambda: f(pos), min_loop=0.0)
                    if best is None or t < best[0]:
                        best = (t, cand, err)
            except (RuntimeError, ValueError) as e:
                # a candidate the engine cannot run (device memory, an
                # unsupported layout) is skipped, as in the twin
                print(f"\n(p={p}, r={r}) skipped: {e}", flush=True)
            print(".", end="", flush=True)
    if best is None:
        return None, None
    t, cand, err = best
    print(f"\nBest parameters: r = {cand.tree_radius}, p = {cand.fmm_order}, "
          f"time = {t}, error = {err}")
    return cand, err


def run_test_mode(config, n, state, engine) -> int:
    """-test: timing at current order, then rel. error for p=1..10
    (main3.cu:790-811)."""
    from coulomb_oscillators_tpu_torch.models import oscillator as M
    from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err
    from coulomb_oscillators_tpu_torch.utils import timing

    f = M.make_coulomb_force(config, n, engine)
    t = timing.test_time(lambda: f(state.pos), min_loop=1.0)
    print(f"{config.fmm_order}: Average time: {t} [s]")

    ref_acc = M.make_coulomb_force(config, n, "direct_ref")(state.pos)
    orders = range(1, 11) if not engine.startswith("direct") else [config.fmm_order]
    for p in orders:
        cand = config.replace(fmm_order=p)
        acc = M.make_coulomb_force(cand, n, engine)(state.pos)
        print(f"{p}: Relative error: {float(mean_rel_err(acc, ref_acc))}")
    return 0


def run_test2_mode(config, n, state, engine) -> int:
    """-test2: error drift over tree_steps+1 pre-euler steps with the trap
    only (main3.cu:812-831), validating tree reuse."""
    from coulomb_oscillators_tpu_torch.models import integrators as I
    from coulomb_oscillators_tpu_torch.models import oscillator as M
    from coulomb_oscillators_tpu_torch.ops.elastic import elastic
    from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err

    cfg = config.replace(unsort=False)
    test_f = M.make_coulomb_force(cfg, n, engine)
    ref_f = M.make_coulomb_force(cfg, n, "direct_ref")
    # freeze the tree across steps (the point of -test2: validate reuse)
    eng = getattr(test_f, "engine", None)
    fstate = eng.build(state.pos) if eng is not None else None
    euler = I.make_step(lambda p: elastic(p, cfg.omega0_sq()), "pre_euler",
                        cfg.dt)
    for i in range(cfg.tree_steps + 1):
        acc = (eng.force(state.pos, fstate) if eng is not None
               else test_f(state.pos))
        err = float(mean_rel_err(acc, ref_f(state.pos)))
        print(f"Relative error after {i} steps: {err}")
        state = euler(state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
