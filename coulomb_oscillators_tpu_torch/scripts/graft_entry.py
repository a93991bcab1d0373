"""Driver entry points: the production step on one device, and the
multi-device dry run.

Twin of the repository root's ``__graft_entry__.py``.

  * :func:`entry` returns ``(fn, example_args)``: one leapfrog step of the
    flagship system (kd-tree FMM Coulomb + harmonic trap) on a small state,
    with the frozen ``FmmState`` captured as it is inside the simulator's
    window loop.  On the card unless the caller names the CPU.
  * :func:`dryrun_multichip` validates the multi-device path: it spawns
    `n_devices` ranks and runs the twin's checks on tiny shapes.  Rank r
    runs on ``cuda:r`` unless the caller names the CPU (the twin's virtual
    host-platform mesh) or one card for all ranks to share.

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.graft_entry [--ranks 8]
      [--device cpu | --device cuda:0 --share-device]
"""

from __future__ import annotations

import argparse
import math

import torch

from coulomb_oscillators_tpu_torch.scripts import _common as C


def entry(device=None):
    """(fn, example_args): fn(pos, vel, acc) -> (pos, vel, acc), one
    leapfrog step of the kd-FMM system at n = 4096 on `device` (cuda:0
    unless named)."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import integrators as I
    from coulomb_oscillators_tpu_torch.ops.elastic import add_elastic
    from coulomb_oscillators_tpu_torch.ops.fmm import KdFmmEngine
    from coulomb_oscillators_tpu_torch.state import (
        ParticleState, particle_state_from_numpy)

    device = C.pick_device(device)
    config = SimConfig(fmm_order=3, tree_radius=2.0)
    n = 4096
    pos, vel = C.beam(n, config)
    state = particle_state_from_numpy(pos, vel, device=device)
    eng = KdFmmEngine(config, n)
    fstate = eng.build(state.pos)
    omega0_sq = config.omega0_sq()

    def force(p):
        return add_elastic(p, eng.force(p, fstate), omega0_sq)

    step = I.make_step(force, config.integrator, config.dt)

    def fn(pos, vel, acc):
        out = step(ParticleState(pos, vel, acc))
        return out.pos, out.vel, out.acc

    return fn, (state.pos, state.vel, state.acc)


def dryrun_multichip(n_devices: int, device=None,
                     share_device: bool = False) -> None:
    """Run the full step over a mesh of `n_devices` ranks on tiny shapes
    (:func:`_dryrun_rank` on every rank); raises if a rank fails a check.
    Placement is ``parallel.mesh.spawn``'s: rank r on ``cuda:r`` (raising
    when the CUDA devices are too few), CPU ranks with ``device="cpu"``,
    every rank on the one `device` with ``share_device=True``."""
    from coulomb_oscillators_tpu_torch.parallel import mesh as PM
    PM.spawn(_dryrun_rank, n_devices, device=device,
             share_device=share_device)


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


def _dryrun_rank(mesh) -> None:
    """One rank of the dry run, the twin's checks in its order:

      1. the PARTICLE-SHARDED kd-FMM step (parallel/fmm_pshard.py): each
         rank owns exactly G / n_devices leaf blocks of the state;
      1b. the mesh-mode Simulator across two rebuild-window boundaries (the
         async pipeline: adopt and regroup at the boundary);
      2. the pair-sharded kd-FMM step (parallel/fmm_shard.py): replicated
         state, sharded hot loops;
      3. the ring-systolic sharded direct step (parallel/mesh.py).
    """
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import integrators as I
    from coulomb_oscillators_tpu_torch.ops.elastic import add_elastic
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
    from coulomb_oscillators_tpu_torch.parallel import mesh as PM
    from coulomb_oscillators_tpu_torch.parallel.fmm_pshard import (
        make_psharded_step, shard_pair_lists)
    from coulomb_oscillators_tpu_torch.parallel.fmm_shard import (
        make_sharded_force)
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import (
        ParticleState, particle_state_from_numpy)

    P, dev = mesh.ndev, mesh.device
    config = SimConfig(fmm_order=3, tree_radius=2.0)
    n = 64 * P
    omega0_sq = config.omega0_sq()
    pos_h, vel_h = C.beam(n, config)
    state = particle_state_from_numpy(pos_h, vel_h, device=dev)

    # --- 1. particle-sharded kd-FMM step (flagship) ---
    # the block level (L - sub_depth) must cover the mesh: each rank owns
    # at least one full block of the dual-granularity near field
    L = max(3, int(math.ceil(math.log2(P))) + 2)
    eng = KdFmmEngine(config, n, L=L)
    fstate = eng.build(state.pos)
    ps, pstep = make_psharded_step(eng, mesh, config, omega0_sq)
    lists, hops = shard_pair_lists(eng, fstate, P)
    ppos = ps.shard_padded(eng.pad_array(state.pos, fstate, fill=FAR))
    acc0 = ps.force_padded(ppos, fstate, lists, hops)
    pstate = ParticleState(
        ppos, ps.shard_padded(eng.pad_array(state.vel, fstate)), acc0)
    G, C_leaf = eng.G_sub, eng.st.C
    assert tuple(pstate.pos.shape) == (G // P, C_leaf, 3), pstate.pos.shape
    pout = pstep(pstate, fstate, lists, hops)
    assert _finite(eng.unpad_array(ps.gather_padded(pout.pos), fstate))

    # --- 1b. mesh-mode Simulator crossing rebuild-window boundaries ---
    cfg_w = config.replace(tree_steps=3, tree_L=L)
    sim = Simulator(cfg_w, n, engine="fmm3_kd", mesh=mesh)
    try:
        out_m = sim.run(sim.init_acc(state), 2 * cfg_w.tree_steps + 1)
    finally:
        sim.close()
    assert out_m.pos.shape == (n, 3) and _finite(out_m.pos)

    # --- 2. pair-sharded kd-FMM step (replicated state) ---
    fmm_force = make_sharded_force(eng, mesh)

    def force_fmm(p):
        return add_elastic(p, fmm_force(p, fstate), omega0_sq)

    step_fmm = I.make_step(force_fmm, "leapfrog", config.dt)
    out = step_fmm(state._replace(acc=force_fmm(state.pos)))
    assert out.pos.shape == (n, 3) and _finite(out.pos)

    # --- 3. ring-systolic sharded direct step ---
    coulomb = PM.make_sharded_direct(mesh, config.eps2, config.kappa(n),
                                     dim=3, scheme="ring")

    def force_ring(p):
        return add_elastic(p, coulomb(p), omega0_sq)

    m = n // P
    rows = slice(mesh.rank * m, (mesh.rank + 1) * m)
    local = ParticleState(state.pos[rows].contiguous(),
                          state.vel[rows].contiguous(),
                          torch.zeros(m, 3, device=dev))
    step_ring = I.make_step(force_ring, "leapfrog", config.dt)
    out2 = step_ring(local._replace(acc=force_ring(local.pos)))
    full = mesh.all_gather(out2.pos)
    assert full.shape == (n, 3) and _finite(full)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="device of entry() and of the dry run's ranks "
                         "(default: cuda:0, and rank r on cuda:r)")
    ap.add_argument("--share-device", action="store_true",
                    help="every rank of the dry run uses --device")
    ap.add_argument("--ranks", type=int, default=8,
                    help="ranks of the dry run")
    args = ap.parse_args(argv)
    fn, xs = entry(args.device)
    out = fn(*xs)
    C.sync(out[0].device)
    print("entry ok:", all(_finite(x) for x in out),
          C.device_info(out[0].device))
    dryrun_multichip(args.ranks, args.device, args.share_device)
    where = (f"sharing {args.device}" if args.share_device
             else args.device or "one CUDA device each")
    print(f"dryrun_multichip ok ({args.ranks} ranks, {where})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
