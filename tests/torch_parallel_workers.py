"""Rank-side scenarios of the port's multi-device tests.

Module-level functions for ``parallel.mesh.spawn``: each runs on every rank
of a spawned group and rank 0's return value (host arrays) goes back to the
test, which holds it against the reference.  This file imports torch and
the port only, never JAX: the same functions run on a CUDA machine that has
no JAX (tests/test_torch_parallel_cuda.py).
"""

import hashlib

import numpy as np
import torch

from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (
    FAR, KdFmmEngine, fmm_state_from_numpy)
from coulomb_oscillators_tpu_torch.parallel import mesh as PM
from coulomb_oscillators_tpu_torch.parallel.fmm_pshard import (
    make_psharded_step, shard_pair_lists)
from coulomb_oscillators_tpu_torch.parallel.fmm_shard import (
    make_sharded_force)
from coulomb_oscillators_tpu_torch.simulate import Simulator
from coulomb_oscillators_tpu_torch.state import (ParticleState,
                                                 particle_state_from_numpy)

SHIFTS = (1, -1, 2, -2)


def _np(x):
    return x.detach().cpu().numpy()


def _all_equal(mesh, x: torch.Tensor) -> bool:
    """Whether every rank holds the same `x` (compared on every rank)."""
    rows = mesh.all_gather(x[None].contiguous())
    return bool((rows == rows[0]).all())


def state_digest(fs) -> torch.Tensor:
    """[4] int64 digest of the integer fields of an FmmState."""
    h = hashlib.sha256()
    for name in ("perm", "inv_perm", "p2p_tgt", "p2p_src", "p2p_valid",
                 "m2l_tgt", "m2l_src", "m2l_valid", "p2p_row_ptr",
                 "p2p_col2d", "m2l_gtgt"):
        h.update(np.ascontiguousarray(_np(getattr(fs, name))).tobytes())
    return torch.from_numpy(np.frombuffer(h.digest(), np.int64).copy())


def collectives(mesh, seed):
    """Each rank's tensor is a seeded array's row block `rank`; returns
    what rank 0 got from every collective, and whether each rank got what
    numpy says it should."""
    torch.set_num_threads(1)
    P, r = mesh.ndev, mesh.rank
    full = np.random.default_rng(seed).normal(size=(P, 5, 3))
    x = torch.from_numpy(full[r]).to(mesh.device)
    before = x.clone()
    out = {"ndev": P, "backend": mesh.backend,
           "all_gather": _np(mesh.all_gather(x)),
           "all_reduce_sum": _np(mesh.all_reduce_sum(x))}
    ok = [np.array_equal(out["all_gather"], full.reshape(P * 5, 3)),
          np.allclose(out["all_reduce_sum"], full.sum(0), rtol=1e-12)]
    for k in SHIFTS:
        got = _np(mesh.ring_shift(x, k))
        out[f"ring_shift_{k}"] = got
        ok.append(np.array_equal(got, full[(r + k) % P]))
    ok.append(torch.equal(x, before))           # inputs are left alone
    flags = mesh.all_gather(torch.tensor([all(ok)], device=mesh.device))
    out["every_rank_ok"] = bool(flags.all())
    out["bytes"] = dict(mesh.bytes)
    out["calls"] = dict(mesh.calls)
    return out


def sharded_direct(mesh, cases, eps2, kappa):
    """cases: {name: (scheme, pos [n, dim])}; every rank takes its rows of
    the padded positions; returns {name: acc [n, dim]}."""
    torch.set_num_threads(1)
    out = {}
    for name, (scheme, pos) in cases.items():
        ppos, n = PM.pad_to_multiple(torch.from_numpy(pos).to(mesh.device),
                                     mesh.ndev)
        m = ppos.shape[0] // mesh.ndev
        fn = PM.make_sharded_direct(mesh, eps2, kappa, dim=pos.shape[1],
                                    scheme=scheme)
        acc_l = fn(ppos[mesh.rank * m:(mesh.rank + 1) * m].contiguous())
        out[name] = _np(mesh.all_gather(acc_l))[:n]
    return out


def _engine(cfg_kw, n, group=None, L=None):
    """The port's kd engine, with the M2L group size forced when given
    (the engine reads CO_M2L_GROUP when it is constructed)."""
    import os
    old = os.environ.get("CO_M2L_GROUP")
    if group is not None:
        os.environ["CO_M2L_GROUP"] = str(group)
    try:
        return KdFmmEngine(SimConfig(**cfg_kw), n, L=L)
    finally:
        if group is not None:
            if old is None:
                del os.environ["CO_M2L_GROUP"]
            else:
                os.environ["CO_M2L_GROUP"] = old


def sharded_forces(mesh, cfg_kw, pos, vel, states, L=None):
    """The particle-sharded force and step, and the pair-sharded force,
    on reference-built states.  states: {"g8": fields, "g1": fields} host
    arrays of an FmmState built with M2L group 8 and 1."""
    torch.set_num_threads(1)
    dev = mesh.device
    n = pos.shape[0]
    cfg = SimConfig(**cfg_kw)
    x = torch.from_numpy(pos).to(dev)
    v = torch.from_numpy(vel).to(dev)
    out = {}
    eng = KdFmmEngine(cfg, n, L=L)
    fs = fmm_state_from_numpy(states["g8"], dev)
    ps, step_fn = make_psharded_step(eng, mesh, cfg, cfg.omega0_sq())
    lists, hops = shard_pair_lists(eng, fs, mesh.ndev)
    ppad = eng.pad_array(x, fs, fill=FAR)
    ppad_l = ps.shard_padded(ppad)
    out["shard_shape"] = tuple(ppad_l.shape)
    out["G_C"] = (eng.G_sub, eng.st.C)
    before = p2p_cuda.launches
    acc_l = ps.force_padded(ppad_l, fs, lists, hops)
    # one kernel launch a force evaluation on a CUDA rank, none on the CPU
    out["p2p_launches"] = p2p_cuda.launches - before
    acc_pad = ps.gather_padded(acc_l)
    out["pshard_force"] = _np(eng.unpad_array(acc_pad, fs))
    # the port's own single-device padded force on the same lists, without
    # the geometry refresh (the sharded path has none)
    out["single_force"] = _np(eng.unpad_array(eng.force_padded(ppad, fs),
                                              fs))
    out["hops"] = hops
    # one leapfrog step on the shards (a0 with the trap term, pads zeroed)
    from coulomb_oscillators_tpu_torch.ops.elastic import add_elastic
    lo = mesh.rank * ps.Gl
    mask_l = eng.mask3(dev)[lo:lo + ps.Gl, :, None]
    a0_l = torch.where(mask_l, add_elastic(ppad_l, acc_l, cfg.omega0_sq()),
                       0.0)
    pstate = ParticleState(ppad_l, ps.shard_padded(eng.pad_array(v, fs)),
                           a0_l)
    stepped = step_fn(pstate, fs, lists, hops)
    out["step_pos"] = _np(eng.unpad_array(ps.gather_padded(stepped.pos), fs))
    out["mesh_calls"] = dict(mesh.calls)
    # pair-sharded force (replicated positions), grouped and ungrouped M2L
    for key, group in (("g8", 8), ("g1", 1)):
        e = _engine(cfg_kw, n, group, L)
        f = fmm_state_from_numpy(states[key], dev)
        force = make_sharded_force(e, mesh)
        acc = force(x, f)
        out[f"shard_force_{key}"] = _np(acc)
        out[f"shard_force_{key}_equal"] = _all_equal(mesh, acc)
    return out


def mesh_simulator(mesh, runs, pos, vel):
    """runs: {name: (config kwargs, steps)}: the mesh-mode Simulator from
    init_acc over `steps`; per run the final positions, whether all ranks
    returned the same state and adopted the same lists, and the rebuild
    counts."""
    torch.set_num_threads(1)
    out = {}
    for name, (cfg_kw, steps) in runs.items():
        cfg = SimConfig(**cfg_kw)
        sim = Simulator(cfg, pos.shape[0], engine="fmm3_kd", mesh=mesh)
        try:
            st = sim.init_acc(particle_state_from_numpy(
                pos, vel, device=mesh.device))
            st = sim.run(st, steps)
            digest = state_digest(sim._fstate).to(mesh.device)
            out[name] = dict(
                pos=_np(st.pos), vel=_np(st.vel),
                states_equal=_all_equal(mesh, torch.cat([st.pos, st.vel,
                                                         st.acc])),
                lists_equal=_all_equal(mesh, digest),
                rebuilds=dict(sim.rebuilds),
                shard_shape=tuple(sim._padded.pos.shape),
                G_C=(sim._fmm.G_sub, sim._fmm.st.C))
        finally:
            sim.close()
    try:
        Simulator(SimConfig(), pos.shape[0], engine="fmm3", mesh=mesh)
    except ValueError as e:
        out["fmm3_error"] = str(e)
    return out


def parallel_scenarios(mesh, spec):
    """Everything tests/test_torch_parallel.py asks of one group of ranks,
    in one spawn: the collectives, and where `spec` holds them the sharded
    forces (per named case: arguments of :func:`sharded_forces`) and the
    sharded direct force (arguments of :func:`sharded_direct`)."""
    out = {"collectives": collectives(mesh, spec["seed"])}
    for name, args in spec.get("forces", {}).items():
        out[name] = sharded_forces(mesh, *args)
    if "direct" in spec:
        out["direct"] = sharded_direct(mesh, *spec["direct"])
    return out
