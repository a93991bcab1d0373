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


def _engine(cfg_kw, n, group=None, L=None, fly=None):
    """The port's kd engine, with the M2L group size and the M2L mode
    forced when given (the engine reads CO_M2L_GROUP and CO_M2L_FLY when
    it is constructed)."""
    import os
    env = {k: str(v) for k, v in (("CO_M2L_GROUP", group),
                                  ("CO_M2L_FLY", fly)) if v is not None}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return KdFmmEngine(SimConfig(**cfg_kw), n, L=L)
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def stored_forces(mesh, cfg_kw, pos, state):
    """Stored-fold M2L (CO_M2L_FLY=0) on a reference-built stored-mode
    state: the particle-sharded force, the pair-sharded force and the
    single-device padded force, all on the same lists."""
    torch.set_num_threads(1)
    dev = mesh.device
    n = pos.shape[0]
    x = torch.from_numpy(pos).to(dev)
    eng = _engine(cfg_kw, n, fly=0)
    fs = fmm_state_from_numpy(state, dev)
    ps, _ = make_psharded_step(eng, mesh, SimConfig(**cfg_kw),
                               SimConfig(**cfg_kw).omega0_sq())
    lists, hops = shard_pair_lists(eng, fs, mesh.ndev)
    ppad = eng.pad_array(x, fs, fill=FAR)
    acc_pad = ps.gather_padded(ps.force_padded(ps.shard_padded(ppad), fs,
                                               lists, hops))
    loc = ps.localize(lists, hops, dev)
    return {"m2l_fly": eng.m2l_fly,
            "local_fold_rows": tuple(loc.m2l_h2.shape),
            "pshard_force": _np(eng.unpad_array(acc_pad, fs)),
            "shard_force": _np(make_sharded_force(eng, mesh)(x, fs)),
            "single_force": _np(eng.unpad_array(eng.force_padded(ppad, fs),
                                                fs))}


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
    forces (per named case: arguments of :func:`sharded_forces`), the
    sharded direct force (arguments of :func:`sharded_direct`) and the
    stored-fold forces (arguments of :func:`stored_forces`)."""
    out = {"collectives": collectives(mesh, spec["seed"])}
    for name, args in spec.get("forces", {}).items():
        out[name] = sharded_forces(mesh, *args)
    if "direct" in spec:
        out["direct"] = sharded_direct(mesh, *spec["direct"])
    if "stored" in spec:
        out["stored"] = stored_forces(mesh, *spec["stored"])
    return out


def _group_threads() -> list:
    """Names of this process's threads that belong to a gloo process group
    (its worker threads ``pt_gloo_runloop`` and its transport thread
    ``gloo_tcp_loop``), read from /proc."""
    import os
    names = []
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                name = f.read().strip()
        except OSError:       # the thread ended meanwhile
            continue
        if "gloo" in name:
            names.append(name)
    return sorted(names)


def _exit_if_group_threads() -> None:
    """Exit with code 3 if a gloo thread is still alive.  A thread joined
    just before can stay listed in /proc for a moment, so the check waits
    up to 2 s for the list to empty; a group that was never freed keeps
    its threads for good."""
    import os
    import sys
    import time
    deadline = time.monotonic() + 2.0
    left = _group_threads()
    while left and time.monotonic() < deadline:
        time.sleep(0.05)
        left = _group_threads()
    if left:
        print(f"rank exits with the group's threads alive: {left}",
              file=sys.stderr, flush=True)
        os._exit(3)


def teardown(mesh, steps):
    """Ends the way a ``-chips`` run's ranks end: a mesh-mode Simulator
    (whose step closures hold it, and so the mesh, in a reference cycle)
    runs `steps` steps across a rebuild boundary and is closed; the rank
    then leaves through ``parallel.mesh``'s teardown.  At exit, before the
    interpreter finalises (``atexit``), the rank ends with code 3 if a
    thread of the gloo group is still alive: the group's destructor did
    not run while the interpreter could still serve those threads."""
    import atexit
    atexit.register(_exit_if_group_threads)
    torch.set_num_threads(1)
    n = 64 * mesh.ndev
    cfg = SimConfig(fmm_order=3, tree_radius=2.0, tree_steps=2, tree_L=3)
    sim = Simulator(cfg, n, engine="fmm3_kd", mesh=mesh)
    try:
        rng = np.random.default_rng(0)
        pos = (rng.normal(size=(n, 3)) * 1e-3).astype(np.float32)
        st = sim.init_acc(particle_state_from_numpy(
            pos, np.zeros_like(pos), device=mesh.device))
        st = sim.run(st, steps)
    finally:
        sim.close()
    return bool(torch.isfinite(st.pos).all())


# the collectives by the code a segment record carries for them
CUT_CODES = {"all_gather": 1, "all_reduce_sum": 2, "ring_shift": 3}


def _record_step(mesh, rec, fn):
    """Run `fn` with every ATen op recorded into `rec` (the capture lint's
    recorder) and every collective made a cut: the ops between two
    collectives form a segment, and a collective's own ops (its staging)
    are run unrecorded, as a replay runs them between two graphs.
    Returns (segments: list of op lists, collective names in order)."""
    from torch.utils._python_dispatch import _disable_current_modes
    from coulomb_oscillators_tpu_torch.utils import graphs
    segments, cuts = [[]], []
    real = graphs.collective

    def cut(f, x, out_shape, out_dtype=None):
        before = dict(mesh.calls)
        with _disable_current_modes():
            out = real(f, x, out_shape, out_dtype)
        segments[-1].extend(rec.ops)
        rec.ops.clear()
        segments.append([])
        cuts.extend(k for k in mesh.calls
                    if mesh.calls[k] != before.get(k, 0))
        return out

    graphs.collective = cut
    try:
        with rec:
            fn()
    finally:
        graphs.collective = real
    segments[-1].extend(rec.ops)
    rec.ops.clear()
    return segments, cuts


def _mesh_lint_case(mesh, engine, n, dim):
    """One engine's mesh-mode Simulator under the lint's recorder: steps
    1 and 2 of a window, then a step after the pipeline's priming refresh
    and one after an adopted background re-sort.  Returns this rank's
    record."""
    from test_torch_capture_lint import _Recorder
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    x_std = (0.003, 0.001, 0.01)[:dim]
    pos, vel = ID.init_gaussian(n, x_std, x_std, dim=dim, seed=3)
    cfg = SimConfig(dim=dim, fmm_order=3, tree_radius=2.0, tree_steps=3,
                    omega0=(1.0,) * dim, tree_async=True)
    sim = Simulator(cfg, n, engine=engine, mesh=mesh)
    rec = _Recorder()
    try:
        sim.init_acc(particle_state_from_numpy(pos, vel, device=mesh.device))
        sim.advance_padded(1)                          # warm-up
        steps = [_record_step(mesh, rec, lambda: sim.advance_padded(1)),
                 _record_step(mesh, rec, lambda: sim.advance_padded(1))]
        sim.start_window()                             # priming refresh
        steps.append(_record_step(mesh, rec, lambda: sim.advance_padded(1)))
        sim.advance_padded(2)
        sim.start_window()                             # adopted re-sort
        steps.append(_record_step(mesh, rec, lambda: sim.advance_padded(1)))
        halo = sim._pfrozen[1].hops
        out = dict(rebuilds=dict(sim.rebuilds), bad=list(rec.bad),
                   halo=halo, cuts=[c for _, c in steps],
                   same_ops=[s == steps[0][0] for s, _ in steps[1:]],
                   segments=[len(s) for s, _ in steps],
                   eager=sim.graph is None)
    finally:
        sim.close()
    codes = torch.zeros(16, dtype=torch.int64)
    for i, c in enumerate(out["cuts"][0]):
        codes[i] = CUT_CODES[c]
    out["cuts_equal_across_ranks"] = _all_equal(mesh, codes)
    return out


def _entries_case(mesh, dim):
    """The rank's sharded near field over its padded entry list against
    the plain sum over its CSR, on the halo blocks of a beam."""
    from coulomb_oscillators_tpu_torch.parallel.fmm_pshard import (
        PShardedKdFmm)
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    n = 2048
    cfg = SimConfig(dim=dim, fmm_order=3, tree_radius=2.0,
                    omega0=(1.0,) * dim)
    x_std = (0.003, 0.001, 0.01)[:dim]
    pos, _ = ID.init_gaussian(n, x_std, x_std, dim=dim, seed=4)
    eng = KdFmmEngine(cfg, n)
    fs = eng.build(torch.from_numpy(pos))
    ps = PShardedKdFmm(eng, mesh)
    lists, hops = shard_pair_lists(eng, fs, mesh.ndev)
    loc = ps.localize(lists, hops, "cpu")
    cat = ps.halo_blocks(ps.shard_padded(eng.pad_array(
        torch.from_numpy(pos), fs, fill=FAR)), loc)
    csr = p2p_cuda.p2p_plain(cat, loc.row_ptr, loc.col2d, eng.nsub,
                             cfg.eps2)
    lst = p2p_cuda.p2p_plain_entries(cat, loc.p2p_tgt, loc.p2p_src,
                                     eng.nsub, cfg.eps2)
    pads = int((loc.p2p_tgt == loc.col2d.shape[0]).sum())
    ok = (torch.equal(lst, csr)
          and torch.equal(ps.near_padded(cat, loc), csr[:ps.Glb])
          and pads > 0 and bool(torch.isfinite(csr).all()))
    return bool(mesh.all_gather(torch.tensor([ok])).all())


def mesh_graph_scenarios(mesh, cases):
    """What tests/test_torch_mesh_graphs.py asks of one group of CPU
    ranks: per case of `cases` ({name: (engine, n, dim)}) the lint record
    of the mesh step; the rank-consistent re-capture vote; the entries
    form of the near field against the CSR form in dims 2 and 3."""
    from coulomb_oscillators_tpu_torch.simulate import any_rank
    from coulomb_oscillators_tpu_torch.utils.graphs import StepGraph
    torch.set_num_threads(1)
    out = {name: _mesh_lint_case(mesh, *args)
           for name, args in cases.items()}
    # the vote: a key that changed on one rank only (its col2d grew, as
    # an adoption with a higher degree does) is a re-capture everywhere
    st = ParticleState(*(torch.zeros(4, 3) for _ in range(3)))
    loc = (torch.zeros(6, 128, dtype=torch.int32), (1,))
    grown = (torch.zeros(6, 256 if mesh.rank == 0 else 128,
                         dtype=torch.int32), (1,))
    key = StepGraph._key_of(st, loc, ())
    changed = StepGraph._key_of(st, grown, ()) != key
    unchanged = StepGraph._key_of(st, (loc[0].clone(), (1,)), ()) != key
    votes = [any_rank(mesh, changed), any_rank(mesh, unchanged),
             any_rank(mesh, mesh.rank == 1)]
    out["votes"] = votes
    out["votes_equal"] = _all_equal(mesh, torch.tensor(votes))
    out["changed_here"] = _all_equal(mesh, torch.tensor([changed]))
    out["entries"] = {dim: _entries_case(mesh, dim) for dim in (2, 3)}
    return out


def mesh_graph_modes(mesh, cfg_kw, pos, vel, windows, runs):
    """runs: [(graphs on, rank that grows its col2d capacity or None)]:
    per run the mesh-mode Simulator from init_acc over `windows` windows
    of tree_steps with ``CO_CUDA_GRAPHS`` 1 or 0.  The growing rank alone
    raises its near-field degree capacity after the first window, so the
    next adoption changes its capture key only.  Per run: rank 0's
    positions, and every rank's captures, segments, P2P launches and
    col2d width; whether all ranks returned the same state."""
    import os
    torch.set_num_threads(1)
    cfg = SimConfig(**cfg_kw)
    out = []
    for graphs_on, grow_rank in runs:
        os.environ["CO_CUDA_GRAPHS"] = "1" if graphs_on else "0"
        try:
            sim = Simulator(cfg, pos.shape[0], engine="fmm3_kd", mesh=mesh)
        finally:
            del os.environ["CO_CUDA_GRAPHS"]
        before = p2p_cuda.launches
        try:
            sim.init_acc(particle_state_from_numpy(pos, vel,
                                                   device=mesh.device))
            for w in range(windows):
                sim.advance_padded(cfg.tree_steps)
                if w == 0 and grow_rank == mesh.rank:
                    sim._fmm._pshard_caps["dmax"] += 128
            st = sim.current_state()
            g = sim.graph
            row = [g.captures if g else 0, g.segments if g else 0,
                   p2p_cuda.launches - before,
                   sim._pfrozen[1].col2d.shape[1]]
        finally:
            sim.close()
        rows = mesh.all_gather(torch.tensor([row], device=mesh.device))
        out.append(dict(pos=_np(st.pos), per_rank=_np(rows).tolist(),
                        states_equal=_all_equal(
                            mesh, torch.cat([st.pos, st.vel, st.acc])),
                        rebuilds=dict(sim.rebuilds)))
    return out
