"""Driver ``cli_loop``: the program's command-line run (``cli._run``), a
``Simulator.run`` of ``snapshot_every`` steps and then a snapshot of the
unpadded state in the reference's byte format (``utils/io.write_state``),
again and again, into a directory under the temporary directory.

Traffic keys: ``sim`` (cadence keys, if any), ``snapshot_every``,
``warmup_blocks`` (runs of ``snapshot_every`` steps in set-up, after the
CLI's first step and snapshot 0), ``steps_per_s`` and ``trace_steps``
(the window's work, in whole blocks of ``snapshot_every``, and its traced
tail: ``harness.py``), and ``check`` (``targets``, ``every``).
The time of each ``write_state`` call is kept for ``snapshot_ms``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from benchmark import program as P
from benchmark import trace as T
from benchmark.reference import snapshot as S


def setup(ctx) -> None:
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
    cfg = P.sim_config(ctx.config, ctx.workload)
    pos, vel = P.make_beam(ctx.config, cfg, ctx.seed)
    sim = Simulator(cfg, ctx.config["n"], engine=ctx.config["engine"])
    ctx.sim = sim
    ctx.inst = P.Instrumented(sim, ctx.trace)
    ctx.outdir = tempfile.mkdtemp(prefix="bench_snapshots_")
    ctx.cleanup.append(lambda d=ctx.outdir: shutil.rmtree(d, True))
    ctx.snapshot_s = []
    st = sim.init_acc(particle_state_from_numpy(pos, vel, device=ctx.device))
    ctx.start = {"pos": pos, "acc": P.host_state(st)["acc"]}
    ctx.state = _run(ctx, st, 1)
    ctx.it = 0
    _snapshot(ctx)
    for _ in range(int(ctx.workload["warmup_blocks"])):
        _block(ctx)
    ctx.sync()
    ctx.snapshot_s = []


def _run(ctx, st, k):
    with T.span("bench.run", ctx.trace):
        return ctx.sim.run(st, k)


def _snapshot(ctx) -> None:
    from coulomb_oscillators_tpu_torch.utils import io as SIO
    with T.span("bench.snapshot", ctx.trace):
        st = ctx.state
        pos = st.pos.cpu().numpy().astype(np.float32)
        vel = st.vel.cpu().numpy().astype(np.float32)
        path = SIO.snapshot_name(ctx.outdir, ctx.it, ctx.sim.config.dt)
        t0 = time.perf_counter()
        SIO.write_state(path, pos, vel)
        ctx.snapshot_s.append(time.perf_counter() - t0)
    ctx.last_snapshot = {"path": path, "pos": pos, "vel": vel}


def _block(ctx) -> None:
    k = int(ctx.workload["snapshot_every"])
    ctx.state = _run(ctx, ctx.state, k)
    ctx.it += k
    _snapshot(ctx)


def window(ctx) -> None:
    steps = 0
    t0 = time.perf_counter()
    while not ctx.window_done(steps):
        ctx.tick(steps)
        _block(ctx)
        steps += int(ctx.workload["snapshot_every"])
    ctx.sync()
    ctx.window_s = time.perf_counter() - t0
    ctx.steps = steps


def collect(ctx) -> dict:
    snap = ctx.last_snapshot
    first = P.host_state(ctx.state)
    if os.path.getsize(snap["path"]) == 2 * first["pos"].nbytes:
        # the step chain starts from the bytes on disk
        first["pos"], first["vel"] = S.read(snap["path"])

    def step():
        ctx.state = _run(ctx, ctx.state, 1)
        return ctx.state

    return {"start": ctx.start, "snapshot": snap,
            "steps": P.steps_after(ctx, first, step)}
