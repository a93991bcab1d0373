"""Driver ``window``: the kd engine's production loop, one reuse window
after another through ``Simulator.advance_padded``, never unpadding.

Traffic keys: ``sim`` (the cadence: ``tree_steps``, ``tree_resort_every``,
``tree_pipeline``), ``warmup_windows`` (windows run in set-up: the first
adoptions and the step graph's first captures), ``steps_per_s`` and
``trace_steps`` (the window's work, in whole windows of ``tree_steps``,
and its traced tail: ``harness.py``), and ``check`` (``targets``,
``every``).
"""

from __future__ import annotations

import time

from benchmark import program as P


def setup(ctx) -> None:
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
    cfg = P.sim_config(ctx.config, ctx.workload)
    pos, vel = P.make_beam(ctx.config, cfg, ctx.seed)
    sim = Simulator(cfg, ctx.config["n"], engine=ctx.config["engine"])
    ctx.sim = sim
    ctx.inst = P.Instrumented(sim, ctx.trace)
    st = sim.init_acc(particle_state_from_numpy(pos, vel, device=ctx.device))
    ctx.start = {"pos": pos, "acc": P.host_state(st)["acc"]}
    ctx.state = None
    for _ in range(int(ctx.workload["warmup_windows"])):
        sim.advance_padded(max(cfg.tree_steps, 1))
    ctx.sync()


def window(ctx) -> None:
    sim = ctx.sim
    ts = max(sim.config.tree_steps, 1)
    steps = 0
    t0 = time.perf_counter()
    while not ctx.window_done(steps):
        ctx.tick(steps)
        sim.advance_padded(ts)
        steps += ts
    ctx.sync()
    ctx.window_s = time.perf_counter() - t0
    ctx.steps = steps


def collect(ctx) -> dict:
    sim = ctx.sim

    def step():
        sim.advance_padded(1)
        return sim.current_state()

    return {"start": ctx.start,
            "steps": P.steps_after(ctx, P.host_state(sim.current_state()),
                                   step)}
