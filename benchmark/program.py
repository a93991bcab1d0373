"""What the drivers share: the program under test built from a
configuration and a traffic file, the harness's own spans and samples
around its calls into the program's layers, and the steps after the
window that the comparison reads.

The program is ``coulomb_oscillators_tpu_torch``, imported here and in the
drivers only.  Its Simulator is wrapped per instance, never edited:

  * ``start_window`` (the window boundary: adoption, repad, the next
    rebuild's submission) runs inside a ``bench.boundary`` span, and after
    a boundary that adopted a full re-sort the host seconds of that
    rebuild (``KdFmmEngine.last_build_times``, which keeps only the last
    one) are sampled;
  * ``_scan_step`` (the window's steps: CUDA-graph replays) runs inside a
    ``bench.replay`` span and, in a traced run, notes which near lists
    each of its force evaluations ran (a capture's warm-up is one more);
  * ``current_state`` (the unpad) runs inside ``bench.unpad``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import beam as B
from benchmark import trace as T
from benchmark import work as W


def sim_config(config: dict, workload: dict):
    """The program's SimConfig: the configuration's ``sim`` keys, then the
    traffic's."""
    from coulomb_oscillators_tpu_torch import SimConfig
    kw = dict(config["sim"])
    kw.update(workload.get("sim", {}))
    for k, v in kw.items():
        if isinstance(v, list):
            kw[k] = tuple(v)
    return SimConfig(**kw)


def make_beam(config: dict, cfg, seed: int):
    """The seeded beam of a configuration (host float32 arrays), by its
    ``beam.kind``: ``"gaussian"`` (the default) with u_std = omega0 *
    x_std, as the reference's CLI sets it, or ``"kv"``, the upstream 2D
    program's KV beam of the semi-axes ``beam.A`` and depressed phase
    advances ``beam.omega`` the file states."""
    beam = config["beam"]
    kind = beam.get("kind", "gaussian")
    if kind == "kv":
        return B.kv(config["n"], beam["A"], beam["omega"], seed)
    if kind != "gaussian":
        raise ValueError(f"no beam of kind {kind!r}")
    x_std = beam["x_std"]
    u_std = [w * x for w, x in zip(cfg.omega0, x_std)]
    return B.gaussian(config["n"], x_std, u_std, seed)


class Instrumented:
    """A Simulator with the harness's spans and samples (module
    docstring).  `lists` is kept only while `record_lists` is set."""

    def __init__(self, sim, trace_on: bool):
        self.sim = sim
        self.trace_on = trace_on
        self.record_lists = False
        self.in_window = False
        self.full_build_s = []
        self.full_build_parts = []
        self.lists = {}
        self.window_steps = 0
        self.captures_at = []     # (window step, caps) of each capture
        self._orig = {k: getattr(sim, k) for k in
                      ("start_window", "_scan_step", "current_state")}
        sim.start_window = self._start_window
        sim._scan_step = self._scan_step
        sim.current_state = self._current_state

    def _start_window(self):
        sim = self.sim
        before = sim.rebuilds["adopt_full"]
        with T.span("bench.boundary", self.trace_on):
            self._orig["start_window"]()
        if sim.rebuilds["adopt_full"] > before:
            parts = {k: float(v)
                     for k, v in sim._fmm.last_build_times.items()}
            self.full_build_s.append(sum(parts.values()))
            self.full_build_parts.append(parts)

    def _scan_step(self, state, frozen, k):
        g = self.sim.graph
        c0 = g.captures if g is not None else 0
        with T.span("bench.replay", self.trace_on):
            out = self._orig["_scan_step"](state, frozen, k)
        g = self.sim.graph
        extra = (g.captures if g is not None else 0) - c0
        if self.in_window:
            if extra:
                self.captures_at.append((self.window_steps,
                                         dict(self.sim._fmm.caps)))
            self.window_steps += k
        if self.record_lists:
            key = (frozen.p2p_row_ptr.data_ptr(), frozen.p2p_col2d.data_ptr())
            ent = self.lists.setdefault(
                key, [frozen.p2p_row_ptr, frozen.p2p_col2d, 0])
            ent[2] += (k + extra) * W.FORCE_EVALS[self.sim.config.integrator]
        return out

    def _current_state(self):
        with T.span("bench.unpad", self.trace_on):
            return self._orig["current_state"]()

    def p2p_bound_ms(self) -> float:
        """The roofline bound of every P2P evaluation noted, summed; frees
        the lists."""
        eng = self.sim._fmm
        total = 0.0
        for row_ptr, col2d, evals in self.lists.values():
            w = W.p2p_work(row_ptr, col2d, eng.nsub, eng.n, eng.L,
                           eng.st.C, eng.dim)
            total += evals * W.bound_ms(w["pairs"], w["bytes"], eng.dim)
        self.lists = {}
        return total


def host_state(st) -> dict:
    """A ParticleState as host float32 arrays."""
    return {k: getattr(st, k).detach().cpu().numpy().astype(np.float32)
            for k in ("pos", "vel", "acc")}


def steps_after(ctx, first: dict, step) -> list:
    """The states the comparison reads: `first` (the state the window
    ended with), then one state per call of `step` (one step through the
    driver module's own entry point, returning the ParticleState), until a
    full re-sort has been adopted and the windows its lists serve
    (``tree_resort_every`` x ``tree_steps`` steps) are done.  The force is
    checked at `first`, at the adoption's step, every ``check.every``
    steps after it and at each window's last step."""
    sim = ctx.sim
    cfg = sim.config
    ts = max(cfg.tree_steps, 1)
    cycle = max(1, int(cfg.tree_resort_every)) * ts
    every = int(ctx.workload["check"]["every"])
    out = [dict(first, force=True)]
    adopted = None
    limit = 4 * cycle + 2 * ts + 8
    for i in range(1, limit + 1):
        before = sim.rebuilds["adopt_full"]
        st = host_state(step())
        if adopted is None and sim.rebuilds["adopt_full"] > before:
            adopted = i
        rel = None if adopted is None else i - adopted
        st["force"] = rel is not None and (rel % every == 0
                                           or (rel + 1) % ts == 0)
        out.append(st)
        if rel is not None and rel == cycle - 1:
            return out
    raise RuntimeError(f"no full re-sort was adopted in {limit} steps")


def release(ctx) -> None:
    """Stop the program and give its device memory back before the
    reference runs."""
    import gc
    if ctx.sim is not None:
        ctx.sim.close()
    ctx.sim = ctx.inst = ctx.state = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
