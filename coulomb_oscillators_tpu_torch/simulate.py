"""Simulation driver: integrator x force engine, with the kd engine's
async rebuild pipeline.

Twin of ``coulomb_oscillators_tpu/simulate.py`` (reference sim loop
main3.cu:832-874).  Three paths:

  * the plain engines ("direct", "direct_ref"): the integrator steps the
    oscillator force in a Python loop (the twin's jitted fori_loop);
  * the uniform-grid engines ("fmm3", "fmm3_traceless", "fmm2",
    "fmm2_traceless", "appel"): a synchronous rebuild every `tree_steps`
    iterations, then `k` steps on the original-order state;
  * the kd engines (tree rebuilt every `tree_steps` iterations,
    fmm_cart3_kdtree.cuh:1619-1642): between rebuilds the state lives as
    padded [G, C, dim] leaf blocks and the integrator runs as a Python loop
    of `k` steps; at window boundaries the rebuild pipeline adopts a tree
    built in a background thread from an earlier boundary's positions —
    by the native host builder, or with ``tree_async_build="device"`` by
    the device builders.

Not ported (ROADMAP.md): mesh mode.
"""

from __future__ import annotations

import collections
import concurrent.futures
import time

import numpy as np
import torch

from coulomb_oscillators_tpu_torch import native
from coulomb_oscillators_tpu_torch.config import SimConfig
from coulomb_oscillators_tpu_torch.models import integrators as I
from coulomb_oscillators_tpu_torch.ops.elastic import add_elastic
from coulomb_oscillators_tpu_torch.state import ParticleState

STALE_MARGIN_FACTOR = 2.0


def auto_stale_margin(vel, config: SimConfig) -> np.ndarray:
    """Per-axis traversal-time MAC slack for frozen pair lists:
    rms|v_axis| * dt * max_list_age * 2 (the twin explains the factor and
    the list ages).  `vel` is a tensor or a host array; the mean runs in
    float64.  Returns a [dim] float64 vector (zeros when lists never go
    stale)."""
    ts = max(config.tree_steps, 1)
    if ts <= 1:
        return np.zeros(config.dim)
    if not config.tree_async:
        age = ts
    elif max(1, int(config.tree_resort_every)) > 1:
        age = 2 * ts
    else:
        age = (max(1, int(config.tree_pipeline)) + 1) * ts
    if isinstance(vel, torch.Tensor):
        vel = vel.detach().cpu().numpy()
    vrms_ax = np.sqrt(np.mean(np.asarray(vel, np.float64) ** 2, axis=0))
    return vrms_ax * config.dt * age * STALE_MARGIN_FACTOR


class _HostCopy:
    """A device tensor copied to pinned host memory without blocking the
    stream; :meth:`numpy` waits for the copy only."""

    def __init__(self, x: torch.Tensor):
        if x.device.type == "cuda":
            self._buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._buf.copy_(x, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(x.device))
        else:
            self._buf = x.detach().clone()
            self._done = None

    def numpy(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._buf.numpy()


class Simulator:
    """Runs the Coulomb-oscillator system with any force engine."""

    def __init__(self, config: SimConfig, n: int, engine: str = "fmm3_kd",
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh mode is not ported yet: ROADMAP.md queue 1, item 10")
        self.config = config
        self.n = n
        self.engine_name = engine
        self.omega0_sq = config.omega0_sq()
        self._fmm = None
        self._fstate = None
        self._padded = None       # kd engine: ParticleState of [G, C, dim]
        self._pending = None      # in-flight device rebuild
        if not (engine.startswith("fmm") or engine == "appel"):
            from coulomb_oscillators_tpu_torch.models.oscillator import (
                make_oscillator_force)
            self._plain_force = make_oscillator_force(config, n, engine)
            self._plain_step = I.make_step(self._plain_force,
                                           config.integrator, config.dt)
            return
        from coulomb_oscillators_tpu_torch.ops import fmm as fmm_mod
        self._fmm = fmm_mod.make_engine_object(config, n, engine)
        self._steps_since_build = 0
        self._last_out = None
        # host-async rebuild pipeline: queue of (due_boundary, kind, future)
        self._pqueue = collections.deque()
        self._boundary_i = 0
        self._last_full = None
        self._pool = None
        self.last_rebuild_wait = 0.0
        # rebuilds by kind, for diagnostics: adopted full re-sorts (with
        # repad), adopted refreshes, synchronous refreshes, synchronous
        # full builds
        self.rebuilds = collections.Counter()
        self._use_padded = hasattr(self._fmm, "force_padded")
        self._scan_step = (self._make_fmm_scan_padded() if self._use_padded
                           else self._make_fmm_scan())

    # ------------------------------------------------------------------ #
    def _make_fmm_scan(self):
        """Window loop on the original-order state (uniform-grid engines):
        `k` steps against the frozen tree."""
        eng = self._fmm
        cfg = self.config
        omega0_sq = self.omega0_sq

        def scan_k(state, fstate, k):
            step = I.make_step(
                lambda p: add_elastic(p, eng.force(p, fstate), omega0_sq),
                cfg.integrator, cfg.dt)
            for _ in range(k):
                state = step(state)
            return state

        return scan_k

    # ------------------------------------------------------------------ #
    def _make_fmm_scan_padded(self):
        """Window loop on padded [G, C, dim] leaf blocks.  With
        config.geom_refresh (default, and only when lists are reused) every
        force eval first recomputes expansion geometry from the live
        positions; lists stay frozen."""
        eng = self._fmm
        cfg = self.config
        omega0_sq = self.omega0_sq
        geo = cfg.geom_refresh and cfg.tree_steps > 1

        def force(ppad, fstate):
            if geo:
                fstate = eng.geom_refresh(ppad, fstate)
            acc = eng.force_padded(ppad, fstate)
            acc = add_elastic(ppad, acc, omega0_sq)
            # pad slots park at FAR: their trap term is huge — zero it so
            # pad velocities stay 0 and pad positions stay put
            return torch.where(eng.mask3(ppad.device)[..., None], acc, 0.0)

        def scan_k(pstate, fstate, k):
            step = I.make_step(lambda p: force(p, fstate),
                               cfg.integrator, cfg.dt)
            for _ in range(k):
                pstate = step(pstate)
            return pstate

        return scan_k

    def _pad_state(self, state: ParticleState) -> ParticleState:
        from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR
        eng, fs = self._fmm, self._fstate
        return ParticleState(eng.pad_array(state.pos, fs, fill=FAR),
                             eng.pad_array(state.vel, fs),
                             eng.pad_array(state.acc, fs))

    def _unpad_state(self, pstate: ParticleState) -> ParticleState:
        eng, fs = self._fmm, self._fstate
        return ParticleState(eng.unpad_array(pstate.pos, fs),
                             eng.unpad_array(pstate.vel, fs),
                             eng.unpad_array(pstate.acc, fs))

    # ------------------------------------------------------------------ #
    def init_acc(self, state: ParticleState) -> ParticleState:
        """Precompute a0 (main3.cu:835-839); the kd engine builds its tree
        first."""
        if self._fmm is None:
            return state._replace(acc=self._plain_force(state.pos))
        self._set_stale_margin(state)
        self._fstate = self._fmm.build(state.pos)
        self._steps_since_build = 0
        acc = self._fmm.force(state.pos, self._fstate)
        out = state._replace(acc=add_elastic(state.pos, acc, self.omega0_sq))
        if self._use_padded:
            self._padded = self._pad_state(out)
            self._last_out = out
        return out

    def _set_stale_margin(self, state: ParticleState) -> None:
        """Temporal MAC slack: config.stale_margin >= 0 is explicit,
        < 0 derives the per-axis vector (auto_stale_margin)."""
        sm = float(self.config.stale_margin)
        self._fmm.stale_margin_abs = (sm if sm >= 0.0 else
                                      auto_stale_margin(state.vel,
                                                        self.config))

    def run(self, state: ParticleState, steps: int) -> ParticleState:
        """Advance `steps` iterations, rebuilding the tree as configured."""
        if self._fmm is None:
            return I.nsteps(self._plain_step, state, steps)
        if not self._use_padded:
            return self._run_unpadded(state, steps)
        # a state we did not hand out (or a cold start) enters padded form
        if (self._padded is None or self._fstate is None
                or state is not self._last_out):
            self._drop_pending()
            self._fstate = self._fmm.build(state.pos)
            self._steps_since_build = 0
            self._padded = self._pad_state(state)
        self.advance_padded(steps)
        return self.current_state()

    def _run_unpadded(self, state: ParticleState,
                      steps: int) -> ParticleState:
        """Uniform-grid engines: a synchronous rebuild every `tree_steps`
        iterations, then up to `tree_steps` steps against it."""
        ts = max(self.config.tree_steps, 1)
        done = 0
        while done < steps:
            if self._fstate is None or self._steps_since_build >= ts:
                self._fstate = self._fmm.build(state.pos)
                self._steps_since_build = 0
                self.rebuilds["sync_full"] += 1
            k = min(ts - self._steps_since_build, steps - done)
            state = self._scan_step(state, self._fstate, k)
            self._steps_since_build += k
            done += k
        return state

    def advance_padded(self, steps: int) -> torch.Tensor:
        """Advance on the padded path without unpadding at the end; returns
        the padded positions.  Requires an active padded run (init_acc or
        run first); :meth:`current_state` unpads."""
        if self._padded is None or self._fstate is None:
            raise RuntimeError("advance_padded requires an active padded "
                               "run (call init_acc + run first)")
        ts = max(self.config.tree_steps, 1)
        done = 0
        while done < steps:
            if self._steps_since_build >= ts:
                self._rebuild_padded()
                self._steps_since_build = 0
            k = min(ts - self._steps_since_build, steps - done)
            self._padded = self._scan_step(self._padded, self._fstate, k)
            self._steps_since_build += k
            done += k
        self._last_out = None     # handed-out states are now stale
        return self._padded.pos

    def current_state(self) -> ParticleState:
        """Unpad and return the current state (resumable via run())."""
        out = self._unpad_state(self._padded)
        self._last_out = out
        return out

    def _rebuild_padded(self) -> None:
        """Window-boundary rebuild of the padded state.

        Async (config.tree_async): a FULL re-sort (host kd + traversal from
        a host copy of this boundary's positions) every `tree_resort_every`
        (K) boundaries, adopted `tree_pipeline` (D) boundaries later through
        a composed old -> new padded-layout gather (repad); a background
        REFRESH (exact bounds on the current permutation) at the other
        boundaries, adopted at the next one.  The first boundary primes the
        pipeline with a synchronous refresh.  With
        ``tree_async_build="device"`` each boundary instead adopts the
        device rebuild submitted at the previous one (a refresh primes the
        first).  Sync (or a host builder without the native library): the
        reference's blocking rebuild."""
        eng = self._fmm
        device = self._padded.pos.device
        use_device = self.config.tree_async_build == "device"
        if not self.config.tree_async or not (use_device
                                              or native.available()):
            cur = self._unpad_state(self._padded)
            self._fstate = eng.build(cur.pos)
            self._padded = self._pad_state(cur)
            self.rebuilds["sync_full"] += 1
            return
        if use_device:
            # the job sorts on the device from original-order positions
            # (unpad here, repad at adoption)
            cur = self._unpad_state(self._padded)
            if self._pending is not None:
                t0 = time.perf_counter()
                self._fstate = self._pending.result()
                self.last_rebuild_wait = time.perf_counter() - t0
                self._padded = self._pad_state(cur)
                self.rebuilds["adopt_device"] += 1
            else:
                self._fstate = eng.refresh(self._padded.pos, self._fstate)
                self.rebuilds["sync_refresh"] += 1
            self._pending = self._executor().submit(
                lambda p=cur.pos: eng.adopt(eng.build_device_async(p),
                                            device))
            return

        D = max(1, int(self.config.tree_pipeline))
        K = max(1, int(self.config.tree_resort_every))
        i = self._boundary_i
        self._boundary_i += 1

        if self._pqueue and self._pqueue[0][0] <= i:
            _, kind, fut = self._pqueue.popleft()
            t0 = time.perf_counter()
            res = fut.result()
            self.last_rebuild_wait = time.perf_counter() - t0
            if kind == "full":
                fs_new, remap = res
                self._padded = ParticleState(*eng.repad_triple(
                    self._padded.pos, self._padded.vel, self._padded.acc,
                    remap))
                self._fstate = fs_new
            else:
                self._fstate = res
            self.rebuilds["adopt_" + kind] += 1
            # collision safety: drop any other job due at this boundary
            while self._pqueue and self._pqueue[0][0] <= i:
                self._pqueue.popleft()[2].result()
        elif not self._pqueue:
            # pipeline priming: exact bounds on the current permutation
            self._fstate = eng.refresh(self._padded.pos, self._fstate)
            self.rebuilds["sync_refresh"] += 1

        fs_cur = self._fstate
        ppad = self._padded.pos
        if i % K == 0:
            # the next FULL re-sort, from a host copy of this boundary's
            # positions; its repad maps from the layout current at ITS
            # adoption (the previous full job's result; the single worker
            # runs jobs in order)
            prev = self._last_full
            ppad_h = _HostCopy(ppad)
            inv_h = _HostCopy(fs_cur.inv_perm)

            def job(ppad_h=ppad_h, inv_h=inv_h, prev=prev, fs_cur=fs_cur):
                fs_new = eng.adopt(eng.build_host_padded(
                    ppad_h.numpy(), inv_h.numpy()), device)
                fs_old = prev.result()[0] if prev is not None else fs_cur
                return fs_new, eng.make_repad(fs_old, fs_new)

            fut = self._executor().submit(job)
            self._last_full = fut
            self._pqueue.append((i + D, "full", fut))
        elif (i + 1 - D) % K != 0:
            # background refresh, adopted next boundary (skipped when a
            # full adoption lands there)
            def rjob(ppad=ppad, fs_cur=fs_cur):
                return eng.refresh(ppad, fs_cur)

            self._pqueue.append((i + 1, "refresh",
                                 self._executor().submit(rjob)))

    def _executor(self):
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tree-build")
        return self._pool

    def _drop_pending(self) -> None:
        """Cancel or finish every queued rebuild job (their results are
        discarded, their errors raised) and reset the pipeline."""
        if self._pending is not None:
            if not self._pending.cancel():
                self._pending.result()
            self._pending = None
        while self._pqueue:
            _, _, f = self._pqueue.popleft()
            if not f.cancel():
                f.result()
        self._boundary_i = 0
        self._last_full = None

    def close(self) -> None:
        """Finish queued rebuilds and stop the background thread (nothing
        to do for a plain engine)."""
        if self._fmm is None:
            return
        self._drop_pending()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
