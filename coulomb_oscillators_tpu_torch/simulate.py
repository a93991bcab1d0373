"""Simulation driver: integrator x force engine, with the kd engine's
async rebuild pipeline and its multi-device (mesh) mode.

Twin of ``coulomb_oscillators_tpu/simulate.py`` (reference sim loop
main3.cu:832-874).  Three paths:

  * the plain engines ("direct", "direct_ref"): the integrator steps the
    oscillator force;
  * the uniform-grid engines ("fmm3", "fmm3_traceless", "fmm2",
    "fmm2_traceless", "appel"): a synchronous rebuild every `tree_steps`
    iterations, then `k` steps on the original-order state;
  * the kd engines (tree rebuilt every `tree_steps` iterations,
    fmm_cart3_kdtree.cuh:1619-1642): between rebuilds the state lives as
    padded [G, C, dim] leaf blocks and the integrator runs `k` steps; at
    window boundaries the rebuild pipeline adopts a tree built in a
    background thread from an earlier boundary's positions — by the native
    host builder, or with ``tree_async_build="device"`` by the device
    builders.

On a card a rebuild job runs with the card's list-layout stream current
(``kdtree.layout_stream``, the traversal's side stream), so that its
device work runs beside the queued windows, and hands back an event after
its last kernel; the adopting thread's stream waits on that event before
the repad and the next replay (:meth:`Simulator._wait`).

Each path's `k` steps are one step body run `k` times.  On CUDA tensors the
body is captured once as a CUDA graph and replayed `k` times
(``utils/graphs.py``), the twin of the reference's jitted ``fori_loop``; the
``CO_CUDA_GRAPHS`` environment variable set to 0 when the Simulator is built
runs the same body eagerly instead (the twin of ``JAX_DISABLE_JIT``).  CPU
tensors always run it eagerly: the CPU has no graphs.  What leaves a graph
(the state a window hands back, the rebuild jobs' inputs, host copies) is a
clone that later replays never overwrite.

Mesh mode (``Simulator(..., mesh=parallel.mesh.make_mesh(...))``, kd
engines only) runs the padded window loop particle-sharded
(``parallel/fmm_pshard.py``).  The reference drives its mesh from one
process; the port is SPMD: every rank constructs the same Simulator and
calls the same methods with the same full ``ParticleState``, keeps only its
leaf-block shard between calls, and gets the full state back from
:meth:`run` (one all_gather of the padded triple).  At a window boundary
every rank runs the same deterministic rebuild on the gathered positions,
so all ranks adopt identical lists without a broadcast, and the background
rebuild thread makes no collective call.  The sharded window evaluates the
force against the frozen tree without the geometry refresh, as the
reference's mesh mode does.  Each rank localizes its share of the lists once
an adoption, and on CUDA tensors its step body runs as CUDA graphs cut at
the force's collectives (``utils/graphs.py``), the twin of the reference's
jitted ``shard_map`` ``fori_loop``; ``CO_CUDA_GRAPHS=0`` and CPU ranks run
it eagerly.  Ranks must capture together (a rank that captures runs no
collective while its peers replay theirs), and a rank's capture key (its
lists' shapes, its halo hops) can change at an adoption where another's
does not: so at every window whose tree changed, the ranks combine their
"my key changed" flags in one all_reduce_sum, and every rank captures
again or none does.

While a profiler runs, the window pipeline records spans
(``utils/profiling.py``): ``sim.boundary`` around a boundary that
rebuilds, and inside it ``sim.boundary.wait`` (each wait on a rebuild
job), ``.repad``, ``.refresh`` (a synchronous refresh) and ``.submit``
(the host copies and the next job's submission, which carries the
recording onto the rebuild thread); ``sim.window`` around each run of
window steps and ``sim.unpad`` in :meth:`Simulator.current_state`.  The
kd force's stages are timed as ``fmm.refresh`` (the geometry refresh)
and, in the engine, ``fmm.upward`` / ``fmm.m2l`` / ``fmm.downward`` /
``fmm.p2p``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from coulomb_oscillators_tpu_torch import native
from coulomb_oscillators_tpu_torch.config import SimConfig
from coulomb_oscillators_tpu_torch.models import integrators as I
from coulomb_oscillators_tpu_torch.ops.elastic import add_elastic
from coulomb_oscillators_tpu_torch.state import ParticleState
from coulomb_oscillators_tpu_torch.utils import profiling as P
from coulomb_oscillators_tpu_torch.utils.graphs import StepGraph

def auto_stale_margin(vel, config: SimConfig) -> np.ndarray:
    """Per-axis traversal-time MAC slack for frozen pair lists:
    rms|v_axis| * dt * max_list_age * factor (the twin explains the
    factor and the list ages).  The factor is 2 unless the
    ``CO_STALE_MARGIN_FACTOR`` environment variable gives another, read
    at each call as in the twin.  `vel` is a tensor or a host array; the
    mean runs in float64.  Returns a [dim] float64 vector (zeros when
    lists never go stale)."""
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
    fac = float(os.environ.get("CO_STALE_MARGIN_FACTOR", "2.0"))
    return vrms_ax * config.dt * age * fac


def any_rank(mesh, flag: bool) -> bool:
    """Whether `flag` holds on any rank of `mesh`: one all_reduce_sum,
    called by every rank's main thread at the same point."""
    x = torch.tensor([1.0 if flag else 0.0], device=mesh.device)
    return bool(mesh.all_reduce_sum(x)[0] > 0)


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


class _Done(NamedTuple):
    """A rebuild job's result: its value, the event after its last kernel
    on the list-layout stream (None on a CPU), and the device."""
    value: object
    ready: Optional[torch.cuda.Event]
    device: torch.device


def _tensors(x):
    """The tensors of a (nested) tuple of tensors."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for y in x:
            yield from _tensors(y)


class Simulator:
    """Runs the Coulomb-oscillator system with any force engine."""

    def __init__(self, config: SimConfig, n: int, engine: str = "direct",
                 mesh=None):
        """mesh: optional ``parallel.mesh.Mesh``: runs the kd-FMM padded
        window particle-sharded over its ranks (each owns n/P particles).
        Only supported for the kd engines."""
        if mesh is not None and not engine.endswith("_kd"):
            raise ValueError(f"mesh mode needs a kd engine, got {engine!r}")
        self.config = config
        self.n = n
        self.engine_name = engine
        self.omega0_sq = config.omega0_sq()
        # CUDA graphs for the window steps on CUDA tensors (utils/graphs.py);
        # CO_CUDA_GRAPHS=0 runs the same step eagerly
        self.use_graphs = os.environ.get("CO_CUDA_GRAPHS", "1") != "0"
        self.graph = None         # the StepGraph, made at the first window
        self._fmm = None
        self._fstate = None
        self._padded = None       # kd engine: ParticleState of [G, C, dim]
                                  # (mesh mode: this rank's [G/P, C, dim])
        self._mesh = mesh
        self._ps = None           # PShardedKdFmm when mesh is set
        if not (engine.startswith("fmm") or engine == "appel"):
            from coulomb_oscillators_tpu_torch.models.oscillator import (
                make_oscillator_force)
            self._plain_force = make_oscillator_force(config, n, engine)
            self._step = I.make_step(lambda p, _: self._plain_force(p),
                                     config.integrator, config.dt)
            return
        from coulomb_oscillators_tpu_torch.ops import fmm as fmm_mod
        self._fmm = fmm_mod.make_engine_object(config, n, engine)
        self._steps_since_build = 0
        self._last_out = None
        # the async rebuild pipeline: queue of (due_boundary, kind, future)
        self._pqueue = collections.deque()
        self._boundary_i = 0
        self._last_full = None
        self._pool = None
        # seconds the last adoption waited on its background job, and the
        # sum over every adoption so far
        self.last_rebuild_wait = 0.0
        self.rebuild_wait_total = 0.0
        # rebuilds by kind, for diagnostics: adopted full re-sorts (with
        # repad), adopted refreshes, synchronous refreshes, synchronous
        # full builds
        self.rebuilds = collections.Counter()
        self._use_padded = hasattr(self._fmm, "force_padded")
        if mesh is not None:
            from coulomb_oscillators_tpu_torch.parallel.fmm_pshard import (
                make_psharded_body)
            self._ps, self._step = make_psharded_body(self._fmm, mesh, config,
                                                      self.omega0_sq)
            self._plists = self._phops = None
            self._pfrozen = None      # (tree, this rank's localized lists)
            self._voted = None        # the _pfrozen of the last graph vote
            self._scan_step = self._mesh_window
            return
        self._step = I.make_step(self._padded_force if self._use_padded
                                 else self._grid_force,
                                 config.integrator, config.dt)
        self._scan_step = self._window

    # ------------------------------------------------------------------ #
    def _grid_force(self, pos, fstate):
        """The uniform-grid engines' force with the trap term, on the
        original-order state against the frozen tree."""
        return add_elastic(pos, self._fmm.force(pos, fstate), self.omega0_sq)

    def _padded_force(self, ppad, fstate):
        """The kd engines' force with the trap term on padded [G, C, dim]
        leaf blocks.  With config.geom_refresh (default, and only when
        lists are reused) every force eval first recomputes expansion
        geometry from the live positions; lists stay frozen."""
        eng = self._fmm
        if self.config.geom_refresh and self.config.tree_steps > 1:
            # a stage that the force's first stage ends
            P.stage("fmm.refresh", ppad.device)
            fstate = eng.geom_refresh(ppad, fstate)
        acc = add_elastic(ppad, eng.force_padded(ppad, fstate),
                          self.omega0_sq)
        # pad slots park at FAR: their trap term is huge — zero it so pad
        # velocities stay 0 and pad positions stay put
        return torch.where(eng.mask3(ppad.device)[..., None], acc, 0.0)

    def _window(self, state, frozen, k: int):
        """`k` steps of the path's step body against the frozen tree (``()``
        for a plain engine; the tree and the rank's lists in mesh mode):
        replays of its CUDA graph on a CUDA tensor unless CO_CUDA_GRAPHS=0
        was set, else eagerly.  The grid engines' cell capacity is baked
        into the step, so it keys the capture."""
        if k <= 0:
            return state
        with P.span("sim.window"):
            if state.pos.device.type == "cuda" and self.use_graphs:
                if self.graph is None:
                    self.graph = StepGraph(self._step)
                static = (() if self._fmm is None or self._use_padded
                          else (self._fmm.cell_cap,))
                return self.graph.run(state, frozen, k, static)
            P.run_begins(state.pos.device, k)
            for _ in range(k):
                state = self._step(state, frozen)
            P.run_ends(state.pos.device)
            if P.recording():
                P.count("stage.steps", k)
            return state

    def _mesh_window(self, state, fstate, k: int):
        """Mesh mode's `k` steps of the sharded step body against the frozen
        tree `fstate` and this rank's lists localized for it (both set by
        :meth:`_set_fstate`): as :meth:`_window`, with the re-capture
        decided by all ranks together (module docstring)."""
        frozen = self._pfrozen
        if k > 0 and state.pos.device.type == "cuda" and self.use_graphs:
            # every rank reaches this point with the same tree adoptions
            # behind it, so all of them vote here or none does
            if (self.graph is not None and frozen is not self._voted
                    and any_rank(self._mesh,
                                 self.graph.stale(state, frozen))):
                self.graph.release()
            self._voted = frozen
        return self._window(state, frozen, k)

    def _pad_state(self, state: ParticleState) -> ParticleState:
        """The full original-order state as padded blocks (mesh mode: this
        rank's shard of them)."""
        from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR
        eng, fs = self._fmm, self._fstate
        return self._shard(ParticleState(
            eng.pad_array(state.pos, fs, fill=FAR),
            eng.pad_array(state.vel, fs), eng.pad_array(state.acc, fs)))

    def _shard(self, full: ParticleState) -> ParticleState:
        """The padded state of all leaves as this rank holds it: all of it,
        or in mesh mode this rank's shard."""
        if self._ps is None:
            return full
        return ParticleState(*(self._ps.shard_padded(x) for x in full))

    def _set_fstate(self, fstate) -> None:
        """Adopt a tree; mesh mode regroups its pair lists for the ranks
        (the reference's ``_reshard_lists``)."""
        self._fstate = fstate
        if self._ps is not None:
            from coulomb_oscillators_tpu_torch.parallel.fmm_pshard import (
                shard_pair_lists)
            self._plists, self._phops = shard_pair_lists(
                self._fmm, fstate, self._ps.ndev)
            self._pfrozen = (fstate, self._ps.localize(
                self._plists, self._phops, fstate.center.device))

    def _full_padded(self) -> ParticleState:
        """The padded state of all leaves (mesh mode: one all_gather of
        the ranks' (pos, vel, acc) shards)."""
        if self._ps is None:
            return self._padded
        dim = self._fmm.dim
        full = self._ps.gather_padded(torch.cat(tuple(self._padded), dim=2))
        return ParticleState(*(full[..., i * dim:(i + 1) * dim]
                               for i in range(3)))

    def _unpad_state(self, pstate: ParticleState) -> ParticleState:
        """Padded blocks of all leaves -> the original-order state."""
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
        self._set_fstate(self._fmm.build(state.pos))
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
            return self._window(state, (), steps)
        if not self._use_padded:
            return self._run_unpadded(state, steps)
        # a state we did not hand out (or a cold start) enters padded form
        if (self._padded is None or self._fstate is None
                or state is not self._last_out):
            self._drop_queue()
            self._set_fstate(self._fmm.build(state.pos))
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
        the padded positions (mesh mode: this rank's shard, with no gather).
        Requires an active padded run (init_acc or run first);
        :meth:`current_state` unpads."""
        if self._padded is None or self._fstate is None:
            raise RuntimeError("advance_padded requires an active padded "
                               "run (call init_acc + run first)")
        ts = max(self.config.tree_steps, 1)
        done = 0
        while done < steps:
            self.start_window()
            k = min(ts - self._steps_since_build, steps - done)
            self._padded = self._scan_step(self._padded, self._fstate, k)
            self._steps_since_build += k
            done += k
        self._last_out = None     # handed-out states are now stale
        return self._padded.pos

    def start_window(self) -> None:
        """Run the window-boundary rebuild now if the reuse window is used
        up (:meth:`advance_padded` does so before its next step); a probe
        calls it to read the state a new window starts from."""
        if self._steps_since_build >= max(self.config.tree_steps, 1):
            with P.span("sim.boundary"):
                self._rebuild_padded()
            self._steps_since_build = 0

    def current_state(self) -> ParticleState:
        """Unpad and return the current state (resumable via run()); in
        mesh mode the full state, on every rank."""
        with P.span("sim.unpad"):
            out = self._unpad_state(self._full_padded())
        self._last_out = out
        return out

    def _rebuild_padded(self) -> None:
        """Window-boundary rebuild of the padded state (in mesh mode of all
        ranks' leaves, gathered: every rank runs the same rebuild, and the
        worker thread calls no collective).

        Async (config.tree_async): a FULL re-sort, built in the background
        from this boundary's positions, every K boundaries, adopted D
        boundaries later through a composed old -> new padded-layout gather
        (repad); a background REFRESH (exact bounds on the current
        permutation) at the other boundaries, adopted at the next one.  The
        first boundary primes the pipeline with a synchronous refresh.  The
        full re-sort's builder is the device builder with
        ``tree_async_build="device"`` (in one process), from the unpadded
        positions on the device, and otherwise the native host builder, from
        host copies of the padded positions and their permutation.  Sync (or
        a host builder without the native library): the reference's blocking
        rebuild."""
        eng, cfg = self._fmm, self.config
        full = self._full_padded()
        device = full.pos.device
        on_device = cfg.tree_async_build == "device" and self._ps is None
        if not cfg.tree_async or not (on_device or native.available()):
            cur = self._unpad_state(full)
            self._set_fstate(eng.build(cur.pos))
            self._padded = self._pad_state(cur)
            self.rebuilds["sync_full"] += 1
            return
        if on_device or self._ps is not None:
            # K = D = 1, a full re-sort adopted at every boundary: the
            # cadence of the reference's device builder and mesh mode,
            # which ignore tree_resort_every and tree_pipeline
            # (coulomb_oscillators_tpu/simulate.py:297-322, 394-405)
            K = D = 1
        else:
            K = max(1, int(cfg.tree_resort_every))
            D = max(1, int(cfg.tree_pipeline))
        i = self._boundary_i
        self._boundary_i += 1

        if self._pqueue and self._pqueue[0][0] <= i:
            _, kind, fut = self._pqueue.popleft()
            res = self._wait(fut)
            if kind == "refresh":
                self._set_fstate(res)
            else:
                fs_new, remap = res
                with P.span("sim.boundary.repad"):
                    full = ParticleState(*eng.repad_triple(
                        full.pos, full.vel, full.acc, remap))
                    self._padded = self._shard(full)
                self._set_fstate(fs_new)
            self.rebuilds["adopt_" + kind] += 1
            # collision safety: drop any other job due at this boundary
            while self._pqueue and self._pqueue[0][0] <= i:
                self._pqueue.popleft()[2].result()
        elif not self._pqueue:
            # pipeline priming: exact bounds on the current permutation
            with P.span("sim.boundary.refresh"):
                self._set_fstate(eng.refresh(full.pos, self._fstate))
            self.rebuilds["sync_refresh"] += 1

        fs_cur = self._fstate
        ppad = full.pos
        if i % K == 0:
            # the next FULL re-sort, from this boundary's positions; its
            # repad maps from the layout current at ITS adoption (the
            # previous full job's result; the single worker runs jobs in
            # order)
            prev = self._last_full

            def job(*src, prev=prev, fs_cur=fs_cur):
                if on_device:
                    fs_new = eng.build_device_async(*src)
                else:
                    ppad_h, inv_h = src
                    fs_new = eng.build_host_padded(ppad_h.numpy(),
                                                   inv_h.numpy(), device)
                fs_old = (prev.result().value[0] if prev is not None
                          else fs_cur)
                return fs_new, eng.make_repad(fs_old, fs_new)

            with P.span("sim.boundary.submit"):
                src = ((eng.unpad_array(ppad, fs_cur),) if on_device else
                       (_HostCopy(ppad), _HostCopy(fs_cur.inv_perm)))
                fut = self._executor().submit(
                    self._job(job, device, after_window=on_device), *src)
            self._last_full = fut
            self._pqueue.append((i + D, "device" if on_device else "full",
                                 fut))
        elif (i + 1 - D) % K != 0:
            # background refresh, adopted next boundary (skipped when a
            # full adoption lands there)
            def rjob(ppad=ppad, fs_cur=fs_cur):
                return eng.refresh(ppad, fs_cur)

            with P.span("sim.boundary.submit"):
                fut = self._executor().submit(
                    self._job(rjob, device, after_window=True))
            self._pqueue.append((i + 1, "refresh", fut))

    def _job(self, fn, device, after_window: bool = False):
        """`fn` as a rebuild job for the worker thread.  On a card it runs
        with the list-layout stream current (``kdtree.layout_stream``),
        after the window work queued so far where `after_window` says that
        it reads the window's tensors; it returns a :class:`_Done` whose
        event follows its last kernel there."""
        from coulomb_oscillators_tpu_torch.ops.fmm import kdtree
        device = torch.device(device)
        queued = None
        if after_window and device.type == "cuda":
            queued = torch.cuda.Event()
            queued.record(torch.cuda.current_stream(device))

        def job(*args):
            with kdtree.layout_stream(device):
                if queued is not None:
                    torch.cuda.current_stream(device).wait_event(queued)
                value = fn(*args)
                return _Done(value, kdtree.layout_event(device), device)

        return P.carry(job)

    def _wait(self, fut):
        """A rebuild job's result, handed over to this thread's stream
        (``kdtree.hand_over``: the stream waits for the job's last kernel
        and its tensors are marked as used here); the wait is timed
        (``sim.boundary.wait`` and :attr:`rebuild_wait_total`)."""
        from coulomb_oscillators_tpu_torch.ops.fmm import kdtree
        t = {}
        with P.span("sim.boundary.wait", t, "s"):
            done = fut.result()
        self._waited(t["s"])
        kdtree.hand_over(_tensors(done.value), done.ready, done.device)
        return done.value

    def _waited(self, seconds: float) -> None:
        self.last_rebuild_wait = seconds
        self.rebuild_wait_total += seconds

    def _executor(self):
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tree-build")
        return self._pool

    def _drop_queue(self) -> None:
        """Cancel or finish every queued rebuild job (their results are
        discarded, their errors raised) and reset the pipeline."""
        while self._pqueue:
            _, _, f = self._pqueue.popleft()
            if not f.cancel():
                f.result()
        self._boundary_i = 0
        self._last_full = None

    def close(self) -> None:
        """Free the step's CUDA graph, finish queued rebuilds and stop the
        background thread.  A later run captures the graph again."""
        if self.graph is not None:
            self.graph.release()
        if self._fmm is None:
            return
        self._drop_queue()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
