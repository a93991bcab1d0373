"""One window step as a CUDA graph, replayed for every step of a window.

The reference compiles each window into one XLA program: ``jax.jit`` of the
step, ``jax.lax.fori_loop`` over the window's steps, one compile for every
stride k (``coulomb_oscillators_tpu/simulate.py``).  The port's twin is
:class:`StepGraph`: it captures ONE step of a window body into a CUDA graph
and replays that graph k times.  There is no reference module of this name.

  * **Static buffers.**  The graph reads and writes its own copies of the
    state (pos, vel, acc) and of every tensor of the frozen tree (an
    ``FmmState``, an ``OctState`` or nothing).  The captured step writes
    its result back into the state buffers, so replays chain.  A run
    copies the caller's state in, replays, and hands back clones taken on
    the current stream, which later replays never overwrite; the frozen
    tree is copied in when the caller passes another tree object than the
    one copied last (an adopted tree is an immutable object).
  * **Warm-up, then capture.**  Capture does not run the body, and the
    body's first call does work that a capture may not: the kernels'
    libraries are built, lookup tables and cached index tensors are
    uploaded, cuBLAS makes its handles.  So the body runs once on the
    static buffers (scratch copies of the caller's state, overwritten by
    the copy-in before the first replay), then once under capture.
  * **Capture mode** ``thread_local``: the Simulator's tree-build thread
    uploads and refreshes lists on the device while the main thread may
    be capturing, which the default global mode forbids.
  * **Re-capture** happens when the shapes, dtypes or devices of the state
    or of the frozen tensors change, or the caller's `static` key (Python
    values the body bakes in, such as a cell capacity) does, as ``jax.jit``
    retraces.  The old graph and its memory pool are released first.
    :attr:`StepGraph.captures` and :attr:`StepGraph.capture_seconds` count
    them.
  * **Counters.**  A replay does not run the Python wrappers that count
    kernel launches (``ops.fmm.p2p_cuda.launches``,
    ``ops.direct.launches``).  Every counter registered with
    :func:`register_counter` advances on each replay by what the captured
    step added to it; the warm-up's and the capture's own additions are
    taken back (the capture launches nothing, and the warm-up's launches
    are not steps of the run).
  * **Cut points.**  A collective that stages through host memory (gloo
    moves a CUDA tensor through ``.cpu()``) cannot sit inside a graph.  So
    a step body that calls :func:`collective` is captured in *segments*:
    each call ends the segment being captured, records the collective's
    function, its input (a tensor the segment wrote) and an output buffer
    allocated outside the capture, and begins the next segment in the same
    memory pool; nothing runs.  A replay of the step runs segment 0, the
    first collective for real (reading the recorded input, writing the
    recorded buffer), segment 1, and so on.  A body without cuts is one
    segment: the one graph of a single-device step.  The reference's twin
    is the jitted ``shard_map`` ``fori_loop`` whose body carries its
    ``all_gather`` / ``psum`` / ``ppermute``
    (``coulomb_oscillators_tpu/parallel/fmm_pshard.py``).
  * **The trap of segments.**  A tensor that one segment allocates and a
    later one reads (the leaf-frame monomials ``V`` that the sharded far
    field computes before its all_gather and reads again in its L2P after
    the all_reduce; the drifted positions across a force evaluation)
    lives in the graphs' private pool, and nothing but the capture order
    says that its memory is still in use.  It is safe only because every
    segment shares the first one's pool, the segments are captured in
    order, replayed in that order, and released together.  Never replay a
    segment alone or release one without the others.
  * **Ranks.**  The warm-up runs the collectives for real, the capture
    runs none, and every replay runs one set: ranks of a mesh must capture
    together, or their collective sequences no longer pair up.  The caller
    makes that decision for all ranks at once (:meth:`StepGraph.stale`
    says whether this rank would capture; ``simulate.py`` combines the
    ranks' answers).
  * **Timed stages.**  The step's ``profiling.stage`` marks become
    external CUDA timing events, event-record nodes of the graph, in every
    capture (the warm-up records none); the StepGraph owns them.  They
    hold the last replay's times only, so while a profiler runs a run
    leaves its last replay as a pending sample of its `k` steps, and the
    next run or :meth:`release` hands it to ``profiling.add_sample``,
    which never blocks (an incomplete sample counts as missed).  A run
    also marks the stream before its first replay and after its last
    (``profiling.run_begins`` / ``run_ends``), and spans its capture,
    frozen-tree copy and replays (``graph.capture``, ``graph.copy_frozen``,
    ``graph.replay``).
  * A capture or replay that fails raises: nothing runs eagerly instead.

The Simulator decides where graphs run (``simulate.py``); this module
imports nothing of the port but torch and ``utils/profiling.py``.
"""

from __future__ import annotations

import threading
import time

import torch

from coulomb_oscillators_tpu_torch.utils import profiling as P

# (object, attribute name) of integer counters that replays advance
_counters = []

# ``graph``: the StepGraph this thread is capturing, if any.  The mesh's
# collectives hold no StepGraph, so :func:`collective` asks here.
_capturing = threading.local()


def register_counter(obj, attr: str) -> None:
    """Make replays advance the integer ``obj.attr`` as eager steps would."""
    if not any(o is obj and a == attr for o, a in _counters):
        _counters.append((obj, attr))


def unregister_counter(obj, attr: str) -> None:
    """Undo :func:`register_counter`."""
    _counters[:] = [(o, a) for o, a in _counters
                    if not (o is obj and a == attr)]


def collective(fn, x: torch.Tensor, out_shape, out_dtype=None):
    """``fn(x)``, a collective of a mesh (``parallel/mesh.py``) that hands
    back a new tensor of `out_shape` and `out_dtype` (x's by default).

    Outside a capture it runs now.  Inside one it is a cut point (see the
    module docstring): the segment being captured ends, `fn`, `x` and an
    output buffer allocated outside the capture are recorded, the next
    segment begins in the same pool, and the buffer is returned unfilled;
    each replay fills it with ``fn(x)``."""
    graph = getattr(_capturing, "graph", None)
    if graph is None:
        return fn(x)
    return graph._cut(fn, x, tuple(out_shape), out_dtype or x.dtype)


def _read_counters(counters) -> list:
    return [getattr(o, a) for o, a in counters]


def _leaves(x) -> list:
    """The tensors of `x`, a tensor or nested tuples of them (NamedTuples
    and non-tensor leaves such as Python ints allowed), depth first."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for a in x for t in _leaves(a)]
    return []


def _rebuild(x, tensors):
    """`x` with its tensors replaced, in :func:`_leaves` order, by those of
    the iterator `tensors`; its other leaves kept."""
    if isinstance(x, torch.Tensor):
        return next(tensors)
    if isinstance(x, tuple):
        items = [_rebuild(a, tensors) for a in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _spec(x):
    """What a capture bakes in: the shape, dtype and device of every
    tensor of `x`, and the value of every other leaf."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, tuple):
        return tuple(_spec(a) for a in x)
    return x


def _like(x, items):
    """`items` as a tuple of the type of `x` (a NamedTuple or a tuple)."""
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def _copy_into(dst, src) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


class StepGraph:
    """One step of ``body(state, frozen) -> state`` captured as CUDA
    graphs (one, or one a segment between collectives) and replayed (see
    the module docstring).

    `state` is a tuple type of tensors (``ParticleState``) and `frozen`
    nested tuples of tensors and Python values (a NamedTuple tree state,
    ``()``, or the mesh's ``(tree, local lists)``); the body must not
    change either in place, and must run on their device's current
    stream."""

    def __init__(self, body):
        self.body = body
        self.captures = 0          # captures made (the first one included)
        self.capture_seconds = 0.0  # their wall time, warm-ups included
        self.replays = 0
        self._key = None
        self._segments = []        # the step's graphs, in capture order
        self._cuts = []            # (fn, input, output buffer) after each
                                   # segment but the last
        self._pool = None          # the segments' one memory pool
        self._open = None          # the segment being captured
        self._state = None         # the graph's (pos, vel, acc)
        self._frozen = None        # the graph's copy of the frozen tree
        self._frozen_src = None    # the tree object copied in last
        self._per_replay = []      # (obj, attr, what one replay adds)
        self._stages = []          # (name, event) stage marks of the
                                   # captured step, external timing events
        self._sample = 0           # steps of the run whose last replay the
                                   # stage events hold, not yet read

    @property
    def segments(self) -> int:
        """Graphs a replayed step runs (its collectives + 1; 0 before the
        first capture)."""
        return len(self._segments)

    def stale(self, state, frozen, static=()) -> bool:
        """Whether :meth:`run` with these arguments would capture first."""
        return self._key_of(state, frozen, static) != self._key

    @staticmethod
    def _key_of(state, frozen, static) -> tuple:
        return (tuple(static), _spec(tuple(state)), _spec(frozen))

    def run(self, state, frozen, k: int, static=()):
        """`k` steps from `state` against `frozen` by replays of the
        captured step (capturing it first when needed); returns the new
        state as tensors of its own."""
        if state[0].device.type != "cuda":
            raise ValueError(f"CUDA graphs need CUDA tensors, got "
                             f"{state[0].device}")
        key = self._key_of(state, frozen, static)
        if self._sample:
            self._resolve()
        if key != self._key:
            with P.span("graph.capture"):
                self._capture(state, frozen, key)
        elif frozen is not self._frozen_src:
            with P.span("graph.copy_frozen"):
                _copy_into(_leaves(self._frozen), _leaves(frozen))
            self._frozen_src = frozen
        _copy_into(self._state, state)
        dev = state[0].device
        P.run_begins(dev, k)
        with P.span("graph.replay"):
            for _ in range(k):
                for i, graph in enumerate(self._segments):
                    graph.replay()
                    if i < len(self._cuts):
                        fn, x, out = self._cuts[i]
                        out.copy_(fn(x))
        P.run_ends(dev)
        if self._stages and P.recording():
            self._sample = k
        self.replays += k
        for obj, attr, d in self._per_replay:
            setattr(obj, attr, getattr(obj, attr) + d * k)
        return _like(state, (x.clone() for x in self._state))

    def _resolve(self) -> None:
        """Hand the pending stage sample to ``profiling.add_sample``."""
        steps, self._sample = self._sample, 0
        P.add_sample(self._stages, steps)

    def _capture(self, state, frozen, key) -> None:
        t0 = time.perf_counter()
        self.release()
        dev = state[0].device
        st = tuple(x.clone() for x in state)
        fz = _rebuild(frozen, (x.clone() for x in _leaves(frozen)))
        counters = list(_counters)
        before = _read_counters(counters)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), P.stage_sink(False):
            # the warm-up: every lazy initialisation, on scratch copies
            # (a mesh body's collectives run for real)
            _copy_into(st, self.body(_like(state, st), fz))
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = _read_counters(counters)
        # what torch.cuda.graph does before a capture: free what can be
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        self._pool = torch.cuda.graph_pool_handle()
        _capturing.graph = self
        stages = []
        with torch.cuda.stream(side), P.stage_sink(stages):
            try:
                self._begin()
                _copy_into(st, self.body(_like(state, st), fz))
                self._end()
            except BaseException:
                self._abort()     # on the capturing stream, as it must be
                raise
            finally:
                _capturing.graph = None
        after = _read_counters(counters)
        self._per_replay = [(o, a, n1 - n0) for (o, a), n0, n1
                            in zip(counters, warm, after)]
        for (obj, attr), n in zip(counters, before):
            setattr(obj, attr, n)
        self._state, self._frozen = st, fz
        self._frozen_src, self._key = frozen, key
        self._stages = stages
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0

    def _begin(self) -> None:
        """Begin the next segment, in the step's pool."""
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self._pool,
                            capture_error_mode="thread_local")
        self._segments.append(graph)
        self._open = graph

    def _end(self) -> None:
        graph, self._open = self._open, None
        graph.capture_end()

    def _cut(self, fn, x, out_shape, out_dtype) -> torch.Tensor:
        """A collective met while capturing: see :func:`collective`."""
        self._end()
        out = torch.empty(out_shape, dtype=out_dtype, device=x.device)
        self._cuts.append((fn, x, out))
        self._begin()
        return out

    def _abort(self) -> None:
        """After a failed capture: end the open segment, so that the stream
        leaves capture mode, and free everything captured."""
        if self._open is not None:
            try:
                self._end()
            except RuntimeError:
                pass           # the capture's own error is the one raised
        self.release()

    def release(self) -> None:
        """Free every segment, their memory pool, the collectives' buffers
        and the static buffers, all together (the next run captures
        again); a pending stage sample is read first."""
        if self._sample:
            self._resolve()
        if self._cuts:
            # the buffers were last written on the replaying stream
            torch.cuda.synchronize(self._cuts[0][2].device)
        for graph in self._segments:
            graph.reset()
        self._segments, self._cuts = [], []
        self._pool = self._open = None
        self._state = self._frozen = None
        self._frozen_src = self._key = None
        self._stages = []
