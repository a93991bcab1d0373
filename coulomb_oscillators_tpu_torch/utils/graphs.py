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
  * A capture or replay that fails raises: nothing runs eagerly instead.

The Simulator decides where graphs run (``simulate.py``); this module
imports nothing of the port but torch.
"""

from __future__ import annotations

import time

import torch

# (object, attribute name) of integer counters that replays advance
_counters = []


def register_counter(obj, attr: str) -> None:
    """Make replays advance the integer ``obj.attr`` as eager steps would."""
    if not any(o is obj and a == attr for o, a in _counters):
        _counters.append((obj, attr))


def unregister_counter(obj, attr: str) -> None:
    """Undo :func:`register_counter`."""
    _counters[:] = [(o, a) for o, a in _counters
                    if not (o is obj and a == attr)]


def _read_counters(counters) -> list:
    return [getattr(o, a) for o, a in counters]


def _spec(tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


def _like(x, items):
    """`items` as a tuple of the type of `x` (a NamedTuple or a tuple)."""
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def _copy_into(dst, src) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


class StepGraph:
    """One step of ``body(state, frozen) -> state`` captured as a CUDA
    graph and replayed (see the module docstring).

    `state` is a tuple type of tensors (``ParticleState``) and `frozen` a
    tuple of tensors (a NamedTuple tree state, or ``()``); the body must
    not change either in place, and must run on their device's current
    stream."""

    def __init__(self, body):
        self.body = body
        self.captures = 0          # captures made (the first one included)
        self.capture_seconds = 0.0  # their wall time, warm-ups included
        self.replays = 0
        self._key = None
        self._graph = None
        self._state = None         # the graph's (pos, vel, acc)
        self._frozen = None        # the graph's copy of the frozen tree
        self._frozen_src = None    # the tree object copied in last
        self._per_replay = []      # (obj, attr, what one replay adds)

    def run(self, state, frozen, k: int, static=()):
        """`k` steps from `state` against `frozen` by replays of the
        captured step (capturing it first when needed); returns the new
        state as tensors of its own."""
        if state[0].device.type != "cuda":
            raise ValueError(f"CUDA graphs need CUDA tensors, got "
                             f"{state[0].device}")
        key = (tuple(static), _spec(state), _spec(frozen))
        if key != self._key:
            self._capture(state, frozen, key)
        elif frozen is not self._frozen_src:
            _copy_into(self._frozen, frozen)
            self._frozen_src = frozen
        _copy_into(self._state, state)
        for _ in range(k):
            self._graph.replay()
        self.replays += k
        for obj, attr, d in self._per_replay:
            setattr(obj, attr, getattr(obj, attr) + d * k)
        return _like(state, (x.clone() for x in self._state))

    def _capture(self, state, frozen, key) -> None:
        t0 = time.perf_counter()
        self.release()
        dev = state[0].device
        st = tuple(x.clone() for x in state)
        fz = _like(frozen, (x.clone() for x in frozen))
        counters = list(_counters)
        before = _read_counters(counters)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            # the warm-up: every lazy initialisation, on scratch copies
            _copy_into(st, self.body(_like(state, st), fz))
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = _read_counters(counters)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            _copy_into(st, self.body(_like(state, st), fz))
        after = _read_counters(counters)
        self._per_replay = [(o, a, n1 - n0) for (o, a), n0, n1
                            in zip(counters, warm, after)]
        for (obj, attr), n in zip(counters, before):
            setattr(obj, attr, n)
        self._graph, self._state, self._frozen = graph, st, fz
        self._frozen_src, self._key = frozen, key
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0

    def release(self) -> None:
        """Free the graph, its memory pool and the static buffers (the next
        run captures again)."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._state = self._frozen = None
        self._frozen_src = self._key = None
