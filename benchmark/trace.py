"""The traced run's reading of ``torch.profiler``'s CUDA activity.

The harness profiles the measured window's last seconds (CPU and CUDA
activity, :class:`Tail`) and marks them, and its own calls into the
program's layers, with ``record_function`` spans named ``bench.*``.
:func:`summarize` reads the profiler's events from its Chrome-trace export
(written under the temporary directory and deleted after: the one form
that carries each event's category on the pinned torch, whose kineto
events have no ``activity_type``) and returns what the per-layer metrics
read:

  ``window_s``: the ``bench.window`` span's length;
  ``busy_s``: the union of the device's intervals (kernels, copies,
      memsets) inside it, so overlapping work counts once;
  ``p2p_ms`` / ``p2p_count``: the summed duration and number of the P2P
      kernels' instances (``p2p_kernel`` in 3D, ``p2p2d_kernel`` in 2D);
  ``other_ms``: every other device interval's duration, summed;
  ``device_ops``: the ten device operations that took most time;
  ``idle_gaps``: the ten longest gaps between device intervals, each named
      by the innermost ``bench.*`` span the host was in at its middle.

A trace that holds no kernel at all raises: the profiler lost them.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
P2P_KERNELS = ("p2p_kernel", "p2p2d_kernel")
WINDOW = "bench.window"
NAME_CHARS = 96


@contextlib.contextmanager
def span(name: str, on: bool):
    """A ``record_function`` span when tracing, else nothing."""
    if not on:
        yield
        return
    with torch.profiler.record_function(name):
        yield


class Tail:
    """The traced part of a measured window: torch.profiler over CPU and
    CUDA activity, and the ``bench.window`` span, over the window's last
    `tail` steps of its `total` (all of them when `tail` is None or not
    smaller).

    The driver module's loop calls :meth:`tick` with the steps done
    before each unit of its window, and ends when :meth:`done` says so.
    The first tick at or past ``total - tail`` synchronizes the device (so
    that no kernel launched before it runs inside the trace), starts the
    profiler and calls `on_start`.  The profiler's first start in a
    process is made once before the window (:meth:`__init__`), so the one
    inside it is a warm one.  :meth:`stop` ends the span and the
    profiler."""

    def __init__(self, on: bool, total: int, tail, sync, on_start,
                 log=None):
        self.on, self.total = on, int(total)
        self.tail = min(int(tail), self.total) if tail else self.total
        self.sync, self.on_start, self.log = sync, on_start, log
        self.prof = None
        self._stack = contextlib.ExitStack()
        if on:
            from torch.profiler import ProfilerActivity, profile
            sync()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                sync()

    def tick(self, steps: int) -> None:
        if (self.on and self.prof is None
                and steps >= self.total - self.tail):
            from torch.profiler import ProfilerActivity, profile
            t0 = time.perf_counter()
            self.sync()
            self.prof = self._stack.enter_context(profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            self._stack.enter_context(torch.profiler.record_function(WINDOW))
            if self.log is not None:
                print(f"trace: profiler started in "
                      f"{time.perf_counter() - t0:.2f} s, {steps} steps "
                      f"into the window", file=self.log, flush=True)
            self.on_start()

    def done(self, steps: int) -> bool:
        """Whether the window's `total` steps are done."""
        return steps >= self.total

    def stop(self):
        """End the span and the profiler; the profiler, or None."""
        self._stack.close()
        if self.on and self.prof is None:
            raise RuntimeError("the window ended before its traced part")
        return self.prof


def _events(prof) -> list:
    """(category, name, start us, duration us) of every complete event of
    the profiler's Chrome-trace export."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [(str(e.get("cat", "")).lower(), str(e.get("name", "?")),
             float(e["ts"]), float(e["dur"]))
            for e in raw if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    """Merged [a, b) intervals of a list sorted by start."""
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof) -> dict:
    events = _events(prof)
    wins = [e for e in events if e[1] == WINDOW and e[0] == "user_annotation"]
    if len(wins) != 1:
        raise RuntimeError(f"the trace holds {len(wins)} {WINDOW} spans, "
                           "not one")
    w0 = wins[0][2]
    w1 = w0 + wins[0][3]
    dev = sorted((ts, ts + dur, name, cat) for cat, name, ts, dur in events
                 if cat in DEVICE_CATS and w0 <= ts < w1)
    if not any(c == "kernel" for _, _, _, c in dev):
        raise RuntimeError("the trace of the window holds no kernel: the "
                           "profiler lost them")
    merged = _union([(max(a, w0), min(b, w1)) for a, b, _, _ in dev])
    busy = sum(b - a for a, b in merged)
    by_name = {}
    p2p_ms = other_ms = 0.0
    p2p_count = 0
    for a, b, name, cat in dev:
        ms = (b - a) / 1e3
        if cat == "kernel" and any(k in name for k in P2P_KERNELS):
            p2p_ms += ms
            p2p_count += 1
        else:
            other_ms += ms
        key = name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
    spans = [(ts, ts + dur, name) for cat, name, ts, dur in events
             if cat == "user_annotation" and name.startswith("bench.")
             and name != WINDOW]
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    longest = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2])
                      if b > a), key=lambda g: g[0] - g[1])[:10]
    gaps = []
    for a, b in longest:
        mid = 0.5 * (a + b)
        inside = [s for s in spans if s[0] <= mid < s[1]]
        label = (min(inside, key=lambda s: s[1] - s[0])[2] if inside
                 else "host.other")
        gaps.append([label, (b - a) / 1e6])
    ops = sorted(([k, v] for k, v in by_name.items()), key=lambda o: -o[1])
    cats = {}
    for e in events:
        cats[e[0]] = cats.get(e[0], 0) + 1
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "p2p_ms": p2p_ms, "p2p_count": p2p_count, "other_ms": other_ms,
            "events": len(events), "categories": cats,
            "device_ops": ops[:10], "idle_gaps": gaps}
