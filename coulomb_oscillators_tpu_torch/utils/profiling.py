"""Tracing / profiling harness on ``torch.profiler`` and CUDA events.

Twin of ``coulomb_oscillators_tpu/utils/profiling.py`` in function:

  * :func:`trace` — context manager around ``torch.profiler.profile`` that
    records host and CUDA activity and writes a Chrome trace under a
    directory (viewable in Perfetto / chrome://tracing), with the program
    spans of every thread merged in.
  * :func:`op_histogram` — device-kernel durations by kernel name from a
    trace directory, for terminal triage.
  * :func:`stage_times` — median time of named stages with CUDA events
    (no profiler, no CUPTI needed), ``perf_counter`` on the CPU.
  * :func:`stage_device_times` — the kernels' summed durations of one
    call of each stage, from a trace.
  * ``utils/timing.py`` holds the wall-clock harness.

The port's own spans, counters and timed stages live here too.  They
record only while a ``torch.profiler`` runs on the calling thread (or in
a :func:`trace` block, or on a thread running a job handed over by
:func:`carry` while its submitter recorded); otherwise :func:`span` and
:func:`stage` hand back one shared null context and record nothing:

  * :func:`span` — a host interval at a layer boundary: a
    ``record_function`` on the profiler's timeline, an entry of the span
    log (name, thread, start and end in ``perf_counter_ns``) and the
    name's count and seconds in :func:`totals`.  Given a dict it also
    times its part into it, profiler or not (the rebuild's
    ``last_build_times``).
  * :func:`stage` — a boundary between device intervals inside the force:
    a CUDA timing event on the current stream that ends the stage begun
    before it and begins the next, so adjacent stages share one.  Under a
    CUDA-graph capture it is an external event, an event-record node of
    the graph, made in every capture; the capturing ``StepGraph`` owns
    them and hands one sample a replayed run to :func:`add_sample`.
    Eagerly it is a fresh event (the host clock on the CPU).
  * :func:`run_begins` / :func:`run_ends` — timing events around each run
    of window steps; the stream time from one run's end to the next one's
    start is the window boundary's cost to the device.
  * :func:`count` — a plain counter.

The names recorded, and the per-layer metric each serves:

  ``sim.boundary`` (``.wait``, ``.repad``, ``.refresh``, ``.submit``),
  ``sim.window``, ``sim.unpad``: the window pipeline (``simulate.py``);
  ``kd.fetch`` / ``kd.unpad_host``, ``kd.sort``, ``kd.geom``,
  ``kd.device_build``, ``kd.traverse``, ``kd.lists``, ``kd.upload``,
  ``kd.m2l_fold``, ``kd.refresh.geom_dev``, ``kd.refresh.geom_host``: the
  host rebuild (``ops/fmm/kdtree.py``, mostly on the rebuild thread);
  ``kd.lists.near_entries``, ``kd.lists.near_rows``,
  ``kd.lists.near_row_max``: counters of each list build, its near (P2P)
  entries, sub-leaf rows and longest row's entries
  (``near_entries_per_row``);
  ``graph.capture``, ``graph.copy_frozen``, ``graph.replay``: the step
  graph (``utils/graphs.py``); ``io.write_state``: snapshot I/O;
  ``fmm.refresh``, ``fmm.upward``, ``fmm.m2l``, ``fmm.downward``,
  ``fmm.p2p``: the force's stages (``m2l_ms_per_step``,
  ``upward_ms_per_step``, ``downward_ms_per_step``), with ``stage.steps``
  the steps their samples cover and ``stage.samples_missed`` the samples
  not yet complete when read; ``sim.boundary.device``: the stream time
  between consecutive recorded runs, its count the steps of the runs the
  gaps open (``boundary_device_ms_per_step``).
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import statistics
import tempfile
import threading
import time
from typing import Callable, Dict, Iterable, Mapping, Optional

import torch

# Chrome-trace categories of work that ran on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_FILE = "trace.json"
# the Chrome-trace category of the span-log entries merged by trace()
SPAN_CATEGORY = "program_span"

# ---- program spans, counters and timed stages ------------------------------

_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_totals: Dict[str, list] = {}   # name -> [count, seconds]
_log: list = []                 # (name, thread id, t0 ns, t1 ns, seen by
                                # the profiler)
_thread_names: Dict[int, str] = {}
_pending: list = []             # eager device stages: (name, start, end)
_gaps: list = []                # (a run's end mark, the next one's start
                                # mark, that run's steps)
_run_end = None                 # the last recorded run's end mark
_tracing = 0                    # trace() blocks open
# ``carried``: this thread runs a job handed over by carry() while its
# submitter recorded; ``sink``: the capturing StepGraph's list of stage
# events, or False in its warm-up (stages record nothing there)
_tls = threading.local()


def recording() -> bool:
    """Whether spans and stages record on this thread now."""
    return (_profiler_enabled() or _tracing > 0
            or getattr(_tls, "carried", False))


def count(name: str, n: int = 1, seconds: float = 0.0) -> None:
    """Add to a name's count and seconds in :func:`totals`, recording or
    not."""
    with _lock:
        t = _totals.setdefault(name, [0, 0.0])
        t[0] += n
        t[1] += seconds


class _Span:
    __slots__ = ("name", "into", "key", "on", "rf", "t0")

    def __init__(self, name, into, key, on):
        self.name, self.into, self.key, self.on = name, into, key, on
        self.rf = None

    def __enter__(self):
        if self.on and _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.into is not None:
            self.into[self.key] = (t1 - self.t0) / 1e9
        if self.on:
            th = threading.current_thread()
            with _lock:
                _log.append((self.name, th.native_id, self.t0, t1,
                             self.rf is not None))
                _thread_names.setdefault(th.native_id, th.name)
            count(self.name, 1, (t1 - self.t0) / 1e9)
        return False


def span(name: str, into: Optional[dict] = None, key: Optional[str] = None):
    """A host span named `name` (module docstring).  With `into`, the
    span's seconds are also written to ``into[key]`` (`key` defaults to
    the name's last dotted part), whether or not anything records."""
    on = recording()
    if into is None and not on:
        return _NULL
    return _Span(name, into, key or name.rsplit(".", 1)[-1], on)


def carry(fn: Callable) -> Callable:
    """`fn`, to run on another thread: it records there as the calling
    thread records now (``torch.profiler`` does not follow a job onto a
    worker thread)."""
    if not recording():
        return fn

    def carried(*args, **kwargs):
        prev = getattr(_tls, "carried", False)
        _tls.carried = True
        try:
            return fn(*args, **kwargs)
        finally:
            _tls.carried = prev

    return carried


def _mark(device):
    """A timing mark on `device`: an event recorded on its current stream,
    or the host clock on the CPU."""
    if device.type != "cuda":
        return time.perf_counter_ns()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _elapsed_s(a, b) -> float:
    """Seconds from mark `a` to mark `b`, waiting for `b` on the device."""
    if isinstance(a, int):
        return (b - a) / 1e9
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def stage(name: Optional[str], device) -> None:
    """Mark a stage boundary in the work queued on `device`: the stage
    `name` begins here and the one this thread began before it ends here
    (None ends it and begins none), so adjacent stages share one mark.
    Under a CUDA-graph capture the mark is an external timing event, a node
    of the graph, collected by the capturing StepGraph; else, while
    recording, a fresh event (the host clock on the CPU), the stage it
    ends added to :func:`totals`; else nothing."""
    sink = getattr(_tls, "sink", None)
    if sink is not None:
        if sink is not False:
            ev = torch.cuda.Event(enable_timing=True, external=True)
            ev.record()
            sink.append((name, ev))
        return
    began, _tls.stage = getattr(_tls, "stage", None), None
    if not recording():
        return
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return                    # a capture that owns no stages
    mark = _mark(device)
    if began is not None:
        if isinstance(mark, int):
            count(began[0], 1, (mark - began[1]) / 1e9)
        else:
            with _lock:
                _pending.append((began[0], began[1], mark))
    if name is not None:
        _tls.stage = (name, mark)


@contextlib.contextmanager
def stage_sink(sink):
    """Where this thread's stage marks go inside the block: a list that
    collects ``(name, event)`` under a capture, or False (a capture's
    warm-up: nothing records)."""
    prev = getattr(_tls, "sink", None)
    _tls.sink = sink
    try:
        yield
    finally:
        _tls.sink = prev


def add_sample(marks, steps: int) -> None:
    """A replayed run's stage sample: the ``(name, event)`` marks of the
    captured step, read after the run's last replay; each named mark
    begins a stage that the next mark ends, and its time is taken as the
    time of each of the run's `steps` steps (every step of a window does
    the same work).  Never blocks: events not yet complete count one
    ``stage.samples_missed`` instead."""
    if not all(ev.query() for _, ev in marks):
        count("stage.samples_missed")
        return
    for (name, a), (_, b) in zip(marks, marks[1:]):
        if name is not None:
            count(name, steps, steps * a.elapsed_time(b) / 1e3)
    count("stage.steps", steps)


def run_begins(device, steps: int) -> None:
    """Before the first step of a run of `steps` window steps on
    `device`: while recording, the gap from the last recorded run's end is
    kept for ``sim.boundary.device``."""
    global _run_end
    if not recording():
        _run_end = None
        return
    mark = _mark(torch.device(device))
    if _run_end is not None:
        with _lock:
            _gaps.append((_run_end, mark, steps))
    _run_end = None


def run_ends(device) -> None:
    """After a run's last step (see :func:`run_begins`)."""
    global _run_end
    _run_end = _mark(torch.device(device)) if recording() else None


def totals() -> Dict[str, Dict[str, float]]:
    """Every name's ``{"count", "seconds"}`` recorded since :func:`reset`,
    with the pending eager stages and boundary gaps resolved (waiting for
    their events)."""
    with _lock:
        pending, _pending[:] = list(_pending), []
        gaps, _gaps[:] = list(_gaps), []
    for name, a, b in pending:
        count(name, 1, _elapsed_s(a, b))
    for a, b, steps in gaps:
        count("sim.boundary.device", steps, _elapsed_s(a, b))
    with _lock:
        return {k: {"count": v[0], "seconds": v[1]}
                for k, v in _totals.items()}


def reset() -> None:
    """Forget every total, span, pending stage and boundary gap."""
    global _run_end
    with _lock:
        _totals.clear()
        _log.clear()
        _thread_names.clear()
        _pending.clear()
        _gaps.clear()
        _run_end = None


def per_step_ms(tot: Mapping, name: str) -> Optional[float]:
    """A stage's sampled ms per step from :func:`totals`: its seconds over
    ``stage.steps``; None when nothing was sampled."""
    steps = tot.get("stage.steps", {}).get("count", 0)
    if name not in tot or not steps:
        return None
    return 1e3 * tot[name]["seconds"] / steps


# ---- the profiler's trace ---------------------------------------------------

def _merge_spans(path: str, entries: list) -> dict:
    """Add the span log's `entries` that the profiler did not record
    itself (those of other threads) to the Chrome trace at `path`, as
    complete events on their own thread ids, on the trace's clock: shifted
    by the median of (trace start - log start) over the spans both hold.
    Returns that alignment, also written to the trace under
    ``programSpans``: the offset, its spread (the distance between its
    quartiles) and range over the spans matched, and the entries
    merged."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    seen = collections.defaultdict(list)
    for name, _, t0, _, was_seen in entries:
        if was_seen:
            seen[name].append(t0)
    marks = collections.defaultdict(list)
    pid = None
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") in seen):
            marks[e["name"]].append(float(e["ts"]))
            pid = e.get("pid", pid)
    offsets = []
    for name, t0s in seen.items():
        ts = sorted(marks.get(name, []))
        if len(ts) == len(t0s):
            offsets += [a - b / 1e3 for a, b in zip(ts, sorted(t0s))]
    align = {"matched": len(offsets), "merged": 0, "offset_us": None,
             "spread_us": None, "range_us": None}
    if offsets:
        off = statistics.median(offsets)
        q = (statistics.quantiles(offsets, n=4) if len(offsets) > 1
             else [off, off, off])
        align.update(offset_us=off, spread_us=q[2] - q[0],
                     range_us=max(offsets) - min(offsets))
        tids = set()
        for name, tid, t0, t1, was_seen in entries:
            if was_seen:
                continue
            events.append({"ph": "X", "cat": SPAN_CATEGORY, "name": name,
                           "pid": pid, "tid": tid, "ts": t0 / 1e3 + off,
                           "dur": (t1 - t0) / 1e3})
            tids.add(tid)
            align["merged"] += 1
        for tid in sorted(tids):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {
                               "name": _thread_names.get(tid, str(tid))}})
    doc["traceEvents"] = events
    doc["programSpans"] = align
    with open(path, "w") as f:
        json.dump(doc, f)
    return align


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block: ``with trace("/tmp/tr") as prof: run(); sync()``.

    Records CPU activity, and CUDA activity when a card is present; on
    exit the Chrome trace is written to ``<logdir>/trace.json``, with the
    program spans that every thread recorded in the block merged in
    (:func:`_merge_spans`).  Yields the profiler.  With a card but without
    CUDA tracing in this PyTorch build (CUPTI missing) it raises instead
    of recording host time only."""
    global _tracing
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "torch.profiler cannot trace the card: this PyTorch build "
                "has no CUDA profiler activity (CUPTI is missing); use "
                "stage_times, which needs CUDA events only")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    n0 = len(_log)
    with profile(activities=activities) as prof:
        _tracing += 1
        try:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            _tracing -= 1
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with _lock:
        entries = _log[n0:]
    _merge_spans(path, entries)


def histogram(events: Iterable[Mapping], top: Optional[int] = 30,
              categories=DEVICE_CATEGORIES) -> Dict[str, float]:
    """Sum the durations (ms) of complete Chrome-trace events (``ph`` "X",
    ``dur`` in microseconds) whose ``cat`` is one of `categories`, by
    name, largest first; `top` None keeps every name."""
    agg = collections.Counter()
    for ev in events:
        if (ev.get("ph") == "X" and "dur" in ev
                and ev.get("cat") in categories):
            agg[ev.get("name", "?")] += ev["dur"] / 1000.0
    return dict(agg.most_common(top))


def _trace_files(logdir: str):
    pats = ("*.json", "*.json.gz")
    return sorted(f for p in pats for f in glob.glob(
        os.path.join(logdir, "**", p), recursive=True))


def op_histogram(logdir, top: Optional[int] = 30,
                 categories=DEVICE_CATEGORIES) -> Dict[str, float]:
    """Device-kernel durations (ms) by kernel name, largest first, from a
    :func:`trace` directory.  Host events are excluded (pass
    ``categories=("cpu_op",)`` for the host's operators instead)."""
    events = []
    for f in _trace_files(os.fspath(logdir)):
        opener = gzip.open if f.endswith(".gz") else open
        with opener(f, "rt") as fh:
            events.extend(json.load(fh).get("traceEvents", []))
    return histogram(events, top, categories)


def stage_times(fn_by_name: Mapping[str, Callable[[], object]],
                reps: int = 5, device="cpu") -> Dict[str, float]:
    """Median ms of each named nullary stage over `reps` calls after one
    warm-up call.  On a CUDA `device` each call sits between two CUDA
    events and the card is synchronized once per stage; on the CPU the
    host clock times each call."""
    cuda = torch.device(device).type == "cuda"
    out = {}
    for name, fn in fn_by_name.items():
        fn()
        if cuda:
            torch.cuda.synchronize(device)
            pairs = []
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                pairs.append((a, b))
            torch.cuda.synchronize(device)
            ms = [a.elapsed_time(b) for a, b in pairs]
        else:
            ms = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(ms)
    return out


def stage_device_times(fn_by_name: Mapping[str, Callable[[], object]],
                       device) -> Dict[str, float]:
    """Device ms of ONE call of each named stage: the sum of the kernels'
    durations in a :func:`trace` of that call (after one warm-up call).
    Beside :func:`stage_times` it tells a stage the card works through
    from one whose time is the host's launches.  CUDA devices only."""
    if torch.device(device).type != "cuda":
        raise ValueError("stage_device_times traces the card; a CPU run "
                         "has no device time")
    out = {}
    for name, fn in fn_by_name.items():
        fn()
        torch.cuda.synchronize(device)
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp):
                fn()
            out[name] = sum(op_histogram(tmp, top=None).values())
    return out


def stage_summary(stages_ms: Mapping[str, float], whole_ms: float,
                  parts: Optional[Iterable[str]] = None) -> dict:
    """The stages named in `parts` (default: all) against the whole they
    were cut from: their sum, its ratio to `whole_ms`, and each stage's
    share of the sum."""
    names = list(stages_ms) if parts is None else list(parts)
    total = sum(stages_ms[k] for k in names)
    return {"sum_ms": total, "whole_ms": whole_ms,
            "sum_over_whole": total / whole_ms,
            "share": {k: stages_ms[k] / total for k in names}}
