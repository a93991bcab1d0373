"""Tracing / profiling harness on ``torch.profiler`` and CUDA events.

Twin of ``coulomb_oscillators_tpu/utils/profiling.py`` in function:

  * :func:`trace` — context manager around ``torch.profiler.profile`` that
    records host and CUDA activity and writes a Chrome trace under a
    directory (viewable in Perfetto / chrome://tracing).
  * :func:`op_histogram` — device-kernel durations by kernel name from a
    trace directory or a finished profiler, for terminal triage.
  * :func:`stage_times` — median time of named stages with CUDA events
    (no profiler, no CUPTI needed), ``perf_counter`` on the CPU.
  * :func:`stage_device_times` — the kernels' summed durations of one
    call of each stage, from a trace.
  * ``utils/timing.py`` holds the wall-clock harness.
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
import time
from typing import Callable, Dict, Iterable, Mapping, Optional

import torch

# Chrome-trace categories of work that ran on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block: ``with trace("/tmp/tr") as prof: run(); sync()``.

    Records CPU activity, and CUDA activity when a card is present; on
    exit the Chrome trace is written to ``<logdir>/trace.json``.  Yields
    the profiler.  With a card but without CUDA tracing in this PyTorch
    build (CUPTI missing) it raises instead of recording host time only."""
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
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


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


def _profiler_events(prof):
    """A finished profiler's events in Chrome-trace form."""
    from torch.autograd import DeviceType
    for e in prof.events():
        yield {"ph": "X", "name": e.name,
               "cat": ("kernel" if e.device_type == DeviceType.CUDA
                       else "cpu_op"),
               "dur": e.time_range.elapsed_us()}


def _trace_files(logdir: str):
    pats = ("*.json", "*.json.gz")
    return sorted(f for p in pats for f in glob.glob(
        os.path.join(logdir, "**", p), recursive=True))


def op_histogram(logdir_or_prof, top: Optional[int] = 30,
                 categories=DEVICE_CATEGORIES) -> Dict[str, float]:
    """Device-kernel durations (ms) by kernel name, largest first, from a
    :func:`trace` directory or a finished ``torch.profiler.profile``.
    Host events are excluded (pass ``categories=("cpu_op",)`` for the
    host's operators instead)."""
    if not isinstance(logdir_or_prof, (str, os.PathLike)):
        return histogram(_profiler_events(logdir_or_prof), top, categories)
    events = []
    for f in _trace_files(os.fspath(logdir_or_prof)):
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
