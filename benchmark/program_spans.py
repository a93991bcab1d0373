"""The program's own spans, counters and timed stages, as the per-layer
readers of ``benchmark/metrics/`` read them: the totals of
``coulomb_oscillators_tpu_torch/utils/profiling.py``.  The readers run
after the harness has released the Simulator, so the step graph's last
stage sample has been read; and the program records only while a
profiler runs, so the totals hold the traced tail alone.  A program
without them (an older checkout) gives None, as does a name nothing
recorded: no reader raises for it.

Stage times are samples: a step graph's timing events hold its last
replay, and the program takes one replay a window as the time of each of
the window's steps (within a window the lists and shapes are fixed, so
every step does the same work).
"""

from __future__ import annotations


def totals():
    """The program's totals (``{name: {"count", "seconds"}}``), or None
    where the program has none."""
    try:
        from coulomb_oscillators_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "totals", None)
    return read() if callable(read) else None


def stage_ms_per_step(*names):
    """The summed sampled seconds of the stages `names` over the steps the
    samples cover (``stage.steps``), in ms; None without a sample of any
    of them."""
    tot = totals()
    if not tot:
        return None
    steps = tot.get("stage.steps", {}).get("count", 0)
    found = [tot[n]["seconds"] for n in names if n in tot]
    if not steps or not found:
        return None
    return 1e3 * sum(found) / steps


def per_count_ms(name: str):
    """A total's seconds over its count, in ms; None without it."""
    tot = totals()
    entry = (tot or {}).get(name)
    if not entry or not entry["count"]:
        return None
    return 1e3 * entry["seconds"] / entry["count"]
