"""The readers of the program's own spans, counters and timed stages
(``benchmark/program_spans.py`` and the five metrics over it): each gives
a number from filled totals and None from empty ones, a program without
totals gives None, and none of them reads the harness's own spans or its
trace."""

from __future__ import annotations

import os
import types

import pytest
import torch

from benchmark import harness as H
from benchmark import program_spans as S
from benchmark.tests.conftest import REPO

from coulomb_oscillators_tpu_torch.utils import profiling as P

STAGE_READERS = ("m2l_ms_per_step", "upward_ms_per_step",
                 "downward_ms_per_step")
READERS = STAGE_READERS + ("boundary_device_ms_per_step",
                           "graph_capture_s")


class _Event:
    """A stand-in for a CUDA timing event at `ms` on the stream."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.ms - self.ms


def _read(name, ctx):
    return H.load_module(REPO, "metrics", name).read(ctx)


@pytest.fixture
def clean():
    P.reset()
    yield
    P.reset()


def test_empty_totals_read_nothing(clean):
    ctx = types.SimpleNamespace()
    assert all(_read(name, ctx) is None for name in READERS)
    # a missed sample alone is no stage time
    P.count("stage.samples_missed")
    assert all(_read(name, ctx) is None for name in STAGE_READERS)


def test_filled_totals(clean):
    """Two windows sampled (16 and 8 steps), a third whose last mark had
    not completed when read, and two boundary gaps."""
    names = ("fmm.refresh", "fmm.upward", "fmm.m2l", "fmm.downward",
             "fmm.p2p", None)
    marks = [(n, _Event(t)) for n, t in zip(names, (0.0, 1.0, 4.0, 44.0,
                                                    46.0, 58.0))]
    P.add_sample(marks, 16)
    P.add_sample(marks, 8)
    P.add_sample(marks[:3] + [(None, _Event(9.0, False))], 4)
    P.count("sim.boundary.device", 16, 0.032)
    P.count("sim.boundary.device", 8, 0.004)
    ctx = types.SimpleNamespace(capture_s=0.75)
    assert _read("m2l_ms_per_step", ctx) == pytest.approx(40.0)
    assert _read("upward_ms_per_step", ctx) == pytest.approx(1.0 + 3.0)
    assert _read("downward_ms_per_step", ctx) == pytest.approx(2.0)
    assert _read("boundary_device_ms_per_step", ctx) == pytest.approx(1.5)
    assert _read("graph_capture_s", ctx) == 0.75
    tot = P.totals()
    assert tot["stage.steps"]["count"] == 24
    assert tot["stage.samples_missed"]["count"] == 1
    assert S.stage_ms_per_step("fmm.p2p") == pytest.approx(12.0)
    assert S.stage_ms_per_step("no.such.stage") is None


def test_a_program_without_totals_reads_nothing(clean, monkeypatch):
    """The parent's program has no ``profiling.totals``: every reader
    gives None and none raises."""
    P.count("sim.boundary.device", 8, 0.004)
    monkeypatch.delattr(P, "totals")
    ctx = types.SimpleNamespace()
    assert all(_read(name, ctx) is None for name in READERS)


def test_no_reader_reads_the_harness_spans_or_trace():
    for name in READERS:
        with open(os.path.join(REPO, "benchmark", "metrics",
                               f"{name}.py")) as f:
            src = f.read()
        assert "bench." not in src and "ctx.tr" not in src, name
    with open(os.path.join(REPO, "benchmark", "program_spans.py")) as f:
        src = f.read()
    assert "bench." not in src and "ctx" not in src


def test_a_recorded_cpu_run_fills_the_readers(tiny_root, clean):
    """A tiny window cell on the CPU under a CPU profiler: after the
    harness has released the Simulator, the stage readers and the
    boundary reader find numbers (host times here, never device
    numbers); without the profiler the same run records nothing."""
    torch.set_num_threads(2)
    out = H.run_cell(tiny_root, "tiny_beam.w", 7, 0.2, device="cpu")
    assert out["correct"]
    assert P.totals() == {}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        out = H.run_cell(tiny_root, "tiny_beam.w", 7, 0.2, device="cpu")
    assert out["correct"]
    ctx = types.SimpleNamespace(capture_s=out["diag"]["capture_s"])
    for name in READERS:
        v = _read(name, ctx)
        assert v is not None and v >= 0.0, name
    tot = P.totals()
    assert tot["stage.steps"]["count"] > 0
    assert tot["sim.boundary.wait"]["count"] >= 1
