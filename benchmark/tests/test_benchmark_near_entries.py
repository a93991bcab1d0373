"""The reader of ``near_entries_per_row``: the near entries of the traced
tail's list builds over their sub-leaf rows, from the program's counters
(``kd.lists.near_entries``, ``kd.lists.near_rows``); None from empty
totals or from a program without totals, never raising."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark import harness as H
from benchmark.tests.conftest import REPO

from coulomb_oscillators_tpu_torch.utils import profiling as P

NAME = "near_entries_per_row"


def _read(ctx=None):
    return H.load_module(REPO, "metrics", NAME).read(
        ctx or types.SimpleNamespace())


@pytest.fixture
def clean():
    P.reset()
    yield
    P.reset()


def test_empty_totals_read_nothing(clean):
    assert _read() is None
    P.count("kd.lists.near_row_max", 130)
    assert _read() is None


def test_filled_totals(clean):
    """Three builds of 4096 rows: 520,000, 530,000 and 40,000 entries."""
    for entries in (520_000, 530_000, 40_000):
        P.count("kd.lists.near_entries", entries)
        P.count("kd.lists.near_rows", 4096)
        P.count("kd.lists.near_row_max", 200)
    assert _read() == pytest.approx(1_090_000 / (3 * 4096))


def test_a_program_without_totals_reads_nothing(clean, monkeypatch):
    P.count("kd.lists.near_entries", 100)
    P.count("kd.lists.near_rows", 10)
    monkeypatch.delattr(P, "totals")
    assert _read() is None


@pytest.mark.parametrize("cell", ["tiny_kd2.w", "tiny_beam.w"])
def test_a_recorded_cpu_run_reads_its_builds(tiny_root, clean, cell):
    """A tiny window cell on the CPU under a CPU profiler, in 2D and in
    3D: the list builds of the recorded window give a ratio above zero;
    without the profiler nothing is counted."""
    torch.set_num_threads(2)
    H.run_cell(tiny_root, cell, 7, 0.2, device="cpu")
    assert _read() is None
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        out = H.run_cell(tiny_root, cell, 7, 0.2, device="cpu")
    assert out["correct"]
    tot = P.totals()
    assert tot["kd.lists.near_rows"]["count"] > 0
    assert _read() > 0.0
