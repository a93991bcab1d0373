"""The comparison fails what it must, at a size a test run holds.

  * the control (the reference in bfloat16 in the program's place) fails
    each tiny cell's limits while the program meets them; the force alone
    in bfloat16, with the step in float32, fails the beam cells' in 3D and
    in 2D (the CLI configuration's own force error is as coarse as
    bfloat16's: PERF.md);
  * a run whose timed path is broken underneath reads ``correct`` false,
    for each fault a one-chip cell can have: a step that returns its
    state unchanged, half of the particles left out of the force, an
    answer altered where it is produced, and (the CLI cell) a snapshot
    byte altered on its way to disk.  These cells have no exchange
    between chips to leave out.

Each run skips the harness's look for a card (``device="cpu"``) and
drives the rest of it; the limits are the real cells' own.
"""

from __future__ import annotations

import pytest

from benchmark import harness as H
from benchmark.reference import compare as CMP

CELLS = ["tiny_beam.w", "tiny_cli.s", "tiny_kd2.w"]
SEED = 2 ** 31 + 101


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(tiny_root, cell):
    out = H.run_cell(tiny_root, cell, SEED, 0.3, device="cpu",
                     control=True)
    limits = H.load_json(tiny_root, "benchmark", "workloads",
                         f"{cell}.json")["limits"]
    assert out["correct"], out["checks"]
    assert not all(ok for *_, ok in CMP.judge(out["control"], limits))
    if cell != "tiny_cli.s":
        assert not all(ok for *_, ok in CMP.judge(out["control_force"],
                                                  limits))


def _unchanged(monkeypatch):
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    monkeypatch.setattr(Simulator, "_window",
                        lambda self, state, frozen, k: state)


def _half_left_out(monkeypatch):
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine
    orig = KdFmmEngine.force_padded

    def half(self, ppad, fs):
        out = orig(self, ppad, fs).clone()
        out[: out.shape[0] // 2] = 0.0
        return out
    monkeypatch.setattr(KdFmmEngine, "force_padded", half)


def _altered(monkeypatch):
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    orig = Simulator._window

    def window(self, state, frozen, k):
        out = orig(self, state, frozen, k)
        pos = out.pos.clone()
        # one particle's last axis: z in 3D (0.1 of its rms), y in 2D
        # (1.8 of its rms)
        pos[0, 0, -1] += 1e-3
        return out._replace(pos=pos)
    monkeypatch.setattr(Simulator, "_window", window)


def _snapshot_byte(monkeypatch):
    from coulomb_oscillators_tpu_torch.utils import io as SIO
    orig = SIO.write_state

    def write(path, pos, vel):
        pos = pos.copy()
        pos.view("u1")[7] ^= 1
        orig(path, pos, vel)
    monkeypatch.setattr(SIO, "write_state", write)


FAULTS = [("tiny_beam.w", _unchanged), ("tiny_beam.w", _half_left_out),
          ("tiny_beam.w", _altered), ("tiny_cli.s", _unchanged),
          ("tiny_cli.s", _half_left_out), ("tiny_cli.s", _altered),
          ("tiny_cli.s", _snapshot_byte), ("tiny_kd2.w", _unchanged),
          ("tiny_kd2.w", _half_left_out), ("tiny_kd2.w", _altered)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_reads_not_correct(tiny_root, cell, fault,
                                               monkeypatch):
    fault(monkeypatch)
    out = H.run_cell(tiny_root, cell, SEED, 0.3, device="cpu")
    assert not out["correct"], out["checks"]
