"""The port's ladder and energy-drift scripts on the CPU at a tiny size:
the ladder's configurations are the twin's, a row runs each engine kind,
the drift of an exact-force run stays tiny, and both scripts refuse to
measure without a card.
"""

import math

import pytest
import torch

from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.scripts import energy_drift, ladder

torch.set_num_threads(1)


def test_ladder_configs_are_the_twins():
    """Configs 1-5 of scripts/ladder.py: tags, engines, sizes and knobs."""
    rows = ladder.configs({1, 2, 3, 4, 5})
    assert [(tag, eng, n) for tag, _, n, eng, _ in rows] == [
        ("1_direct_N4096", "direct", 4096),
        ("2_fmm2d_N100k_p4", "fmm2_kd", 100_000),
        ("3a_kd_N1M_beam", "fmm3_kd", 1_000_000),
        ("3b_octree_traceless_N1M_uniform", "fmm3_traceless", 1_000_000),
        ("4_p8_forestruth_N100k", "fmm3_kd", 100_000),
        ("5_kd_N10M_rebuild_every_step", "fmm3_kd", 10_000_000)]
    cfg = {tag: c for tag, c, *_ in rows}
    assert cfg["2_fmm2d_N100k_p4"].dim == 2
    assert cfg["4_p8_forestruth_N100k"].integrator == "forestruth"
    assert cfg["4_p8_forestruth_N100k"].fmm_order == 8
    assert cfg["5_kd_N10M_rebuild_every_step"].tree_steps == 1
    assert [r[0] for r in ladder.configs({1, 2, 3, 4})] == [
        r[0] for r in rows[:5]]


@pytest.mark.parametrize("engine,cfg,uniform", [
    ("direct", dict(), False),
    ("fmm2_kd", dict(dim=2, omega0=(1.095, 1.0), fmm_order=3,
                     tree_radius=2.0, tree_steps=2), False),
    ("fmm3_traceless", dict(fmm_order=3, tree_steps=2), True),
])
def test_ladder_row_runs(engine, cfg, uniform):
    row = ladder.run("t", SimConfig(**cfg), 512, engine, "cpu", steps=3,
                     uniform=uniform, repeats=1)
    assert row["engine"] == engine and row["n"] == 512 and row["finite"]
    assert row["sec_per_step"] > 0 and math.isfinite(row["sec_per_step"])
    assert row["particle_steps_per_s"] == pytest.approx(
        512 / row["sec_per_step"])


def test_energy_drift_run_one_exact_forces():
    """Exact forces at the encounter-resolving dt=2e-5: drift far below
    the 1e-6 north-star bound over 40 steps."""
    drift, max_drift, psteps = energy_drift.run_one(
        512, 40, "direct", 3, 2.0, dt=2e-5, block=20, quiet=True,
        device=torch.device("cpu"))
    assert 0.0 <= drift <= max_drift < 1e-7
    assert psteps > 0


def test_scripts_refuse_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ladder.main(["1"]) == 1
    assert energy_drift.main(["sweep", "10"]) == 1
    err = capsys.readouterr().err
    assert "no CUDA device" in err
