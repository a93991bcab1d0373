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


def test_direct_bench_cases_and_bounds():
    """direct_bench's cases (the CLI's beams at ladder 1's, the CLI's and
    a large N) and its work and bounds: N^2 pairs, positions read and
    forces written once, 20 / 14 flops a pair over 67 TFLOP/s against one
    special-function op a pair."""
    from coulomb_oscillators_tpu_torch.scripts import direct_bench as B
    assert B.CASES == ((3, 4096), (3, 30001), (3, 262144), (2, 30001))
    w = B.work(30001, 3)
    assert w["pairs"] == 30001 ** 2 and w["bytes"] == 2 * 30001 * 3 * 4
    assert w["bound_by"] == "operations"
    assert w["bound_ms"] == pytest.approx(30001 ** 2 * 20 / 67e12 * 1e3)
    assert w["bound_ms"] == pytest.approx(0.2687, rel=1e-3)
    w2 = B.work(30001, 2)
    assert w2["bound_ms"] == pytest.approx(w2["mufu_ms"])
    assert w2["bound_ms"] == pytest.approx(0.2152, rel=1e-3)
    assert B.work(262144, 3)["bound_ms"] == pytest.approx(20.51, rel=1e-3)
    cfg, pos = B.beam(64, 2)
    assert cfg.dim == 2 and pos.shape == (64, 2)
    # the earlier kernel's split rule: 118 tiles x 9 splits at N = 30001
    assert B.old_splits(30001, 132) == (9, 14)


def test_direct_bench_reads_the_pair_loop():
    """The SASS reader finds the innermost loop with the most pair ops (a
    backward branch, by address or by label; the 3D function's outer loop
    holds more) and counts its instructions a pair."""
    from coulomb_oscillators_tpu_torch.scripts import direct_bench as B
    sass = """
        Function : _ZN12_GLOBAL__N_113direct_kernelILi3EEEvPKfPfiiff
        /*0000*/                   S2R R0, SR_TID.X ;      /* 0x0 */
        /*0010*/                   LDS.128 R4, [R2] ;      /* 0x0 */
        /*0020*/                   FADD R8, R9, -R4 ;      /* 0x0 */
        /*0030*/                   MUFU.RSQ R10, R11 ;     /* 0x0 */
        /*0040*/                   MUFU.RSQ R12, R13 ;     /* 0x0 */
        /*0050*/               @P0 BRA 0x10 ;              /* 0x0 */
        /*0060*/                   MUFU.RSQ R12, R13 ;     /* 0x0 */
        /*0070*/               @P1 BRA 0x0 ;               /* 0x0 */
        /*0080*/                   EXIT ;                  /* 0x0 */
        Function : _ZN12_GLOBAL__N_113direct_kernelILi2EEEvPKfPfiiff
        /*0000*/                   S2R R0, SR_TID.X ;      /* 0x0 */
.L_x_1:
        /*0010*/                   MUFU.RCP R10, R11 ;     /* 0x0 */
        /*0020*/                   FFMA R1, R2, R3, R1 ;   /* 0x0 */
        /*0030*/                   FFMA R4, R2, R3, R4 ;   /* 0x0 */
        /*0040*/              @!P1 BRA `(.L_x_1) ;         /* 0x0 */
        /*0050*/                   MUFU.RCP R10, R11 ;     /* 0x0 */
        /*0060*/                   BRA `(.L_x_1) ;         /* 0x0 */
        /*0070*/                   EXIT ;                  /* 0x0 */
    """
    loops = B.sass_loops(sass)
    l3 = loops["_ZN12_GLOBAL__N_113direct_kernelILi3EEEvPKfPfiiff"]
    assert (l3["instructions"], l3["pairs"], l3["per_pair"]) == (5, 2, 2.5)
    assert l3["ops"]["MUFU.RSQ"] == 2 and l3["ops"]["BRA"] == 1
    l2 = loops["_ZN12_GLOBAL__N_113direct_kernelILi2EEEvPKfPfiiff"]
    assert (l2["instructions"], l2["pairs"]) == (4, 1)    # the inner one


def test_direct_bench_refuses_without_a_card(monkeypatch, capsys):
    from coulomb_oscillators_tpu_torch.scripts import direct_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert direct_bench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
