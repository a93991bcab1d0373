"""The port's ladder and energy-drift scripts on the CPU at a tiny size:
the ladder's configurations are the twin's, a row runs each engine kind,
the freeze-and-drift mode and the artifact file work as in the twin, the
drift of an exact-force run stays tiny, the north-star artifact runs the
twin's stiffening ladder, and both scripts refuse to measure without a
card.
"""

import importlib.util
import json
import math
import os
import sys

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


@pytest.mark.parametrize("env,want", [(None, True), ("1", True),
                                      ("0", False)])
def test_ladder_geom_refresh_switch(monkeypatch, env, want):
    """CO_GEOM_REFRESH=0 (read by the ladder alone, as in the twin's
    scripts/ladder.py:47-48) reaches the Simulator's config, and the row
    says which mode ran."""
    from coulomb_oscillators_tpu_torch import simulate
    if env is None:
        monkeypatch.delenv("CO_GEOM_REFRESH", raising=False)
    else:
        monkeypatch.setenv("CO_GEOM_REFRESH", env)
    seen = []

    class Recording(simulate.Simulator):
        def __init__(self, config, *a, **k):
            seen.append(config.geom_refresh)
            super().__init__(config, *a, **k)

    monkeypatch.setattr(simulate, "Simulator", Recording)
    cfg = SimConfig(fmm_order=3, tree_radius=2.0, tree_steps=2)
    row = ladder.run("t", cfg, 512, "fmm3_kd", "cpu", steps=3, repeats=1)
    assert seen == [want] and row["geom_refresh"] is want
    assert row["steps_run"] == 2 + 2 + 3
    assert row["finite"] and row["captures"] == 0 and row["peak_gib"] is None
    assert cfg.geom_refresh                  # the caller's config is kept


def _fake_ladder(monkeypatch, fail=None):
    """main() without a card: a fake row per config, raising for the tag
    `fail`; records the artifact's row count when each row starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ladder, "card", lambda: {"device": "fake",
                                                 "power_limit": "1 W"})
    seen = []

    def run(tag, config, n, engine, device, **kw):
        out = os.environ.get("CO_LADDER_OUT") or "ladder_out.json"
        seen.append((tag, len(json.load(open(out))["rows"])
                     if os.path.exists(out) else 0))
        if tag == fail:
            raise RuntimeError(f"no room for {tag}")
        return {"config": tag, "engine": engine, "n": n}

    monkeypatch.setattr(ladder, "run", run)
    return seen


def test_ladder_octree_error_row(tmp_path, monkeypatch):
    """A raise in config 3b gives the twin's error row and the ladder goes
    on (scripts/ladder.py:120-131); a raise anywhere else ends the run."""
    monkeypatch.chdir(tmp_path)
    tag = ladder.OCTREE_ROW
    seen = _fake_ladder(monkeypatch, fail=tag)
    assert ladder.main(["3", "4", "--out", "ladder_out.json"]) == 0
    rows = json.load(open("ladder_out.json"))["rows"]
    ex = RuntimeError(f"no room for {tag}")
    assert rows[1] == {"config": tag, "error": repr(ex)[:200]}
    assert [r["config"] for r in rows] == [t for t, _ in seen] == [
        "3a_kd_N1M_beam", tag, "4_p8_forestruth_N100k"]
    _fake_ladder(monkeypatch, fail="3a_kd_N1M_beam")
    with pytest.raises(RuntimeError, match="no room for 3a"):
        ladder.main(["3"])


@pytest.mark.parametrize("how", ["--out", "CO_LADDER_OUT", "neither"])
def test_ladder_artifact_rewritten_after_each_row(tmp_path, monkeypatch,
                                                  how):
    """--out, or else CO_LADDER_OUT, names the artifact, rewritten after
    every row; with neither nothing is written (never the twin's root
    LADDER_r05.json)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("CO_LADDER_OUT", raising=False)
    argv = ["1", "2", "4"]
    if how == "--out":
        argv += ["--out", "ladder_out.json"]
    elif how == "CO_LADDER_OUT":
        monkeypatch.setenv("CO_LADDER_OUT", "ladder_out.json")
    seen = _fake_ladder(monkeypatch)
    assert ladder.main(argv) == 0
    if how == "neither":
        assert os.listdir(tmp_path) == [] and [k for _, k in seen] == [0] * 3
        return
    assert [k for _, k in seen] == [0, 1, 2]
    rows = json.load(open("ladder_out.json"))["rows"]
    assert [r["config"] for r in rows] == [t for t, _ in seen]
    assert rows[0]["device"] == "fake"


def _reference_drift_script(monkeypatch):
    """scripts/energy_drift.py loaded as a module, without its compile
    cache and with sys.path restored."""
    from coulomb_oscillators_tpu.utils import cache
    monkeypatch.setattr(cache, "_enabled", True)
    monkeypatch.setattr(sys, "path", list(sys.path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "reference_energy_drift", os.path.join(root, "scripts",
                                               "energy_drift.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_energy_drift_artifact_is_the_twins(tmp_path, monkeypatch, capsys):
    """artifact() against the twin's emit_artifact, with both run_ones
    replaced by one fake whose first rung drifts past 1e-6 and whose second
    does not: the same two calls with the same arguments, the same printed
    stiffening line, the same keys, values and config; the port adds the
    bound, the verdict, each rung's drift and where it ran.  The second
    rung's explicit boost wins over the accuracy-grade auto-boost in both
    packages."""
    from coulomb_oscillators_tpu import SimConfig as JConfig
    from coulomb_oscillators_tpu.ops.fmm.kdtree import KdFmmEngine as JEng
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine
    ref = _reference_drift_script(monkeypatch)
    monkeypatch.chdir(tmp_path)

    def fake(calls):
        def run_one(*args, **kw):
            kw.pop("device", None)
            calls.append((args, kw))
            return ((2e-6, 3e-6, 1.5) if len(calls) == 1
                    else (4e-7, 6e-7, 1.25))
        return run_one

    want_calls, got_calls = [], []
    monkeypatch.setattr(ref, "run_one", fake(want_calls))
    monkeypatch.setattr(energy_drift, "run_one", fake(got_calls))
    ref.emit_artifact(path=str(tmp_path / "ref.json"), steps=77)
    want_out = capsys.readouterr().out
    want = json.load(open(tmp_path / "ref.json"))
    got = energy_drift.artifact(steps=77, device=torch.device("cpu"))
    got_out = capsys.readouterr().out
    assert got_calls == want_calls and len(got_calls) == 2
    stiffen = [ln for ln in want_out.splitlines() if "stiffening" in ln]
    assert len(stiffen) == 1 and stiffen[0] in got_out.splitlines()
    assert set(got) - set(want) == {"bound", "pass", "rung_max_drifts",
                                    "torch", "device"}
    for k in ("metric", "value", "max_drift", "steps", "config",
              "psteps_per_s"):
        assert got[k] == want[k], k
    assert got["config"]["mac_sub_boost"] == 4.0
    assert (got["bound"], got["pass"], got["rung_max_drifts"]) == (
        1e-6, True, [3e-6, 6e-7])
    assert "total_energy_kahan" in got["measurement"]
    assert os.listdir(tmp_path) == ["ref.json"]      # no default file
    for kw in energy_drift.ARTIFACT_LADDER:
        t = KdFmmEngine(SimConfig(fmm_order=6, tree_radius=2.5, **kw),
                        30001).mac_sub_boost
        assert t == JEng(JConfig(fmm_order=6, tree_radius=2.5, **kw),
                         30001).mac_sub_boost
        assert t == kw.get("mac_sub_boost", 2.0)


def test_energy_drift_artifact_runs():
    """The artifact at n=512, 20 steps on the CPU: finite drifts on the
    first rung, well inside the bound."""
    res = energy_drift.artifact(steps=20, n=512, device=torch.device("cpu"))
    assert res["config"]["n"] == 512 and res["steps"] == 20
    assert 0.0 <= res["value"] <= res["max_drift"] < 1e-6
    assert res["pass"] and res["rung_max_drifts"] == [res["max_drift"]]
    assert res["device"] == "cpu" and res["psteps_per_s"] > 0


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
    assert energy_drift.main(["artifact", "10"]) == 1
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
