"""The port's bench and its probes on the CPU at small N.

The grid constants equal the root bench.py's (read with `ast`, nothing of
it is imported); `_score`, the refinement gates, the certification and
`_emit`'s field set hold on synthetic rows; the interaction counts of
`probe` equal the reference's arithmetic run on the reference engine's
lists for the same positions; `window_ladder` leaves a run bitwise
unchanged; `bench --n 2048 --device cpu --quick` prints one JSON line
with every field; and every measurement script raises without a card
unless ``--device cpu`` is given.  No time measured here is a device time.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu import native as jnative
from coulomb_oscillators_tpu import simulate as jsim
from coulomb_oscillators_tpu.ops.fmm.kdtree import (KdFmmEngine as JEngine,
                                                    _heap_off)
from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.scripts import _common as C
from coulomb_oscillators_tpu_torch.scripts import bench as B
from coulomb_oscillators_tpu_torch.scripts import cadence_probe as CP
from coulomb_oscillators_tpu_torch.scripts import profile_force as PF
from coulomb_oscillators_tpu_torch.scripts import stale_margin_probe as SP
from coulomb_oscillators_tpu_torch.simulate import Simulator
from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2048
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ("CO_SUB_BOOST", "CO_M2L_GROUP", "CO_STALE_MARGIN",
              "CO_STALE_MARGIN_FACTOR", "CO_SORT_MODE", "CO_BENCH_BUDGET_S",
              "CO_CADENCE_COMBOS", "CO_TS", "CO_RESORT", "CO_PIPE",
              "CO_BUILDER"):
        monkeypatch.delenv(k, raising=False)


# ---- constants -------------------------------------------------------------

def _root_constants(path, names):
    """The first module-level literal assignment of each name in a
    source file, by `ast`."""
    tree = ast.parse(open(path).read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in names \
                and node.targets[0].id not in out:
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


def test_grid_constants_equal_the_root_bench():
    names = ("ERR_BOUND", "N_HEAD", "SEARCH_P", "SEARCH_R", "SEARCH_BOOST",
             "DEFAULT_TUNED", "REFINE")
    root = _root_constants(os.path.join(REPO, "bench.py"), names)
    assert set(root) == set(names)
    for k in names:
        assert getattr(B, k) == root[k], k
    # the second cadence is the config's own defaults
    cfg = SimConfig()
    assert B.DEFAULT_CADENCE == {"tree_steps": cfg.tree_steps,
                                 "resort_every": cfg.tree_resort_every,
                                 "pipeline": cfg.tree_pipeline}


def test_cadence_probe_combos_are_the_originals_plus_the_defaults(
        monkeypatch):
    root = _root_constants(os.path.join(REPO, "scripts", "cadence_probe.py"),
                           ("COMBOS",))["COMBOS"]
    assert list(CP.COMBOS[:-1]) == root
    assert CP.COMBOS[-1] == (8, 1, 1, 1, "host")
    assert CP.combos_from_env() == CP.COMBOS
    monkeypatch.setenv("CO_CADENCE_COMBOS", "8,4,2,1,host;16,4,2,0,kd_device;"
                                            "4,1,1")
    assert CP.combos_from_env() == ((8, 4, 2, 1, "host"),
                                    (16, 4, 2, 0, "kd_device"),
                                    (4, 1, 1, 1, "host"))
    with pytest.raises(ValueError):
        CP.parse_combos("8,1")


# ---- pure helpers ----------------------------------------------------------

def test_score_and_refine_gates():
    row = {"err": 5e-4, "force_s": 0.08, "rebuild_s": 1.6}
    assert B._score(row, 16) == pytest.approx(0.18)
    assert B._score({"force_s": 0.1}, 8) == pytest.approx(0.1)
    assert B._score(row, 0) == pytest.approx(1.68)
    # the 1.5x window-headroom gate: 5e-4 x 1.5 <= 1e-3 passes, 7e-4 not
    assert B.refine_gate(row, 0.2, 16)[0]
    assert not B.refine_gate(dict(row, err=7e-4), 0.2, 16)[0]
    assert "headroom" in B.refine_gate(dict(row, err=7e-4), 0.2, 16)[1]
    # the 0.95 score gate: 0.18 < 0.95 x 0.19 = 0.1805, not < 0.95 x 0.189
    assert B.refine_gate(row, 0.19, 16)[0]
    assert not B.refine_gate(row, 0.189, 16)[0]
    # an over-bound probe row has no cost fields
    assert B.refine_gate({"err": 2e-3}, 1.0, 16) == (False, "over bound")


def test_certify():
    ok = {0: 3e-4, 8: 4e-4, 16: 5e-4}
    assert B.certify(3e-4, [ok]) == (True, "")
    assert B.certify(3e-4, [ok, ok]) == (True, "")
    assert not B.certify(1.2e-3, [ok])[0]
    assert "fresh-tree" in B.certify(1.2e-3, [ok])[1]
    assert "window-mean" in B.certify(3e-4, [{0: 9e-4, 16: 1.3e-3}])[1]
    late = {0: 1e-4, 8: 1e-4, 16: 1.1e-3}
    assert "window step" in B.certify(3e-4, [late])[1]
    # every window of the re-sort cycle counts, not only the first
    assert "window 1" in B.certify(3e-4, [ok, late])[1]
    assert not B.certify(3e-4, [])[0]
    assert not B.certify(float("nan"), [ok])[0]


def _block(**kw):
    win = {"s_per_step": 0.1, "caps": {"p2p": 8192}, "boundary_wait_s": 0.2,
           "counts": {"m2l": 10, "p2p": 5}, "rebuild_s": 1.5,
           "rebuild_breakdown_s": {"kd": 0.4, "traverse": 0.7}}
    out = {"p": 6, "r": 1.67, "boost": 1.5, "err": 3.3e-4, "median": 0.1,
           "times": [0.1, 0.11, 0.09], "windows": [win, win, win],
           "cadence": {"tree_steps": 16, "resort_every": 2, "pipeline": 2,
                       "builder": "host"},
           "ladders": [{0: 3.0e-4, 8: 3.2e-4, 16: 3.5e-4},
                       {0: 3.4e-4, 8: 3.8e-4, 16: 4.4e-4}],
           "margin": [1e-4, 3e-5, 3e-4], "rebuilds": {"adopt_full": 3},
           "finite": True}
    out.update(kw)
    return out


# the root bench's `extra` fields the port keeps, and the port's own
ORIGINAL_EXTRA = {"n", "p", "r", "sub_boost", "force_rel_err", "err_bound",
                  "sec_per_step_median", "sec_per_step_all", "tree_steps",
                  "resort_every", "pipeline", "builder",
                  "stale_window_errs", "stale_window_mean_err",
                  "stale_window_err", "stale_margin_auto",
                  "interaction_rates", "probes", "final_candidates", "note"}
PORT_EXTRA = {"default_cadence", "rebuild_s", "rebuild_breakdown_s",
              "boundary_wait_s", "device", "certified"}
RATES = {"p2p_phys_Gint_per_s", "p2p_lane_Gint_per_s", "m2l_Mtrans_per_s",
         "p2p_phys_int_per_eval", "p2p_lane_int_per_eval",
         "m2l_entries_per_eval"}


def test_emit_field_set_on_synthetic_rows():
    probes = [{"p": 6, "r": 1.67, "boost": 1.5, "err": 3.3e-4,
               "p2p_phys_int": 6_000_000_000, "p2p_lane_int": 6_500_000_000,
               "m2l_entries": 40_000_000, "force_s": 0.08, "rebuild_s": 1.4}]
    best = _block()
    dflt = B._cadence_block(_block(cadence={"tree_steps": 8,
                                            "resort_every": 1,
                                            "pipeline": 1}), 1_000_000)
    out = B._emit(best, 1_000_000, "leapfrog", probes, [{"p": 6}],
                  default_cadence=dflt, device={"device": "x"}, note="t")
    assert out["metric"] == "particle_steps_per_s"
    assert out["unit"] == "psteps/s"
    assert out["value"] == pytest.approx(1e7)
    assert "vs_baseline" not in out and "vs_baseline" not in out["extra"]
    x = out["extra"]
    assert ORIGINAL_EXTRA | PORT_EXTRA <= set(x)
    assert set(x["interaction_rates"]) == RATES
    assert x["interaction_rates"]["p2p_phys_Gint_per_s"] == pytest.approx(60)
    assert x["interaction_rates"]["m2l_Mtrans_per_s"] == pytest.approx(400)
    # the cycle's worst window stands for it; all are kept
    assert x["stale_window_errs"] == {"0": 3.4e-4, "8": 3.8e-4, "16": 4.4e-4}
    assert len(x["stale_window_errs_cycle"]) == 2
    assert x["stale_window_errs_cycle"][0]["16"] == 3.5e-4
    assert x["stale_window_err"] == 4.4e-4
    assert x["stale_window_mean_err"] == pytest.approx(3.8666667e-4)
    assert x["certified"] is True and x["certified_reason"] == ""
    assert x["boundary_wait_s"] == [0.2, 0.2, 0.2]
    assert x["rebuild_s"] == [1.5, 1.5, 1.5]
    assert x["rebuild_breakdown_s"] == {"kd": 0.4, "traverse": 0.7}
    d = x["default_cadence"]
    assert (d["tree_steps"], d["resort_every"], d["pipeline"]) == (8, 1, 1)
    assert {"particle_steps_per_s", "sec_per_step_median",
            "sec_per_step_all", "rebuild_s", "rebuild_breakdown_s",
            "boundary_wait_s"} <= set(d)
    json.dumps(out)
    # an uncertified headline says so, and why
    bad = B._emit(_block(ladders=[{0: 9e-4, 16: 1.4e-3}]), 1_000_000,
                  "leapfrog", probes, [])
    assert bad["extra"]["certified"] is False
    assert "window" in bad["extra"]["certified_reason"]
    over = B._emit(_block(err=1.5e-3), 1_000_000, "leapfrog", probes, [])
    assert over["extra"]["certified"] is False
    # a timed candidate's row says whether its own windows certify it
    row = B._final_row(_block(ladders=[{0: 9e-4, 16: 1.4e-3}]))
    assert row["certified"] is False and row["stale_window_max_err"] == 1.4e-3
    assert B._final_row(_block())["certified"] is True
    assert set(row) == {"p", "r", "boost", "err", "median", "certified",
                        "stale_window_max_err", "certified_reason"}
    # a winner without a probe row reports no rates
    assert B._emit(_block(p=5), 1_000_000, "leapfrog", probes,
                   [])["extra"]["interaction_rates"] == {}


def test_load_tuned(tmp_path):
    assert B.load_tuned() == B.DEFAULT_TUNED
    f = tmp_path / "t.json"
    f.write_text(json.dumps({"p": 5, "r": 2.0, "note": "x",
                             "builder": "kd_device"}))
    t = B.load_tuned(str(f))
    assert (t["p"], t["r"], t["boost"]) == (5, 2.0, 1.5)
    assert B.cadence_of(t) == {"tree_steps": 8, "resort_every": 1,
                               "pipeline": 2, "builder": "kd_device"}
    assert B.cadence_of(B.DEFAULT_TUNED) == {
        "tree_steps": 16, "resort_every": 2, "pipeline": 2,
        "builder": "host"}


# ---- probe -----------------------------------------------------------------

@pytest.fixture(scope="module")
def bench():
    b = B.Bench(N, "cpu")
    b.oracle()
    return b


def test_oracle_targets_and_cache(bench, tmp_path):
    sub = np.random.default_rng(0).choice(N, 2048, replace=False)
    assert np.array_equal(bench.sub, sub)
    assert bench.acc_ref.shape == (2048, 3)
    assert np.array_equal(C.oracle_targets(5000),
                          np.random.default_rng(0).choice(5000, 2048,
                                                          replace=False))
    b = B.Bench(512, "cpu", oracle_cache=str(tmp_path))
    assert b.oracle() == "computed"
    ref = b.acc_ref.clone()
    b2 = B.Bench(512, "cpu", oracle_cache=str(tmp_path))
    assert b2.oracle() == "cached" and torch.equal(b2.acc_ref, ref)


@pytest.mark.parametrize("p,r,boost,cadence", [
    (3, 2.0, 1.5, {"tree_steps": 16, "resort_every": 2, "pipeline": 2}),
    (2, 1.67, 1.0, {"tree_steps": 8, "resort_every": 1, "pipeline": 1}),
    (4, 2.5, 1.3, {"tree_steps": 1, "resort_every": 1, "pipeline": 1})],
    ids=["p3", "p2", "p4"])
def test_probe_counts_equal_the_references_arithmetic(bench, p, r, boost,
                                                      cadence):
    """The reference's counting (bench.py, probe) on the reference
    engine's own lists for the same positions and the same margin."""
    row = bench.probe(p, r, boost, cadence)
    # the reference engine, as its probe prepares it
    jcfg = JConfig(fmm_order=p, tree_radius=r)
    eng = JEngine(jcfg, N, use_pallas=True)
    eng.mac_sub_boost = boost if eng.sub_depth else 1.0
    eng.stale_margin_abs = jsim.auto_stale_margin(
        bench.vel_h, jcfg.replace(tree_steps=cadence["tree_steps"],
                                  tree_resort_every=cadence["resort_every"],
                                  tree_pipeline=cadence["pipeline"]))
    perm = jnative.kdtree_build(bench.pos_h, eng.L)
    c_h, lb_h, rb_h, lam_h = jnative.node_geometry(bench.pos_h[perm], eng.L)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(N, dtype=perm.dtype)
    m2l, p2p = eng._traverse(c_h, lb_h, rb_h)
    fs = eng._lists_to_state(perm, inv, c_h, lam_h, m2l, p2p, {})
    Ls, S = eng.L, eng.sub_depth
    mult_leaf = eng.st.mult[_heap_off(Ls):].astype(np.int64)
    tb = p2p[:, 0].astype(np.int64)
    pk = p2p[:, 1].astype(np.int64) & 0xFFFFFFFF
    sb = pk & ((1 << eng.mask_shift) - 1)
    mask = pk >> eng.mask_shift
    src_m = np.zeros(p2p.shape[0], dtype=np.int64)
    for k in range(1 << S):
        src_m += ((mask >> k) & 1) * mult_leaf[(sb << S) + k]
    assert row["p2p_phys_int"] == int(np.sum(mult_leaf[tb] * src_m))
    assert row["p2p_lane_int"] == int(np.sum(np.asarray(fs.p2p_valid))
                                      * eng.st.C * eng.C_blk)
    assert row["m2l_entries"] == int(m2l.shape[0])
    assert row["p2p_phys_int"] > 0 and row["m2l_entries"] > 0
    assert (row["p"], row["r"], row["boost"]) == (p, r, boost)
    # the cost fields come only with an error under the bound
    assert row["err"] > 0
    if row["err"] < B.ERR_BOUND:
        assert row["force_s"] > 0 and row["rebuild_s"] > 0 \
            and row["first_traverse_s"] > 0
    else:
        assert "force_s" not in row and "rebuild_s" not in row


def test_probe_over_bound_has_no_cost_fields(bench):
    row = bench.probe(1, 1.11, 1.0)
    assert row["err"] >= B.ERR_BOUND
    assert "force_s" not in row and "p2p_phys_int" in row


def test_grid_for_p_descends_and_stops(bench, monkeypatch):
    """Radii descending, boosts descending inside; the boost descent
    stops at its first over-bound value, and the radius descent at the
    first radius whose first error is twice the bound (or the second one
    over it)."""
    monkeypatch.setattr(B, "SEARCH_R", [1.11, 1.43, 2.0, 3.0])
    monkeypatch.setattr(B, "SEARCH_BOOST", [1.5, 1.0])
    rows = bench.grid_for_p(2)
    assert [r["r"] for r in rows] == sorted((r["r"] for r in rows),
                                            reverse=True)
    assert (rows[0]["r"], rows[0]["boost"]) == (3.0, 1.5)
    assert all(r["p"] == 2 for r in rows)
    for r in rows:
        assert ("force_s" in r) == (r["err"] < B.ERR_BOUND)
    by_r = {}
    for r in rows:
        by_r.setdefault(r["r"], []).append(r)
    for rr in by_r.values():
        assert [x["boost"] for x in rr] == [1.5, 1.0][:len(rr)]
        # only the last boost tried at a radius may be over the bound
        assert all(x["err"] < B.ERR_BOUND for x in rr[:-1])
    # the largest radius is under the bound, the descent crossed it and
    # stopped there: the smallest radius was never built
    assert rows[0]["err"] < B.ERR_BOUND
    assert rows[-1]["boost"] == 1.5 and rows[-1]["err"] >= B.ERR_BOUND
    assert 1.11 not in by_r
    over = [rr[0]["err"] for rr in by_r.values()
            if rr[0]["err"] >= B.ERR_BOUND]
    assert len(over) <= 2 and (over[-1] >= 2 * B.ERR_BOUND
                               or len(over) == 2)


# ---- window_ladder ---------------------------------------------------------

def _sim(ts=4, resort=2, pipeline=2):
    cfg = SP.cadence_config(3, 2.0, ts, resort, pipeline)
    pos, vel = C.beam(N, cfg)
    sim = Simulator(cfg, N, engine="fmm3_kd")
    st = sim.init_acc(particle_state_from_numpy(pos, vel, device="cpu"))
    sim.run(st, 2)
    sim.advance_padded(2 * ts)
    return sim


@pytest.mark.parametrize("cadence", [(4, 2, 2), (4, 1, 1)],
                         ids=["tuned_like", "default_like"])
def test_window_ladder_leaves_the_run_bitwise_unchanged(cadence):
    """Measuring the error at every step of a window leaves
    `_steps_since_build`, the rebuild queue and the next window's
    positions as in a run that measured nothing."""
    ts = cadence[0]
    sub = torch.from_numpy(C.oracle_targets(N))
    a, b = _sim(*cadence), _sim(*cadence)
    try:
        assert torch.equal(a._padded.pos, b._padded.pos)
        errs = SP.window_ladder(a, sub, every=1)
        # the bare run: to the window's end, then one whole window
        b.advance_padded(ts - b._steps_since_build)
        b.advance_padded(ts)
        assert sorted(errs) == list(range(ts + 1))
        assert all(0 < e < 1e-3 for e in errs.values())
        assert a._steps_since_build == b._steps_since_build == ts
        assert a._boundary_i == b._boundary_i
        assert [(q[0], q[1]) for q in a._pqueue] == \
            [(q[0], q[1]) for q in b._pqueue]
        assert dict(a.rebuilds) == dict(b.rebuilds)
        for x, y in zip(a._padded, b._padded):
            assert torch.equal(x, y)
        a.advance_padded(ts + 1)
        b.advance_padded(ts + 1)
        for x, y in zip(a.current_state(), b.current_state()):
            assert torch.equal(x, y)
    finally:
        a.close()
        b.close()


def test_window_ladder_steps_and_eval_count():
    sub = torch.from_numpy(C.oracle_targets(N))
    sim = _sim(8, 1, 1)
    try:
        errs = SP.window_ladder(sim, sub, every=4)
    finally:
        sim.close()
    assert sorted(errs) == [0, 4, 8]
    assert SP.ladder_evals(8, 4) == 3 and SP.ladder_evals(16, 4) == 5
    assert SP.ladder_evals(16, 1) == 17 and SP.ladder_evals(6, 4) == 3
    assert SP.ladder_evals(1, 1) == 2


def test_margin_knobs_of_the_sweep(monkeypatch):
    assert SP.parse_margins("0,1e-4,auto,autoF3") == [0.0, 1e-4, "auto",
                                                      "autoF3"]
    with pytest.raises(ValueError):
        SP.parse_margins("automatic")
    monkeypatch.setenv("CO_STALE_MARGIN", "9")
    with SP.margin_env(3e-4):
        assert os.environ["CO_STALE_MARGIN"] == "0.0003"
        assert "CO_STALE_MARGIN_FACTOR" not in os.environ
    with SP.margin_env("autoF3.5"):
        assert "CO_STALE_MARGIN" not in os.environ
        assert os.environ["CO_STALE_MARGIN_FACTOR"] == "3.5"
    with SP.margin_env("auto"):
        assert "CO_STALE_MARGIN" not in os.environ
        assert "CO_STALE_MARGIN_FACTOR" not in os.environ
    assert os.environ["CO_STALE_MARGIN"] == "9"       # restored
    with SP.builder_env("kd_device"):
        assert os.environ["CO_SORT_MODE"] == "kd_device"
    assert "CO_SORT_MODE" not in os.environ


def test_stale_margin_sweep_rows(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("CO_TS", "4")
    out = tmp_path / "sm.json"
    assert SP.main(["1024", "3", "2.0", "0,3e-4,auto", "--every", "2",
                    "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["config"] == {"n": 1024, "p": 3, "r": 2.0, "ts": 4,
                             "resort_every": 2, "pipeline": 2,
                             "builder": "host", "every": 2}
    rows = doc["rows"]
    assert [r["margin"] for r in rows] == [0.0, 3e-4, "auto"]
    assert [r["resolved_margin"] for r in rows[:2]] == [0.0, 3e-4]
    assert len(rows[2]["resolved_margin"]) == 3        # per axis
    for r in rows:
        assert sorted(r["errs"]) == ["0", "2", "4"]
        assert r["window_mean"] <= r["window_max"] < 1e-3
        assert r["s_per_step"] > 0
    # a wider flat margin keeps more pairs near
    assert rows[1]["counts"]["p2p"] >= rows[0]["counts"]["p2p"]
    assert "CO_STALE_MARGIN" not in os.environ
    assert capsys.readouterr().out.count("@@ ") == 3


def test_cadence_probe_row(monkeypatch, capsys):
    monkeypatch.setenv("CO_CADENCE_COMBOS", "4,2,2;4,1,1,0,kd_device")
    assert CP.main(["1024", "3", "2.0", "1.5", "--windows", "2",
                    "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(ln[3:]) for ln in lines if ln.startswith("@@ ")]
    assert [(r["ts"], r["resort_every"], r["pipeline"], r["geom"],
             r["builder"]) for r in rows] == [(4, 2, 2, 1, "host"),
                                              (4, 1, 1, 0, "kd_device")]
    for r in rows:
        assert len(r["times"]) == len(r["boundary_wait_s"]) == 2
        assert 0 < r["stale_err"] < 1e-3
        assert r["psteps_per_s"] == pytest.approx(1024
                                                  / r["median_s_per_step"])
    assert rows[0]["rebuilds"].get("adopt_full", 0) > 0
    assert rows[1]["rebuilds"].get("adopt_device", 0) > 0
    doc = json.loads(lines[-1])
    assert len(doc["rows"]) == 2 and doc["device"]["device"] == "cpu"
    assert "CO_SORT_MODE" not in os.environ


# ---- the bench, end to end --------------------------------------------------

def test_bench_quick_prints_one_json_line_with_every_field(tmp_path,
                                                           capsys):
    tuned = tmp_path / "tuned.json"
    tuned.write_text(json.dumps({"p": 3, "r": 2.0, "boost": 1.5,
                                 "tree_steps": 16, "resort_every": 2,
                                 "pipeline": 2}))
    saved = tmp_path / "saved.json"
    before = set(os.listdir(REPO))
    assert B.main(["--n", str(N), "--device", "cpu", "--quick", "--tuned",
                   str(tuned), "--save-tuned", str(saved)]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    data = [ln for ln in lines if not ln.startswith("#")]
    assert len(data) == 1 and data[0] == lines[-1]
    out = json.loads(data[0])
    assert set(out) == {"metric", "value", "unit", "graphs", "extra"}
    assert out["graphs"] is False            # the CPU runs its steps eagerly
    x = out["extra"]
    assert x["captures"] == 0 and x["eager"] is None      # --quick
    assert ORIGINAL_EXTRA | PORT_EXTRA <= set(x)
    assert (x["n"], x["p"], x["r"], x["sub_boost"]) == (N, 3, 2.0, 1.5)
    assert (x["tree_steps"], x["resort_every"], x["pipeline"]) == (16, 2, 2)
    assert out["value"] == pytest.approx(N / x["sec_per_step_median"])
    assert len(x["sec_per_step_all"]) == 3               # --quick
    assert sorted(map(int, x["stale_window_errs"])) == [0, 4, 8, 12, 16]
    assert len(x["stale_window_errs_cycle"]) == 2        # resort_every
    assert x["certified"] is True
    assert x["final_candidates"][0]["certified"] is True
    assert 0 < x["force_rel_err"] < 1e-3
    assert set(x["interaction_rates"]) == RATES
    assert len(x["boundary_wait_s"]) == len(x["rebuild_s"]) == 3
    assert {"kd", "traverse", "lists", "upload"} <= set(
        x["rebuild_breakdown_s"])
    d = x["default_cadence"]
    assert (d["tree_steps"], d["resort_every"], d["pipeline"]) == (8, 1, 1)
    assert len(d["sec_per_step_all"]) == 3
    assert x["device"]["device"] == "cpu"
    assert len(x["probes"]) == 1 and len(x["final_candidates"]) == 1
    assert x["finite"] is True
    # no kernel on the CPU: the plain version ran, nothing was counted.
    # Force evaluations: the probe (1 + its timing loop), the tuned timing
    # (init_acc, 100 warm-up and 48 timed steps, 12 + 16 + 16 ladder steps
    # and 2 x 5 measurements), the default timing (init_acc, 52 + 48 steps)
    assert x["p2p_kernel_launches"] == 0
    assert x["force_evals"] >= 1 + 2 + (1 + 100 + 48 + 44 + 10) \
        + (1 + 52 + 48)
    # the winner goes only where --save-tuned says; the root is untouched
    assert json.loads(saved.read_text())["p"] == 3
    assert set(os.listdir(REPO)) == before


def test_bench_requires_true_float32_matmuls(monkeypatch):
    monkeypatch.setattr(torch, "get_float32_matmul_precision",
                        lambda: "high")
    with pytest.raises(RuntimeError, match="highest"):
        B.run(n=256, device="cpu", quick=True)


@pytest.mark.parametrize("main,argv", [
    (B.main, []), (B.main, ["--quick"]), (B.main, ["probe", "3", "2", "1.5"]),
    (B.main, ["fullgrid"]), (SP.main, []), (CP.main, []), (PF.main, []),
    (PF.main, ["all"]), (PF.main, ["trace"]), (PF.main, ["prodtrace"])],
    ids=["bench", "bench_quick", "bench_probe", "bench_fullgrid",
         "stale_margin_probe", "cadence_probe", "profile_force",
         "profile_all", "profile_trace", "profile_prodtrace"])
def test_scripts_raise_without_a_card(monkeypatch, capsys, main, argv):
    """Without a card and without --device cpu every measurement script
    raises; none prints a result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert "{" not in capsys.readouterr().out


def test_pick_device():
    assert C.pick_device("cpu") == CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            C.pick_device(None)
        with pytest.raises(RuntimeError):
            C.pick_device("cuda")
    assert C.device_info("cpu") == {"torch": torch.__version__,
                                    "device": "cpu"}
