"""Port vs reference: the probe twins ``scripts/{stale_anatomy,err_diag,
leaf_size_probe,sortmode_probe}.py`` of the port.

Each probe runs on the CPU at a small size on the same numpy beam as the
reference side, which the test builds through the JAX package's API
(``Simulator``, ``refresh_geometry_device``, ``refresh``, ``build``,
``direct_kahan_targets``, ``native``), never through the reference
scripts, which write into ``docs/`` and a compile cache.  Integer columns
(pair counts, C, degrees, physical pairs, lanes) are held exactly equal;
error columns within ``ERR_RTOL`` of the reference's plus ``ERR_ATOL``:
the two packages' forces differ by float32 rounding, ~1e-6 of |a| a
target, which moves a mean relative error by up to ~1e-6 whatever its
size, and an error near 1e-3 by ~1e-3 of itself.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu import ParticleState as JState
from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu import native as jnative
from coulomb_oscillators_tpu.ops import direct as JD
from coulomb_oscillators_tpu.ops.fmm.kdtree import KdFmmEngine as JEngine
from coulomb_oscillators_tpu.ops.fmm.kdtree import _heap_off as j_heap_off
from coulomb_oscillators_tpu.ops.reductions import mean_rel_err as j_mre
from coulomb_oscillators_tpu.ops.reductions import rel_diff1 as j_rel_diff1
from coulomb_oscillators_tpu.simulate import Simulator as JSim
from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
from coulomb_oscillators_tpu_torch.scripts import _common as C
from coulomb_oscillators_tpu_torch.scripts import err_diag as ED
from coulomb_oscillators_tpu_torch.scripts import leaf_size_probe as LP
from coulomb_oscillators_tpu_torch.scripts import sortmode_probe as SM
from coulomb_oscillators_tpu_torch.scripts import stale_anatomy as SA

torch.set_num_threads(1)

N = 4096
N_SMALL = 2048           # stale_anatomy (35 force evaluations), sortmode
P = 3
ERR_RTOL = 1e-2
ERR_ATOL = 1e-6
TS, RESORT, PIPE, BOOST, R_ANAT = 4, 2, 2, 1.5, 1.67


def _approx(want):
    return pytest.approx(want, rel=ERR_RTOL, abs=ERR_ATOL)


@pytest.fixture(scope="module")
def beam():
    return C.beam(N)


def _jstate(pos, vel):
    return JState(jnp.asarray(pos), jnp.asarray(vel),
                  jnp.zeros(pos.shape, jnp.float32))


def _reference_anatomy(pos, vel):
    """The reference script's window loop (scripts/stale_anatomy.py:
    70-110) on the JAX package's Simulator."""
    n = pos.shape[0]
    cfg = JConfig(fmm_order=P, tree_radius=R_ANAT, tree_steps=TS,
                  tree_resort_every=RESORT, tree_pipeline=PIPE,
                  geom_refresh=False)
    sub = jnp.asarray(C.oracle_targets(n))
    sim = JSim(cfg, n, engine="fmm3_kd")
    eng = sim._fmm
    sim.run(sim.init_acc(_jstate(pos, vel)), 2)
    for _ in range(SA.PRIME_WINDOWS):
        sim.advance_padded(TS)

    def err(fs):
        cur = sim.current_state()
        ref = JD.direct_kahan_targets(cur.pos[sub], cur.pos, cfg.eps2,
                                      cfg.kappa(n))
        return float(j_mre(eng.force(cur.pos, fs)[sub], ref))

    rows = []
    for i in range(TS + 1):
        row = {"step": i, "prod": err(sim._fstate),
               "geo": err(eng.refresh_geometry_device(sim._padded.pos,
                                                      sim._fstate))}
        if i in (0, TS):
            row["rfsh"] = err(eng.refresh(sim._padded.pos, sim._fstate))
        if i == TS:
            row["fresh"] = err(eng.build(sim.current_state().pos))
        rows.append(row)
        if i < TS:
            sim.advance_padded(1)
    return rows


def test_stale_anatomy_matches_reference(beam, monkeypatch):
    """ts + 1 rows with the reference's columns at the reference's steps,
    every error within tolerance of the reference's; the window means are
    the rows' means; the probe made the force evaluations it reports."""
    pos, vel = (x[:N_SMALL] for x in beam)
    calls = []
    stage = KdFmmEngine._stage_p2p

    def counted(self, ppad, fs):
        calls.append(1)
        return stage(self, ppad, fs)

    monkeypatch.setenv("CO_SUB_BOOST", str(BOOST))
    want = _reference_anatomy(pos, vel)
    monkeypatch.delenv("CO_SUB_BOOST")
    monkeypatch.setattr(KdFmmEngine, "_stage_p2p", counted)
    out = SA.anatomy(N_SMALL, P, R_ANAT, BOOST, TS, RESORT, PIPE, "cpu",
                     min_loop=0.01, pos=pos, vel=vel)
    got = out["ladder"]
    assert [sorted(set(r) - {"rfsh_s"}) for r in got] == \
        [sorted(r) for r in want]
    for g, w in zip(got, want):
        for k in ("prod", "geo", "rfsh", "fresh"):
            if k in w:
                assert g[k] == _approx(w[k]), (g, w)
    assert out["window_mean_prod"] == pytest.approx(
        np.mean([r["prod"] for r in got]), rel=1e-12)
    assert out["window_mean_geo"] == pytest.approx(
        np.mean([r["geo"] for r in got]), rel=1e-12)
    assert out["geom_refresh_ms"] > 0
    assert len(calls) == out["force_evals"]
    assert out["config"] == {"n": N_SMALL, "p": P, "r": R_ANAT,
                             "boost": BOOST, "ts": TS,
                             "resort_every": RESORT, "pipeline": PIPE}


def test_err_diag_matches_reference(beam):
    """The force error's mean, percentiles, max, halves and L2 ratio
    within tolerance of the reference's (its engine, its Kahan oracle);
    the plain direct sum's own noise below 1e-6 in both packages (each
    sums in its own order); the P2P plain-against-Kahan noise finite and
    below 1e-5."""
    pos = beam[0]
    nt = 1024
    out = ED.diag(N, P, R_ANAT, "cpu", n_targets=nt, pos=pos)
    cfg = JConfig(fmm_order=P, tree_radius=R_ANAT)
    jpos = jnp.asarray(pos)
    eng = JEngine(cfg, N)
    acc = eng.force(jpos, eng.build(jpos))
    sub = jnp.asarray(np.random.default_rng(0).choice(N, nt, replace=False))
    ref = JD.direct_kahan_targets(jpos[sub], jpos, cfg.eps2, cfg.kappa(N))
    e = np.asarray(j_rel_diff1(acc[sub], ref))
    order = np.argsort(np.asarray(jnp.linalg.norm(ref, axis=1)))
    want = {"mean": e.mean(), "max": e.max(),
            **{f"p{q:g}": np.percentile(e, q) for q in ED.QUANTILES}}
    assert set(out["force"]) == set(want)
    for k, v in want.items():
        assert out["force"][k] == _approx(float(v)), k
    assert out["top_half"] == _approx(float(e[order[nt // 2:]].mean()))
    assert out["bottom_half"] == _approx(float(e[order[:nt // 2]].mean()))
    l2 = float(jnp.linalg.norm(acc[sub] - ref) / jnp.linalg.norm(ref))
    assert out["l2"] == _approx(l2)
    j_noise = np.asarray(j_rel_diff1(
        JD.direct_jnp(jpos, cfg.eps2, cfg.kappa(N))[sub], ref))
    assert 0 < out["oracle_noise"]["mean"] < 1e-6
    assert 0 < float(j_noise.mean()) < 1e-6
    assert out["oracle_noise"]["p99"] >= out["oracle_noise"]["mean"]
    noise = out["p2p_noise"]
    assert all(np.isfinite(v) for v in noise.values())
    assert 0 < noise["mean"] <= noise["p99"] <= noise["max"] < 1e-5


@pytest.mark.parametrize("n,p", [(N, 3), (N, 6)])
def test_p2p_kahan_is_closer_to_float64_than_the_plain_pass(n, p):
    """On the same lists, the compensated pass sits closer to the float64
    plain sum (the CSR form, ``p2p_plain``) than the plain float32 pass
    the engine runs, in the mean over real slots, and within 1e-6."""
    cfg = SimConfig(fmm_order=p, tree_radius=R_ANAT)
    pos = torch.from_numpy(C.beam(n, cfg)[0])
    eng = KdFmmEngine(cfg, n)
    fs = eng.build(pos)
    ppad = eng.pad_array(pos, fs, fill=FAR)
    f64 = p2p_cuda.p2p_plain(
        ppad.reshape(eng.G_blk, eng.C_blk, 3).double(), fs.p2p_row_ptr,
        fs.p2p_col2d, eng.nsub, cfg.eps2).reshape(ppad.shape)
    mask = eng.mask3("cpu")

    def err(x):
        d = torch.linalg.vector_norm(x.double() - f64, dim=-1)[mask]
        return float((d / torch.linalg.vector_norm(f64, dim=-1)[mask])
                     .mean())

    e_plain = err(eng._stage_p2p(ppad, fs))
    e_kahan = err(ED.p2p_kahan(eng, ppad, fs))
    assert e_kahan < e_plain < 1e-6
    # a chunk far smaller than a rank's entries gives the same sums
    small = ED.p2p_kahan(eng, ppad, fs, chunk=7)
    assert err(small) < e_plain


def _reference_leaf_row(pos, L, use_pallas):
    """The reference's leaf_size_probe columns at level L
    (scripts/leaf_size_probe.py:40-58), built with the JAX package's
    engine and native library; the packed source entries are decoded one
    mask bit at a time."""
    eng = JEngine(JConfig(fmm_order=P, tree_radius=2.0), N, L=L,
                  use_pallas=use_pallas)
    perm = jnative.kdtree_build(pos, L)
    c_h, lb_h, rb_h, _ = jnative.node_geometry(pos[perm], L)
    m2l, p2p = eng._traverse(c_h, lb_h, rb_h)
    G, S = 1 << L, eng.sub_depth
    mult = eng.st.mult[j_heap_off(L):].astype(np.int64)
    phys = 0
    for t, packed in p2p.tolist():
        v = packed & 0xFFFFFFFF
        blk = v & ((1 << (32 - (1 << S))) - 1)
        for q in range(1 << S):
            if (v >> (32 - (1 << S)) >> q) & 1:
                phys += int(mult[t]) * int(mult[(blk << S) + q])
    Cn = -(-N // G)
    deg = np.bincount(p2p[:, 0], minlength=G)
    return {"L": L, "C": Cn, "sub_depth": S, "p2p": p2p.shape[0],
            "m2l": m2l.shape[0], "deg_mean": float(deg.mean()),
            "deg_max": int(deg.max()), "phys": phys,
            "lane128": p2p.shape[0] * 128 * 128,
            "laneC": p2p.shape[0] * (-(-Cn // 8) * 8) ** 2}


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["pad1", "lane_quantum"])
def test_leaf_size_probe_equals_reference(beam, use_pallas):
    """Every column but the build seconds exactly equal to the reference's
    at levels with sub_depth 0 (below the auto level) and 2, whether the
    reference pads C to 1 (its script's use_pallas=False) or to the lane
    quantum (the port's layout)."""
    pos = beam[0]
    levels = (5, 6, 7)
    rows = LP.probe(N, P, 2.0, levels, pos=pos)
    assert {r["sub_depth"] for r in rows} == {0, 2}
    for row, L in zip(rows, levels):
        want = _reference_leaf_row(pos, L, use_pallas)
        assert row.pop("build_s") >= 0
        assert row == want


SHAPE_RTOL = 1e-4   # leaf shapes: float32 centres and bounds, to the 7th power


def _reference_leaf_shape(eng, fs, pos):
    """sortmode_probe.leaf_shape's columns from the reference engine's
    tree, in numpy: the leaves are the equal-count segments of its sorted
    order."""
    L, n = eng.L, pos.shape[0]
    G = 1 << L
    beg = np.arange(G + 1) * n // G
    ps = pos[np.asarray(fs.perm)]
    center = np.asarray(fs.center)[j_heap_off(L):][:G]
    lam = np.asarray(fs.lam)[j_heap_off(L):][:G]
    aspect, rho_p1 = [], []
    for g in range(G):
        leaf = ps[beg[g]:beg[g + 1]]
        side = leaf.max(axis=0) - leaf.min(axis=0)
        aspect.append(side.max() / max(side.min(), 1e-30))
        rho = np.linalg.norm(leaf - center[g], axis=1).max()
        rho_p1.append((rho / lam[g]) ** (eng.p + 1))
    return {"aspect": float(np.median(aspect)),
            "rho_p1": float(np.mean(rho_p1))}


def test_sortmode_probe_matches_reference(beam):
    """Each builder's pair counts exactly equal to the reference's, its
    error within tolerance of the reference's, its leaves' shape within
    SHAPE_RTOL of the reference tree's, its build parts timed."""
    pos = beam[0][:N_SMALL]
    rows = SM.probe(N_SMALL, P, 1.7, "cpu", pos=pos)
    assert [r["mode"] for r in rows] == list(SM.MODES)
    cfg = JConfig(fmm_order=P, tree_radius=1.7)
    jpos = jnp.asarray(pos)
    sub = jnp.asarray(C.oracle_targets(N_SMALL))
    ref = JD.direct_kahan_targets(jpos[sub], jpos, cfg.eps2,
                                  cfg.kappa(N_SMALL))
    for row in rows:
        eng = JEngine(cfg, N_SMALL, sort_mode=row["mode"])
        fs = eng.build(jpos)
        assert row["counts"] == eng.last_counts, row["mode"]
        err = float(j_mre(eng.force(jpos, fs)[sub], ref))
        assert row["err"] == _approx(err), row["mode"]
        shape = _reference_leaf_shape(eng, fs, pos)
        for k in ("aspect", "rho_p1"):
            assert row[k] == pytest.approx(shape[k], rel=SHAPE_RTOL), \
                (row["mode"], k)
        assert row["build_s"] > 0
        assert set(row["build_times"]) == set(eng.last_build_times)


@pytest.mark.parametrize("main", [SA.main, ED.main, LP.main, SM.main],
                         ids=["stale_anatomy", "err_diag", "leaf_size_probe",
                              "sortmode_probe"])
def test_probes_refuse_without_a_card(monkeypatch, capsys, main):
    """Without a card and without --device cpu every probe raises and
    prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
    assert "@@" not in capsys.readouterr().out


def test_leaf_size_probe_main_writes_its_rows(monkeypatch, tmp_path,
                                              capsys):
    """--device cpu runs; the @@ line and --out hold the same rows, one a
    level of LEVELS, the device named as the host."""
    import json
    monkeypatch.setattr(LP, "LEVELS", (3, 4))
    out = tmp_path / "rows.json"
    assert LP.main(["1024", "3", "2.0", "--device", "cpu",
                    "--out", str(out)]) == 0
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("@@ ")][-1]
    printed = json.loads(line[3:])
    assert printed == json.loads(out.read_text())
    assert [r["L"] for r in printed["rows"]] == [3, 4]
    assert printed["device"]["device"] == "cpu"
