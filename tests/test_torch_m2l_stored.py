"""Port vs reference: the kd engine's stored-fold M2L mode (``CO_M2L_FLY=0``).

In stored mode the per-entry M2L geometry (H2, w, logc) is folded once when
the lists are adopted, again at every geometry refresh, and kept in the
state's ``m2l_h2``/``m2l_w``/``m2l_logc``; fly mode (the default in both
packages) folds it inside the M2L loop and stores placeholders.  Each case
builds both packages' engines on the same seeded beam with the knob set by
``monkeypatch`` before the engines are made; the reference engine is built
with ``use_pallas=True`` (the port's one layout, a CPU build) and its
forces come from its jnp scan branch on that layout.  The reference's own
tests never set the knob, so these are the only tests of the mode.  The
reference's p=8 build takes about a minute on the CPU, so its comparisons
stop at p=6; the dense form (p=7) is held against the port's fly mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu import ParticleState as JState
from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu.models import init_dist as ID
from coulomb_oscillators_tpu.ops.fmm.kdtree import (FAR as JFAR,
                                                    KdFmmEngine as JEngine)
from coulomb_oscillators_tpu.simulate import Simulator as JSim
from coulomb_oscillators_tpu_torch import SimConfig as TConfig
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (
    FmmState, KdFmmEngine, fmm_state_from_numpy)
from coulomb_oscillators_tpu_torch.simulate import Simulator as TSim
from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

torch.set_num_threads(1)

N = 2048
X_STD = (0.003, 0.001, 0.01)
FOLD = ("m2l_h2", "m2l_w", "m2l_logc")
# (dim, p, precision); float64 builds take the device Morton sort, whose
# node geometry both packages compute in double (tests/test_torch_kd_
# variants.py::test_kd_float64)
CASES = {"3d_p3": (3, 3, "float32"), "3d_p6": (3, 6, "float32"),
         "2d_p4": (2, 4, "float32"), "3d_p4_f64": (3, 4, "float64"),
         "2d_p4_f64": (2, 4, "float64")}
# the fold against the reference (float32: rtol 1e-5); the forces
# (tests/test_torch_kdtree.py's 1e-5 of max|a|); stored against fly in the
# port (1e-6 float32, 1e-12 float64)
FOLD_RTOL = {"float32": 1e-5, "float64": 1e-12}
FORCE_TOL = {"float32": 1e-5, "float64": 1e-12}
FLY_TOL = {"float32": 1e-6, "float64": 1e-12}


def _cfg(dim, p, precision="float32"):
    extra = {"omega0": (1.095, 1.0)} if dim == 2 else {}
    return dict(dim=dim, fmm_order=p, tree_radius=2.0, precision=precision,
                **extra)


def _beam(dim, precision="float32", n=N):
    x = X_STD[:dim]
    om = (1.095, 1.0) if dim == 2 else JConfig().omega0
    u = tuple(w * s for w, s in zip(om, x))
    pos, vel = ID.init_gaussian(n, x, u, dim=dim, seed=7)
    return pos.astype(precision), vel.astype(precision)


def _np_state(fs):
    return {f: np.asarray(getattr(fs, f)) for f in fs._fields}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _assert_fold_close(got, want, rtol):
    """Each stored-fold field elementwise within rtol, beside the field's
    largest magnitude (entries of H2 pass through zero)."""
    for f in FOLD:
        a, b = np.asarray(want[f]), np.asarray(got[f])
        assert a.shape == b.shape, (f, a.shape, b.shape)
        np.testing.assert_allclose(b, a, rtol=rtol,
                                   atol=rtol * np.abs(a).max(), err_msg=f)


def _case(dim, p, precision):
    """Everything the tests of one case compare, as host arrays: both
    packages' stored-mode states, forces and refreshed states, the port's
    fly-mode force, and both packages' fly-mode placeholders."""
    kw = {"sort_mode": "morton"} if precision == "float64" else {}
    pos, vel = _beam(dim, precision)
    pos2 = pos + 0.2 * np.asarray(X_STD[:dim], precision) * np.random.\
        default_rng(8).standard_normal(pos.shape).astype(precision)
    cfg = _cfg(dim, p, precision)
    out = {}
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", precision == "float64")
    try:
        with pytest.MonkeyPatch.context() as mp:
            for fly in ("0", "1"):
                mp.setenv("CO_M2L_FLY", fly)
                jeng = JEngine(JConfig(**cfg), N, use_pallas=True, **kw)
                teng = KdFmmEngine(TConfig(**cfg), N, **kw)
                jfs = jeng.build(jnp.asarray(pos))
                tfs = teng.build(torch.from_numpy(pos))
                tpos = torch.from_numpy(pos)
                out[fly] = dict(jeng=jeng, teng=teng, jfs=_np_state(jfs),
                                tfs=_np_state(tfs),
                                tforce=teng.force(tpos, tfs).numpy())
                if fly == "1":
                    continue
                jeng.use_pallas = False      # its scan branch, same layout
                try:
                    out[fly]["jforce"] = np.asarray(
                        jeng.force(jnp.asarray(pos), jfs))
                finally:
                    jeng.use_pallas = True
                out[fly]["tforce_jstate"] = teng.force(
                    tpos, fmm_state_from_numpy(_np_state(jfs), "cpu")).numpy()
                ppad_j = jeng.pad_array(jnp.asarray(pos2), jfs, fill=JFAR)
                out[fly]["jrefresh"] = _np_state(
                    jeng.geom_refresh_in_jit(ppad_j, jfs))
                out[fly]["trefresh"] = _np_state(teng.geom_refresh(
                    torch.from_numpy(np.array(ppad_j)),
                    fmm_state_from_numpy(_np_state(jfs), "cpu")))
    finally:
        jax.config.update("jax_enable_x64", old)
    return out


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    dim, p, precision = CASES[request.param]
    return dict(dim=dim, p=p, precision=precision,
                **_case(dim, p, precision))


def test_engine_reads_the_knob(case):
    """CO_M2L_FLY read at init, as the reference reads it: "0" stores the
    fold, anything else (here "1") folds on the fly."""
    assert case["0"]["teng"].m2l_fly is case["0"]["jeng"].m2l_fly is False
    assert case["1"]["teng"].m2l_fly is case["1"]["jeng"].m2l_fly is True


def test_stored_fold_matches_reference(case):
    """The port's stored fold against the reference's m2l_geo within
    rtol 1e-5 (float32; 1e-12 float64), [Km, S_H] / [Km] / [Km]; every
    integer field bitwise equal."""
    j, t = case["0"]["jfs"], case["0"]["tfs"]
    assert t["m2l_h2"].shape == (t["m2l_tgt"].shape[0],
                                 case["0"]["teng"].tables.S_H)
    assert t["m2l_h2"].dtype == np.dtype(case["precision"])
    _assert_fold_close(t, j, FOLD_RTOL[case["precision"]])
    for f in FmmState._fields:
        if f not in FOLD + ("center", "lam"):
            assert np.array_equal(t[f], j[f]), f


def test_fly_placeholders_match_reference(case):
    """Fly mode stores the reference's placeholders: zeros [1, 1], [1],
    [1] (in the engine's dtype)."""
    j, t = case["1"]["jfs"], case["1"]["tfs"]
    for f, shape in zip(FOLD, ((1, 1), (1,), (1,))):
        assert t[f].shape == j[f].shape == shape, f
        assert np.array_equal(t[f], j[f]) and not t[f].any(), f
        assert t[f].dtype == np.dtype(case["precision"]), f


def test_stored_force_matches_reference(case):
    """The port's stored-mode force, on its own state and on the
    reference's converted state, against the reference's stored-mode
    force: within 1e-5 of max|a| (float32 sums in another order; 1e-12 in
    float64)."""
    c = case["0"]
    tol = FORCE_TOL[case["precision"]]
    assert _rel(c["tforce"], c["jforce"]) <= tol
    assert _rel(c["tforce_jstate"], c["jforce"]) <= tol


def test_stored_force_matches_fly_in_port(case):
    """Stored against fly in the port, on the same lists: <= 1e-6 of
    max|a| in float32, <= 1e-12 in float64."""
    assert _rel(case["0"]["tforce"], case["1"]["tforce"]) <= \
        FLY_TOL[case["precision"]]


def test_refresh_matches_reference(case):
    """geom_refresh in stored mode against the reference's
    geom_refresh_in_jit in stored mode, from the reference's state on
    moved positions, field by field: center/lam within 1e-6 (float32) of
    their largest magnitude, the refolded geometry as the fold above, the
    rest bitwise; the refold moved."""
    j, t = case["0"]["jrefresh"], case["0"]["trefresh"]
    rtol = FOLD_RTOL[case["precision"]]
    for f in ("center", "lam"):
        np.testing.assert_allclose(t[f], j[f], rtol=rtol / 10,
                                   atol=rtol / 10 * np.abs(j[f]).max(),
                                   err_msg=f)
    _assert_fold_close(t, j, rtol)
    for f in FmmState._fields:
        if f not in FOLD + ("center", "lam"):
            assert np.array_equal(t[f], j[f]), f
    assert not np.array_equal(t["m2l_h2"], case["0"]["jfs"]["m2l_h2"])


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_dense_form_stored_matches_fly(monkeypatch, precision):
    """p=7 (the dense W-matrix forms, p > SPARSE_P_MAX), port only: the
    stored fold is [Km, S_H] and the stored-mode force matches fly mode on
    the same lists (<= 1e-6 float32, 1e-12 float64)."""
    cfg = TConfig(**_cfg(3, 7, precision))
    pos = torch.from_numpy(_beam(3, precision)[0])
    kw = {"sort_mode": "morton"} if precision == "float64" else {}
    forces = {}
    for fly in ("0", "1"):
        monkeypatch.setenv("CO_M2L_FLY", fly)
        eng = KdFmmEngine(cfg, N, **kw)
        fs = eng.build(pos)
        if fly == "0":
            assert fs.m2l_h2.shape == (fs.m2l_tgt.shape[0], eng.tables.S_H)
        forces[fly] = eng.force(pos, fs).numpy()
    assert _rel(forces["0"], forces["1"]) <= FLY_TOL[precision]


def test_stored_stage_refuses_a_fly_state(monkeypatch):
    """A stored-mode engine given a state built in fly mode raises rather
    than reading the placeholders."""
    pos = torch.from_numpy(_beam(3)[0])
    cfg = TConfig(**_cfg(3, 3))
    fs = KdFmmEngine(cfg, N).build(pos)
    monkeypatch.setenv("CO_M2L_FLY", "0")
    with pytest.raises(ValueError, match="stored fold"):
        KdFmmEngine(cfg, N).force(pos, fs)


def test_simulator_stored_mode_tracks_reference(monkeypatch):
    """Simulator("fmm3_kd") with tree_steps=4 and CO_M2L_FLY=0 in both
    packages, 7 leapfrog steps across a rebuild boundary with the geometry
    refresh (which refolds the stored geometry at every force evaluation):
    max|dpos| / max|pos| <= 1e-5 (tests/test_torch_simulate.py's kd bound);
    the port's state holds the stored fold."""
    monkeypatch.setenv("CO_M2L_FLY", "0")
    pos, vel = _beam(3)
    cfg = dict(fmm_order=3, tree_radius=2.0, tree_steps=4)
    js = JSim(JConfig(**cfg), N, engine="fmm3_kd")
    assert js._fmm.m2l_fly is False
    st = js.init_acc(JState(jnp.asarray(pos), jnp.asarray(vel),
                            jnp.zeros((N, 3), jnp.float32)))
    ref = np.asarray(js.run(st, 7).pos)
    ts = TSim(TConfig(**cfg), N, engine="fmm3_kd")
    try:
        assert ts._fmm.m2l_fly is False
        out = ts.run(ts.init_acc(particle_state_from_numpy(
            pos, vel, device="cpu")), 7)
        assert ts._fstate.m2l_h2.shape[0] == ts._fstate.m2l_tgt.shape[0]
        assert ts.rebuilds["adopt_full"] + ts.rebuilds["sync_refresh"] >= 1
    finally:
        ts.close()
    got = out.pos.numpy()
    assert _rel(got, ref) <= 1e-5
    assert np.isfinite(out.vel.numpy()).all()
