"""Port vs reference: the Simulator's trajectory across rebuild boundaries
(sync, async, and the pipelined/refresh cadence), the auto stale margin,
and what the port's Simulator refuses (mesh mode itself is held against the
reference in tests/test_torch_mesh_sim.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu import ParticleState as JState
from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu.models import init_dist as ID
from coulomb_oscillators_tpu.simulate import (Simulator as JSim,
                                              auto_stale_margin as j_margin)
from coulomb_oscillators_tpu_torch import SimConfig as TConfig
from coulomb_oscillators_tpu_torch.simulate import (Simulator as TSim,
                                                    auto_stale_margin)
from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

torch.set_num_threads(1)

N = 2048
X_STD = (0.003, 0.001, 0.01)


@pytest.fixture(scope="module")
def beam():
    u = tuple(w * x for w, x in zip(JConfig().omega0, X_STD))
    return ID.init_gaussian(N, X_STD, u)


@pytest.mark.parametrize("kw", [
    dict(tree_async=True),
    dict(tree_async=False),
    dict(tree_async=True, tree_resort_every=2),
    dict(tree_async=True, tree_pipeline=2),
    dict(tree_async=True, tree_async_build="device", tree_resort_every=2,
         tree_pipeline=2),
], ids=["async", "sync", "resort2", "pipeline2", "device_resort2"])
def test_trajectory_matches_reference(beam, kw):
    """7 leapfrog steps with tree_steps=3 cross 2 rebuild boundaries; the
    resort/pipeline cadences run 10 steps (3 boundaries), so a background
    refresh, or a full re-sort adopted two boundaries late, is adopted.
    The device builder ignores the resort/pipeline cadence, as the
    reference's does: it adopts a re-sort at every boundary after the
    priming refresh, and no background refresh.  Both packages build the
    same trees and lists, so positions differ only by float32 summation
    order; max|dpos|/max|pos| <= 1e-5."""
    pos, vel = beam
    steps = 7 if len(kw) == 1 else 10
    cfg = dict(fmm_order=3, tree_radius=2.0, tree_steps=3, **kw)
    js = JSim(JConfig(**cfg), N, engine="fmm3_kd")
    st = js.init_acc(JState(jnp.asarray(pos), jnp.asarray(vel),
                            jnp.zeros((N, 3), jnp.float32)))
    ref = np.asarray(js.run(st, steps).pos)
    ts = TSim(TConfig(**cfg), N, engine="fmm3_kd")
    try:
        st = ts.init_acc(particle_state_from_numpy(pos, vel, device="cpu"))
        out = ts.run(st, steps)
    finally:
        ts.close()
    got = out.pos.numpy()
    dev = np.abs(got - ref).max() / np.abs(ref).max()
    assert dev <= 1e-5, dev
    assert np.isfinite(out.vel.numpy()).all()
    if kw.get("tree_async_build") == "device":
        assert dict(ts.rebuilds) == {"sync_refresh": 1, "adopt_device": 2}
    elif kw["tree_async"]:
        assert ts.rebuilds["adopt_full"] >= 1
        if "tree_resort_every" in kw:
            assert ts.rebuilds["adopt_refresh"] >= 1
    else:
        assert ts.rebuilds["sync_full"] == 2


def test_resume_and_advance_padded(beam):
    """run() continues from the state it handed out; advance_padded needs
    an active run; a foreign state restarts the pipeline."""
    pos, vel = beam
    cfg = TConfig(fmm_order=3, tree_radius=2.0, tree_steps=2)
    sim = TSim(cfg, N, engine="fmm3_kd")
    try:
        with pytest.raises(RuntimeError):
            sim.advance_padded(1)
        st = sim.init_acc(particle_state_from_numpy(pos, vel, device="cpu"))
        a = sim.run(st, 3)
        b = sim.run(a, 2)                       # resumes the padded run
        sim.advance_padded(1)
        c = sim.current_state()
        assert c.pos.shape == (N, 3) and np.isfinite(c.pos.numpy()).all()
        assert not torch.equal(b.pos, c.pos)
        # restart
        d = sim.run(particle_state_from_numpy(pos, vel, device="cpu"), 1)
        assert np.isfinite(d.pos.numpy()).all()
    finally:
        sim.close()


@pytest.mark.parametrize("kw", [dict(), dict(tree_async=False),
                                dict(tree_resort_every=2),
                                dict(tree_pipeline=2), dict(tree_steps=1)])
def test_auto_stale_margin_matches(beam, kw):
    _, vel = beam
    cfg = dict(dict(tree_steps=8), **kw)
    got = auto_stale_margin(torch.from_numpy(vel), TConfig(**cfg))
    ref = j_margin(vel, JConfig(**cfg))       # numpy input: float64 mean
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


def test_stale_margin_config(beam):
    pos, vel = beam
    st = particle_state_from_numpy(pos, vel, device="cpu")
    sim = TSim(TConfig(stale_margin=0.0), N, engine="fmm3_kd")
    sim._set_stale_margin(st)
    assert sim._fmm.stale_margin_abs == 0.0
    sim = TSim(TConfig(tree_steps=8, tree_pipeline=2), N,
               engine="fmm3_kd")
    sim._set_stale_margin(st)
    vrms = np.sqrt(np.mean(vel.astype(np.float64) ** 2, axis=0))
    np.testing.assert_allclose(sim._fmm.stale_margin_abs,
                               vrms * 5e-4 * 8 * 3 * 2.0, rtol=1e-12)


@pytest.mark.parametrize("kw,engine", [
    (dict(tree_async_build="device"), "fmm3_kd"),
    (dict(), "fmm2_kd"),
    (dict(), "fmm3"),
    (dict(), "appel"),
])
def test_unported_modes_raise(kw, engine):
    """Every engine and the device builder construct now (the Simulator
    picks the padded window loop for kd engines, the original-order loop
    for the uniform-grid ones); mesh mode takes a kd engine only, and
    refuses any other with the reference's ValueError."""
    dim = 2 if engine.endswith("2_kd") else 3
    sim = TSim(TConfig(dim=dim, omega0=(1.095, 1.0, 1.0)[:dim], **kw), N,
               engine=engine)
    assert sim._use_padded == engine.endswith("_kd")
    assert sim._fmm.dim == dim
    sim.close()
    if not engine.endswith("_kd"):
        with pytest.raises(ValueError, match="mesh mode needs a kd engine"):
            TSim(TConfig(), N, engine=engine, mesh=object())
    with pytest.raises(ValueError, match="mesh mode needs a kd engine"):
        TSim(TConfig(), N, mesh=object())


def _reference_run(cfg, pos, vel, engine, steps):
    dim = pos.shape[1]
    js = JSim(JConfig(**cfg), len(pos), engine=engine)
    st = js.init_acc(JState(jnp.asarray(pos), jnp.asarray(vel),
                            jnp.zeros((len(pos), dim), jnp.float32)))
    return np.asarray(js.run(st, steps).pos)


@pytest.mark.parametrize("engine,kw", [
    ("fmm3", dict(fmm_order=3)),
    ("appel", dict()),
    ("fmm2_kd", dict(dim=2, omega0=(1.095, 1.0), fmm_order=3,
                     tree_radius=2.0)),
    ("fmm3_kd", dict(fmm_order=3, tree_radius=2.0,
                     tree_async_build="device")),
], ids=["fmm3", "appel", "fmm2_kd", "device_build"])
def test_engine_trajectories_match_reference(engine, kw):
    """7 leapfrog steps with tree_steps=3 cross 2 rebuild boundaries on
    the reference's Simulator and the port's: the uniform-grid engines on
    a uniform box (a concentrated beam would fill one cell), the kd
    engines on the beam.  max|dpos|/max|pos| <= 1e-5 (float32 sums in
    another order).  The device-builder run adopts a background device
    rebuild at the second boundary."""
    cfg = dict(tree_steps=3, **kw)
    dim = cfg.get("dim", 3)
    n = 1024 if engine in ("fmm3", "appel") else N
    if engine.endswith("_kd"):
        x = X_STD[:dim]
        u = tuple(w * xs for w, xs in zip(JConfig(**cfg).omega0, x))
        pos, vel = ID.init_gaussian(n, x, u, dim=dim)
    else:
        pos = ID.init_uniform(n, (-0.01,) * dim, (0.01,) * dim, dim=dim)
        vel = np.zeros_like(pos)
    ref = _reference_run(cfg, pos, vel, engine, 7)
    ts = TSim(TConfig(**cfg), n, engine=engine)
    try:
        out = ts.run(ts.init_acc(particle_state_from_numpy(
            pos, vel, device="cpu")), 7)
    finally:
        ts.close()
    got = out.pos.numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5
    assert np.isfinite(out.vel.numpy()).all()
    if engine.endswith("_kd"):
        key = ("adopt_device" if kw.get("tree_async_build") == "device"
               else "adopt_full")
        assert ts.rebuilds[key] == 1, dict(ts.rebuilds)
    else:
        assert ts.rebuilds["sync_full"] == 2, dict(ts.rebuilds)
