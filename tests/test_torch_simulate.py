"""Port vs reference: the Simulator's trajectory across rebuild boundaries
(sync, async, and the pipelined/refresh cadence), the auto stale margin,
and what the port's Simulator refuses.
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
], ids=["async", "sync", "resort2", "pipeline2"])
def test_trajectory_matches_reference(beam, kw):
    """7 leapfrog steps with tree_steps=3 cross 2 rebuild boundaries; the
    resort/pipeline cadences run 10 steps (3 boundaries), so a background
    refresh, or a full re-sort adopted two boundaries late, is adopted.
    Both packages build the same trees and lists, so positions differ only
    by float32 summation order; max|dpos|/max|pos| <= 1e-5."""
    pos, vel = beam
    steps = 7 if len(kw) == 1 else 10
    cfg = dict(fmm_order=3, tree_radius=2.0, tree_steps=3, **kw)
    js = JSim(JConfig(**cfg), N, engine="fmm3_kd")
    st = js.init_acc(JState(jnp.asarray(pos), jnp.asarray(vel),
                            jnp.zeros((N, 3), jnp.float32)))
    ref = np.asarray(js.run(st, steps).pos)
    ts = TSim(TConfig(**cfg), N)
    try:
        st = ts.init_acc(particle_state_from_numpy(pos, vel))
        out = ts.run(st, steps)
    finally:
        ts.close()
    got = out.pos.numpy()
    dev = np.abs(got - ref).max() / np.abs(ref).max()
    assert dev <= 1e-5, dev
    assert np.isfinite(out.vel.numpy()).all()
    if kw["tree_async"]:
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
    sim = TSim(cfg, N)
    try:
        with pytest.raises(RuntimeError):
            sim.advance_padded(1)
        st = sim.init_acc(particle_state_from_numpy(pos, vel))
        a = sim.run(st, 3)
        b = sim.run(a, 2)                       # resumes the padded run
        sim.advance_padded(1)
        c = sim.current_state()
        assert c.pos.shape == (N, 3) and np.isfinite(c.pos.numpy()).all()
        assert not torch.equal(b.pos, c.pos)
        d = sim.run(particle_state_from_numpy(pos, vel), 1)   # restart
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
    st = particle_state_from_numpy(pos, vel)
    sim = TSim(TConfig(stale_margin=0.0), N)
    sim._set_stale_margin(st)
    assert sim._fmm.stale_margin_abs == 0.0
    sim = TSim(TConfig(tree_steps=8, tree_pipeline=2), N)
    sim._set_stale_margin(st)
    vrms = np.sqrt(np.mean(vel.astype(np.float64) ** 2, axis=0))
    np.testing.assert_allclose(sim._fmm.stale_margin_abs,
                               vrms * 5e-4 * 8 * 3 * 2.0, rtol=1e-12)


@pytest.mark.parametrize("kw,engine", [
    (dict(tree_async_build="device"), "fmm3_kd"),
    (dict(), "direct"),
    (dict(), "fmm3"),
    (dict(), "appel"),
])
def test_unported_modes_raise(kw, engine):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TSim(TConfig(**kw), N, engine=engine)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TSim(TConfig(), N, mesh=object())
