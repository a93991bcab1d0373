"""Port vs reference: the system end to end on the plain engines — twins of
tests/test_system.py (direct N small, leapfrog, 3D, energy conservation),
the oscillator force composition, ``ops.fmm.make_engine``, and the port's
``Simulator("direct")`` trajectory against the reference's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu import ParticleState as JState
from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu.models import init_dist as ID
from coulomb_oscillators_tpu.models import oscillator as JM
from coulomb_oscillators_tpu.simulate import Simulator as JSim
from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.models import integrators as I
from coulomb_oscillators_tpu_torch.models import oscillator as M
from coulomb_oscillators_tpu_torch.ops import fmm as tfmm
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine
from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err
from coulomb_oscillators_tpu_torch.simulate import Simulator
from coulomb_oscillators_tpu_torch.state import (ParticleState,
                                                 particle_state_from_numpy)

torch.set_num_threads(1)

X_STD = (0.003, 0.001, 0.01)


def _beam(config, n):
    u = tuple(w * xs for w, xs in zip(config.omega0, X_STD))
    return ID.init_gaussian(n, X_STD, u, dtype=np.float32)


def _make_state(config, n):
    pos, vel = _beam(config, n)
    return M.init_accelerations(
        config, particle_state_from_numpy(pos, vel, device="cpu"))


def test_energy_drift_direct_512():
    config = SimConfig()
    n = 512
    state = _make_state(config, n)
    e0 = float(M.total_energy(config, state))
    step = M.make_step_fn(config, n, engine="direct", integrator="leapfrog")
    state = I.nsteps(step, state, 500)
    e1 = float(M.total_energy(config, state))
    drift = abs(e1 - e0) / abs(e0)
    assert drift < 1e-4, drift


def test_engines_agree():
    config = SimConfig()
    n = 300
    state = _make_state(config, n)
    a1 = M.make_oscillator_force(config, n, "direct")(state.pos)
    a2 = M.make_oscillator_force(config, n, "direct_ref")(state.pos)
    assert float(mean_rel_err(a1, a2)) < 1e-5


def test_trap_only_oscillation_period():
    # With xi=0 the system is a pure anisotropic harmonic oscillator.
    config = SimConfig(xi=0.0, dt=1e-3)
    n = 4
    pos = torch.from_numpy(
        (np.random.default_rng(7).normal(size=(n, 3)) * 0.01).astype(
            np.float32))
    state = M.init_accelerations(
        config, ParticleState(pos, torch.zeros_like(pos),
                              torch.zeros_like(pos)))
    # integrate one full period of the y/z oscillators (omega=1): T = 2*pi
    steps = int(round(2 * np.pi / config.dt))
    out = I.nsteps(M.make_step_fn(config, n), state, steps)
    np.testing.assert_allclose(out.pos.numpy()[:, 1:], pos.numpy()[:, 1:],
                               atol=2e-4)


def test_simulator_plain_engine():
    config = SimConfig(dt=1e-3)
    n = 128
    state = _make_state(config, n)
    sim = Simulator(config, n, engine="direct")
    out = sim.run(state, 7)
    sim.close()
    assert out.pos.shape == (n, 3)
    assert bool(torch.isfinite(out.pos).all())


@pytest.mark.parametrize("engine", ["direct", "direct_ref"])
def test_simulator_plain_trajectory_matches_reference(engine):
    """The port's Simulator on a plain engine against the reference's:
    init_acc + 20 leapfrog steps from the same seeded beam; the forces
    differ only by float32 summation order, max|dpos|/max|pos| <= 1e-5."""
    n = 400
    cfg = dict(dt=1e-3)
    pos, vel = _beam(JConfig(**cfg), n)
    js = JSim(JConfig(**cfg), n, engine=engine)
    st = js.init_acc(JState(jnp.asarray(pos), jnp.asarray(vel),
                            jnp.zeros((n, 3), jnp.float32)))
    ref = np.asarray(js.run(st, 20).pos)
    ts = Simulator(SimConfig(**cfg), n, engine=engine)
    st = ts.init_acc(particle_state_from_numpy(pos, vel, device="cpu"))
    got = ts.run(st, 20).pos.numpy()
    ts.close()
    dev = np.abs(got - ref).max() / np.abs(ref).max()
    assert dev <= 1e-5, dev


def test_oscillator_force_and_step_match_reference():
    """make_oscillator_force / make_step_fn / init_accelerations on the
    direct engine against the reference's, on the same state."""
    n = 300
    jc, tc = JConfig(), SimConfig()
    pos, vel = _beam(jc, n)
    ja = np.asarray(JM.make_oscillator_force(jc, n, "direct")(
        jnp.asarray(pos)))
    ta = M.make_oscillator_force(tc, n, "direct")(torch.from_numpy(pos))
    assert np.abs(ta.numpy() - ja).max() / np.abs(ja).max() <= 1e-5
    js = JM.init_accelerations(jc, JState(jnp.asarray(pos), jnp.asarray(vel),
                                          jnp.zeros((n, 3), jnp.float32)))
    ts = M.init_accelerations(
        tc, particle_state_from_numpy(pos, vel, device="cpu"))
    js = JM.make_step_fn(jc, n, "direct")(js)
    ts = M.make_step_fn(tc, n, "direct")(ts)
    for a, b in zip(ts, js):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() / np.abs(b).max() <= 1e-5


def test_make_engine_rebuilds_and_carries_engine():
    """ops.fmm.make_engine: a pos -> acc callable that rebuilds its tree on
    every call and carries the engine object; through make_coulomb_force
    it agrees with the reference's FMM engine (the same native build and
    lists; float32 summation order only)."""
    n = 1500
    cfg = dict(fmm_order=4, tree_radius=2.0)
    pos, _ = _beam(JConfig(**cfg), n)
    f = tfmm.make_engine(SimConfig(**cfg), n, "fmm3_kd")
    assert isinstance(f.engine, KdFmmEngine)
    tpos = torch.from_numpy(pos)
    got = f(tpos)
    assert torch.equal(got, f.engine.force(tpos, f.engine.build(tpos)))
    ref = np.asarray(JM.make_coulomb_force(JConfig(**cfg), n, "fmm3_kd")(
        jnp.asarray(pos)))
    via = M.make_coulomb_force(SimConfig(**cfg), n, "fmm3_kd")(tpos).numpy()
    assert np.abs(via - ref).max() / np.abs(ref).max() <= 1e-5
    # every registry name reaches an engine through make_engine
    assert isinstance(tfmm.make_engine(SimConfig(), n, "fmm3").engine,
                      tfmm.OctreeFmmEngine)
