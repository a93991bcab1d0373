"""Port of tests/test_integrators.py onto the port's ``make_step``:
convergence order against the exact harmonic-oscillator solution, time
reversibility, bounded float32 leapfrog energy, and euler kicking with the
cached acceleration.  The port's step is also held against the reference's
on the same numpy inputs, and its coefficients (rounded to the state dtype
once per dtype) against a step that rounds them at every stage.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu.models import integrators as JI
from coulomb_oscillators_tpu.state import ParticleState as JState
from coulomb_oscillators_tpu_torch.models import integrators as I
from coulomb_oscillators_tpu_torch.state import ParticleState

torch.set_num_threads(1)

OMEGA2 = (1.095**2, 1.0, 1.0)
POS0 = [[0.3, -0.2, 0.5]]
VEL0 = [[0.1, 0.4, -0.3]]


def trap_force(pos):
    return -pos * torch.tensor(OMEGA2, dtype=pos.dtype)


def exact_harmonic(pos0, vel0, t):
    w = np.sqrt(np.asarray(OMEGA2))
    return (pos0 * np.cos(w * t) + vel0 * np.sin(w * t) / w,
            vel0 * np.cos(w * t) - pos0 * w * np.sin(w * t))


def _run(table, dt, steps, dtype=torch.float64):
    pos0 = torch.tensor(POS0, dtype=dtype)
    vel0 = torch.tensor(VEL0, dtype=dtype)
    state = ParticleState(pos0, vel0, trap_force(pos0))
    return I.nsteps(I.make_step(trap_force, table, dt), state, steps)


@pytest.mark.parametrize("name,order", [
    ("euler", 1), ("leapfrog", 2), ("forestruth", 4), ("pefrl", 4),
])
def test_convergence_order(name, order):
    t_end = 1.0
    errs = []
    for steps in (64, 128):
        st = _run(I.INTEGRATORS[name], t_end / steps, steps)
        ep, _ = exact_harmonic(np.asarray(POS0), np.asarray(VEL0), t_end)
        errs.append(float(np.max(np.abs(st.pos.numpy() - ep))))
    rate = np.log2(errs[0] / errs[1])
    assert rate > order - 0.5, (name, errs, rate)


@pytest.mark.parametrize("name", ["leapfrog", "forestruth", "pefrl"])
def test_time_reversibility(name):
    dt, steps = 1e-2, 100
    st = _run(I.INTEGRATORS[name], dt, steps)
    back = ParticleState(st.pos, -st.vel, st.acc)
    back = I.nsteps(I.make_step(trap_force, I.INTEGRATORS[name], dt), back,
                    steps)
    assert float((back.pos - torch.tensor(POS0, dtype=torch.float64))
                 .abs().max()) < 1e-10


def test_leapfrog_energy_bounded_f32():
    dt = 5e-4
    pos0 = torch.from_numpy((np.random.default_rng(0).normal(size=(64, 3))
                             * 0.01).astype(np.float32))
    state = ParticleState(pos0, torch.zeros_like(pos0), trap_force(pos0))
    step = I.make_step(trap_force, "leapfrog", dt)

    def energy(s):
        k = torch.tensor(OMEGA2, dtype=torch.float32)
        return float(0.5 * torch.sum(s.vel**2)
                     + 0.5 * torch.sum(s.pos**2 * k))

    e0 = energy(state)
    e1 = energy(I.nsteps(step, state, 10_000))
    assert abs(e1 - e0) / abs(e0) < 1e-4


def test_euler_uses_cached_acceleration():
    pos0 = torch.ones((1, 3), dtype=torch.float32)
    state = ParticleState(pos0, torch.zeros_like(pos0),
                          torch.full_like(pos0, 2.0))
    dt = 0.5
    out = I.make_step(trap_force, "euler", dt)(state)
    np.testing.assert_allclose(out.vel.numpy(), 2.0 * dt)
    np.testing.assert_allclose(out.pos.numpy(), 1.0 + 2.0 * dt * dt)


def _jtrap(pos):
    return -pos * jnp.asarray(OMEGA2, dtype=pos.dtype)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-13)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(I.INTEGRATORS))
def test_step_matches_reference(name, dtype, tol):
    """20 steps of the port's step against the reference's from the same
    numpy state: max|d| / max|x| within `tol` per component (elementwise
    arithmetic in the same order; the float32 bound allows XLA's fused
    multiply-adds)."""
    rng = np.random.default_rng(11)
    pos, vel = (rng.normal(size=(32, 3)).astype(dtype) for _ in range(2))
    acc = (-pos * np.asarray(OMEGA2)).astype(dtype)
    x64 = dtype == np.float64
    if x64:
        jax.config.update("jax_enable_x64", True)
    try:
        js = JState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(acc))
        js = JI.nsteps(JI.make_step(_jtrap, name, 3e-3), js, 20)
        ref = [np.asarray(x) for x in js]
    finally:
        if x64:
            jax.config.update("jax_enable_x64", False)
    ts = ParticleState(*(torch.from_numpy(x) for x in (pos, vel, acc)))
    ts = I.nsteps(I.make_step(trap_force, name, 3e-3), ts, 20)
    for got, want in zip(ts, ref):
        assert got.numpy().dtype == want.dtype
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(I.INTEGRATORS))
def test_rounded_once_equals_rounded_per_stage(name, dtype):
    """The step rounds each stage's coefficient once per dtype; the result
    is bitwise that of rounding it at every stage, and one step function
    serves both dtypes."""
    dt, scale = 7e-3, 0.9
    table = I.INTEGRATORS[name]

    def per_stage(state):
        pos, vel, acc = state
        for s in table:
            if s[0] == "D":
                c = float(torch.tensor(dt * s[1], dtype=torch.float64)
                          .to(pos.dtype))
                pos = pos + vel * c
            elif s[0] == "K":
                c = float(torch.tensor(dt * scale * s[1],
                                       dtype=torch.float64).to(pos.dtype))
                vel = vel + acc * c
            else:
                acc = trap_force(pos)
        return ParticleState(pos, vel, acc)

    step = I.make_step(trap_force, name, dt, scale)
    rng = np.random.default_rng(12)
    for dt_ in (torch.float64, dtype):     # the other dtype first, then this
        a = b = ParticleState(*(torch.from_numpy(rng.normal(size=(16, 3)))
                                .to(dt_) for _ in range(3)))
        for _ in range(5):
            a, b = step(a), per_stage(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
