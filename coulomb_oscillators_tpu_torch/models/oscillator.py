"""The Coulomb-oscillator system: force composition and simulation API.

Twin of ``coulomb_oscillators_tpu/models/oscillator.py`` (reference:
Simulation/main3.cu:47-69 — `coulombOscillator*` composes an
interchangeable Coulomb engine with the external harmonic trap).  An
engine is a function pos -> acc; the oscillator force adds the trap term.
Everything runs eagerly (the twin jits the step).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from coulomb_oscillators_tpu_torch.config import SimConfig
from coulomb_oscillators_tpu_torch.models import integrators as integ
from coulomb_oscillators_tpu_torch.ops import direct as direct_ops
from coulomb_oscillators_tpu_torch.ops import energy as energy_ops
from coulomb_oscillators_tpu_torch.ops.elastic import add_elastic
from coulomb_oscillators_tpu_torch.state import ParticleState

ForceFn = Callable[[torch.Tensor], torch.Tensor]


def make_coulomb_force(config: SimConfig, n: int,
                       engine: str = "direct") -> ForceFn:
    """Coulomb force pos -> acc for the given engine (no trap term).

    Engines (reference equivalents):
      * "direct"     — the Hopper kernel on a CUDA tensor, the plain
                       chunked sum on a CPU tensor (direct/direct2,
                       direct.cuh);
      * "direct_ref" — Kahan-compensated oracle (direct3,
                       direct.cuh:192-245);
      * FMM names    — ``ops.fmm.make_engine`` (the tree is rebuilt on
                       every call).
    """
    eps2 = config.eps2
    kappa = config.kappa(n)
    if engine == "direct":
        return lambda pos: direct_ops.direct(pos, eps2, kappa)
    if engine == "direct_ref":
        return lambda pos: direct_ops.direct_kahan(pos, eps2, kappa)
    from coulomb_oscillators_tpu_torch.ops import fmm
    return fmm.make_engine(config, n, engine)


def make_oscillator_force(config: SimConfig, n: int,
                          engine: str = "direct") -> ForceFn:
    """Coulomb engine + harmonic trap (coulombOscillator*, main3.cu:47-69)."""
    coulomb = make_coulomb_force(config, n, engine)
    omega0_sq = config.omega0_sq()

    def force(pos: torch.Tensor) -> torch.Tensor:
        return add_elastic(pos, coulomb(pos), omega0_sq)

    return force


def make_step_fn(config: SimConfig, n: int, engine: str = "direct",
                 integrator: Optional[str] = None):
    """Single integration step ParticleState -> ParticleState."""
    force = make_oscillator_force(config, n, engine)
    return integ.make_step(force, integrator or config.integrator, config.dt)


def init_accelerations(config: SimConfig, state: ParticleState,
                       engine: str = "direct") -> ParticleState:
    """Precompute a0 = f(x0) before the first step (main3.cu:835-839)."""
    force = make_oscillator_force(config, state.n, engine)
    return state._replace(acc=force(state.pos))


def total_energy(config: SimConfig, state: ParticleState) -> torch.Tensor:
    """Conserved Hamiltonian of the oscillator system (O(N^2) Coulomb sum)."""
    return energy_ops.total_energy(
        state.pos, state.vel, config.eps2, config.kappa(state.n),
        config.omega0_sq())


def total_energy_fmm(config: SimConfig, state: ParticleState,
                     engine, fstate) -> torch.Tensor:
    """Hamiltonian with the Coulomb term from the FMM potential — O(N),
    usable at scales where the pairwise sum is impractical."""
    ke = 0.5 * torch.sum(torch.square(state.vel).to(torch.float32))
    k = torch.as_tensor(config.omega0_sq(), dtype=torch.float32,
                        device=state.pos.device)
    trap = 0.5 * torch.sum(torch.square(state.pos).to(torch.float32) * k)
    phi = engine.potential(state.pos, fstate)
    return ke + trap + 0.5 * torch.sum(phi.to(torch.float32))
