"""Symplectic integrators as coefficient-table compositions.

Twin of ``coulomb_oscillators_tpu/models/integrators.py`` (reference:
Simulation/integrator.cuh): the same stage tables, unrolled by
:func:`make_step` into a step over tensors.  Coefficients are computed in
Python float (binary64) and rounded to the state dtype, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from coulomb_oscillators_tpu_torch.state import ParticleState

# Stage encodings: ("D", c) drift, ("K", c) kick, ("F",) force eval.
Stage = Tuple

# 1/(2 - cbrt(2)) — Forest-Ruth parameter (integrator.cuh:98)
_FR = 1.3512071919596576340476878089715

# PEFRL parameters (integrator.cuh:130-132)
_PEFRL_X = +0.1786178958448091
_PEFRL_L = -0.2123418310626054
_PEFRL_C = -0.06626458266981849

SYMPLECTIC_EULER: Sequence[Stage] = (("K", 1.0), ("D", 1.0), ("F",))
PRE_SYMPLECTIC_EULER: Sequence[Stage] = (("F",), ("K", 1.0), ("D", 1.0))
LEAPFROG: Sequence[Stage] = (("K", 0.5), ("D", 1.0), ("F",), ("K", 0.5))
FORESTRUTH: Sequence[Stage] = (
    ("D", _FR / 2), ("F",), ("K", _FR),
    ("D", (1 - _FR) / 2), ("F",), ("K", 1 - 2 * _FR),
    ("D", (1 - _FR) / 2), ("F",), ("K", _FR),
    ("D", _FR / 2),
)
PEFRL: Sequence[Stage] = (
    ("D", _PEFRL_X), ("F",), ("K", (1 - 2 * _PEFRL_L) / 2),
    ("D", _PEFRL_C), ("F",), ("K", _PEFRL_L),
    ("D", 1 - 2 * (_PEFRL_C + _PEFRL_X)), ("F",), ("K", _PEFRL_L),
    ("D", _PEFRL_C), ("F",), ("K", (1 - 2 * _PEFRL_L) / 2),
    ("D", _PEFRL_X),
)

INTEGRATORS = {
    "euler": SYMPLECTIC_EULER,
    "pre_euler": PRE_SYMPLECTIC_EULER,
    "leapfrog": LEAPFROG,
    "forestruth": FORESTRUTH,
    "fr": FORESTRUTH,
    "pefrl": PEFRL,
}

# Number of force evaluations per step, for throughput accounting.
FORCE_EVALS = {name: sum(1 for s in tab if s[0] == "F")
               for name, tab in INTEGRATORS.items()}


def _as_dtype(x: float, dtype: torch.dtype) -> float:
    """A binary64 coefficient rounded to the state dtype (returned as the
    Python float of that exact value, so the multiply sees no second
    rounding and no device copy)."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def make_step(
    force_fn: Callable[[torch.Tensor], torch.Tensor],
    table: Sequence[Stage] | str,
    dt: float,
    scale: float = 1.0,
) -> Callable[[ParticleState], ParticleState]:
    """Build a single-step function state -> state from a stage table.

    `force_fn`: pos [N,D] -> acc [N,D] (already includes the trap term).
    The step allocates new tensors; it never updates its input in place.
    """
    if isinstance(table, str):
        table = INTEGRATORS[table]
    dt = float(dt)
    scale = float(scale)

    def step(state: ParticleState) -> ParticleState:
        pos, vel, acc = state
        dtype = pos.dtype
        for stage in table:
            if stage[0] == "D":
                pos = pos + vel * _as_dtype(dt * stage[1], dtype)
            elif stage[0] == "K":
                vel = vel + acc * _as_dtype(dt * scale * stage[1], dtype)
            else:  # "F"
                acc = force_fn(pos)
        return ParticleState(pos, vel, acc)

    return step


def nsteps(step_fn, state: ParticleState, n: int) -> ParticleState:
    """Run `n` steps (the twin's lax.scan, as a Python loop)."""
    for _ in range(n):
        state = step_fn(state)
    return state
