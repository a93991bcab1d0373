"""Symplectic integrators as coefficient-table compositions.

Twin of ``coulomb_oscillators_tpu/models/integrators.py`` (reference:
Simulation/integrator.cuh): the same stage tables, unrolled by
:func:`make_step` into a step over tensors.  Coefficients are computed in
Python float (binary64) and rounded to the state dtype, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from coulomb_oscillators_tpu_torch.config import round_to_dtype
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


def make_step(
    force_fn: Callable[..., torch.Tensor],
    table: Sequence[Stage] | str,
    dt: float,
    scale: float = 1.0,
) -> Callable[..., ParticleState]:
    """Build a single-step function state -> state from a stage table.

    `force_fn`: pos [N,D] -> acc [N,D] (already includes the trap term).
    Extra arguments of the step, ``step(state, *args)``, are handed on to
    every ``force_fn(pos, *args)`` (the frozen tree of a window).  The
    stage coefficients are rounded to the state dtype once, when the step
    first sees that dtype.  The step allocates new tensors; it never
    updates its input in place.
    """
    if isinstance(table, str):
        table = INTEGRATORS[table]
    dt = float(dt)
    scale = float(scale)
    coefs = {}      # dtype -> the table's stages with rounded coefficients

    def stages(dtype):
        if dtype not in coefs:
            coefs[dtype] = tuple(
                (s[0], round_to_dtype(dt * s[1] if s[0] == "D"
                                      else dt * scale * s[1], dtype))
                if s[0] in "DK" else s for s in table)
        return coefs[dtype]

    def step(state: ParticleState, *args) -> ParticleState:
        pos, vel, acc = state
        for stage in stages(pos.dtype):
            if stage[0] == "D":
                pos = pos + vel * stage[1]
            elif stage[0] == "K":
                vel = vel + acc * stage[1]
            else:  # "F"
                acc = force_fn(pos, *args)
        return ParticleState(pos, vel, acc)

    return step


def nsteps(step_fn, state: ParticleState, n: int) -> ParticleState:
    """Run `n` steps eagerly (the twin's lax.scan, as a Python loop; the
    Simulator replays a captured step instead, ``utils/graphs.py``)."""
    for _ in range(n):
        state = step_fn(state)
    return state
