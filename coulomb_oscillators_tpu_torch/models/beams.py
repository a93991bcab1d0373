"""Matched-beam parameter algebra for the 2D driver.

Numpy copy of ``coulomb_oscillators_tpu/models/beams.py``.

Reference: Simulation/main.cu:294-315 — given emittances (ex, ey), trap
frequencies omega0 and a tune depression for y, solve the rms envelope
matching conditions for the KV beam: the x depressed phase advance solves
the quartic

    w^4 - 2*om0x^2 * w^2 + d * w + om0x^4 = 0,
    d = -Ay^2 * (om0y^2 - omy^2)^2 / (4 * ex)

then A = 2*sqrt(emit/omega), xi = (om0y^2-omy^2) * Ay * (Ax+Ay) / 2, and the
rms-equivalent gaussian has x = A/2, u = omega*A/2.
"""

from __future__ import annotations

import numpy as np


def matched_beam_2d(omega0, emit, tune_dep_y: float = 0.8):
    """Matched KV/gaussian beam parameters.

    Returns dict with A (semi-axes), omega (depressed phase advances),
    xi (space-charge coupling), x_std, u_std (rms-matched gaussian moments).
    """
    omega0 = np.asarray(omega0, dtype=np.float64)
    emit = np.asarray(emit, dtype=np.float64)

    omega_y = tune_dep_y * omega0[1]
    A_y = 2.0 * np.sqrt(emit[1] / omega_y)
    domega_y = (omega0[1] + omega_y) * (omega0[1] - omega_y)

    om0x2 = omega0[0] ** 2
    d = -A_y * A_y * domega_y * domega_y / (4.0 * emit[0])
    # quartic w^4 + c w^2 + d w + e = 0, c = -2 om0x^2, e = om0x^4
    roots = np.roots([1.0, 0.0, -2.0 * om0x2, d, om0x2 * om0x2])
    real = roots[np.abs(roots.imag) < 1e-9 * np.abs(roots).max()].real
    cands = real[(real > 0) & (real < omega0[0])]
    if cands.size == 0:
        raise ValueError("no matched solution: envelope quartic has no "
                         "positive depressed root")
    omega_x = float(np.min(cands))  # the depressed (smallest positive) root

    A_x = 2.0 * np.sqrt(emit[0] / omega_x)
    A = np.array([A_x, A_y])
    omega = np.array([omega_x, omega_y])
    xi = float(domega_y * A_y * (A_x + A_y) / 2.0)
    return {
        "A": A,
        "omega": omega,
        "xi": xi,
        "x_std": A / 2.0,
        "u_std": omega * A / 2.0,
    }
