"""Deterministic initial particle distributions.

Numpy copy of ``coulomb_oscillators_tpu/models/init_dist.py``: the same
MT19937 stream, so its arrays equal the twin's bit for bit.

Reference: Simulation/main3.cu:71-137 (centerDist, adjustRMS, initU, initGA)
and Simulation/main.cu:120-145 (initKV).  The reference draws from a fixed
std::mt19937_64 stream (seed 5351550349027530206, main3.cu:662-666); the TPU
rebuild uses jax.random with a fixed default seed — runs are bit-deterministic
for a given seed/backend, which is the property the reference's fixture
provides (SURVEY.md §4).

Sampling and moment-matching happen in float64 on host (numpy via jax on CPU
would truncate; we use jnp with explicit f64->target cast at the end) so the
exact-moment adjustment is not polluted by f32 rounding.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

DEFAULT_SEED = 5351550349027530206  # main3.cu:662


def _rng(seed: int) -> np.random.Generator:
    # MT19937 like the reference; discard(624*2) mirrors main3.cu:663.
    bitgen = np.random.MT19937(seed % (2**32))
    gen = np.random.Generator(bitgen)
    return gen


def center_dist(data: np.ndarray) -> np.ndarray:
    """Subtract the mean so the distribution is exactly centered (main3.cu:71-80)."""
    return data - data.mean(axis=0, keepdims=True)


def adjust_rms(data: np.ndarray, adj) -> np.ndarray:
    """Rescale so the per-component RMS equals `adj` exactly (main3.cu:82-92)."""
    rms = np.sqrt(np.mean(data * data, axis=0, keepdims=True))
    return data * (np.asarray(adj) / rms)


def init_gaussian(n: int, x_std, u_std, dim: int = 3,
                  seed: int = DEFAULT_SEED,
                  dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian beam: pos ~ N(0, x_std^2), vel ~ N(0, u_std^2), exactly
    centered and RMS-matched per component (initGA, main3.cu:114-137)."""
    gen = _rng(seed)
    samples = gen.standard_normal(size=(2 * n, dim), dtype=np.float64)
    pos = samples[:n] * np.asarray(x_std, dtype=np.float64)
    vel = samples[n:] * np.asarray(u_std, dtype=np.float64)
    pos = adjust_rms(center_dist(pos), x_std)
    vel = adjust_rms(center_dist(vel), u_std)
    return pos.astype(dtype), vel.astype(dtype)


def init_uniform(n: int, a, b, dim: int = 3,
                 seed: int = DEFAULT_SEED,
                 dtype=np.float32) -> np.ndarray:
    """Uniform positions over the cuboid [a, b], centered (initU,
    main3.cu:94-112).  Velocities are left to the caller, as in the
    reference (velocities 'remain uninitialized')."""
    gen = _rng(seed)
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    pos = gen.uniform(size=(n, dim)) * (b - a) + a
    return center_dist(pos).astype(dtype)


def init_kv(n: int, semi_axis, omega, seed: int = DEFAULT_SEED,
            dtype=np.float64) -> Tuple[np.ndarray, np.ndarray]:
    """Kapchinskij-Vladimirskij 2D beam distribution (initKV, main.cu:120-145).

    semi_axis: (Ax, Ay) envelope semi-axes; omega: depressed phase advance.
    pos_x = Ax sqrt(eta) cos(2 pi etax), pos_y = Ay sqrt(1-eta) cos(2 pi etay),
    vel = A*omega times the matching sines; moments matched to A/2 and
    omega*A/2 exactly.
    """
    gen = _rng(seed)
    A = np.asarray(semi_axis, dtype=np.float64)
    om = np.asarray(omega, dtype=np.float64)
    eta = gen.uniform(size=n)
    etax = 2 * np.pi * gen.uniform(size=n)
    etay = 2 * np.pi * gen.uniform(size=n)
    rt, rt1 = np.sqrt(eta), np.sqrt(1 - eta)
    pos = np.stack([A[0] * rt * np.cos(etax), A[1] * rt1 * np.cos(etay)], axis=1)
    vel = np.stack([A[0] * om[0] * rt * np.sin(etax),
                    A[1] * om[1] * rt1 * np.sin(etay)], axis=1)
    pos = adjust_rms(center_dist(pos), A / 2)
    vel = adjust_rms(center_dist(vel), om * A / 2)
    return pos.astype(dtype), vel.astype(dtype)
