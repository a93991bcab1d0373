"""The benchmark's inputs, made from ``--seed`` alone.

A Gaussian beam (:func:`gaussian`): positions ~ N(0, x_std^2) and
velocities ~ N(0, u_std^2) per axis, exactly centred and rescaled to those
rms values, as the reference's initGA does (Simulation/main3.cu:114-137).
A Kapchinskij-Vladimirskij beam (:func:`kv`), the upstream 2D program's
default (Simulation/main.cu:120-145, :752).  Both are drawn in float64
with NumPy's PCG64 and rounded to float32.

The draw itself is fixed (``BASE_STREAM``); the seed picks the order in
which the particles are handed to the program.  So every seed gives the
program the same work: the same particles, the same tree and lists (up to
the order of sums inside a leaf), the same list capacities and captures
at the same steps.  Fresh draws, and even the beam's mirror images,
changed the work from seed to seed far more than two runs of one seed
differed (the largest partner row of the P2P lists, and with it the
device memory, the captures and the rate), so the seed varies only what
does not change it.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1
BASE_STREAM = 20260917        # the one draw every seed reorders


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed & MASK64, stream])))


def _ordered(pos, x_rms, vel, u_rms, seed: int, dtype):
    """`pos` and `vel` centred and rescaled to the rms values per axis
    exactly, rounded to `dtype`, in the order the seed picks."""
    out = []
    for a, std in ((pos, x_rms), (vel, u_rms)):
        a = a - a.mean(axis=0)
        a = a * (std / np.sqrt(np.mean(a * a, axis=0)))
        out.append(a.astype(dtype))
    order = _rng(seed, 2).permutation(len(out[0]))
    return out[0][order], out[1][order]


def gaussian(n: int, x_std, u_std, seed: int, dtype=np.float32):
    """(pos, vel) [n, dim] of the beam, in the order the seed picks."""
    x_std = np.asarray(x_std, np.float64)
    u_std = np.asarray(u_std, np.float64)
    s = _rng(BASE_STREAM, 0).standard_normal((2 * n, x_std.shape[0]))
    return _ordered(s[:n], x_std, s[n:], u_std, seed, dtype)


def kv(n: int, A, omega, seed: int, dtype=np.float32):
    """(pos, vel) [n, 2] of the KV beam of semi-axes `A` and depressed
    phase advances `omega`, in the order the seed picks: with eta, etax
    and etay uniform on [0, 1), x = A_x sqrt(eta) cos(2 pi etax), y = A_y
    sqrt(1 - eta) cos(2 pi etay), and the velocities A omega sqrt(.)
    sin(.) on the same phases; then centred and rescaled to rms A / 2 and
    omega A / 2 per axis exactly (initKV, main.cu:120-145)."""
    A = np.asarray(A, np.float64)
    omega = np.asarray(omega, np.float64)
    eta, etax, etay = _rng(BASE_STREAM, 3).random((3, n))
    amp = np.stack([np.sqrt(eta), np.sqrt(1.0 - eta)], axis=1)
    phase = 2.0 * np.pi * np.stack([etax, etay], axis=1)
    return _ordered(A * amp * np.cos(phase), A / 2,
                    A * omega * amp * np.sin(phase), omega * A / 2, seed,
                    dtype)


def targets(n: int, count: int, seed: int) -> np.ndarray:
    """`count` distinct particle indices drawn from the seed (all n, in
    order, when count >= n)."""
    if count >= n:
        return np.arange(n, dtype=np.int64)
    return np.sort(_rng(seed, 1).choice(n, count, replace=False))
