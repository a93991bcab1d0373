"""The benchmark's inputs, made from ``--seed`` alone.

A Gaussian beam: positions ~ N(0, x_std^2) and velocities ~ N(0,
u_std^2) per axis, exactly centred and rescaled to those rms values, as
the reference's initGA does (Simulation/main3.cu:114-137), drawn in
float64 with NumPy's PCG64 and rounded to float32.

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


def gaussian(n: int, x_std, u_std, seed: int, dtype=np.float32):
    """(pos, vel) [n, dim] of the beam, in the order the seed picks."""
    x_std = np.asarray(x_std, np.float64)
    u_std = np.asarray(u_std, np.float64)
    s = _rng(BASE_STREAM, 0).standard_normal((2 * n, x_std.shape[0]))
    out = []
    for a, std in ((s[:n], x_std), (s[n:], u_std)):
        a = a - a.mean(axis=0)
        a = a * (std / np.sqrt(np.mean(a * a, axis=0)))
        out.append(a.astype(dtype))
    order = _rng(seed, 2).permutation(n)
    return out[0][order], out[1][order]


def targets(n: int, count: int, seed: int) -> np.ndarray:
    """`count` distinct particle indices drawn from the seed (all n, in
    order, when count >= n)."""
    if count >= n:
        return np.arange(n, dtype=np.int64)
    return np.sort(_rng(seed, 1).choice(n, count, replace=False))
