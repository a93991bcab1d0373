"""The reference's snapshot format, read plainly: the raw little-endian
dump of the positions [N, DIM] and then the velocities [N, DIM], float32
in the 3D program, N given by the file's size (Simulation/main3.cu:629-667
reads it, :848-872 writes it)."""

from __future__ import annotations

import numpy as np


def read(path: str, dim: int = 3, dtype=np.float32):
    """(pos, vel) of one snapshot file; raises if its size is not a whole
    number of particles."""
    raw = np.fromfile(path, dtype=np.dtype(dtype).newbyteorder("<"))
    if raw.size % (2 * dim):
        raise ValueError(f"{path}: {raw.size} values are not 2 x {dim} x N")
    n = raw.size // (2 * dim)
    return (raw[:n * dim].reshape(n, dim).astype(dtype),
            raw[n * dim:].reshape(n, dim).astype(dtype))
