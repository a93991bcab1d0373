"""Binary snapshot I/O, byte-compatible with the reference.

Numpy copy of ``coulomb_oscillators_tpu/utils/io.py``: the same bytes.

Format (Simulation/main3.cu:629-667 read, :848-872 write): a snapshot file is
the raw little-endian dump of positions then velocities, each ``[N, DIM]`` in
the state scalar type (float32 for the 3D driver, float64 for the 2D driver,
constants.cuh:22-28 / main.cu:34-35).  N is inferred from the file size
(main3.cu:636).  Keeping this format byte-identical preserves the contract
with the reference's OpenGL viewer (Graphics/main.cpp:155-184) and enables
checkpoint/resume: any snapshot can be passed back as the input state.

``args.txt`` records the exact CLI (main3.cu:671-683).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def snapshot_name(outdir: str, iteration: int, dt: float) -> str:
    """out<iter>_<dt>.bin with C++ std::to_string(double) formatting
    (6 fixed decimals), main3.cu:855-856."""
    return os.path.join(outdir, f"out{iteration}_{dt:.6f}.bin")


def write_state(path: str, pos: np.ndarray, vel: np.ndarray) -> None:
    """Write positions then velocities as raw bytes (main3.cu:848-858)."""
    pos = np.asarray(pos)
    vel = np.asarray(vel)
    if pos.shape != vel.shape:
        raise ValueError(f"pos/vel shape mismatch: {pos.shape} vs {vel.shape}")
    with open(path, "wb") as f:
        f.write(np.ascontiguousarray(pos).tobytes())
        f.write(np.ascontiguousarray(vel.astype(pos.dtype)).tobytes())


def read_state(path: str, dim: int = 3, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Read a snapshot; N inferred from file size (main3.cu:629-652)."""
    raw = np.fromfile(path, dtype=dtype)
    if raw.size % (2 * dim) != 0:
        raise ValueError(
            f"{path}: size {raw.size} scalars not divisible by 2*dim={2*dim}")
    n = raw.size // (2 * dim)
    pos = raw[: n * dim].reshape(n, dim).copy()
    vel = raw[n * dim:].reshape(n, dim).copy()
    return pos, vel


def write_args(outdir: str, argv) -> None:
    """Persist the exact CLI to args.txt (main3.cu:671-683)."""
    with open(os.path.join(outdir, "args.txt"), "w") as f:
        f.write(" ".join(str(a) for a in argv) + " ")
