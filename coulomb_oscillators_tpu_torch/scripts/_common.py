"""What the measurement scripts share: the device rule, the card's
identity, the production beam and the seeded oracle targets."""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

X_STD = (0.003, 0.001, 0.01)     # the production Gaussian beam (README)
N_TARGETS = 2048                 # Kahan-oracle targets, default_rng(0)


def pick_device(name=None) -> torch.device:
    """``cuda:0`` unless the caller names another device.  A measurement
    script measures the card: without one, and without an explicit
    ``--device cpu``, this raises instead of timing the host."""
    if name not in (None, "cuda"):
        return torch.device(name)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this script measures the card; pass "
            "--device cpu to run it on the host (tests, rehearsals)")
    return torch.device("cuda", 0)


def device_info(device) -> dict:
    """Where the numbers were taken: for a card its nvidia-smi name and
    power limit with the torch and CUDA versions, else the word cpu."""
    info = {"torch": torch.__version__}
    if torch.device(device).type != "cuda":
        return dict(info, device="cpu")
    from coulomb_oscillators_tpu_torch.scripts.ladder import card
    return dict(info, **card(), cuda=torch.version.cuda)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def beam(n: int, config=None):
    """The production Gaussian beam at `n` in float32: (pos, vel) on the
    host, x_std = X_STD, u = omega0 * x_std, seed 0."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    config = config or SimConfig()
    u = tuple(w * x for w, x in zip(config.omega0, X_STD))
    return ID.init_gaussian(n, X_STD, u, dtype=np.float32)


def oracle_targets(n: int) -> np.ndarray:
    """Indices of the seeded oracle targets (2048, or all below that)."""
    return np.random.default_rng(0).choice(n, min(N_TARGETS, n),
                                           replace=False)


@contextlib.contextmanager
def graphs_env(on):
    """``CO_CUDA_GRAPHS`` for the Simulators built inside: True or False
    forces the card's CUDA graphs on or off, None leaves the environment's
    choice (the Simulator reads the knob when it is built)."""
    saved = os.environ.get("CO_CUDA_GRAPHS")
    try:
        if on is not None:
            os.environ["CO_CUDA_GRAPHS"] = "1" if on else "0"
        yield
    finally:
        if saved is None:
            os.environ.pop("CO_CUDA_GRAPHS", None)
        else:
            os.environ["CO_CUDA_GRAPHS"] = saved


def graph_info(sim) -> dict:
    """A Simulator's CUDA-graph facts: whether its steps replay a graph,
    and its captures and their seconds."""
    g = sim.graph
    return {"graphs": g is not None, "captures": g.captures if g else 0,
            "capture_s": g.capture_seconds if g else 0.0}

