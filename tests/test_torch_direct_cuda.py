"""The Hopper direct kernel against its plain PyTorch version and the
Kahan oracle, on the card.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX (the GPU machine has none), so it runs there on its own,
without the repository's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_direct_cuda.py -q
"""

import numpy as np
import pytest
import torch

from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.models.beams import matched_beam_2d
from coulomb_oscillators_tpu_torch.ops import direct as D
from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err
from coulomb_oscillators_tpu_torch.simulate import Simulator
from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

pytestmark = pytest.mark.cuda

X_STD = (0.003, 0.001, 0.01)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _rel_dev(a, b):
    return float(torch.linalg.vector_norm(a - b, dim=-1).max()
                 / torch.linalg.vector_norm(b, dim=-1).max())


@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_matches_kahan(cuda, dim):
    """Mean relative error <= 1e-6 against Kahan at n=1000, the reference
    kernel's contract (tests/test_direct.py::test_direct_pallas_matches)."""
    rng = np.random.default_rng(1234)
    pos = torch.from_numpy(rng.normal(size=(1000, dim)).astype(np.float32)
                           * 0.01).to(cuda)
    before = D.launches
    got = D.direct(pos, 1e-18, 2e-9)
    assert D.launches == before + 1
    ref = D.direct_kahan(pos, 1e-18, 2e-9)
    err = float(mean_rel_err(got, ref))
    assert err <= 1e-6, err


@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_matches_plain_at_cli_size(cuda, dim):
    """N=30001 (the CLI's default): the 3D Gaussian beam and the 2D KV
    beam; max|da|/max|a| <= 1e-5 against the plain version (the kernel
    sums each split by tiles, the plain version by torch.sum)."""
    n = 30001
    if dim == 3:
        cfg = SimConfig()
        u = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
        pos, _ = ID.init_gaussian(n, X_STD, u)
    else:
        om = [6.22 * 2 * np.pi, 6.21 * 2 * np.pi]
        beam = matched_beam_2d(om, [0.03e-3, 0.01e-3], 0.8)
        cfg = SimConfig(dim=2, omega0=tuple(om), xi=beam["xi"])
        pos, _ = ID.init_kv(n, beam["A"], beam["omega"], dtype=np.float32)
    p = torch.from_numpy(pos).to(cuda)
    got = D.direct(p, cfg.eps2, cfg.kappa(n))
    ref = D.direct_plain(p, cfg.eps2, cfg.kappa(n))
    assert bool(torch.isfinite(got).all())
    dev = _rel_dev(got, ref)
    assert dev <= 1e-5, dev


def test_kernel_rejects_float64(cuda):
    before = D.launches
    with pytest.raises(ValueError, match="float32"):
        D.direct(torch.zeros(64, 3, dtype=torch.float64, device=cuda),
                 1e-18, 1.0)
    assert D.launches == before


def test_direct_simulator_cuda_matches_cpu(cuda):
    """Simulator("direct") on the card (kernel) and on the CPU (plain):
    20 leapfrog steps, max|dpos|/max|pos| <= 1e-5; one launch per force
    evaluation."""
    n = 2048
    cfg = SimConfig(dt=1e-3)
    u = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
    pos, vel = ID.init_gaussian(n, X_STD, u)
    outs = []
    for device in ("cpu", cuda):
        sim = Simulator(cfg, n, engine="direct")
        before = D.launches
        st = sim.init_acc(particle_state_from_numpy(pos, vel, device=device))
        outs.append(sim.run(st, 20).pos.cpu().numpy())
        expected = 0 if device == "cpu" else 21
        assert D.launches - before == expected
    dev = np.abs(outs[1] - outs[0]).max() / np.abs(outs[0]).max()
    assert dev <= 1e-5, dev
