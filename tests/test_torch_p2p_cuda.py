"""The Hopper P2P kernel against its plain PyTorch version, on the card.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX (the GPU machine has none), so it runs there on its own,
without the repository's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_p2p_cuda.py -q
"""

import numpy as np
import pytest
import torch

from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
from coulomb_oscillators_tpu_torch.simulate import Simulator
from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

pytestmark = pytest.mark.cuda

X_STD = (0.003, 0.001, 0.01)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("sub_depth", [2, 0])
def test_kernel_matches_plain(cuda, sub_depth):
    """max|da| / max|a| <= 1e-5 (the reference kernel's contract,
    tests/test_p2p_pallas_tpu.py): the kernel sums each target's pairs
    sequentially, the plain version by tiles and index_add_."""
    n = 50_000
    cfg = SimConfig(fmm_order=3, tree_radius=1.7)
    pos_h, _ = ID.init_gaussian(n, X_STD, X_STD)
    pos = torch.from_numpy(pos_h).to(cuda)
    eng = KdFmmEngine(cfg, n, sub_depth=sub_depth)
    fs = eng.build(pos)
    ppad = eng.pad_array(pos, fs, fill=FAR)
    pblk = ppad.reshape(eng.G_blk, eng.C_blk, 3)
    before = p2p_cuda.launches
    got = eng._stage_p2p(ppad, fs).reshape(pblk.shape)
    assert p2p_cuda.launches == before + 1
    ref = p2p_cuda.p2p_plain(pblk, fs.p2p_row_ptr, fs.p2p_col2d, eng.nsub,
                             cfg.eps2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    scale = torch.linalg.vector_norm(ref, dim=-1).max()
    dev = float(torch.linalg.vector_norm(got - ref, dim=-1).max() / scale)
    assert dev <= 1e-5, dev


@pytest.mark.parametrize("kw", [dict(dens_inhom=0.25), dict(tree_L=10)],
                         ids=["CB512", "CB1024"])
def test_kernel_matches_plain_wide_blocks(cuda, kw):
    """Blocks wider than 256 slots, which the CLI's -i and -maxlevel reach
    at N=1M: dens_inhom=0.25 gives L=13, C=128, CB=512; tree_L=10 gives
    sub_depth=0, C=CB=1024.  max|da|/max|a| <= 1e-5 against the plain
    version."""
    n = 1_000_000
    cfg = SimConfig(fmm_order=6, tree_radius=1.67, **kw)
    u = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
    pos_h, _ = ID.init_gaussian(n, X_STD, u, seed=0)
    pos = torch.from_numpy(pos_h).to(cuda)
    eng = KdFmmEngine(cfg, n)
    assert eng.C_blk > 256
    fs = eng.build(pos)
    ppad = eng.pad_array(pos, fs, fill=FAR)
    pblk = ppad.reshape(eng.G_blk, eng.C_blk, 3)
    got = eng._stage_p2p(ppad, fs).reshape(pblk.shape)
    ref = p2p_cuda.p2p_plain(pblk, fs.p2p_row_ptr, fs.p2p_col2d, eng.nsub,
                             cfg.eps2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    scale = torch.linalg.vector_norm(ref, dim=-1).max()
    dev = float(torch.linalg.vector_norm(got - ref, dim=-1).max() / scale)
    assert dev <= 1e-5, dev


@pytest.mark.parametrize("n", [50_000, 1_000_000])
def test_float64_kernel_matches_plain(cuda, n):
    """The double instantiation on a float64 kd state (device Morton
    build, uniform box): one launch, and max|da| / max|a| <= 1e-12 against
    the plain float64 version.  Both carry the same ~1e-36 per FAR pad."""
    cfg = SimConfig(fmm_order=4, tree_radius=2.0, precision="float64")
    pos = torch.from_numpy(ID.init_uniform(n, (-0.01,) * 3, (0.01,) * 3)
                           .astype(np.float64)).to(cuda)
    eng = KdFmmEngine(cfg, n, sort_mode="morton")
    fs = eng.build(pos)
    ppad = eng.pad_array(pos, fs, fill=FAR)
    pblk = ppad.reshape(eng.G_blk, eng.C_blk, 3)
    before = p2p_cuda.launches
    got = eng._stage_p2p(ppad, fs).reshape(pblk.shape)
    assert p2p_cuda.launches == before + 1 and got.dtype == torch.float64
    ref = p2p_cuda.p2p_plain(pblk, fs.p2p_row_ptr, fs.p2p_col2d, eng.nsub,
                             cfg.eps2)
    torch.cuda.synchronize()
    scale = torch.linalg.vector_norm(ref, dim=-1).max()
    dev = float(torch.linalg.vector_norm(got - ref, dim=-1).max() / scale)
    assert dev <= 1e-12, dev


def test_kernel_rejects_unsupported_layout(cuda):
    pos = torch.zeros(2, 96, 3, device=cuda)          # C = 24 at nsub = 4
    rp = torch.zeros(9, dtype=torch.int32, device=cuda)
    col = torch.zeros(8, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        p2p_cuda.p2p(pos, rp, col, 4, 1e-18)


def test_simulator_cuda_matches_cpu(cuda):
    """The same run on the card and on the CPU (plain P2P):
    max|dpos|/max|pos| <= 1e-5 (summation order only)."""
    n = 4096
    cfg = SimConfig(fmm_order=4, tree_radius=2.0, tree_steps=3)
    pos, vel = ID.init_gaussian(n, X_STD, X_STD)
    outs = []
    for device in ("cpu", cuda):
        sim = Simulator(cfg, n)
        try:
            st = sim.init_acc(particle_state_from_numpy(pos, vel,
                                                        device=device))
            outs.append(sim.run(st, 7).pos.cpu().numpy())
        finally:
            sim.close()
    dev = np.abs(outs[1] - outs[0]).max() / np.abs(outs[0]).max()
    assert dev <= 1e-5, dev
