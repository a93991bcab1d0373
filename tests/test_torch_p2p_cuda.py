"""The Hopper P2P kernels against their plain PyTorch version, on the
card: csrc/p2p.cu in dim 3 (fmm3_kd) and csrc/p2p2d.cu in dim 2
(fmm2_kd), float32 and float64.

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
from torch_p2p_lists import rel_dev, synthetic

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

X_STD = (0.003, 0.001, 0.01)
# fmm2_kd's config (ladder row 2) on the 2D Gaussian beam
CFG2 = dict(dim=2, omega0=(1.095, 1.0), fmm_order=4, tree_radius=2.0)


def _beam2(n, seed=0):
    """The 2D Gaussian beam of fmm2_kd (x_std = X_STD[:2], u = omega0 x
    x_std): float32 positions and velocities."""
    u = tuple(w * x for w, x in zip(CFG2["omega0"], X_STD[:2]))
    return ID.init_gaussian(n, X_STD[:2], u, dim=2, seed=seed)


def _dev(got, ref):
    """max|da| / max|a| over the rows of [.., dim] tensors."""
    scale = torch.linalg.vector_norm(ref, dim=-1).max()
    return float(torch.linalg.vector_norm(got - ref, dim=-1).max() / scale)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dim", [3, 2], ids=["dim3", "dim2"])
@pytest.mark.parametrize("sub_depth", [2, 0])
def test_kernel_matches_plain(cuda, sub_depth, dim):
    """max|da| / max|a| <= 1e-5 (the reference kernel's contract,
    tests/test_p2p_pallas_tpu.py) on a kd engine state: in dim 3 the 3D
    beam at N=50k, in dim 2 fmm2_kd's beam and config at N=100k (ladder
    row 2).  The kernel sums each target's pairs sequentially, the plain
    version by tiles and index_add_.  One launch, counted in launches_2d
    too in dim 2."""
    if dim == 3:
        n, cfg = 50_000, SimConfig(fmm_order=3, tree_radius=1.7)
        pos_h, _ = ID.init_gaussian(n, X_STD, X_STD)
    else:
        n, cfg = 100_000, SimConfig(**CFG2)
        pos_h, _ = _beam2(n)
    pos = torch.from_numpy(pos_h).to(cuda)
    eng = KdFmmEngine(cfg, n, sub_depth=sub_depth)
    fs = eng.build(pos)
    ppad = eng.pad_array(pos, fs, fill=FAR)
    pblk = ppad.reshape(eng.G_blk, eng.C_blk, dim)
    before = (p2p_cuda.launches, p2p_cuda.launches_2d)
    got = eng._stage_p2p(ppad, fs).reshape(pblk.shape)
    assert (p2p_cuda.launches, p2p_cuda.launches_2d) == (
        before[0] + 1, before[1] + (dim == 2))
    ref = p2p_cuda.p2p_plain(pblk, fs.p2p_row_ptr, fs.p2p_col2d, eng.nsub,
                             cfg.eps2)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    dev = _dev(got, ref)
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


@pytest.mark.parametrize("dim", [3, 2], ids=["dim3", "dim2"])
@pytest.mark.parametrize("n", [50_000, 1_000_000])
def test_float64_kernel_matches_plain(cuda, n, dim):
    """The double instantiation on a float64 kd state (device Morton
    build, uniform box or square): one launch, and max|da| / max|a| <=
    1e-12 against the plain float64 version.  Both carry the same ~1e-36
    (dim 3) or ~5e-19 (dim 2) per FAR pad."""
    cfg = SimConfig(fmm_order=4, tree_radius=2.0, precision="float64",
                    **({} if dim == 3 else dict(dim=2, omega0=(1.095, 1.0))))
    pos = torch.from_numpy(ID.init_uniform(n, (-0.01,) * dim, (0.01,) * dim,
                                           dim=dim)
                           .astype(np.float64)).to(cuda)
    eng = KdFmmEngine(cfg, n, sort_mode="morton")
    fs = eng.build(pos)
    ppad = eng.pad_array(pos, fs, fill=FAR)
    pblk = ppad.reshape(eng.G_blk, eng.C_blk, dim)
    before = p2p_cuda.launches
    got = eng._stage_p2p(ppad, fs).reshape(pblk.shape)
    assert p2p_cuda.launches == before + 1 and got.dtype == torch.float64
    ref = p2p_cuda.p2p_plain(pblk, fs.p2p_row_ptr, fs.p2p_col2d, eng.nsub,
                             cfg.eps2)
    torch.cuda.synchronize()
    dev = _dev(got, ref)
    assert dev <= 1e-12, dev


@pytest.mark.parametrize("dim", [3, 2], ids=["dim3", "dim2"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("nsub,CB", [
    (n, cb) for n in (1, 2, 4, 8) for cb in (128, 256, 512, 1024)
    if (cb // n) % 32 == 0])
def test_kernel_matches_plain_synthetic(cuda, nsub, CB, dtype, dim):
    """Seeded synthetic lists (trailing FAR pads, an empty row, a row
    above dmax, the sentinel, mask-0 entries, every lane-group mask and a
    row of 1,600 entries), in dims 3 and 2: max|da| / max|a| <= 1e-5 in
    float32 and 1e-12 in float64 against the plain version; one launch per
    call (counted in launches_2d too in dim 2); the same bits again, and
    in dim 3 in grid order (no block order)."""
    pos, rp, col = synthetic(nsub, CB, Gb=24, dtype=dtype, seed=nsub + CB,
                             long_row=1600, dim=dim)
    args = (torch.from_numpy(pos).to(cuda), torch.from_numpy(rp).to(cuda),
            torch.from_numpy(col).to(cuda), nsub, 1e-18)
    before = (p2p_cuda.launches, p2p_cuda.launches_2d)
    got = p2p_cuda.p2p(*args)
    assert (p2p_cuda.launches, p2p_cuda.launches_2d) == (
        before[0] + 1, before[1] + (dim == 2))
    ref = p2p_cuda.p2p_plain(*args)
    again = p2p_cuda.p2p(*args)
    torch.cuda.synchronize()
    assert got.dtype == args[0].dtype and bool(torch.isfinite(got).all())
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert rel_dev(got.cpu().numpy(), ref.cpu().double().numpy()) <= tol
    assert torch.equal(got, again)
    if dim == 3:
        assert torch.equal(got, p2p_cuda.launch(*args, order=None))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("K", [1, 16, 32])
@pytest.mark.parametrize("nsub,CB", [(4, 128), (1, 256), (8, 1024)])
def test_kernel2d_segments(cuda, nsub, CB, K, dtype):
    """The dim-2 kernel with segments of K entries on synthetic lists with
    rows of 1, K, K + 1 and 1,600 entries (the last one spans 50-1,600
    segments): max|da| / max|a| <= 1e-5 in float32 and 1e-12 in float64
    against the plain version, bitwise the same in a second launch, one
    launch a call."""
    pos, rp, col = synthetic(nsub, CB, Gb=24, dtype=dtype, seed=K + CB,
                             long_row=1600, dim=2, degrees=(1, K, K + 1))
    args = (torch.from_numpy(pos).to(cuda), torch.from_numpy(rp).to(cuda),
            torch.from_numpy(col).to(cuda), nsub, 1e-18)
    before = p2p_cuda.launches_2d
    got = p2p_cuda.launch_2d(*args, K=K)
    again = p2p_cuda.launch_2d(*args, K=K)
    assert p2p_cuda.launches_2d == before + 2
    ref = p2p_cuda.p2p_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert rel_dev(got.cpu().numpy(), ref.cpu().double().numpy()) <= tol


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [100_000, 1_000_000])
def test_kernel2d_matches_plain_kd_states(cuda, n, dtype):
    """The dim-2 kernel on fmm2_kd's states (ladder row 2's config and 2D
    beam) at N = 100k and at N = 1M, whose heaviest row holds ~2,000
    entries: max|da| / max|a| <= 1e-5 in float32 and 1e-12 in float64
    against the plain version, bitwise the same in a second call."""
    cfg = SimConfig(precision=dtype, **CFG2)
    pos_h, _ = _beam2(n)
    pos = torch.from_numpy(pos_h.astype(dtype)).to(cuda)
    eng = KdFmmEngine(cfg, n)
    fs = eng.build(pos)
    pblk = eng.pad_array(pos, fs, fill=FAR).reshape(eng.G_blk, eng.C_blk, 2)
    args = (pblk.contiguous(), fs.p2p_row_ptr, fs.p2p_col2d, eng.nsub,
            cfg.eps2)
    got = p2p_cuda.p2p(*args)
    again = p2p_cuda.p2p(*args)
    ref = p2p_cuda.p2p_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == pos.dtype and torch.equal(got, again)
    dev = _dev(got, ref)
    assert dev <= (1e-5 if dtype == "float32" else 1e-12), dev


def test_kernel2d_graph_replay_equals_eager(cuda):
    """p2p() in dim 2 captured in a CUDA graph (its plan, scratch and
    launch) and replayed twice equals the eager call bitwise."""
    pos, rp, col = synthetic(4, 128, Gb=64, seed=3, long_row=1600, dim=2)
    args = (torch.from_numpy(pos).to(cuda), torch.from_numpy(rp).to(cuda),
            torch.from_numpy(col).to(cuda), 4, 1e-18)
    eager = p2p_cuda.p2p(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        p2p_cuda.p2p(*args)                  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = p2p_cuda.p2p(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_kernel_rejects_unsupported_layout(cuda):
    """C = 24 at nsub = 4 (not a multiple of 32) and a last dim of 4 raise
    on the card, launching nothing."""
    rp = torch.zeros(9, dtype=torch.int32, device=cuda)
    col = torch.zeros(8, 128, dtype=torch.int32, device=cuda)
    before = p2p_cuda.launches
    for shape in ((2, 96, 3), (2, 128, 4)):
        with pytest.raises(ValueError):
            p2p_cuda.p2p(torch.zeros(shape, device=cuda), rp, col, 4, 1e-18)
    assert p2p_cuda.launches == before


@pytest.mark.parametrize("engine", ["fmm3_kd", "fmm2_kd"])
def test_simulator_cuda_matches_cpu(cuda, engine):
    """The same run on the card and on the CPU (plain P2P):
    max|dpos|/max|pos| <= 1e-5 (summation order only)."""
    n = 4096
    if engine == "fmm3_kd":
        cfg = SimConfig(fmm_order=4, tree_radius=2.0, tree_steps=3)
        pos, vel = ID.init_gaussian(n, X_STD, X_STD)
    else:
        cfg = SimConfig(tree_steps=3, **CFG2)
        pos, vel = _beam2(n)
    outs = []
    for device in ("cpu", cuda):
        sim = Simulator(cfg, n, engine=engine)
        try:
            st = sim.init_acc(particle_state_from_numpy(pos, vel,
                                                        device=device))
            outs.append(sim.run(st, 7).pos.cpu().numpy())
        finally:
            sim.close()
    dev = np.abs(outs[1] - outs[0]).max() / np.abs(outs[0]).max()
    assert dev <= 1e-5, dev


def test_kd2_card_paths_never_reach_the_plain_version(cuda, monkeypatch):
    """fmm2_kd on the card with p2p_plain and p2p_plain_entries made to
    raise: a force evaluation and a Simulator window (init_acc and 2
    windows of 4 steps, graphs or not as the environment says) run, and
    the dim-2 kernel launches once a force evaluation."""
    def refuse(*a, **k):
        raise AssertionError("a card path reached the plain P2P version")

    monkeypatch.setattr(p2p_cuda, "p2p_plain", refuse)
    monkeypatch.setattr(p2p_cuda, "p2p_plain_entries", refuse)
    n = 20_000
    cfg = SimConfig(tree_steps=4, **CFG2)
    pos_h, vel_h = _beam2(n)
    pos = torch.from_numpy(pos_h).to(cuda)
    eng = KdFmmEngine(cfg, n)
    before = p2p_cuda.launches_2d
    acc = eng.force(pos, eng.build(pos))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(acc).all()) and acc.shape == (n, 2)
    assert p2p_cuda.launches_2d == before + 1
    sim = Simulator(cfg, n, engine="fmm2_kd")
    try:
        torch.cuda.synchronize()
        before = p2p_cuda.launches_2d
        st = sim.init_acc(particle_state_from_numpy(pos_h, vel_h,
                                                    device=cuda))
        st = sim.run(st, 8)
        torch.cuda.synchronize()
    finally:
        sim.close()
    assert bool(torch.isfinite(st.pos).all())
    assert p2p_cuda.launches_2d - before == 1 + 8
