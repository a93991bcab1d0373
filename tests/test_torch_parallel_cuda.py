"""The multi-device layer on the card: ranks that share one CUDA device.

Every test here needs a CUDA device and skips without one.  This file and
its rank-side helper (tests/torch_parallel_workers.py) import no JAX (the
GPU machine has none), so they run there without the repository's JAX
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py -q

Two ranks share ``cuda:0`` (``share_device=True``: gloo, collectives staged
through host memory); one rank on ``cuda:0`` runs the NCCL branch.  The
sharded near field launches the Hopper P2P kernel, the sharded direct force
the direct kernel's separate-targets entry.  The mesh-mode Simulator runs
its step as CUDA graphs cut at the collectives, held against
``CO_CUDA_GRAPHS=0`` with the bound of chip_smoke.py's phase 16.
"""

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.ops import direct as D
from coulomb_oscillators_tpu_torch.parallel import mesh as PM

pytestmark = pytest.mark.cuda

X_STD = (0.003, 0.001, 0.01)
N = 50_000
CFG = dict(fmm_order=3, tree_radius=1.7)
SHARED = dict(device="cuda:0", share_device=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rel(a, b):
    return (np.linalg.norm(a - b, axis=-1).max()
            / np.linalg.norm(b, axis=-1).max())


@pytest.mark.parametrize("ndev,kw", [(2, SHARED), (1, {})],
                         ids=["2_shared_gloo", "1_nccl"])
def test_collectives_on_the_card(cuda, ndev, kw):
    r = PM.spawn(W.collectives, ndev, 11, **kw)
    assert r["backend"] == ("gloo" if ndev > 1 else "nccl")
    assert r["every_rank_ok"]


def test_sharded_forces_two_ranks_share_the_card(cuda):
    """The particle-sharded force (one P2P kernel launch on the rank's
    concatenated blocks) and the pair-sharded force against the
    single-device kernel path on the same lists: <= 1e-5 of max|a| (float32
    sums in another order)."""
    pos, vel = ID.init_gaussian(N, X_STD, X_STD)
    states = {}
    for key, g in (("g8", 8), ("g1", 1)):
        fs = W._engine(CFG, N, g).build(torch.from_numpy(pos).to(cuda))
        states[key] = {k: getattr(fs, k).cpu().numpy() for k in fs._fields}
    r = PM.spawn(W.sharded_forces, 2, CFG, pos, vel, states, **SHARED)
    G, C = r["G_C"]
    assert r["shard_shape"] == (G // 2, C, 3)
    assert r["p2p_launches"] == 1
    ref = r["single_force"]
    assert np.isfinite(r["step_pos"]).all()
    for key in ("pshard_force", "shard_force_g8", "shard_force_g1"):
        assert _rel(r[key], ref) <= 1e-5, key


@pytest.mark.parametrize("dim", [2, 3])
def test_direct_targets_kernel_matches_plain(cuda, dim):
    """The direct kernel's separate-targets entry against the plain
    block-on-block form: <= 1e-5 of max|a|; one launch."""
    pos, _ = ID.init_gaussian(30001, X_STD[:dim], X_STD[:dim], dim=dim)
    src = torch.from_numpy(pos).to(cuda)
    tgt = src[5000:12345].contiguous()
    before = D.launches
    got = D.direct_targets(tgt, src, 1e-18, 2e-9)
    assert D.launches == before + 1
    ref = D.direct_targets_plain(tgt, src, 1e-18, 2e-9)
    torch.cuda.synchronize()
    assert _rel(got.cpu().numpy(), ref.cpu().numpy()) <= 1e-5
    # and it is the all-pairs kernel restricted to those rows
    full = D.direct(src, 1e-18, 2e-9)[5000:12345]
    assert _rel(got.cpu().numpy(), full.cpu().numpy()) <= 1e-5
    with pytest.raises(ValueError):
        D.direct_targets(tgt.double(), src.double(), 1e-18, 2e-9)


def test_sharded_direct_two_ranks_share_the_card(cuda):
    cases = {f"{s}{d}": (s, ID.init_gaussian(30001, X_STD[:d], X_STD[:d],
                                             dim=d)[0])
             for s in ("ring", "allgather") for d in (2, 3)}
    r = PM.spawn(W.sharded_direct, 2, cases, 1e-18, 2e-9, **SHARED)
    for name, (_, pos) in cases.items():
        ref = D.direct(torch.from_numpy(pos).to(cuda), 1e-18, 2e-9)
        assert _rel(r[name], ref.cpu().numpy()) <= 1e-5, name


def test_mesh_simulator_two_ranks_share_the_card(cuda):
    """The mesh-mode Simulator across two boundaries (a priming refresh,
    then an adopted background rebuild): every rank returns the same state
    and adopts the same lists; against the single-device Simulator without
    its geometry refresh <= 1e-4 of max|pos|."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
    pos, vel = ID.init_gaussian(N, X_STD, X_STD)
    kw = dict(CFG, tree_steps=3, tree_async=True)
    r = PM.spawn(W.mesh_simulator, 2, {"async": (kw, 8)}, pos, vel,
                 **SHARED)["async"]
    assert r["states_equal"] and r["lists_equal"]
    assert r["rebuilds"] == {"sync_refresh": 1, "adopt_full": 1}
    sim = Simulator(SimConfig(geom_refresh=False, **kw), N, "fmm3_kd")
    try:
        st = sim.init_acc(particle_state_from_numpy(pos, vel, device=cuda))
        ref = sim.run(st, 8).pos.cpu().numpy()
    finally:
        sim.close()
    assert np.abs(r["pos"] - ref).max() / np.abs(ref).max() <= 1e-4


def test_dryrun_two_ranks_share_the_card(cuda):
    """The dry run of scripts/graft_entry.py with every rank on the one
    card; with its default placement (a CUDA device a rank) it raises when
    the devices are too few."""
    from coulomb_oscillators_tpu_torch.scripts import graft_entry
    graft_entry.dryrun_multichip(2, **SHARED)
    k = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"only {k} devices visible"):
        graft_entry.dryrun_multichip(k + 1)


@pytest.mark.parametrize("ndev,kw", [(2, SHARED), (1, {})],
                         ids=["2_shared_gloo", "1_nccl"])
def test_mesh_simulator_graphs_against_eager(cuda, ndev, kw):
    """The mesh-mode Simulator over 3 windows of 3 steps (a priming
    refresh, an adopted background rebuild), twice eagerly and once with
    graphs from one start: graphs within max(2 x eager against eager,
    1e-6) of max|pos|; every rank captured, as often as the others, with
    one segment more than the collectives of a step; P2P launches == force
    evaluations on every rank in both modes."""
    pos, vel = ID.init_gaussian(N, X_STD, X_STD)
    kw_cfg = dict(CFG, tree_steps=3, tree_async=True)
    runs = PM.spawn(W.mesh_graph_modes, ndev, kw_cfg, pos, vel, 3,
                    [(False, None), (False, None), (True, None)], **kw)
    evals = 1 + 3 * 3
    for r in runs:
        assert r["states_equal"]
        assert r["rebuilds"] == {"sync_refresh": 1, "adopt_full": 1}
        assert [row[2] for row in r["per_rank"]] == [evals] * ndev
    graphs = runs[2]["per_rank"]
    assert all(row[0] >= 1 and row[0] == graphs[0][0] for row in graphs)
    # all_gather, all_reduce_sum, a ring_shift a halo hop: 2 segments more
    assert all(row[1] >= 3 for row in graphs)
    assert all(row[:2] == [0, 0] for r in runs[:2] for row in r["per_rank"])
    ref = runs[0]["pos"]
    ee = np.abs(runs[1]["pos"] - ref).max() / np.abs(ref).max()
    ge = np.abs(runs[2]["pos"] - ref).max() / np.abs(ref).max()
    assert ge <= max(2 * ee, 1e-6), (ge, ee)


def test_mesh_recapture_when_one_rank_grows(cuda):
    """Two ranks sharing the card; rank 0 alone raises its near-field
    degree capacity after the first window, so the next adoption widens
    its col2d and changes its capture key only: both ranks capture again
    (as often as each other, once more than without the growth), and the
    run stays within 1e-5 of max|pos| of the eager run with the same
    growth."""
    pos, vel = ID.init_gaussian(N, X_STD, X_STD, seed=1)
    kw_cfg = dict(CFG, tree_steps=3, tree_async=True)
    runs = PM.spawn(W.mesh_graph_modes, 2, kw_cfg, pos, vel, 3,
                    [(True, None), (True, 0), (False, 0)], **SHARED)
    plain, grown, eager = (r["per_rank"] for r in runs)
    # rank 0's col2d only
    assert grown[0][3] == plain[0][3] + 128 and grown[1][3] == plain[1][3]
    assert plain[0][0] == plain[1][0] and grown[0][0] == grown[1][0]
    assert grown[0][0] == plain[0][0] + 1
    assert all(row[2] == 10 for row in grown + eager)
    ref = runs[2]["pos"]
    assert np.abs(runs[1]["pos"] - ref).max() / np.abs(ref).max() <= 1e-5
