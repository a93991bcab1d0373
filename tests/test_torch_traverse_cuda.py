"""The kd engine's traversal on the card (csrc/traverse.cu through
ops/fmm/traverse.py) against the native host traversal.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX (the GPU machine has none), so it runs there on its own,
without the repository's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_traverse_cuda.py -q

The card's lists against ``native.traverse_fine`` on the benchmark's 1M
beam (its auto stale margin at 16/2/2), the CLI's 30001, and fmm2_kd's 2D
beam at 1M and 30001 (the kernel's dim-2 path): ``near``
element for element, ``m2l`` after a (target, source) sort.  A 16/2/2
Simulator at N = 100k runs every traversal on the card and none on the
host.  The same tree with card lists and with native lists: the P2P pass
bitwise equal (the near lists are equal), the force within float32
reordering of the M2L sums (the M2L entries of a target come in another
order).
"""

import numpy as np
import pytest
import torch

from benchmark import beam as bench_beam
from coulomb_oscillators_tpu_torch import SimConfig, native
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.ops.fmm import kdtree, traverse
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
from coulomb_oscillators_tpu_torch.simulate import (Simulator,
                                                    auto_stale_margin)
from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

X_STD = (0.003, 0.001, 0.01)
# the benchmark's configurations (benchmark/configs, benchmark/workloads)
BEAM_1M = dict(fmm_order=6, tree_radius=1.67, mac_sub_boost=1.5,
               tree_steps=16, tree_resort_every=2, tree_pipeline=2)
CLI_30K = dict(tree_steps=8, tree_resort_every=1, tree_pipeline=1)
# fmm2_kd at ladder row 2's order and radius: the kernel's dim-2 path
KD2 = dict(dim=2, omega0=(1.095, 1.0), fmm_order=4, tree_radius=2.0)
# float32 reordering of the M2L sums: the card's and the native lists
# hold the same entries, each target's in another order
FORCE_REORDER_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the traversal kernel has no CPU "
                    "mode)")
    return torch.device("cuda", 0)


def _engine(n, kw, seed=7):
    """An engine with the Simulator's auto stale margin, and the host
    tree's (center, lb, rb) of the benchmark's beam."""
    cfg = SimConfig(**kw)
    x_std = X_STD[:cfg.dim]
    u = tuple(w * x for w, x in zip(cfg.omega0, x_std))
    pos, vel = bench_beam.gaussian(n, x_std, u, seed)
    eng = KdFmmEngine(cfg, n)
    eng.stale_margin_abs = auto_stale_margin(vel, cfg)
    perm = native.kdtree_build(pos, eng.L)
    c, lb, rb, _ = native.node_geometry(pos[perm], eng.L)
    return eng, c, lb, rb


def _sorted(m2l):
    return m2l[np.lexsort((m2l[:, 1], m2l[:, 0]))]


@pytest.mark.parametrize("n,kw", [(1_000_000, BEAM_1M), (30001, CLI_30K),
                                  (1_000_000, KD2), (30001, KD2)],
                         ids=["beam_1m", "cli_30001", "kd2_1m", "kd2_30001"])
def test_card_lists_equal_native(cuda, n, kw):
    eng, c, lb, rb = _engine(n, kw)
    nat0, dev0 = kdtree.native_traversals, kdtree.device_traversals
    m2l_n, near_n = eng._traverse(c, lb, rb)
    launches, reruns = traverse.launches, traverse.reruns
    m2l_c, near_c = eng._traverse(c, lb, rb, cuda)
    assert kdtree.native_traversals == nat0 + 1
    assert kdtree.device_traversals == dev0 + 1
    # one launch a level, at most 2L + 1 levels a run
    runs = 1 + traverse.reruns - reruns
    assert runs <= traverse.launches - launches <= runs * (2 * eng.L + 1)
    assert m2l_c.dtype == np.int64 and near_c.dtype == np.int64
    assert near_c.shape[0] > 0 and np.array_equal(near_c, near_n)
    assert m2l_c.shape[0] > 0 and np.array_equal(m2l_c, _sorted(m2l_n))
    # a second traversal reuses the sizes the first one found: no rerun
    reruns = traverse.reruns
    m2l_2, near_2 = eng._traverse(c, lb, rb, cuda)
    assert traverse.reruns == reruns
    assert np.array_equal(m2l_2, m2l_c) and np.array_equal(near_2, near_c)


def test_simulator_traverses_on_the_card_only(cuda, monkeypatch):
    """16/2/2 at N = 100k: every traversal the Simulator runs (the
    set-up's build, the priming refresh, the background re-sorts) runs on
    the card."""
    n = 100_000
    cfg = SimConfig(**BEAM_1M)
    u = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
    pos, vel = ID.init_gaussian(n, X_STD, u)
    calls = []
    real = KdFmmEngine._traverse

    def spy(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(KdFmmEngine, "_traverse", spy)
    nat0, dev0 = kdtree.native_traversals, kdtree.device_traversals
    sim = Simulator(cfg, n, engine="fmm3_kd")
    try:
        sim.init_acc(particle_state_from_numpy(pos, vel, device=cuda))
        sim.advance_padded(16 * 6)
        torch.cuda.synchronize()
    finally:
        sim.close()
    assert sim.rebuilds["adopt_full"] >= 2
    assert sim.rebuilds["sync_refresh"] == 1
    assert len(calls) >= 4
    assert kdtree.device_traversals - dev0 == len(calls)
    assert kdtree.native_traversals == nat0


def test_force_with_card_lists(cuda):
    """One tree at N = 100k with card and with native lists: P2P bitwise
    equal, the force within FORCE_REORDER_TOL of its largest value."""
    n = 100_000
    cfg = SimConfig(**BEAM_1M)
    u = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
    pos, vel = ID.init_gaussian(n, X_STD, u)
    pos_d = torch.from_numpy(pos).to(cuda)
    eng = KdFmmEngine(cfg, n)
    eng.stale_margin_abs = auto_stale_margin(vel, cfg)
    fs_card = eng.adopt(eng.build_host(pos_d, cuda), cuda)
    fs_host = eng.adopt(eng.build_host(pos_d, "cpu"), cuda)
    assert torch.equal(fs_card.perm, fs_host.perm)
    assert torch.equal(fs_card.p2p_col2d, fs_host.p2p_col2d)
    ppad = eng.pad_array(pos_d, fs_card, fill=FAR)
    assert torch.equal(eng._stage_p2p(ppad, fs_card),
                       eng._stage_p2p(ppad, fs_host))
    a = eng.force_padded(ppad, fs_card)
    b = eng.force_padded(ppad, fs_host)
    mask = eng.mask3(cuda)
    err = float((a - b)[mask].abs().max() / b[mask].abs().max())
    assert err <= FORCE_REORDER_TOL, err
