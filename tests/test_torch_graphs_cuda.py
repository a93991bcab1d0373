"""The Simulator's CUDA graphs (utils/graphs.py) against its eager steps,
on the card.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX (the GPU machine has none), so it runs there on its own,
without the repository's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py -q

Small versions of chip_smoke.py's phase 16: the direct engine bitwise equal
with and without graphs; the kd window within max(2 x eager against eager,
1e-6) of max|pos| across an adopted re-sort; a uniform-grid engine within
1e-5; a re-capture when the list capacity grows; the kernels' launch
counters advancing with every replay; a capture that fails raising.
"""

import numpy as np
import pytest
import torch

from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.ops import direct as D
from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
from coulomb_oscillators_tpu_torch.simulate import Simulator
from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
from coulomb_oscillators_tpu_torch.utils.graphs import StepGraph

pytestmark = pytest.mark.cuda

X_STD = (0.003, 0.001, 0.01)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


def _beam(n, cfg, seed=0):
    u = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
    return ID.init_gaussian(n, X_STD, u, seed=seed)


def _run(monkeypatch, graphs, cfg, n, engine, steps, pos, vel, dev,
         between=None):
    """init_acc + `steps` steps (in runs of tree_steps, `between(sim)`
    called after the first run); returns (positions, the simulator)."""
    monkeypatch.setenv("CO_CUDA_GRAPHS", "1" if graphs else "0")
    sim = Simulator(cfg, n, engine=engine)
    try:
        st = sim.init_acc(particle_state_from_numpy(pos, vel, device=dev))
        ts = max(cfg.tree_steps, 1)
        for i in range(0, steps, ts):
            st = sim.run(st, min(ts, steps - i))
            if i == 0 and between is not None:
                between(sim)
        torch.cuda.synchronize()
    finally:
        sim.close()
    return st.pos, sim


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_direct_bitwise_equal_and_counted(cuda, monkeypatch):
    """Simulator("direct"), 60 leapfrog steps in runs of 20: the same
    positions bit for bit with and without graphs (the kernel's split
    sums are deterministic); one capture; the direct kernel's launches
    equal the force evaluations in both modes."""
    n = 4096
    cfg = SimConfig(tree_steps=20)
    pos, vel = _beam(n, cfg)
    outs = []
    for graphs in (True, False):
        D.launches = 0
        p, sim = _run(monkeypatch, graphs, cfg, n, "direct", 60, pos, vel,
                      cuda)
        assert D.launches == 1 + 60, (graphs, D.launches)
        assert (sim.graph is not None) == graphs
        if graphs:
            assert sim.graph.captures == 1 and sim.graph.replays == 60
        outs.append(p)
    assert torch.equal(outs[0], outs[1])


def test_kd_window_across_adopted_resort(cuda, monkeypatch):
    """fmm3_kd at N=50k, windows of 4 steps, 3 windows: the default
    pipeline primes with a refresh and adopts a background re-sort with
    its repad.  Graph against eager within max(2 x eager against eager,
    1e-6) of max|pos|; P2P launches == force evaluations."""
    n = 50_000
    cfg = SimConfig(fmm_order=4, tree_radius=1.67, tree_steps=4)
    pos, vel = _beam(n, cfg)
    runs = []
    for graphs in (False, False, True):
        p2p_cuda.launches = 0
        p, sim = _run(monkeypatch, graphs, cfg, n, "fmm3_kd", 12, pos, vel,
                      cuda)
        assert p2p_cuda.launches == 1 + 12, (graphs, p2p_cuda.launches)
        assert sim.rebuilds["adopt_full"] == 1, dict(sim.rebuilds)
        assert bool(torch.isfinite(p).all())
        runs.append(p)
    ee = _rel(runs[1], runs[0])
    ge = _rel(runs[2], runs[0])
    assert ge <= max(2 * ee, 1e-6), (ge, ee)


def test_recapture_on_grown_capacity(cuda, monkeypatch):
    """A P2P list capacity that grows at an adoption changes the frozen
    tree's shapes: the graph is captured again, the launches still equal
    the force evaluations, and the run stays within 1e-5 of the eager run
    with the same capacities."""
    n = 50_000
    cfg = SimConfig(fmm_order=4, tree_radius=1.67, tree_steps=4)
    pos, vel = _beam(n, cfg, seed=1)

    def grow(sim):
        sim._fmm.caps["p2p"] *= 2

    outs = []
    for graphs in (True, False):
        p2p_cuda.launches = 0
        p, sim = _run(monkeypatch, graphs, cfg, n, "fmm3_kd", 12, pos, vel,
                      cuda, between=grow)
        assert p2p_cuda.launches == 1 + 12
        if graphs:
            assert sim.graph.captures == 2, sim.graph.captures
            assert sim.graph.capture_seconds > 0
        outs.append(p)
    assert _rel(outs[0], outs[1]) <= 1e-5


def test_grid_engine_graph_vs_eager(cuda, monkeypatch):
    """fmm3_traceless at N=100k on a uniform box, 2 windows of 4 steps:
    graph against eager within 1e-5 of max|pos|."""
    n = 100_000
    cfg = SimConfig(fmm_order=3, tree_steps=4)
    pos = np.random.default_rng(2).uniform(-0.01, 0.01,
                                           (n, 3)).astype(np.float32)
    vel = np.zeros_like(pos)
    outs = [_run(monkeypatch, g, cfg, n, "fmm3_traceless", 8, pos, vel,
                 cuda)[0] for g in (True, False)]
    assert _rel(outs[0], outs[1]) <= 1e-5


def test_capture_failure_raises(cuda):
    """A step that reads a device value on the host cannot be captured:
    the run raises, and nothing runs it eagerly instead."""
    x = torch.ones(8, 3, device=cuda)

    def body(state, frozen):
        s = float(state[0].sum())
        return tuple(t + s for t in state)

    g = StepGraph(body)
    with pytest.raises(RuntimeError):
        g.run((x, x.clone(), x.clone()), (), 2)
    assert g.captures == 0
    torch.cuda.synchronize()
