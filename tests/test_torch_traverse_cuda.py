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
order).  A Simulator at 16/2/2 and at 8/1/1 lays every list out on the
card, from lists that never leave it, into states equal to the host's
layout of the native lists of the same positions.
"""

import copy

import numpy as np
import pytest
import torch

from benchmark import beam as bench_beam
from coulomb_oscillators_tpu_torch import SimConfig, native
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.ops.fmm import kdtree, traverse
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (FAR, FmmState,
                                                         KdFmmEngine)
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


def _host(lists, cuda):
    """A card traversal's lists (int32 on the card, made on its side
    stream) as host int64 arrays."""
    assert all(x.device == cuda and x.dtype == torch.int32 for x in lists)
    torch.cuda.synchronize(cuda)
    return tuple(x.cpu().numpy().astype(np.int64) for x in lists)


@pytest.mark.parametrize("n,kw", [(1_000_000, BEAM_1M), (30001, CLI_30K),
                                  (1_000_000, KD2), (30001, KD2)],
                         ids=["beam_1m", "cli_30001", "kd2_1m", "kd2_30001"])
def test_card_lists_equal_native(cuda, n, kw):
    eng, c, lb, rb = _engine(n, kw)
    nat0, dev0 = kdtree.native_traversals, kdtree.device_traversals
    m2l_n, near_n = eng._traverse(c, lb, rb)
    launches, reruns = traverse.launches, traverse.reruns
    m2l_c, near_c = _host(eng._traverse(c, lb, rb, cuda), cuda)
    assert kdtree.native_traversals == nat0 + 1
    assert kdtree.device_traversals == dev0 + 1
    # one launch a level, at most 2L + 1 levels a run
    runs = 1 + traverse.reruns - reruns
    assert runs <= traverse.launches - launches <= runs * (2 * eng.L + 1)
    assert near_c.shape[0] > 0 and np.array_equal(near_c, near_n)
    assert m2l_c.shape[0] > 0 and np.array_equal(m2l_c, _sorted(m2l_n))
    # a second traversal reuses the sizes the first one found: no rerun
    reruns = traverse.reruns
    m2l_2, near_2 = _host(eng._traverse(c, lb, rb, cuda), cuda)
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
    fs_card = eng.build_host(pos_d, cuda)
    fs_host = FmmState(*(t.to(cuda) for t in eng.build_host(pos_d, "cpu")))
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


@pytest.mark.parametrize("cadence", [(16, 2, 2), (8, 1, 1)],
                         ids=["16-2-2", "8-1-1"])
def test_simulator_lays_out_lists_on_the_card(cuda, monkeypatch, cadence):
    """A Simulator at N = 100k with the 1M cell's order and radius, at the
    production cadence 16/2/2 and the upstream's 8/1/1: every list layout
    runs on the card (``device_layouts`` counts one a traversal, none on
    the host) from lists that never left it, with one wait for the device
    (the sizes' read-back) and no ``pin_memory()``; only perm, inv_perm,
    center and lam cross from the host.  Each full re-sort's state equals
    the state laid out on the host from the native traversal of the same
    positions (the M2L sources after a sort within each target's run);
    the near-list counters record what the states hold; and a window
    adopted while the main stream still holds the last window's replays
    computes the force an eager step computes on the same state."""
    from coulomb_oscillators_tpu_torch.utils import profiling as P
    ts, K, D = cadence
    n = 100_000
    cfg = SimConfig(**dict(BEAM_1M, tree_steps=ts, tree_resort_every=K,
                           tree_pipeline=D))
    u = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
    pos, vel = ID.init_gaussian(n, X_STD, u)
    active = [True]
    tls = __import__("threading").local()
    layouts, staged, pinned, waits = [], [], [], []
    real = {k: getattr(KdFmmEngine, k) for k in
            ("_lists_to_state", "build_host_padded", "_stage")}
    real_sync = torch.cuda.Event.synchronize

    def spy_bhp(self, ppad_h, inv_h, device):
        tls.src = (np.array(ppad_h), np.array(inv_h))
        return real["build_host_padded"](self, ppad_h, inv_h, device)

    def spy_l2s(self, perm, inv, c, lam, m2l, near, bt):
        if not active[0]:
            return real["_lists_to_state"](self, perm, inv, c, lam, m2l,
                                           near, bt)
        assert isinstance(m2l, torch.Tensor) and m2l.device == cuda
        assert isinstance(near, torch.Tensor) and near.device == cuda
        src, tls.src = getattr(tls, "src", None), None
        tls.waits, tls.staged = 0, []
        fs = real["_lists_to_state"](self, perm, inv, c, lam, m2l, near, bt)
        waits.append(tls.waits)
        staged.append(tls.staged)
        tls.waits = tls.staged = None
        layouts.append((fs, src, dict(self.caps), self.near_cap))
        return fs

    def spy_stage(self, arrays, device):
        if getattr(tls, "staged", None) is not None:
            tls.staged += [tuple(a.shape) for a in arrays
                           if not isinstance(a, torch.Tensor)]
        return real["_stage"](self, arrays, device)

    def spy_sync(ev):
        if getattr(tls, "waits", None) is not None:
            tls.waits += 1
        return real_sync(ev)

    monkeypatch.setattr(KdFmmEngine, "build_host_padded", spy_bhp)
    monkeypatch.setattr(KdFmmEngine, "_lists_to_state", spy_l2s)
    monkeypatch.setattr(KdFmmEngine, "_stage", spy_stage)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", spy_sync)
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda t, *a, **k: pinned.append(t.shape))
    # the counters record as under a profiler
    monkeypatch.setattr(P, "_tracing", 1)
    P.reset()
    dev0, host0 = kdtree.device_layouts, kdtree.host_layouts
    trav0 = kdtree.device_traversals
    sim = Simulator(cfg, n, engine="fmm3_kd")
    eng = sim._fmm
    checked, prev_checked = 0, False
    try:
        sim.init_acc(particle_state_from_numpy(pos, vel, device=cuda))
        sim.advance_padded(ts)
        for _ in range(8):
            before = sim.rebuilds["adopt_full"]
            sim.advance_padded(ts)
            if sim.rebuilds["adopt_full"] > before and not prev_checked:
                # the adoption came while the last window was queued
                a = sim._padded.acc
                b = sim._padded_force(sim._padded.pos, sim._fstate)
                mask = eng.mask3(cuda)
                err = float((a - b)[mask].abs().max() / b[mask].abs().max())
                assert err <= FORCE_REORDER_TOL, err
                checked += 1
                prev_checked = True
            else:
                prev_checked = False
        torch.cuda.synchronize()
    finally:
        sim.close()
    active[0] = False
    tot = P.totals()
    P.reset()
    assert checked >= 3
    assert sim.rebuilds["adopt_full"] >= 3
    nlay = kdtree.device_layouts - dev0
    assert nlay == len(layouts) == kdtree.device_traversals - trav0
    assert kdtree.host_layouts == host0
    assert waits == [1] * nlay
    assert pinned == []
    # the set-up's build and the full re-sorts stage all four; a refresh
    # keeps the permutation already on the card
    Mheap = (1 << (eng.L + 1)) - 1
    assert staged == [[(n,), (n,), (Mheap, 3), (Mheap,)]
                      if src is not None or i == 0 else [(Mheap, 3), (Mheap,)]
                      for i, (_, src, _, _) in enumerate(layouts)]
    rows = [fs.p2p_row_ptr.cpu().numpy() for fs, _, _, _ in layouts]
    assert tot["kd.lists.near_entries"]["count"] == sum(
        int(r[-1]) for r in rows)
    assert tot["kd.lists.near_rows"]["count"] == nlay * eng.G_sub
    assert tot["kd.lists.near_row_max"]["count"] == sum(
        int(np.diff(r).max()) for r in rows)
    full = [x for x in layouts if x[1] is not None]
    assert len(full) >= sim.rebuilds["adopt_full"]
    for fs, (ppad_h, inv_h), caps, near_cap in full:
        host = copy.copy(eng)
        host.caps, host.near_cap, host._card = dict(caps), near_cap, None
        ref = host.build_host_padded(ppad_h, inv_h, "cpu")
        assert host.caps == caps
        for f in ("perm", "inv_perm", "m2l_tgt", "m2l_valid", "m2l_gtgt",
                  "p2p_tgt", "p2p_src", "p2p_valid", "p2p_row_ptr",
                  "p2p_col2d"):
            assert torch.equal(getattr(fs, f).cpu(), getattr(ref, f)), f
        # the card's entries of a target come sorted by source, in the
        # same slots
        v = ref.m2l_valid.numpy()
        t, s = ref.m2l_tgt.numpy()[v], ref.m2l_src.numpy()[v]
        got = fs.m2l_src.cpu().numpy()
        assert np.array_equal(got[v], s[np.lexsort((s, t))])
        assert not got[~v].any()
