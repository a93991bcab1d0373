"""The kd engine's M2L kernel on the card (csrc/m2l.cu through
ops/fmm/m2l_cuda.py) against its plain version, ``KdFmmEngine.m2l_plain``.

Every test here needs a CUDA device and skips without one.  This file
imports no JAX (the GPU machine has none), so it runs there on its own,
without the repository's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_m2l_cuda.py -q

The kernel's stage against the plain loop on the same card state, for
(dim, p) = (3, 6), (3, 3), (2, 4), group sizes 1 and 8, fly and stored
mode, float32 and float64: max|dev| / max|ref| <= 1e-5 in float32 and
1e-12 in float64 (the sums run in another order, and the kernel adds with
float atomics).  The lists carry pad entries (each target's run padded to
the group size, the tail up to the capacity); a cut list ends in a
partial tile and a partly padded group; every list is shorter than one
chunk of the plain loop.  A Simulator's step graph against its eager
steps, with one launch a force evaluation and a replay; a p = 7 engine
(the dense forms) on the plain path; and the benchmark's 1M production
state (``kd3_beam_1m`` at 16/2/2, its auto stale margin) once.
"""

import numpy as np
import pytest
import torch

from benchmark import beam as bench_beam
from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.ops.fmm import m2l_cuda
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (FAR,
                                                         M2L_LOOP_CHUNK,
                                                         KdFmmEngine)
from coulomb_oscillators_tpu_torch.simulate import (Simulator,
                                                    auto_stale_margin)
from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

X_STD = (0.003, 0.001, 0.01)
TOL = {"float32": 1e-5, "float64": 1e-12}
# the benchmark's production configuration and cadence (benchmark/configs/
# kd3_beam_1m.json, benchmark/workloads/kd3_beam_1m.tuned.json)
BEAM_1M = dict(fmm_order=6, tree_radius=1.67, mac_sub_boost=1.5,
               tree_steps=16, tree_resort_every=2, tree_pipeline=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the M2L kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _state(monkeypatch, dev, dim, p, precision="float32", g=8, fly=True,
           n=30001, kw=None, margin=False):
    """(engine, state, multipole heap) of a Gaussian beam on the card,
    with the group size and fold mode set before the engine is made."""
    monkeypatch.setenv("CO_M2L_GROUP", str(g))
    monkeypatch.setenv("CO_M2L_FLY", "1" if fly else "0")
    cfg = SimConfig(**{"dim": dim, "fmm_order": p, "tree_radius": 1.2,
                       "precision": precision,
                       **({"omega0": (1.095, 1.0)} if dim == 2 else {}),
                       **(kw or {})})
    x_std = X_STD[:dim]
    u = tuple(w * x for w, x in zip(cfg.omega0, x_std))
    pos, vel = bench_beam.gaussian(n, x_std, u, 7)
    eng = KdFmmEngine(cfg, n)
    if margin:
        eng.stale_margin_abs = auto_stale_margin(vel, cfg)
    post = torch.as_tensor(pos.astype(precision), device=dev)
    fs = eng.build(post)
    mh = eng._stage_multipoles(eng.pad_array(post, fs, fill=FAR), fs)
    return eng, fs, mh


def _cut(fs, g, fly):
    """The list cut short after a group that holds valid and pad entries
    (g = 1: after a pad entry), inside a tile of 32 entries; a stored fold
    is cut with it."""
    v = fs.m2l_valid.view(-1, g)
    mixed = (v.any(1) & ~v.all(1)) if g > 1 else ~v[:, 0]
    ends = (mixed.nonzero()[:, 0] + 1) * g
    ends = ends[ends % 32 != 0]
    k = int(ends.max() if g > 1 else ends.min())
    part = {f: getattr(fs, f)[:k].contiguous()
            for f in ("m2l_tgt", "m2l_src", "m2l_valid")
            + (() if fly else ("m2l_h2", "m2l_w", "m2l_logc"))}
    if g > 1:
        part["m2l_gtgt"] = fs.m2l_gtgt[:k // g].contiguous()
    return fs._replace(**part)


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("fly", [True, False], ids=["fly", "stored"])
@pytest.mark.parametrize("g", [8, 1])
@pytest.mark.parametrize("dim,p", [(3, 6), (3, 3), (2, 4)],
                         ids=["3d_p6", "3d_p3", "2d_p4"])
def test_kernel_matches_plain(cuda, monkeypatch, dim, p, g, fly, precision):
    eng, fs, mh = _state(monkeypatch, cuda, dim, p, precision, g, fly)
    K = fs.m2l_tgt.shape[0]
    assert K <= M2L_LOOP_CHUNK and K % 32 == 0
    assert 0 < int(fs.m2l_valid.sum()) < K               # pads present
    for cut in (False, True):
        f = _cut(fs, g, fly) if cut else fs
        if cut:
            assert f.m2l_tgt.shape[0] % 32 and not bool(f.m2l_valid[-1])
            assert bool(f.m2l_valid.any())
        before = m2l_cuda.launches
        got = eng._stage_m2l(mh, f)
        assert m2l_cuda.launches == before + 1
        ref = eng.m2l_plain(mh, f)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        err = _rel(got, ref)
        assert err <= TOL[precision], (cut, err)


def test_step_graph_replay_equals_eager(cuda, monkeypatch):
    """fmm3_kd at N = 50k, p = 6, windows of 4 steps, 3 windows (an adopted
    re-sort among them): graph against eager within max(2 x eager against
    eager, 1e-6) of max|pos|; one M2L launch a force evaluation, eager or
    replayed."""
    n = 50_000
    cfg = SimConfig(fmm_order=6, tree_radius=1.67, tree_steps=4)
    u = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
    pos, vel = ID.init_gaussian(n, X_STD, u, seed=0)
    runs = []
    for graphs in (False, False, True):
        monkeypatch.setenv("CO_CUDA_GRAPHS", "1" if graphs else "0")
        m2l_cuda.launches = 0
        sim = Simulator(cfg, n, engine="fmm3_kd")
        try:
            st = sim.init_acc(particle_state_from_numpy(pos, vel,
                                                        device=cuda))
            for _ in range(3):
                st = sim.run(st, 4)
            torch.cuda.synchronize()
            assert m2l_cuda.launches == 1 + 12, (graphs, m2l_cuda.launches)
            assert sim.rebuilds["adopt_full"] == 1, dict(sim.rebuilds)
            if graphs:
                assert sim.graph.replays == 12
            assert bool(torch.isfinite(st.pos).all())
            runs.append(st.pos)
        finally:
            sim.close()
    ee = _rel(runs[1], runs[0])
    ge = _rel(runs[2], runs[0])
    assert ge <= max(2 * ee, 1e-6), (ge, ee)


def test_dense_forms_stay_plain(cuda, monkeypatch):
    """p = 7 (the dense W-matrix forms) launches no kernel: its stage is
    the plain loop on the card."""
    eng, fs, mh = _state(monkeypatch, cuda, 3, 7, n=8192)
    before = m2l_cuda.launches
    got = eng._stage_m2l(mh, fs)
    assert m2l_cuda.launches == before
    assert got.device == cuda
    assert _rel(got, eng.m2l_plain(mh, fs)) <= 1e-6   # index_add_ order
    with pytest.raises(ValueError, match="p <= 6"):
        m2l_cuda.m2l(eng.tables, mh, fs.m2l_tgt, fs.m2l_src, fs.m2l_valid,
                     fs.m2l_gtgt, eng.m2l_group, center=fs.center,
                     lam=fs.lam)


def test_production_state_1m(cuda, monkeypatch):
    """The benchmark's 1M beam at its production settings (p = 6, r =
    1.67, boost 1.5, the 16/2/2 auto stale margin, g = 8, fly): the
    kernel within 1e-5 of the plain loop."""
    monkeypatch.delenv("CO_M2L_GROUP", raising=False)
    monkeypatch.delenv("CO_M2L_FLY", raising=False)
    eng, fs, mh = _state(monkeypatch, cuda, 3, 6, n=1_000_000,
                         kw={k: v for k, v in BEAM_1M.items()
                             if k not in ("fmm_order",)}, margin=True)
    assert eng.m2l_fly and eng.m2l_group == 8
    got = eng._stage_m2l(mh, fs)
    ref = eng.m2l_plain(mh, fs)
    assert _rel(got, ref) <= 1e-5
    assert int(fs.m2l_valid.sum()) > 2_000_000


def test_wrapper_checks_on_the_card(cuda, monkeypatch):
    """A non-contiguous list or a float64 center beside float32
    multipoles raises before any launch."""
    eng, fs, mh = _state(monkeypatch, cuda, 3, 3, n=8192)
    args = (eng.tables, mh, fs.m2l_tgt, fs.m2l_src, fs.m2l_valid,
            fs.m2l_gtgt, eng.m2l_group)
    before = m2l_cuda.launches
    with pytest.raises(ValueError, match="contiguous"):
        m2l_cuda.m2l(*args[:1], mh.t().contiguous().t(), *args[2:],
                     center=fs.center, lam=fs.lam)
    with pytest.raises(ValueError, match="center"):
        m2l_cuda.m2l(*args, center=fs.center.double(), lam=fs.lam)
    assert m2l_cuda.launches == before
    assert np.isfinite(m2l_cuda.m2l(*args, center=fs.center,
                                    lam=fs.lam).cpu().numpy()).all()
