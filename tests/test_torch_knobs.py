"""Port vs reference: constructor defaults and the tuning knobs.

`Simulator.__init__` has the reference's parameters and defaults, and
`KdFmmEngine.__init__` has them for the parameters the port keeps.  Under
each of the reference's environment knobs (`CO_SUB_BOOST`, `CO_M2L_GROUP`,
`CO_STALE_MARGIN`, `CO_STALE_MARGIN_FACTOR`) and under the constructor's
`L=` and `leaf_target=`, both engines built from the same numpy positions
resolve the same boost, group, margin and level and build the same integer
pair lists; the force agrees to the 1e-5 of max|a| that
tests/test_torch_kdtree.py uses (float32 summation order).

The reference engine is built with ``use_pallas=True`` (the port's one
layout); that build runs on the CPU and never calls its Pallas kernel.
"""

import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu import native as jnative
from coulomb_oscillators_tpu import simulate as jsim
from coulomb_oscillators_tpu.models import init_dist as ID
from coulomb_oscillators_tpu.ops.fmm.kdtree import KdFmmEngine as JEngine
from coulomb_oscillators_tpu_torch import SimConfig as TConfig
from coulomb_oscillators_tpu_torch import native as tnative
from coulomb_oscillators_tpu_torch import simulate as tsim
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (
    FmmState, KdFmmEngine, fmm_state_from_numpy)

torch.set_num_threads(1)

X_STD = (0.003, 0.001, 0.01)
N = 2048
KNOBS = ("CO_SUB_BOOST", "CO_M2L_GROUP", "CO_STALE_MARGIN",
         "CO_STALE_MARGIN_FACTOR", "CO_SORT_MODE", "CO_CUDA_GRAPHS",
         "CO_M2L_FLY")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def beam():
    u = tuple(w * x for w, x in zip(JConfig().omega0, X_STD))
    return ID.init_gaussian(N, X_STD, u)


def _params(fn):
    return {k: v.default for k, v in inspect.signature(fn).parameters.items()
            if k != "self"}


def test_simulator_init_signatures_equal():
    assert _params(tsim.Simulator.__init__) == \
        _params(jsim.Simulator.__init__)
    assert _params(tsim.Simulator.__init__)["engine"] == "direct"


def test_parallel_modules_have_the_references_public_names():
    """Every public function and class the reference's three parallel
    modules define exists in the port's (the mesh itself is the port's
    ``Mesh``, the reference's comes from JAX)."""
    import importlib
    for mod in ("mesh", "fmm_shard", "fmm_pshard"):
        j = importlib.import_module(f"coulomb_oscillators_tpu.parallel.{mod}")
        t = importlib.import_module(
            f"coulomb_oscillators_tpu_torch.parallel.{mod}")
        names = [k for k, v in vars(j).items() if not k.startswith("_")
                 and getattr(v, "__module__", None) == j.__name__]
        assert names, mod
        missing = [k for k in names if not callable(getattr(t, k, None))]
        assert not missing, (mod, missing)
        for k in names:
            if inspect.isfunction(getattr(j, k)):
                jp = list(inspect.signature(getattr(j, k)).parameters)
                tp = list(inspect.signature(getattr(t, k)).parameters)
                assert tp[:len(jp)] == jp, (mod, k, jp, tp)
    from coulomb_oscillators_tpu.parallel import fmm_pshard as jps
    from coulomb_oscillators_tpu_torch.parallel import fmm_pshard as tps
    assert tps.PShardLists._fields == jps.PShardLists._fields


def test_default_engine_is_direct_in_both():
    """Simulator(config, n) runs the plain direct engine in both packages
    (no FMM engine object is made)."""
    assert jsim.Simulator(JConfig(), 64)._fmm is None
    t = tsim.Simulator(TConfig(), 64)
    assert t._fmm is None and t.engine_name == "direct"


def test_kd_engine_init_signature_is_the_references_subset():
    """The port drops the TPU knobs use_pallas, m2l_chunk and p2p_chunk;
    every parameter it keeps has the reference's default, in the
    reference's order."""
    j, t = _params(JEngine.__init__), _params(KdFmmEngine.__init__)
    assert set(j) - set(t) == {"use_pallas", "m2l_chunk", "p2p_chunk"}
    assert set(t) <= set(j)
    assert t == {k: j[k] for k in t}
    assert list(t) == [k for k in j if k in t]


def _np_state(fs):
    return {f: np.asarray(getattr(fs, f)) for f in fs._fields}


def _both(pos, cfg, margin=0.0, **kw):
    """Both engines on `pos`: the resolved knobs, the raw traversal lists
    and the built states."""
    jeng = JEngine(JConfig(**cfg), N, use_pallas=True, **kw)
    teng = KdFmmEngine(TConfig(**cfg), N, **kw)
    jeng.stale_margin_abs = teng.stale_margin_abs = margin
    jfs = jeng.build(jnp.asarray(pos))
    tfs = teng.build(torch.from_numpy(pos))
    return jeng, jfs, teng, tfs


def _assert_same(jeng, jfs, teng, tfs, pos):
    for a in ("L", "sub_depth", "mac_sub_boost", "m2l_group",
              "mac_mult_floor", "C_blk"):
        assert getattr(teng, a) == getattr(jeng, a), a
    assert teng.last_counts == jeng.last_counts
    assert teng.caps == jeng.caps
    j = _np_state(jfs)
    for f in FmmState._fields:
        if f not in ("center", "lam"):
            assert np.array_equal(getattr(tfs, f).numpy(), j[f]), f
    # the raw traversal output on the same node geometry
    perm = jnative.kdtree_build(pos, jeng.L)
    c, lb, rb, _ = jnative.node_geometry(pos[perm], jeng.L)
    jm2l, jp2p = jeng._traverse(c, lb, rb)
    perm_t = tnative.kdtree_build(pos, teng.L)
    assert np.array_equal(perm, perm_t)
    tm2l, tp2p = teng._traverse(c, lb, rb)
    assert np.array_equal(jm2l, tm2l) and np.array_equal(jp2p, tp2p)
    # the force: the reference's CPU near field (its jnp scan branch on
    # the same layout) against the port fed the reference's lists;
    # float32 summation order only
    jeng.use_pallas = False
    try:
        ref = np.asarray(jeng.force(jnp.asarray(pos), jfs))
    finally:
        jeng.use_pallas = True
    got = teng.force(torch.from_numpy(pos),
                     fmm_state_from_numpy(j, "cpu")).numpy()
    dev = np.abs(got - ref).max() / np.abs(ref).max()
    assert dev <= 1e-5, dev


CFG = dict(fmm_order=3, tree_radius=2.0)


@pytest.mark.parametrize("value,want", [("1.2", 1.2), ("2.0", 2.0)])
def test_co_sub_boost(monkeypatch, beam, value, want):
    monkeypatch.setenv("CO_SUB_BOOST", value)
    out = _both(beam[0], CFG)
    assert out[2].mac_sub_boost == want
    _assert_same(*out, beam[0])


def test_co_sub_boost_precedence(monkeypatch):
    """explicit config > env > accuracy-grade auto > 1.5, as the
    reference resolves it."""
    monkeypatch.setenv("CO_SUB_BOOST", "1.2")
    for cfg in (dict(mac_sub_boost=1.7), dict(accuracy=1e-6), dict()):
        t = KdFmmEngine(TConfig(**cfg), N).mac_sub_boost
        assert t == JEngine(JConfig(**cfg), N).mac_sub_boost
    assert KdFmmEngine(TConfig(mac_sub_boost=1.7), N).mac_sub_boost == 1.7
    assert KdFmmEngine(TConfig(accuracy=1e-6), N).mac_sub_boost == 1.2
    monkeypatch.delenv("CO_SUB_BOOST")
    assert KdFmmEngine(TConfig(accuracy=1e-6), N).mac_sub_boost == 2.0
    assert KdFmmEngine(TConfig(), N).mac_sub_boost == 1.5
    # read in __init__: a later change does not move a built engine
    eng = KdFmmEngine(TConfig(), N)
    monkeypatch.setenv("CO_SUB_BOOST", "1.1")
    assert eng.mac_sub_boost == 1.5


@pytest.mark.parametrize("value", [None, "1", "0", "", "no"])
def test_co_m2l_fly_is_read_at_init_as_the_reference_reads_it(monkeypatch,
                                                               value):
    """CO_M2L_FLY: "0" alone selects the stored fold, anything else (or
    unset) fly mode, as in the reference; read in __init__, so a later
    change does not move a built engine."""
    if value is not None:
        monkeypatch.setenv("CO_M2L_FLY", value)
    t = KdFmmEngine(TConfig(**CFG), N)
    assert t.m2l_fly is JEngine(JConfig(**CFG), N).m2l_fly is (value != "0")
    monkeypatch.setenv("CO_M2L_FLY", "1" if value == "0" else "0")
    assert t.m2l_fly is (value != "0")


def test_state_fields_are_the_references():
    """FmmState carries the reference's fields in its order, the stored
    fold's three included."""
    from coulomb_oscillators_tpu.ops.fmm.kdtree import FmmState as JState
    assert FmmState._fields == JState._fields


@pytest.mark.parametrize("g", [1, 4, 16])
def test_co_m2l_group(monkeypatch, beam, g):
    monkeypatch.setenv("CO_M2L_GROUP", str(g))
    out = _both(beam[0], CFG)
    assert out[2].m2l_group == g
    # grouped lists carry one target per group; ungrouped ones (g = 1)
    # the reference's one-element placeholder
    assert out[3].m2l_gtgt.shape[0] == (
        out[3].m2l_tgt.shape[0] // g if g > 1 else 1)
    _assert_same(*out, beam[0])


def test_co_stale_margin_overrides_at_traversal_time(monkeypatch, beam):
    """The env margin beats `stale_margin_abs`, and is read per traversal:
    the same engine builds wider lists once it is set and the old ones
    again once it is gone."""
    pos = beam[0]
    base = _both(pos, CFG, margin=1e-5)
    n0 = dict(base[2].last_counts)
    monkeypatch.setenv("CO_STALE_MARGIN", "3e-4")
    jeng, _, teng, _ = base
    jfs = jeng.build(jnp.asarray(pos))
    tfs = teng.build(torch.from_numpy(pos))
    assert teng.last_counts["p2p"] > n0["p2p"]
    _assert_same(jeng, jfs, teng, tfs, pos)
    # an engine whose own margin is the env's builds the same lists
    monkeypatch.delenv("CO_STALE_MARGIN")
    wide = dict(teng.last_counts)
    teng.build(torch.from_numpy(pos))
    assert teng.last_counts == n0
    teng.stale_margin_abs = 3e-4
    teng.build(torch.from_numpy(pos))
    assert teng.last_counts == wide
    # "0" is a margin too (it switches an engine's own margin off)
    monkeypatch.setenv("CO_STALE_MARGIN", "0")
    jeng.stale_margin_abs = 3e-4
    jfs = jeng.build(jnp.asarray(pos))
    tfs = teng.build(torch.from_numpy(pos))
    _assert_same(jeng, jfs, teng, tfs, pos)
    assert teng.last_counts["p2p"] < wide["p2p"]


@pytest.mark.parametrize("factor", [None, "1.0", "3.5"])
@pytest.mark.parametrize("cadence", [
    dict(tree_steps=16, tree_resort_every=2, tree_pipeline=2),
    dict(tree_steps=8, tree_resort_every=1, tree_pipeline=1),
    dict(tree_steps=8, tree_async=False), dict(tree_steps=1)],
    ids=["tuned", "default", "sync", "every_step"])
def test_co_stale_margin_factor(monkeypatch, beam, factor, cadence):
    """auto_stale_margin reads the factor at each call."""
    vel = beam[1]
    if factor is not None:
        monkeypatch.setenv("CO_STALE_MARGIN_FACTOR", factor)
    ref = jsim.auto_stale_margin(vel, JConfig(**cadence))
    for v in (vel, torch.from_numpy(vel)):
        got = tsim.auto_stale_margin(v, TConfig(**cadence))
        np.testing.assert_allclose(got, ref, rtol=1e-12)
    if factor is not None and cadence["tree_steps"] > 1:
        monkeypatch.delenv("CO_STALE_MARGIN_FACTOR")
        two = tsim.auto_stale_margin(vel, TConfig(**cadence))
        np.testing.assert_allclose(got, two * float(factor) / 2.0,
                                   rtol=1e-12)


def test_simulator_auto_margin_follows_the_factor(monkeypatch, beam):
    """The Simulator's resolved margin and first lists equal the
    reference's under a factor."""
    monkeypatch.setenv("CO_STALE_MARGIN_FACTOR", "4.0")
    from coulomb_oscillators_tpu.state import ParticleState as JState
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
    pos, vel = beam
    cfg = dict(CFG, tree_steps=8)
    js = jsim.Simulator(JConfig(**cfg), N, engine="fmm3_kd")
    js.init_acc(JState(jnp.asarray(pos), jnp.asarray(vel),
                       jnp.zeros_like(jnp.asarray(pos))))
    ts = tsim.Simulator(TConfig(**cfg), N, engine="fmm3_kd")
    ts.init_acc(particle_state_from_numpy(pos, vel, device="cpu"))
    ts.close()
    np.testing.assert_allclose(ts._fmm.stale_margin_abs,
                               js._fmm.stale_margin_abs, rtol=1e-6)
    assert ts._fmm.last_counts == js._fmm.last_counts


@pytest.mark.parametrize("kw", [dict(L=5), dict(L=7), dict(L=8),
                                dict(leaf_target=16), dict(leaf_target=64),
                                dict(L=6, leaf_target=64)],
                         ids=lambda kw: "-".join(f"{k}{v}"
                                                 for k, v in kw.items()))
def test_forced_level_and_leaf_target(beam, kw):
    """`L=` forces the level (a coarser tree than the auto level falls
    back to the leaf-granularity MAC, sub_depth 0); `leaf_target=` moves
    the auto level."""
    out = _both(beam[0], CFG, **kw)
    if "L" in kw:
        assert out[2].L == kw["L"]
    _assert_same(*out, beam[0])


@pytest.mark.parametrize("engine", ["direct", "fmm3_kd"])
def test_co_cuda_graphs_read_at_construction(monkeypatch, beam, engine):
    """``CO_CUDA_GRAPHS`` is read when the Simulator is built (0 turns the
    card's graphs off, anything else or unset leaves them on) and not
    after; CPU runs are eager either way and give the same positions."""
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
    pos, vel = beam
    cfg = TConfig(fmm_order=3, tree_radius=2.0, tree_steps=3)
    outs = []
    for knob, want in ((None, True), ("0", False), ("1", True)):
        if knob is None:
            monkeypatch.delenv("CO_CUDA_GRAPHS", raising=False)
        else:
            monkeypatch.setenv("CO_CUDA_GRAPHS", knob)
        sim = tsim.Simulator(cfg, N, engine=engine)
        monkeypatch.setenv("CO_CUDA_GRAPHS", "1" if knob == "0" else "0")
        try:
            assert sim.use_graphs is want
            st = sim.init_acc(particle_state_from_numpy(pos, vel,
                                                        device="cpu"))
            outs.append(sim.run(st, 4).pos)
            assert sim.use_graphs is want
            assert sim.graph is None           # the CPU has no graphs
        finally:
            sim.close()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])

