"""Port vs reference: the uniform-grid octree/quadtree FMM engines and the
Appel monopole engine — twins of tests/test_octree.py, the static grid
maps, the binned state (integer fields bit-equal), and the force on the
reference's own state."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu.ops.fmm import appel as japp
from coulomb_oscillators_tpu.ops.fmm import octree as joct
from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.ops import direct as D
from coulomb_oscillators_tpu_torch.ops.fmm import make_engine_object
from coulomb_oscillators_tpu_torch.ops.fmm import octree as oc
from coulomb_oscillators_tpu_torch.ops.fmm.appel import AppelEngine
from coulomb_oscillators_tpu_torch.ops.fmm.octree import (OctState,
                                                          OctreeFmmEngine)
from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err

torch.set_num_threads(1)

N = 2000
OMEGA = (1.095, 1.0, 1.0)


def _uniform(dim, n=N):
    return ID.init_uniform(n, (-1,) * dim, (1,) * dim, dim=dim)


def _cfgs(dim, **kw):
    return (JConfig(dim=dim, omega0=OMEGA[:dim], **kw),
            SimConfig(dim=dim, omega0=OMEGA[:dim], **kw))


def _np_state(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# ---- static structure: numpy copies, bit-equal ----

@pytest.mark.parametrize("dim,L,R", [(3, 3, 1), (2, 4, 2), (3, 2, 2)])
def test_grid_static_bit_equal(dim, L, R):
    a, b = oc._grid_static(dim, L, R), joct._grid_static(dim, L, R)
    assert a[1] == b[1] and a[2] == b[2]
    for la, lb in zip(a[0], b[0]):
        for k in ("coords", "to_grid", "from_grid"):
            assert np.array_equal(la[k], lb[k])
    ids = np.arange(1 << (dim * L))
    assert np.array_equal(oc._morton_decode(ids, L, dim),
                          joct._morton_decode(ids, L, dim))
    for o in range(-(2 * R + 1), 2 * R + 2):
        assert np.array_equal(oc._axis_mask(1 << L, o, R),
                              joct._axis_mask(1 << L, o, R))
    for args in ((N, 3, dim), (10 ** 6, 5, 3, 1.0), (10 ** 6, 3, 2, 0.25),
                 (N, 4, dim, 1.0, 5)):
        assert oc.auto_level_octree(*args) == joct.auto_level_octree(*args)


@pytest.mark.parametrize("dim,R", [(3, 1), (2, 1), (2, 2), (3, 2)])
def test_parity_classes_reproduce_the_masks(dim, R):
    """The per-parity offset classes the port's M2L runs select exactly
    the offsets the reference's per-axis masks keep (bounds aside, which
    the zero pad covers)."""
    side = 32
    _, offsets, _ = oc._grid_static(dim, 3, R)
    sib = oc._morton_decode(np.arange(1 << dim), 1, dim)
    classes = oc._parity_classes(dim, R)
    for k, o in enumerate(offsets):
        for c, cls in zip(sib, classes):
            i = np.asarray(c) + 16                    # an interior cell
            keep = all(joct._axis_mask(side, o[a], R)[i[a]]
                       for a in range(dim))
            assert (k in cls) == keep, (o, c)


# ---- the binned state and the force on the reference's state ----

@pytest.mark.parametrize("dim,L,R,storage", [
    (3, 3, 1, "symmetric"), (3, 3, 1, "traceless"), (2, 3, 2, "symmetric"),
    (2, 4, 1, "symmetric"), (2, 4, 2, "traceless")])
def test_octree_state_and_force_match(dim, L, R, storage):
    """Integer OctState fields and cell_cap bit-equal to the reference's;
    the port's force on the reference's own state within 1e-5 of the
    reference's force relative to max|a| (float32 sums in another order:
    matmul sums, index_add_, per-parity M2L)."""
    pos = _uniform(dim)
    jc, tc = _cfgs(dim, fmm_order=4, tree_radius=float(R))
    je = joct.OctreeFmmEngine(jc, N, L=L, multipole_storage=storage)
    te = OctreeFmmEngine(tc, N, L=L, multipole_storage=storage)
    js = je.build(jnp.asarray(pos))
    ts = te.build(torch.from_numpy(pos))
    for f in ("perm", "key", "rank", "counts"):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("origin", "cw"):
        assert np.array_equal(np.asarray(getattr(js, f)),
                              getattr(ts, f).numpy()), f
    assert te.cell_cap == je.cell_cap and te.R == je.R == R
    ref = np.asarray(je.force(jnp.asarray(pos), js))
    got = te.force(torch.from_numpy(pos),
                   oc.oct_state_from_numpy(_np_state(js), "cpu"))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("dim,L,R", [(3, 3, 1), (2, 4, 2), (3, 2, 1)])
def test_appel_state_and_force_match(dim, L, R):
    pos = _uniform(dim)
    jc, tc = _cfgs(dim, tree_radius=float(R))
    je, te = japp.AppelEngine(jc, N, L=L), AppelEngine(tc, N, L=L)
    js = je.build(jnp.asarray(pos))
    ts = te.build(torch.from_numpy(pos))
    for f in ("perm", "key", "rank", "counts"):
        assert np.array_equal(np.asarray(getattr(js, f)),
                              getattr(ts, f).numpy()), f
    assert te.cell_cap == je.cell_cap
    ref = np.asarray(je.force(jnp.asarray(pos), js))
    got = te.force(torch.from_numpy(pos),
                   oc.oct_state_from_numpy(_np_state(js), "cpu")).numpy()
    assert _rel(got, ref) <= 1e-5


def test_appel_refuses_int32_slot_overflow():
    """The reference indexes pad slots in int32 and refuses a slot space
    of 2^31 or more; the port indexes in int64 and refuses the same."""
    eng = AppelEngine(SimConfig(), 64, L=8, cell_cap=128)   # 2^24 * 2^7
    pos = torch.from_numpy(_uniform(3, 64))
    with pytest.raises(ValueError, match="int32"):
        eng.force(pos, eng.build(pos))


# ---- twins of tests/test_octree.py ----

@pytest.mark.parametrize("dim,L", [(3, 3), (2, 4)])
def test_octree_converges(dim, L):
    pos = torch.from_numpy(_uniform(dim))
    cfg = _cfgs(dim)[1]
    ref = D.direct_kahan(pos, cfg.eps2, cfg.kappa(N))
    errs = []
    for p in (3, 5):
        eng = OctreeFmmEngine(cfg.replace(fmm_order=p), N, L=L)
        errs.append(float(mean_rel_err(eng.force(pos, eng.build(pos)), ref)))
    assert errs[1] < errs[0] * 0.7, errs
    assert errs[1] < 5e-3, errs


@pytest.mark.parametrize("dim", [3, 2])
def test_appel_monopole_tree(dim):
    cfg = _cfgs(dim)[1]
    eng = make_engine_object(cfg, N, "appel")
    assert isinstance(eng, AppelEngine)
    pos = torch.from_numpy(_uniform(dim))
    acc = eng.force(pos, eng.build(pos))
    ref = D.direct_kahan(pos, cfg.eps2, cfg.kappa(N))
    assert float(mean_rel_err(acc, ref)) < 0.09


def test_appel_error_scale_invariant_in_depth():
    cfg = SimConfig()
    pos = torch.from_numpy(_uniform(3))
    ref = D.direct_kahan(pos, cfg.eps2, cfg.kappa(N))
    errs = []
    for L in (2, 3):
        eng = AppelEngine(cfg, N, L=L)
        errs.append(float(mean_rel_err(eng.force(pos, eng.build(pos)), ref)))
    assert errs[1] < errs[0] * 2.5, errs
    assert errs[1] < 0.12, errs


@pytest.mark.slow
def test_radius_knob_improves_accuracy():
    cfg = SimConfig()
    pos = torch.from_numpy(_uniform(3))
    ref = D.direct_kahan(pos, cfg.eps2, cfg.kappa(N))

    def err(eng):
        return float(mean_rel_err(eng.force(pos, eng.build(pos)), ref))

    e1 = err(OctreeFmmEngine(cfg.replace(fmm_order=4, tree_radius=1.0),
                             N, L=3))
    e2 = err(OctreeFmmEngine(cfg.replace(fmm_order=4, tree_radius=2.0),
                             N, L=3))
    assert e2 < e1 * 0.5, (e1, e2)
    a1 = err(AppelEngine(cfg.replace(tree_radius=1.0), N, L=3))
    a2 = err(AppelEngine(cfg.replace(tree_radius=2.0), N, L=3))
    assert a2 < a1 * 0.6, (a1, a2)


@pytest.mark.slow
def test_radius_any_integer():
    cfg = SimConfig(dim=2, omega0=(1.095, 1.0))
    pos = torch.from_numpy(_uniform(2))
    ref = D.direct_kahan(pos, cfg.eps2, cfg.kappa(N))

    def err(eng):
        return float(mean_rel_err(eng.force(pos, eng.build(pos)), ref))

    errs = [err(AppelEngine(cfg.replace(tree_radius=float(R)), N, L=4))
            for R in (1, 2, 3)]
    assert AppelEngine(cfg.replace(tree_radius=3.0), N, L=4).R == 3
    assert errs[1] < errs[0] and errs[2] < errs[1], errs
    o3 = OctreeFmmEngine(cfg.replace(fmm_order=4, tree_radius=3.0), N, L=4)
    assert o3.R == 3
    e3 = err(o3)
    e1 = err(OctreeFmmEngine(cfg.replace(fmm_order=4, tree_radius=1.0),
                             N, L=4))
    assert e3 < e1 * 0.5, (e1, e3)


def test_octree_engine_registry():
    cfg = SimConfig()
    for name in ("fmm3", "fmm3_traceless"):
        eng = make_engine_object(cfg, N, name)
        assert isinstance(eng, OctreeFmmEngine)
        assert eng.multipole_storage == (
            "traceless" if name.endswith("traceless") else "symmetric")
    cfg2 = SimConfig(dim=2, omega0=(1.095, 1.0))
    for name in ("fmm2", "fmm2_traceless"):
        assert isinstance(make_engine_object(cfg2, N, name), OctreeFmmEngine)


def test_float64_force_matches_reference_float32():
    """The float64 run of the 2D CLI.  The reference's octree cannot run
    in float64: under jax_enable_x64 its M2L dynamic_slice mixes int32 and
    int64 start indices and raises (so the reference CLI's 2D default run
    on a CPU, which turns x64 on, raises too).  The port's float64 force
    on the reference's own float32 state is held against the reference's
    float32 force to float32 accuracy, 1e-5 relative to max|a|, and
    against the port's float32 force."""
    pos = _uniform(2, 1500)
    jc, tc = _cfgs(2, fmm_order=3)
    je = joct.OctreeFmmEngine(jc, 1500)
    js = je.build(jnp.asarray(pos))
    ref = np.asarray(je.force(jnp.asarray(pos), js))
    st = oc.oct_state_from_numpy(_np_state(js), "cpu")
    te = OctreeFmmEngine(tc.replace(precision="float64"), 1500)
    te.cell_cap = je.cell_cap
    got = te.force(torch.from_numpy(pos.astype(np.float64)), st)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), ref) <= 1e-5
    t32 = OctreeFmmEngine(tc, 1500)
    t32.cell_cap = je.cell_cap
    assert _rel(got.numpy(), t32.force(torch.from_numpy(pos), st).numpy()) \
        <= 1e-5


def test_oct_state_from_numpy_round_trip():
    pos = torch.from_numpy(_uniform(3, 500))
    eng = OctreeFmmEngine(SimConfig(), 500)
    st = eng.build(pos)
    back = oc.oct_state_from_numpy(_np_state(st), "cpu")
    assert isinstance(back, OctState)
    for a, b in zip(st, back):
        assert torch.equal(a, b)
