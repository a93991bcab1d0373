"""Port vs reference: the kd-tree engine in dim 2 (fmm2_kd) and in float64,
its device builders and sort modes, and the numpy traversal — twins of
tests/test_fmm_kd_variants.py and tests/test_traversal_native.py.

The port's one layout pads C to the lane quantum and always builds the P2P
CSR, so its integer state is held equal to the reference engine built with
``use_pallas=True`` (that build runs on the CPU; the reference's Pallas
kernel is never called).  Reference forces come from its default CPU
engine (``use_pallas=False``, C unpadded): the tree and lists are the same,
only the pad count differs, and each pad adds at most ~1e-18 in 2D."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu import native as jnative
from coulomb_oscillators_tpu.ops.fmm import kdtree as JK
from coulomb_oscillators_tpu_torch import SimConfig, native
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.ops import direct as D
from coulomb_oscillators_tpu_torch.ops import energy as E
from coulomb_oscillators_tpu_torch.ops.fmm import kdtree as TK
from coulomb_oscillators_tpu_torch.ops.fmm import make_engine_object
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (
    FmmState, KdFmmEngine, fmm_state_from_numpy)
from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err

torch.set_num_threads(1)

N = 3000
CFG2 = dict(dim=2, omega0=(1.095, 1.0), fmm_order=4, tree_radius=2.0)
X_STD = (0.003, 0.001, 0.01)


def _uniform(dim, n=N):
    return ID.init_uniform(n, (-1,) * dim, (1,) * dim, dim=dim)


def _np_state(fs):
    return {f: np.asarray(getattr(fs, f)) for f in fs._fields}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _assert_state_equal(tfs, jfs, geo_tol):
    for f in FmmState._fields:
        a, b = np.asarray(getattr(jfs, f)), getattr(tfs, f).numpy()
        assert a.shape == b.shape, (f, a.shape, b.shape)
        if f in ("center", "lam"):
            assert np.abs(b - a).max() <= geo_tol * np.abs(a).max(), f
        else:
            assert np.array_equal(a, b), f


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


# ---- fmm2_kd ----

def test_kd_2d_state_and_force_match_reference():
    """fmm2_kd on a uniform square: every integer field of the state equals
    the reference's use_pallas=True build, and the port's force on the
    reference's state is within 1e-5 of the reference's force."""
    pos = _uniform(2)
    jfs = JK.KdFmmEngine(JConfig(**CFG2), N, use_pallas=True).build(
        jnp.asarray(pos))
    eng = KdFmmEngine(SimConfig(**CFG2), N)
    _assert_state_equal(eng.build(torch.from_numpy(pos)), jfs, 1e-6)
    jd = JK.KdFmmEngine(JConfig(**CFG2), N)
    ref = np.asarray(jd.force(jnp.asarray(pos), jd.build(jnp.asarray(pos))))
    got = eng.force(torch.from_numpy(pos),
                    fmm_state_from_numpy(_np_state(jfs), "cpu")).numpy()
    assert _rel(got, ref) <= 1e-5


def test_kd_2d_vs_direct():
    """Twin: fmm2_kd against the Kahan oracle (log-potential forces)."""
    cfg = SimConfig(**CFG2)
    eng = make_engine_object(cfg, N, "fmm2_kd")
    assert isinstance(eng, KdFmmEngine) and eng.dim == 2
    pos = torch.from_numpy(_uniform(2))
    acc = eng.force(pos, eng.build(pos))
    ref = D.direct_kahan(pos, cfg.eps2, cfg.kappa(N))
    err = float(mean_rel_err(acc, ref))
    assert err < 2e-3, err


def test_kd_2d_converges_with_order():
    cfg = SimConfig(dim=2, omega0=(1.095, 1.0), tree_radius=2.0)
    pos = torch.from_numpy(_uniform(2))
    ref = D.direct_kahan(pos, cfg.eps2, cfg.kappa(N))
    errs = []
    for p in (2, 5):
        eng = KdFmmEngine(cfg.replace(fmm_order=p), N)
        errs.append(float(mean_rel_err(eng.force(pos, eng.build(pos)), ref)))
    assert errs[1] < errs[0] * 0.5, errs


def test_kd_2d_potential():
    """The 2D potential (-log r pair law) against the reference's at
    n = 4096, where neither build has a pad slot (the reference's 2D sum
    takes each pad's -log(FAR); the port drops pads), and against Kahan
    rows."""
    n = 4096
    pos = _uniform(2, n)
    jd = JK.KdFmmEngine(JConfig(**CFG2), n)
    assert jd.st.pad_mask.all()
    ref = np.asarray(jd.potential(jnp.asarray(pos), jd.build(
        jnp.asarray(pos))))
    eng = KdFmmEngine(SimConfig(**CFG2), n)
    tpos = torch.from_numpy(pos)
    phi = eng.potential(tpos, eng.build(tpos))
    assert _rel(phi.numpy(), ref) <= 1e-5
    rows = eng.config.kappa(n) * E.potential_rows_kahan(tpos.double(),
                                                        eng.config.eps2)
    assert float(((phi.double() - rows).abs() / rows.abs()).mean()) < 2e-3


# ---- float64 ----

def test_kd_float64(x64):
    """Twin: float64 end to end with the device Morton build; the force
    is float64 and no worse than 1.5x the float32 engine's error against a
    float64 oracle.  The state equals the reference's float64 Morton build
    (center/lam to 1e-15) and the force its float64 force to 1e-12."""
    cfg = SimConfig(fmm_order=4, tree_radius=2.0, precision="float64")
    p = _uniform(3).astype(np.float64)
    eng = KdFmmEngine(cfg, N, sort_mode="morton")
    fs = eng.build(torch.from_numpy(p))
    assert fs.center.dtype == fs.lam.dtype == torch.float64
    acc = eng.force(torch.from_numpy(p), fs)
    assert acc.dtype == torch.float64
    d = p[:, None, :] - p[None, :, :]
    w = ((d * d).sum(-1) + cfg.eps2) ** -1.5
    np.fill_diagonal(w, 0.0)
    ref = torch.from_numpy(cfg.kappa(N) * np.einsum("ij,ijd->id", w, d))
    err = float(mean_rel_err(acc, ref))
    assert err < 2e-3, err
    eng32 = KdFmmEngine(cfg.replace(precision="float32"), N,
                        sort_mode="morton")
    p32 = torch.from_numpy(p.astype(np.float32))
    err32 = float(mean_rel_err(eng32.force(p32, eng32.build(p32)).double(),
                               ref))
    assert err <= err32 * 1.5, (err, err32)

    jc = JConfig(fmm_order=4, tree_radius=2.0, precision="float64")
    jfs = JK.KdFmmEngine(jc, N, sort_mode="morton", use_pallas=True).build(
        jnp.asarray(p))
    _assert_state_equal(fs, jfs, 1e-15)
    jd = JK.KdFmmEngine(jc, N, sort_mode="morton")
    jref = np.asarray(jd.force(jnp.asarray(p), jd.build(jnp.asarray(p))))
    assert _rel(acc.numpy(), jref) <= 1e-12


# ---- device builders and sort modes ----

def _leaf_sets(perm, L, n):
    beg = (np.arange((1 << L) + 1) * n) >> L
    perm = np.asarray(perm)
    return [tuple(np.sort(perm[beg[i]:beg[i + 1]])) for i in range(1 << L)]


@pytest.mark.parametrize("builder", ["_build_device", "_build_device_morton"])
@pytest.mark.parametrize("dim", [3, 2])
def test_device_builders_match_reference(builder, dim):
    """The same particles in every leaf (the reference's kd sort is not
    stable, so ties may order differently inside a leaf; these seeded
    inputs have none, so perm is held exactly too), and node geometry
    within 1e-6 relative."""
    n, L = 2048, 6
    x = X_STD[:dim]
    pos = ID.init_gaussian(n, x, x, dim=dim)[0]
    ref = getattr(JK, builder)(jnp.asarray(pos), n, L, dim)
    got = getattr(TK, builder)(torch.from_numpy(pos), n, L, dim)
    assert got[0].dtype == torch.int32
    assert _leaf_sets(got[0], L, n) == _leaf_sets(ref[0], L, n)
    assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
    for a, b in zip(got[1:], ref[1:]):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()


@pytest.mark.parametrize("mode", TK.SORT_MODES)
def test_sort_modes_build_and_agree(mode):
    """Each sort_mode builds a tree and a force within the FMM error of
    the Kahan oracle; "auto" and "kd_native" take the native kd order."""
    n = 1500
    pos = torch.from_numpy(ID.init_gaussian(n, X_STD, X_STD)[0])
    cfg = SimConfig(fmm_order=4, tree_radius=2.0)
    eng = KdFmmEngine(cfg, n, sort_mode=mode)
    fs = eng.build(pos)
    if mode in ("auto", "kd_native"):
        assert np.array_equal(fs.perm.numpy(),
                              native.kdtree_build(pos.numpy(), eng.L))
    ref = D.direct_kahan(pos, cfg.eps2, cfg.kappa(n))
    assert float(mean_rel_err(eng.force(pos, fs), ref)) < 1e-3


def test_sort_mode_env_override_and_check(monkeypatch):
    monkeypatch.setenv("CO_SORT_MODE", "kd_device")
    assert KdFmmEngine(SimConfig(), 512).sort_mode == "kd_device"
    monkeypatch.setenv("CO_SORT_MODE", "bogus")
    with pytest.raises(ValueError, match="sort_mode"):
        KdFmmEngine(SimConfig(), 512)


# ---- the numpy traversal ----

@pytest.mark.parametrize("radius,p", [(2.0, 5), (1.43, 3)])
def test_traverse_raw_matches_native_and_reference(radius, p):
    """Twin of tests/test_traversal_native.py: the numpy traversal plus
    the fine lists give the native single pass's directed M2L and packed
    near lists, as key sets, and the raw pairs equal the reference's
    _traverse_raw."""
    n = 20000
    cfg = SimConfig(fmm_order=p, tree_radius=radius)
    u = tuple(w * xs for w, xs in zip(cfg.omega0, X_STD))
    ph, _ = ID.init_gaussian(n, X_STD, u)
    eng = KdFmmEngine(cfg, n)
    perm = native.kdtree_build(ph, eng.L)
    c, lb, rb, lam = native.node_geometry(ph[perm], eng.L)
    m2l_n, near_n = native.traverse_fine(
        c, lb, rb, eng.st.mult, eng.L, eng.sub_depth, n, 3, p, radius, True)
    m2l_u, p2p_u = TK._traverse_raw(c, lb, rb, eng.st.mult, eng.L, n, p,
                                    radius)
    jm, jp = JK._traverse_raw(c, lb, rb, eng.st.mult, eng.L, n, p, radius)
    assert np.array_equal(m2l_u, jm) and np.array_equal(p2p_u, jp)
    near_f, m2l_f = eng._fine_lists(m2l_u, p2p_u)

    def keyset(a):
        return set(map(tuple, np.asarray(a, np.int64)))

    assert keyset(m2l_n) == keyset(m2l_f)
    assert keyset(near_n) == keyset(near_f)


def test_without_native_library_falls_back(monkeypatch):
    """Without the native library "auto" builds with the device Morton
    sort and the numpy traversal, as the reference does, and says so in
    kdtree.raw_traversals; the force matches the reference's Morton
    build within 1e-5."""
    n = 1500
    pos = ID.init_gaussian(n, X_STD, X_STD)[0]
    cfg = dict(fmm_order=4, tree_radius=2.0)
    monkeypatch.setattr(native, "available", lambda: False)
    before = TK.raw_traversals
    eng = KdFmmEngine(SimConfig(**cfg), n)
    got = eng.force(torch.from_numpy(pos), eng.build(torch.from_numpy(pos)))
    assert TK.raw_traversals == before + 1
    jd = JK.KdFmmEngine(JConfig(**cfg), n, sort_mode="morton")
    ref = np.asarray(jd.force(jnp.asarray(pos), jd.build(jnp.asarray(pos))))
    assert _rel(got.numpy(), ref) <= 1e-5
    assert jnative.get_lib() is not None      # the reference used its lib
