"""Port vs reference: the kd-tree engine's host build, its state, its force
pipeline and its P2P plain version.

The reference engine is built with ``use_pallas=True``, which pads C to the
Pallas lane quantum and builds ``p2p_row_ptr``/``p2p_col2d`` — the one
layout the port always uses.  That build runs on the CPU (``_build_col2d``
is plain jnp); the reference's Pallas kernel is never called.  Its forces
come from its default CPU engine (jnp scan near field).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu.models import init_dist as ID
from coulomb_oscillators_tpu.ops.fmm.kdtree import (FAR as JFAR,
                                                    KdFmmEngine as JEngine,
                                                    auto_level as j_auto_level)
from coulomb_oscillators_tpu_torch import SimConfig as TConfig
from coulomb_oscillators_tpu_torch.ops import direct as TD
from coulomb_oscillators_tpu_torch.ops import fmm as tfmm
from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (
    FAR, FmmState, KdFmmEngine, auto_level, fmm_state_from_numpy)
from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err

torch.set_num_threads(1)

X_STD = (0.003, 0.001, 0.01)
CASES = [(1500, 3), (4096, 4)]


def _beam(n, seed=None):
    u = tuple(w * x for w, x in zip(JConfig().omega0, X_STD))
    kw = {} if seed is None else {"seed": seed}
    return ID.init_gaussian(n, X_STD, u, **kw)


def _np_state(fs):
    return {f: np.asarray(getattr(fs, f)) for f in fs._fields}


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"n{c[0]}p{c[1]}")
def built(request):
    n, p = request.param
    pos, vel = _beam(n)
    jeng = JEngine(JConfig(fmm_order=p, tree_radius=2.0), n, use_pallas=True)
    jfs = jeng.build(jnp.asarray(pos))
    teng = KdFmmEngine(TConfig(fmm_order=p, tree_radius=2.0), n)
    tfs = teng.build(torch.from_numpy(pos))
    return dict(n=n, p=p, pos=pos, vel=vel, jeng=jeng, jfs=jfs, teng=teng,
                tfs=tfs)


def test_engine_geometry_matches(built):
    j, t = built["jeng"], built["teng"]
    for a in ("L", "sub_depth", "mac_mult_floor", "mac_sub_boost", "G_sub",
              "G_blk", "C_blk", "mask_shift", "m2l_group"):
        assert getattr(t, a) == getattr(j, a), a
    assert t.st.C == j.st.C
    for a in ("pad_gather", "pad_mask", "unpad_gather", "mult"):
        assert np.array_equal(getattr(t.st, a), getattr(j.st, a))


def test_build_state_exactly_equal(built):
    j, t = _np_state(built["jfs"]), built["tfs"]
    for f in FmmState._fields:
        a, b = j[f], getattr(t, f).numpy()
        assert a.shape == b.shape, (f, a.shape, b.shape)
        if f in ("center", "lam"):
            # the same native library computes both; float32 round trip
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
        else:
            assert np.array_equal(a, b), f
    assert built["teng"].caps == built["jeng"].caps


def test_force_from_reference_state_matches(built):
    """The port's force fed the reference's state agrees with the
    reference's default CPU force: the lists are the same, so the two
    differ only by float32 summation order (matmul term sums, index_add_
    vs segment_sum)."""
    n, p, pos = built["n"], built["p"], built["pos"]
    jeng = JEngine(JConfig(fmm_order=p, tree_radius=2.0), n)
    ref = np.asarray(jeng.force(jnp.asarray(pos), jeng.build(
        jnp.asarray(pos))))
    fs = fmm_state_from_numpy(_np_state(built["jfs"]), "cpu")
    got = built["teng"].force(torch.from_numpy(pos), fs).numpy()
    dev = np.abs(got - ref).max() / np.abs(ref).max()
    assert dev <= 1e-5, dev


def test_plain_p2p_matches_reference_scan(built):
    """The plain P2P (col2d/row_ptr contract) against the reference's jnp
    scan over the flat pair list (kdtree.py:1596-1639) on the same padded
    positions and state: per-target sums in another order."""
    jeng, jfs = built["jeng"], built["jfs"]
    pos = jnp.asarray(built["pos"])
    ppad_j = jeng.pad_array(pos, jfs, fill=JFAR)
    jeng.use_pallas = False            # the scan branch, same layout
    try:
        ref = np.asarray(jeng._stage_p2p(ppad_j, jfs))
    finally:
        jeng.use_pallas = True
    teng = built["teng"]
    fs = fmm_state_from_numpy(_np_state(jfs), "cpu")
    ppad = torch.tensor(np.asarray(ppad_j))
    got = teng._stage_p2p(ppad, fs).numpy()
    scale = np.linalg.norm(ref, axis=-1).max()
    dev = np.linalg.norm(got - ref, axis=-1).max() / scale
    assert dev <= 1e-5, dev


def test_padding_and_repad_match(built):
    jeng, teng = built["jeng"], built["teng"]
    jfs, tfs = built["jfs"], built["tfs"]
    pos, vel = built["pos"], built["vel"]
    pp = teng.pad_array(torch.from_numpy(pos), tfs, fill=FAR)
    assert np.array_equal(pp.numpy(), np.asarray(
        jeng.pad_array(jnp.asarray(pos), jfs, fill=JFAR)))
    assert np.array_equal(teng.unpad_array(pp, tfs).numpy(), pos)
    # a second tree from moved positions: the layout remap is the same
    moved = (pos + 1e-4 * vel).astype(np.float32)
    jfs2 = jeng.build(jnp.asarray(moved))
    tfs2 = teng.build(torch.from_numpy(moved))
    jmap = np.asarray(jeng.make_repad(jfs, jfs2))
    tmap = teng.make_repad(tfs, tfs2)
    assert np.array_equal(tmap.numpy(), jmap)
    pv = teng.pad_array(torch.from_numpy(vel), tfs)
    got = teng.repad_triple(pp, pv, pv, tmap)
    ref = jeng.repad_triple(jnp.asarray(pp.numpy()), jnp.asarray(pv.numpy()),
                            jnp.asarray(pv.numpy()), jnp.asarray(jmap))
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_geom_refresh_and_refresh_match(built):
    jeng, teng = built["jeng"], built["teng"]
    jfs, tfs = built["jfs"], built["tfs"]
    pos, vel = built["pos"], built["vel"]
    moved = (pos + 2e-4 * vel / np.abs(vel).max()).astype(np.float32)
    jp = jeng.pad_array(jnp.asarray(moved), jfs, fill=JFAR)
    tp = teng.pad_array(torch.from_numpy(moved), tfs, fill=FAR)
    jg = jeng.geom_refresh_in_jit(jp, jfs)
    tg = teng.geom_refresh(tp, tfs)
    # leaf sums and the heap sweep in float32, in another reduction order:
    # 1e-6 relative to the largest center (the root's is ~0)
    jc = np.asarray(jg.center)
    np.testing.assert_allclose(tg.center.numpy(), jc, rtol=0,
                               atol=1e-6 * np.abs(jc).max())
    np.testing.assert_allclose(tg.lam.numpy(), np.asarray(jg.lam), rtol=1e-6)
    assert tg.m2l_src is tfs.m2l_src            # lists frozen
    # exact bounds + re-traversal on the current permutation
    jr = _np_state(jeng.refresh(jp, jfs))
    tr = teng.refresh(tp, tfs)
    for f in ("m2l_tgt", "m2l_src", "p2p_src", "p2p_row_ptr", "p2p_col2d",
              "m2l_gtgt", "perm"):
        assert np.array_equal(getattr(tr, f).numpy(), jr[f]), f


def test_accuracy_vs_direct():
    """Twin of tests/test_fmm_kd.py::test_accuracy_vs_direct: N=1500, p=4,
    r=2, mean relative error below 1e-3 against the Kahan oracle."""
    n = 1500
    pos, _ = ID.init_gaussian(n, X_STD, X_STD)
    cfg = TConfig(fmm_order=4, tree_radius=2.0)
    tpos = torch.from_numpy(pos)
    ref = TD.direct_kahan(tpos, cfg.eps2, cfg.kappa(n))
    eng = KdFmmEngine(cfg, n)
    err = float(mean_rel_err(eng.force(tpos, eng.build(tpos)), ref))
    assert err < 1e-3, err


def test_stale_margin_inflates_lists():
    """A positive traversal-time margin only makes the MAC stricter: more
    near pairs, and the reference engine with the same margin builds the
    same lists."""
    n = 1500
    pos, _ = _beam(n)
    margin = np.array([2e-5, 1e-5, 6e-5])
    t0 = KdFmmEngine(TConfig(fmm_order=3, tree_radius=2.0), n)
    t1 = KdFmmEngine(TConfig(fmm_order=3, tree_radius=2.0), n)
    t1.stale_margin_abs = margin
    j1 = JEngine(JConfig(fmm_order=3, tree_radius=2.0), n, use_pallas=True)
    j1.stale_margin_abs = margin
    f0 = t0.build(torch.from_numpy(pos))
    f1 = t1.build(torch.from_numpy(pos))
    assert int(f1.p2p_valid.sum()) > int(f0.p2p_valid.sum())
    jf = _np_state(j1.build(jnp.asarray(pos)))
    for f in ("p2p_col2d", "m2l_src", "m2l_tgt"):
        assert np.array_equal(getattr(f1, f).numpy(), jf[f])


def test_auto_level_and_engine_registry():
    for args in ((30001, 3), (100, 3), (10, 3, 1.0, 5), (10 ** 6, 6, 1.0, 0,
                                                         32)):
        assert auto_level(*args) == j_auto_level(*args)
    assert isinstance(tfmm.make_engine_object(TConfig(), 512, "fmm3_kd"),
                      KdFmmEngine)
    # the reference's whole registry constructs
    cfg2 = TConfig(dim=2, omega0=(1.0, 1.0))
    for name, cfg, cls in (("fmm2_kd", cfg2, KdFmmEngine),
                           ("fmm3", TConfig(), tfmm.OctreeFmmEngine),
                           ("fmm3_traceless", TConfig(),
                            tfmm.OctreeFmmEngine),
                           ("fmm2", cfg2, tfmm.OctreeFmmEngine),
                           ("fmm2_traceless", cfg2, tfmm.OctreeFmmEngine),
                           ("appel", TConfig(), tfmm.AppelEngine)):
        assert isinstance(tfmm.make_engine_object(cfg, 512, name), cls)
    assert KdFmmEngine(cfg2, 512).dim == 2
    assert KdFmmEngine(TConfig(precision="float64"), 512).dtype == \
        torch.float64
    with pytest.raises(ValueError):
        tfmm.make_engine_object(TConfig(), 512, "nope")


def test_p2p_wrapper_checks_its_inputs():
    pos = torch.zeros(4, 128, 3)
    rp = torch.zeros(17, dtype=torch.int32)
    col = torch.zeros(16, 128, dtype=torch.int32)
    assert p2p_cuda.p2p(pos, rp, col, 4, 1e-18).shape == pos.shape
    assert p2p_cuda.p2p(pos.double(), rp, col, 4, 1e-18).dtype == \
        torch.float64
    with pytest.raises(ValueError):
        p2p_cuda.p2p(pos.half(), rp, col, 4, 1e-18)
    with pytest.raises(ValueError):
        p2p_cuda.p2p(pos, rp[:-1], col, 4, 1e-18)
    with pytest.raises(ValueError):
        p2p_cuda.p2p(pos, rp, col.long(), 4, 1e-18)
    with pytest.raises(ValueError):
        p2p_cuda.p2p(pos[..., :2], rp, col, 4, 1e-18)


def test_plain_p2p_sentinel_and_masks():
    """The sentinel block (id Gb) contributes exactly zero, a cleared mask
    bit drops its lane group, and the sign-bit mask (nsub=1) decodes."""
    rng = np.random.default_rng(2)
    Gb, CB = 2, 64
    pos = torch.from_numpy(rng.normal(size=(Gb, CB, 3)).astype(np.float32))
    pos[1, 40:] = FAR                                 # pad slots
    eps2 = 1e-6

    def run(entries, nsub):
        G = Gb * nsub
        col = torch.full((G, 4), Gb, dtype=torch.int32)
        rp = torch.zeros(G + 1, dtype=torch.int32)
        for row, vals in entries.items():
            col[row, :len(vals)] = torch.tensor(
                np.array(vals, np.uint32).view(np.int32))
        for row in range(G):
            rp[row + 1] = rp[row] + len(entries.get(row, []))
        return p2p_cuda.p2p_plain(pos, rp, col, nsub, eps2)

    def brute(tgt_rows, src):
        d = pos.reshape(-1, 3)[tgt_rows][:, None, :] - src[None, :, :]
        r = torch.rsqrt(eps2 + (d * d).sum(-1))
        return (d * (r * r * r)[..., None]).sum(1)

    shift = 30                                        # nsub = 2
    out = run({0: [1 | (0b10 << shift), Gb], 3: [0 | (0b01 << shift)]}, 2)
    assert torch.allclose(out[0, :32], brute(torch.arange(32), pos[1, 32:]),
                          rtol=1e-5, atol=0)
    assert float(out[0, 32:].abs().max()) == 0.0
    assert torch.allclose(out[1, 32:], brute(torch.arange(96, 128),
                                             pos[0, :32]), rtol=1e-5, atol=0)
    assert bool(torch.isfinite(out).all())
    out1 = run({1: [0 | (1 << 31)]}, 1)               # mask in the sign bit
    assert torch.allclose(out1[1, :40], brute(torch.arange(64, 104), pos[0]),
                          rtol=1e-5, atol=0)
    assert float(out1[1, 40:].abs().max()) == 0.0     # FAR pads get 0
