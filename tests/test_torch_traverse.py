"""The kd engine's traversal on tensors (ops/fmm/traverse.py) against the
native single pass, on the CPU.

The plain PyTorch frontier (the card kernel's twin, csrc/traverse.cu) and
the device lists made from its pairs are held to ``native.traverse_fine``
on the same tables (``native.traverse_tables``): ``near`` element for
element, ``m2l`` after a sort by (target, source), since the native
within-target order is its depth-first emission order.  Every case also
holds the port's ``traverse_fine``, which now takes its tables from the
same C entry, to the reference's library bit for bit, order included.
The card's kernel against the native: tests/test_torch_traverse_cuda.py.
"""

import numpy as np
import pytest
import torch

from coulomb_oscillators_tpu import native as jnative
from coulomb_oscillators_tpu_torch import SimConfig, native
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.ops.fmm import kdtree
from coulomb_oscillators_tpu_torch.ops.fmm import traverse as T
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine
from coulomb_oscillators_tpu_torch.simulate import auto_stale_margin

torch.set_num_threads(1)

X_STD = (0.003, 0.001, 0.01)

# (dim, n, p, radius, sub_depth, coll, margin, sub_boost, mult_floor):
# margin None, a scalar, or "axes" (the Simulator's per-axis auto margin
# at 16/2/2); mult_floor 1 or "block" (the engine's block occupancy).
# Cases named in PACKING also pack the near list in many target buckets,
# or with the int64 keys of trees deeper than 15 levels.
PACKING = {"3d-s2-scalar": {"BUCKET_KEYS": 1000},
           "2d-s2-axes": {"BUCKET_KEYS": 1000, "INT32_KEYS_MAX_L": 0},
           "3d-prod": {"INT32_KEYS_MAX_L": 0}}
CASES = {
    "3d-s2-plain": (3, 4000, 3, 1.0, 2, True, None, 1.5, "block"),
    "3d-s2-scalar": (3, 4000, 3, 1.0, 2, True, 3e-4, 1.0, 1),
    "3d-s2-nocoll": (3, 4000, 3, 1.0, 2, False, "axes", 1.5, "block"),
    "3d-s0-axes": (3, 4000, 3, 1.0, 0, True, "axes", 1.0, 1),
    "3d-s0-nocoll": (3, 4000, 3, 1.0, 0, False, 3e-4, 1.0, 1),
    "3d-prod": (3, 4000, 6, 1.67, 2, True, "axes", 1.5, "block"),
    "2d-s2-axes": (2, 3000, 4, 2.0, 2, True, "axes", 1.5, "block"),
    "2d-s0-plain": (2, 3000, 4, 2.0, 0, True, None, 1.0, 1),
    "2d-s2-nocoll": (2, 3000, 4, 2.0, 2, False, 1e-4, 1.0, "block"),
    "2d-s2-floor1": (2, 3000, 4, 2.0, 2, True, 1e-4, 1.5, 1),
    # the CLI configuration (N = 30001, p = 3, r = 1.0, 8/1/1), as its
    # engine sets it up
    "cli-30001": (3, 30001, 3, 1.0, 2, True, "axes", 1.5, "block"),
}


def _geometry(dim, n, p, radius, sub_depth, margin):
    """(engine, center, lb, rb) of a Gaussian beam, the bounds inflated as
    KdFmmEngine._traverse inflates them."""
    cfg = SimConfig(dim=dim, omega0=(1.095, 1.0, 1.0)[:dim], fmm_order=p,
                    tree_radius=radius, tree_steps=16, tree_resort_every=2,
                    tree_pipeline=2)
    x_std = X_STD[:dim]
    pos, vel = ID.init_gaussian(n, x_std, tuple(
        w * x for w, x in zip(cfg.omega0, x_std)), dim=dim, seed=3)
    eng = KdFmmEngine(cfg, n, sub_depth=sub_depth)
    perm = native.kdtree_build(pos, eng.L)
    c, lb, rb, _ = native.node_geometry(pos[perm], eng.L)
    sm = auto_stale_margin(vel, cfg) if margin == "axes" else margin
    if sm is not None:
        lb = (lb - sm).astype(lb.dtype)
        rb = (rb + sm).astype(rb.dtype)
    return eng, c, lb, rb


def _sorted(m2l):
    return m2l[np.lexsort((m2l[:, 1], m2l[:, 0]))]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_frontier_matches_native(case, monkeypatch):
    dim, n, p, radius, S, coll, margin, boost, floor = CASES[case]
    eng, c, lb, rb = _geometry(dim, n, p, radius, S, margin)
    assert eng.sub_depth == S
    L = eng.L
    mf = eng.mac_mult_floor if floor == "block" else 1
    if floor == "block" and S:
        assert mf > 1
    args = (c, lb, rb, eng.st.mult, L, S, n, dim, p, radius, coll)
    kw = dict(mult_floor=mf, sub_boost=boost)
    m2l_n, near_n = native.traverse_fine(*args, **kw)
    # the tables' C entry leaves the native single pass as the
    # reference's library computes it, order and all
    m2l_j, near_j = jnative.traverse_fine(*args, **kw)
    assert np.array_equal(m2l_n, m2l_j) and np.array_equal(near_n, near_j)

    for name, value in PACKING.get(case, {}).items():
        monkeypatch.setattr(T, name, value)
    sz, pm2 = native.traverse_tables(lb, rb, eng.st.mult, L, S, n, dim, p,
                                     radius, **kw)
    m2l, near, info = T.traverse(torch.from_numpy(c), torch.from_numpy(sz),
                                 torch.from_numpy(pm2), L, S, coll)
    m2l, near = m2l.numpy().astype(np.int64), near.numpy().astype(np.int64)
    assert m2l_n.shape[0] > 0 and m2l.shape == m2l_n.shape
    assert np.array_equal(m2l, _sorted(m2l_n))
    assert np.array_equal(near, near_n)
    assert (near.shape[0] > 0) == coll
    # every unordered pair once: Kd = 2K, and the levels stay within 2L + 1
    assert info["m2l"] * 2 == m2l.shape[0]
    assert 1 <= info["levels"] <= 2 * L + 1 and info["reruns"] == 0


@pytest.mark.parametrize("entry", ["traverse", "build_host",
                                   "build_host_padded"])
def test_card_engine_raises_without_native(entry, monkeypatch):
    """Lists bound for a card never fall back to the host's numpy
    traversal: without the native library the card path raises, while a
    CPU engine still takes the numpy traversal."""
    dim, n, p, radius, S, coll, margin, boost, floor = CASES["3d-s2-plain"]
    eng, c, lb, rb = _geometry(dim, n, p, radius, S, margin)
    pos = torch.from_numpy(ID.init_gaussian(n, X_STD, X_STD, seed=3)[0])
    fs = eng.build(pos)
    ppad = eng.pad_array(pos, fs).numpy()
    calls = {
        "traverse": lambda d: eng._traverse(c, lb, rb, d),
        "build_host": lambda d: eng.build_host(pos, d),
        "build_host_padded": lambda d: eng.build_host_padded(
            ppad, fs.inv_perm.numpy(), d),
    }

    def absent(*a, **k):
        raise RuntimeError("native library absent")

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "traverse_tables", absent)
    raw, card = kdtree.raw_traversals, kdtree.device_traversals
    if entry == "traverse":
        m2l, near = calls[entry]("cpu")
        assert m2l.shape[0] > 0 and near.shape[0] > 0
        assert kdtree.raw_traversals == raw + 1
        raw += 1
    with pytest.raises(RuntimeError, match="native library absent"):
        calls[entry](torch.device("cuda", 0))
    assert kdtree.raw_traversals == raw
    assert kdtree.device_traversals == card
