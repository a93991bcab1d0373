"""The kd engine's list layout (``kdtree.layout_sizes`` / ``layout_fill``
through ``KdFmmEngine._lists_to_state``) against the NumPy layout it
replaced and against the reference engine's.

The tensor layout runs on whatever device its lists are on: on a card for
the card traversal's lists, on the CPU here.  Each case feeds one
engine's native-traversal lists, build after build, to

  * the engine itself, as host int64 arrays (what a CPU engine gets);
  * a second engine, as int32 tensors (what the card's traversal hands
    over), so that the card path's input runs here too;
  * ``_numpy_layout``, a frozen copy of the NumPy layout the port used
    before the tensor one, carrying its own caps;
  * the reference engine (``use_pallas=True``, the port's one layout),
    with an empty near list its ``use_pallas=False`` build: its CSR
    sizing needs a near list.

Every list field must be equal element for element, the caps and
``near_cap`` equal to the NumPy policy's after every build.  The growth
case steps the MAC radius up so that the M2L cap, the P2P cap and dmax
grow.
"""

import numpy as np
import pytest
import torch

from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu.ops.fmm.kdtree import KdFmmEngine as JEngine
from coulomb_oscillators_tpu_torch import SimConfig as TConfig
from coulomb_oscillators_tpu_torch import native
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.ops.fmm import kdtree
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine

torch.set_num_threads(1)

X_STD = (0.003, 0.001, 0.01)
LIST_FIELDS = ("m2l_tgt", "m2l_src", "m2l_valid", "m2l_gtgt", "p2p_tgt",
               "p2p_src", "p2p_valid", "p2p_row_ptr", "p2p_col2d")
CSR_FIELDS = ("p2p_row_ptr", "p2p_col2d")

# name: (dim, n, p, CO_M2L_GROUP or None for the default 8, coll, radii)
CASES = {
    "3d-grouped": (3, 4096, 4, None, True, (2.0,)),
    "3d-ungrouped": (3, 4096, 4, "1", True, (2.0,)),
    "2d-fmm2_kd": (2, 4096, 4, None, True, (2.0,)),
    "3d-empty-near": (3, 4096, 4, None, False, (2.0,)),
    "3d-growth": (3, 50_000, 3, None, True, (1.0, 2.0, 2.2)),
}


def _numpy_layout(caps: dict, near_cap: int, m2l: np.ndarray,
                  p2p: np.ndarray, L: int, G_blk: int, g: int):
    """The port's NumPy list layout before the tensor one, kept as it was
    (caps updated in place): (fields, near_cap)."""
    Mheap = (1 << (L + 1)) - 1
    G = 1 << L
    tgt = m2l[:, 0].astype(np.int64)
    deg = np.bincount(tgt, minlength=Mheap)
    pdeg = -(-deg // g) * g
    off = np.zeros(Mheap + 1, np.int64)
    np.cumsum(pdeg, out=off[1:])
    rp = np.zeros(Mheap + 1, np.int64)
    np.cumsum(deg, out=rp[1:])
    posn = np.arange(m2l.shape[0], dtype=np.int64)
    posn += np.repeat(off[:-1] - rp[:-1], deg)
    k2 = int(off[-1])
    for name, klen, q, hr in (("m2l", k2, 65536, 1.08),
                              ("p2p", p2p.shape[0], 8192, 1.25)):
        if klen > caps[name]:
            grown = -(-(caps[name] * 5 // 4) // q) * q
            caps[name] = max(max(q, -(-int(klen * hr) // q) * q),
                             grown if caps[name] else 0)
    if p2p.shape[0] > near_cap:
        near_cap = min(caps["p2p"], -(-int(p2p.shape[0] * 1.25) // 256) * 256)
    cap = caps["m2l"]
    m2l_t = np.full(cap, Mheap, dtype=np.int32)
    m2l_s = np.zeros(cap, dtype=np.int32)
    m2l_v = np.zeros(cap, dtype=bool)
    m2l_t[posn] = m2l[:, 0]
    m2l_s[posn] = m2l[:, 1]
    m2l_v[posn] = True
    m2l_gt = (m2l_t.reshape(-1, g).min(axis=1) if g > 1
              else np.zeros(1, dtype=np.int32))
    k = p2p.shape[0]
    p2p_t = np.full(caps["p2p"], G, dtype=np.int32)
    p2p_s = np.zeros(caps["p2p"], dtype=np.int32)
    p2p_v = np.zeros(caps["p2p"], dtype=bool)
    p2p_t[:k] = p2p[:, 0]
    p2p_s[:k] = p2p[:, 1]
    p2p_v[:k] = True
    row_ptr = np.searchsorted(p2p[:, 0], np.arange(G + 1),
                              side="left").astype(np.int32)
    degrees = np.diff(row_ptr)
    dmax = int(degrees.max()) if degrees.size else 1
    if "dmax" not in caps or dmax > caps["dmax"]:
        grown = caps.get("dmax", 0) * 5 // 4
        caps["dmax"] = max(128, -(-max(int(dmax * 1.25), grown) // 128) * 128)
    dmax = caps["dmax"]
    col = np.full((G + 1, dmax), G_blk, np.int32)
    ranks = np.clip(np.arange(k) - row_ptr[p2p[:, 0].astype(np.int64)], 0,
                    dmax - 1)
    col[p2p[:, 0].astype(np.int64), ranks] = p2p[:, 1]
    return dict(m2l_tgt=m2l_t, m2l_src=m2l_s, m2l_valid=m2l_v,
                m2l_gtgt=m2l_gt, p2p_tgt=p2p_t, p2p_src=p2p_s,
                p2p_valid=p2p_v, p2p_row_ptr=row_ptr,
                p2p_col2d=col[:G]), near_cap


@pytest.mark.parametrize("case", list(CASES))
def test_layout_equals_numpy_and_reference(case, monkeypatch):
    dim, n, p, group, coll, radii = CASES[case]
    for k in ("CO_M2L_GROUP", "CO_STALE_MARGIN", "CO_SUB_BOOST"):
        monkeypatch.delenv(k, raising=False)
    if group is not None:
        monkeypatch.setenv("CO_M2L_GROUP", group)
    omega0 = (1.095, 1.0, 1.0)[:dim]
    kw = dict(dim=dim, omega0=omega0, fmm_order=p, coll=coll)
    x_std = X_STD[:dim]
    pos, _ = ID.init_gaussian(n, x_std, x_std, seed=5, dim=dim,
                              dtype=np.float32)
    engs = [KdFmmEngine(TConfig(**kw, tree_radius=radii[0]), n)
            for _ in range(2)]
    eng = engs[0]
    jeng = JEngine(JConfig(**kw, tree_radius=radii[0]), n,
                   use_pallas=coll)
    assert jeng.L == eng.L and jeng.m2l_group == eng.m2l_group
    L, g = eng.L, eng.m2l_group
    perm = native.kdtree_build(pos, L)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=perm.dtype)
    c, lb, rb, lam = native.node_geometry(pos[perm], L)
    caps, near_cap = dict(eng.caps), eng.near_cap
    host0 = kdtree.host_layouts
    grew = {"m2l": False, "p2p": False, "dmax": False}
    last = None
    for r in radii:
        for e in engs:
            e.config = e.config.replace(tree_radius=r)
        jeng.config = jeng.config.replace(tree_radius=r)
        m2l, near = eng._traverse(c, lb, rb)
        assert m2l.dtype == np.int64 and m2l.shape[0] > 0
        assert (near.shape[0] > 0) == coll
        want, near_cap = _numpy_layout(caps, near_cap, m2l, near, L,
                                       eng.G_blk, g)
        got = [eng._lists_to_state(perm, inv, c, lam, m2l, near, {}),
               engs[1]._lists_to_state(
                   perm, inv, c, lam,
                   torch.from_numpy(m2l.astype(np.int32)),
                   torch.from_numpy(near.astype(np.int32)), {})]
        ref = jeng._lists_to_state(perm, inv, c, lam, m2l, near, {})
        for fs, e in zip(got, engs):
            assert e.caps == caps and e.near_cap == near_cap
            assert e.last_counts == {"m2l": m2l.shape[0],
                                     "p2p": near.shape[0]}
            assert torch.equal(fs.perm, torch.from_numpy(perm))
            assert torch.equal(fs.inv_perm, torch.from_numpy(inv))
            for f in LIST_FIELDS:
                a = getattr(fs, f).numpy()
                assert a.dtype == want[f].dtype, f
                assert np.array_equal(a, want[f]), f
                if coll or f not in CSR_FIELDS:
                    assert np.array_equal(a, np.asarray(getattr(ref, f))), f
        assert {k: v for k, v in jeng.caps.items()
                if coll or k != "dmax"} == {
            k: v for k, v in caps.items() if coll or k != "dmax"}
        if last is not None:
            grew = {k: grew[k] or caps[k] > last[k] for k in grew}
        last = dict(caps)
    assert kdtree.host_layouts == host0 + 2 * len(radii)
    if len(radii) > 1:
        assert all(grew.values()), grew
