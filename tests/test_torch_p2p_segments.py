"""The dim-2 P2P kernel's work decomposition and summation order, on the
CPU: ``p2p_cuda.segment_plan`` (the torch code the wrapper runs before
each launch) read as the kernel reads it, and a plain emulation of the
kernel's order of sums (segments of at most K entries, then their partials
added highest segment first) against the plain version and against the
reference's jnp near-field scan (coulomb_oscillators_tpu/ops/fmm/kdtree.py,
``_stage_p2p`` with ``use_pallas=False``).  The kernel itself runs on the
card only (tests/test_torch_p2p_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu.models import init_dist as JID
from coulomb_oscillators_tpu.ops.fmm.kdtree import (FAR as JFAR,
                                                    KdFmmEngine as JEngine)
from coulomb_oscillators_tpu_torch import SimConfig as TConfig
from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (
    KdFmmEngine, fmm_state_from_numpy)
from test_torch_capture_lint import _Recorder
from test_torch_kdtree import _np_state
from torch_p2p_lists import p2p_segments, rel_dev, segment_items, synthetic

torch.set_num_threads(1)

EPS2 = 1e-18
X_STD = (0.003, 0.001, 0.01)


@pytest.mark.parametrize("K", [1, 4, 16, 32])
@pytest.mark.parametrize("nsub,CB", [(4, 128), (1, 256), (2, 256)])
def test_plan_covers_every_entry_once_in_row_order(nsub, CB, K):
    """Every valid entry of every (row, tile) is in exactly one item, the
    items of a row's tile cover [0, degree) in order, a row of more than K
    entries is cut into segments of exactly K (the last one shorter or
    equal), an empty row is one item of no entries, and each segment's
    item comes after the one it waits for (segment s after s + 1)."""
    pos, rp, col = synthetic(nsub, CB, Gb=24, seed=K + CB, long_row=1600,
                             dim=2, degrees=(1, K, K + 1, 2 * K, 2 * K + 1))
    dmax = col.shape[1]
    ntile = CB // nsub // 32
    work = p2p_cuda.segment_plan(torch.from_numpy(rp), dmax, ntile, K)
    R = rp.shape[0] - 1
    assert work.dtype == torch.int32 and work.shape == (R + 2 + R * ntile,)
    assert not work[R + 1:].any()            # the kernel's counters
    items = segment_items(work.numpy(), rp, dmax, ntile, K)
    deg = np.clip(np.diff(rp), 0, dmax)
    seen = {}
    for i, (row, tile, seg, n, e0, e1) in enumerate(items):
        assert (row, tile, seg) not in seen
        seen[row, tile, seg] = i
        assert n == max(1, -(-int(deg[row]) // K))
        assert 0 <= seg < n and e1 - e0 <= K
        assert e1 - e0 == (K if seg < n - 1 else int(deg[row]) - (n - 1) * K)
    for row in range(R):
        n = max(1, -(-int(deg[row]) // K))
        for tile in range(ntile):
            segs = [items[seen[row, tile, s]] for s in range(n)]
            covered = [e for it in segs for e in range(it[4], it[5])]
            assert covered == list(range(int(deg[row])))
            for s in range(n - 1):           # waits point backwards
                assert seen[row, tile, s] > seen[row, tile, s + 1]
    assert len(items) == len(seen) == sum(
        max(1, -(-int(d) // K)) for d in deg) * ntile


def test_plan_shape_depends_on_shapes_only():
    """Two lists of one shape with different degrees give plans of one
    shape (the kernel's grid and buffers never wait on the device)."""
    a = synthetic(4, 128, Gb=24, seed=1, dim=2)[1]
    b = synthetic(4, 128, Gb=24, seed=2, long_row=90, dim=2)[1]
    assert not np.array_equal(np.diff(a), np.diff(b))
    pa = p2p_cuda.segment_plan(torch.from_numpy(a), 128, 1, 16)
    pb = p2p_cuda.segment_plan(torch.from_numpy(b), 128, 1, 16)
    assert pa.shape == pb.shape and not torch.equal(pa, pb)


def test_plan_is_capture_clean():
    """segment_plan runs no operation that waits for the device or makes
    a data-dependent shape (the capture lint's FORBIDDEN list), copies
    nothing across devices, and no sort (no block_order)."""
    rp = torch.from_numpy(synthetic(4, 128, Gb=24, seed=3, long_row=300,
                                    dim=2)[1])
    with _Recorder() as rec:
        p2p_cuda.segment_plan(rp, 384, 1, 16)
    names = {op[0] for op in rec.ops}
    assert not rec.bad, rec.bad
    assert not names & {"sort", "argsort", "index_add", "index_add_"}, names


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("nsub,CB", [(4, 128), (1, 256)])
def test_segment_order_matches_plain(nsub, CB, K, dtype):
    """The kernel's order of sums emulated in plain torch, on lists whose
    longest row (1,600 entries; 120 at K = 1) spans many segments: within
    1e-6 of max|a| of the float64 entry-by-entry sum in float32 (1e-12 in
    float64), and within 1e-5 (1e-12) of p2p_plain.  Against p2p_plain
    itself 1e-6 cannot hold in float32: its one running sum over the long
    row is 1.8-3.4e-6 of max|a| from the float64 sum on these lists, and
    the segmented sum 1.7-8.6e-7."""
    from torch_p2p_lists import brute
    pos, rp, col = synthetic(nsub, CB, Gb=12, dtype=dtype, seed=5 * K + CB,
                             long_row=1600 if K > 1 else 120, dim=2,
                             degrees=(K, K + 1))
    args = (torch.from_numpy(pos), torch.from_numpy(rp),
            torch.from_numpy(col), nsub, EPS2)
    got = p2p_segments(*args, K)
    plain = p2p_cuda.p2p_plain(*args)
    f32 = dtype == np.float32
    assert got.dtype == plain.dtype
    assert rel_dev(got.numpy(), brute(pos, rp, col, nsub, EPS2)) <= (
        1e-6 if f32 else 1e-12)
    assert rel_dev(got.numpy(), plain.double().numpy()) <= (
        1e-5 if f32 else 1e-12)


@pytest.mark.parametrize("K", [2, 8])
@pytest.mark.parametrize("n,p", [(1500, 3), (4096, 4)],
                         ids=["n1500p3", "n4096p4"])
def test_segment_order_matches_reference_scan(n, p, K):
    """The emulated segment order on an fmm2_kd state (the 2D beam and
    fmm2_kd's config) against the reference's jnp scan with weight r^2
    (kdtree.py:1596-1639) on the same padded positions and state, within
    1e-5 of max|a|, as the plain version is held
    (test_torch_kdtree.py::test_plain_p2p_matches_reference_scan_2d).  The
    reference engine is built with use_pallas=True, so that its layout is
    the port's, then switched to its scan branch; K = 2 splits most rows."""
    cfg = dict(dim=2, omega0=(1.095, 1.0), fmm_order=p, tree_radius=2.0)
    u = tuple(w * x for w, x in zip(cfg["omega0"], X_STD[:2]))
    pos, _ = JID.init_gaussian(n, X_STD[:2], u, dim=2)
    jeng = JEngine(JConfig(**cfg), n, use_pallas=True)
    jfs = jeng.build(jnp.asarray(pos))
    ppad_j = jeng.pad_array(jnp.asarray(pos), jfs, fill=JFAR)
    jeng.use_pallas = False            # the scan branch, same layout
    ref = np.asarray(jeng._stage_p2p(ppad_j, jfs))
    teng = KdFmmEngine(TConfig(**cfg), n)
    fs = fmm_state_from_numpy(_np_state(jfs), "cpu")
    pblk = torch.tensor(np.asarray(ppad_j)).reshape(teng.G_blk, teng.C_blk,
                                                    2)
    deg = np.diff(fs.p2p_row_ptr.numpy())
    assert deg.max() > K                # some row is cut into segments
    got = p2p_segments(pblk, fs.p2p_row_ptr, fs.p2p_col2d, teng.nsub,
                       teng.config.eps2, K).reshape(ref.shape).numpy()
    scale = np.linalg.norm(ref, axis=-1).max()
    dev = np.linalg.norm(got - ref, axis=-1).max() / scale
    assert dev <= 1e-5, dev
