"""Time the kd engine's dual-tree MAC traversal on the card beside the
native host traversal it replaces there, and hold both to the same lists.

Cases: ``1m``, the production beam at N = 1M (p = 6, r = 1.67, sub-leaf
boost 1.5, the auto stale margin of the 16/2/2 cadence); ``30001``, the
CLI's configuration (p = 3, r = 1.0, the auto margin of 8/1/1);
``2d_1m`` and ``2d_30001``, fmm2_kd on the 2D Gaussian beam at ladder row
2's order and radius (p = 4, r = 2, the auto margin of 8/1/1), which run
the kernel's dim-2 instantiation.  For each case, on the same inflated
node bounds: the native ``traverse_fine`` on the host
(``KdFmmEngine._traverse`` without a device); the engine's card path end
to end (``_traverse`` on the card: the native tables, their upload, the
frontier, the device lists, until its stream has ended them); the
frontier alone (``traverse.frontier_cuda``, CUDA events, buffers already
sized) beside its byte bound; the list step alone
(``traverse.directed_lists``); with ``--plain`` the plain version
(``traverse.frontier_plain``) on the same card tensors, timed by CUDA
events, and the lists made from its pairs; the counts; and the peak
device memory of one card traversal (its buffers sized by an earlier
one) over what was allocated before it.  ``near`` must equal the
native's element for element and ``m2l`` after a (target, source) sort,
for the card path and for the plain version, else the script exits 1.

    python -m coulomb_oscillators_tpu_torch.scripts.traverse_bench \\
        [1m] [30001] [2d_1m] [2d_30001] [--reps 5] [--plain] [--out FILE]

Prints one JSON row per case and the card's name and power limit; runs on
a CUDA card only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from coulomb_oscillators_tpu_torch import SimConfig, native
from coulomb_oscillators_tpu_torch.ops.fmm import traverse as T
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine
from coulomb_oscillators_tpu_torch.scripts import _common
from coulomb_oscillators_tpu_torch.simulate import auto_stale_margin

CASES = {
    "1m": (1_000_000, dict(fmm_order=6, tree_radius=1.67, mac_sub_boost=1.5,
                           tree_steps=16, tree_resort_every=2,
                           tree_pipeline=2)),
    "30001": (30001, dict(tree_steps=8, tree_resort_every=1,
                          tree_pipeline=1)),
    "2d_1m": (1_000_000, dict(dim=2, omega0=(1.095, 1.0), fmm_order=4,
                              tree_radius=2.0)),
    "2d_30001": (30001, dict(dim=2, omega0=(1.095, 1.0), fmm_order=4,
                             tree_radius=2.0)),
}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet


def _sorted(m2l):
    return m2l[np.lexsort((m2l[:, 1], m2l[:, 0]))]


def _median_s(fn, reps):
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def _events_ms(fn, reps, dev):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def _beam(n, cfg):
    """The production Gaussian beam in 3D (``_common.beam``), its first
    two axes in 2D."""
    if cfg.dim == 3:
        return _common.beam(n, cfg)
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    x_std = _common.X_STD[:2]
    u = tuple(w * x for w, x in zip(cfg.omega0, x_std))
    return ID.init_gaussian(n, x_std, u, dim=2, dtype=np.float32)


def run_case(name, reps, plain, dev):
    n, kw = CASES[name]
    cfg = SimConfig(**kw)
    pos, vel = _beam(n, cfg)
    eng = KdFmmEngine(cfg, n)
    eng.stale_margin_abs = auto_stale_margin(vel, cfg)
    perm = native.kdtree_build(pos, eng.L)
    c, lb, rb, _ = native.node_geometry(pos[perm], eng.L)
    L, S = eng.L, eng.sub_depth

    m2l_n, near_n = eng._traverse(c, lb, rb)
    native_s = _median_s(lambda: eng._traverse(c, lb, rb), reps)
    def card():
        lists = eng._traverse(c, lb, rb, dev)
        T.side_stream(dev).synchronize()
        return lists

    card()                                            # sizes the buffers
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    m2l_c, near_c = card()
    scratch = torch.cuda.max_memory_allocated(dev) - before
    card_s = _median_s(card, reps)
    m2l_c, near_c = (x.cpu().numpy().astype(np.int64) for x in card())
    same = (np.array_equal(near_c, near_n)
            and np.array_equal(m2l_c, _sorted(m2l_n)))

    lbi, rbi = eng.inflated_bounds(lb, rb)
    sz, pm2 = native.traverse_tables(
        lbi, rbi, eng.st.mult, L, S, n, eng.dim, eng.p, cfg.tree_radius,
        mult_floor=eng.mac_mult_floor, sub_boost=eng.mac_sub_boost)
    ct, szt, pmt = (torch.from_numpy(np.ascontiguousarray(x, np.float32))
                    .to(dev) for x in (c, sz, pm2))
    caps = dict(eng._card.caps)
    launches = T.launches
    m2l_u, near_u, info = T.frontier_cuda(ct, szt, pmt, L, caps)
    levels = T.launches - launches
    frontier_ms = _events_ms(lambda: T.frontier_cuda(ct, szt, pmt, L, caps),
                             reps, dev)
    lists_ms = _events_ms(lambda: T.directed_lists(m2l_u, near_u.clone(), L,
                                                   S, cfg.coll), reps, dev)
    # the frontier's bytes: every visited pair read once (8 B), every pair
    # but the root written once as a child (8 B), every M2L and near pair
    # written once (8 B), the tables read once
    tables = ct.numel() * 4 + 2 * szt.numel() * 4
    nbytes = (8 * (2 * info["visited"] - 1 + info["m2l"] + info["near"])
              + tables)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"case": name, "n": n, "dim": eng.dim, "L": L, "sub_depth": S,
           "equal": same,
           "native_s": native_s, "card_s": card_s,
           "frontier_ms": frontier_ms, "lists_ms": lists_ms,
           "levels": levels, "visited": info["visited"],
           "largest_frontier": info["largest"], "m2l_pairs": info["m2l"],
           "near_pairs": info["near"], "m2l_directed": int(m2l_c.shape[0]),
           "near_entries": int(near_c.shape[0]), "frontier_bytes": nbytes,
           "frontier_bound_ms": bound_ms,
           "frontier_share": bound_ms / frontier_ms,
           "scratch_peak_bytes": int(scratch), "reruns": info["reruns"]}
    del m2l_u, near_u
    if plain:
        row["plain_frontier_ms"] = _events_ms(
            lambda: T.frontier_plain(ct, szt, pmt, L), reps, dev)
        m2l_u, near_u, _ = T.frontier_plain(ct, szt, pmt, L)
        m2l_p, near_p = T.directed_lists(m2l_u, near_u, L, S, cfg.coll)
        row["plain_equal"] = (
            np.array_equal(near_p.cpu().numpy().astype(np.int64), near_n)
            and np.array_equal(m2l_p.cpu().numpy().astype(np.int64),
                               _sorted(m2l_n)))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cases", nargs="*", default=list(CASES))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    dev = _common.pick_device()
    torch.set_num_threads(1)
    rows = []
    for name in a.cases:
        row = run_case(name, a.reps, a.plain, dev)
        print(json.dumps(row), flush=True)
        rows.append(row)
    info = _common.device_info(dev)
    print(json.dumps(info))
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"rows": rows, "device": info}, f, indent=1)
    ok = all(r["equal"] and r.get("plain_equal", True) for r in rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
