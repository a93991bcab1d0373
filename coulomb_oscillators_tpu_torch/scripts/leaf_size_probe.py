"""Near- and far-field pair counts and the implied P2P lane work against
the tree level L.

Twin of ``scripts/leaf_size_probe.py``.  For each L it builds the kd tree
with the native library (``native.kdtree_build``, ``node_geometry``) and
runs the engine's traversal (``KdFmmEngine._traverse``), and prints the
leaf capacity C, the P2P and M2L counts, the targets' partner degree, the
physical near-field interactions (the sum of mult_i x mult_j) and the lane
work for tiles of 128 x 128 slots and of C x C (C rounded up to 8).

The near list holds dual-granularity entries (target sub-leaf, packed
source block ``blk | mask << mask_shift``, one mask bit a sub-leaf of the
block; ``ops/fmm/kdtree.py:_fine_lists``): `phys` decodes them.  Every
column comes from the node counts and the traversal, so it does not
depend on the padding of C.

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.leaf_size_probe
      [n] [p] [r] [--out FILE] [--device cpu]
The rows go on lines of their own, then one ``@@`` JSON line with the rows
and the card.  The build runs on the host; the device only names the card
beside the numbers.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from coulomb_oscillators_tpu_torch.scripts import _common as C

LEVELS = (12, 13, 14, 15, 16)


def level_row(eng, pos_h: np.ndarray) -> dict:
    """One row for the engine's level: the native build, geometry and
    traversal of `pos_h` (host float32 [n, 3]), with its host seconds."""
    from coulomb_oscillators_tpu_torch import native
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import _heap_off
    L, n = eng.L, eng.n
    t0 = time.perf_counter()
    perm = native.kdtree_build(pos_h, L)
    c_h, lb_h, rb_h, _ = native.node_geometry(pos_h[perm], L)
    m2l, p2p = eng._traverse(c_h, lb_h, rb_h)
    dt = time.perf_counter() - t0
    G = 1 << L
    Cn = -(-n // G)
    mult = eng.st.mult[_heap_off(L):].astype(np.int64)
    S = eng.sub_depth
    ti = p2p[:, 0].astype(np.int64)
    v = p2p[:, 1].astype(np.int64) & 0xFFFFFFFF
    shift = eng.mask_shift
    blk = v & ((1 << shift) - 1)
    bits = (v[:, None] >> shift >> np.arange(1 << S)) & 1     # [q, nsub]
    src_sub = (blk[:, None] << S) + np.arange(1 << S)
    src_mult = (bits * mult[np.minimum(src_sub, G - 1)]).sum(axis=1)
    q = p2p.shape[0]
    deg = np.bincount(ti, minlength=G)
    Cpad = -(-Cn // 8) * 8
    return {"L": L, "C": Cn, "sub_depth": S, "p2p": q,
            "m2l": int(m2l.shape[0]),
            "deg_mean": float(deg.mean()), "deg_max": int(deg.max()),
            "phys": int(np.sum(mult[ti] * src_mult)),
            "lane128": q * 128 * 128, "laneC": q * Cpad * Cpad,
            "build_s": dt}


def probe(n: int, p: int, r: float, levels=LEVELS, pos=None) -> list:
    """One :func:`level_row` a level of `levels` on the production beam
    (or on `pos`, a host float32 array)."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine
    cfg = SimConfig(fmm_order=p, tree_radius=r)
    if pos is None:
        pos, _ = C.beam(n, cfg)
    pos = np.ascontiguousarray(pos, dtype=np.float32)
    rows = []
    for L in levels:
        row = level_row(KdFmmEngine(cfg, n, L=L), pos)
        rows.append(row)
        print(f"L={L:2d} C={row['C']:4d} p2p={row['p2p']:8d} "
              f"m2l={row['m2l']:8d} deg(mean/max)={row['deg_mean']:6.1f}/"
              f"{row['deg_max']:5d} phys={row['phys'] / 1e9:6.2f}G "
              f"lane128={row['lane128'] / 1e9:7.1f}G "
              f"laneC={row['laneC'] / 1e9:7.1f}G "
              f"build={row['build_s']:5.1f}s", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("p", nargs="?", type=int, default=5)
    ap.add_argument("r", nargs="?", type=float, default=2.0)
    ap.add_argument("--out", default=None,
                    help="write the rows to this JSON file")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = C.pick_device(args.device)
    rows = probe(args.n, args.p, args.r, LEVELS)
    out = {"config": {"n": args.n, "p": args.p, "r": args.r},
           "device": C.device_info(device), "rows": rows}
    C.emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
