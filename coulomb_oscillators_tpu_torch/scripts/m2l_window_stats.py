"""Whether a windowed M2L is possible: the spread of the source rows that
one chunk of M2L entries reads.

Twin of ``scripts/m2l_window_stats.py``.  A windowed M2L reads, for each
chunk of entries, one contiguous window of the multipole heap in place of
one row an entry; on the card the window is what one SM would hold in
shared memory.  It is possible only where the per-chunk source window
(max src - min src + 1) is bounded for real trees.  The script builds the
production entry lists of the port's kd engine, copies them to the host
and prints, as the reference does:

  * the entries per source level;
  * the windows of target-sorted chunks (the list's own order);
  * the source and target windows of source-sorted chunks;
  * the windows of chunks cut within (target level, source level)
    buckets, with the buckets' pad waste.

Every number is an integer or a ratio of integers, so each equals the
reference's on the same beam.  A chunk size with no full chunk gets a row
that says so (the reference raises there).

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.m2l_window_stats
      [n] [p] [r] [--out FILE] [--device cpu]
The rows go on lines of their own, then one ``@@`` JSON line with the rows
and the card.  The statistics are host numpy; the device builds the lists.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.scripts import _common as C

TARGET_CHUNKS = (1024, 2048, 4096, 8192)
SOURCE_CHUNKS = (2048, 8192)


def _skipped(chunk: int, order: str) -> tuple:
    return (f"chunk={chunk:5d} ({order}): skipped (K < chunk)",
            {"order": order, "chunk": chunk, "skipped": True})


def window_stats(src: np.ndarray, tgt: np.ndarray, valid: np.ndarray,
                 L: int) -> tuple:
    """The reference's lines and one dict a line from an entry list
    (source and target heap indices, validity) of a tree of level L."""
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import _heap_off
    val = valid.astype(bool)
    sv, tv = src[val], tgt[val]
    K = len(sv)
    lines, rows = [], []

    def add(line, row):
        lines.append(line)
        rows.append(row)

    offs = np.array([_heap_off(l) for l in range(L + 2)])
    lev = np.searchsorted(offs, sv, side="right") - 1
    counts = np.bincount(lev, minlength=L + 1)
    per_level = {l: int(c) for l, c in enumerate(counts) if c}
    add(f"entries per source level: {per_level}",
         {"entries_per_source_level": per_level})

    for chunk in TARGET_CHUNKS:
        nch = K // chunk
        if not nch:
            add(*_skipped(chunk, "target-sorted"))
            continue
        s2 = sv[: nch * chunk].reshape(nch, chunk)
        w = s2.max(axis=1) - s2.min(axis=1) + 1
        q = [int(np.percentile(w, x)) for x in (50, 90, 99)]
        add(f"chunk={chunk:5d} (target-sorted): window p50={q[0]} "
             f"p90={q[1]} p99={q[2]} max={int(w.max())}",
             {"order": "target-sorted", "chunk": chunk, "p50": q[0],
              "p90": q[1], "p99": q[2], "max": int(w.max())})

    order = np.argsort(sv, kind="stable")
    ss = sv[order]
    for chunk in SOURCE_CHUNKS:
        nch = K // chunk
        if not nch:
            add(*_skipped(chunk, "source-sorted"))
            continue
        s2 = ss[: nch * chunk].reshape(nch, chunk)
        w = s2.max(axis=1) - s2.min(axis=1) + 1
        t2 = tv[order][: nch * chunk].reshape(nch, chunk)
        wt = t2.max(axis=1) - t2.min(axis=1) + 1
        row = {"order": "source-sorted", "chunk": chunk,
               "src_p99": int(np.percentile(w, 99)), "src_max": int(w.max()),
               "tgt_p50": int(np.percentile(wt, 50)),
               "tgt_p99": int(np.percentile(wt, 99)),
               "tgt_max": int(wt.max())}
        add(f"chunk={chunk:5d} (source-sorted): src-window "
             f"p99={row['src_p99']} max={row['src_max']}; tgt-window "
             f"p50={row['tgt_p50']} p99={row['tgt_p99']} "
             f"max={row['tgt_max']}", row)

    # (lev_t, lev_s) buckets sorted by target: contiguous targets and
    # spatially local sources in each; chunks are padded to the buckets'
    # ends, hence the waste
    lev_t = np.searchsorted(offs, tv, side="right") - 1
    order2 = np.lexsort((sv, tv, lev, lev_t))
    s3 = sv[order2]
    t3 = tv[order2]
    key_b = lev_t[order2] * 64 + lev[order2]
    bounds = np.concatenate([[0], np.flatnonzero(np.diff(key_b)) + 1, [K]])
    nbuckets = len(bounds) - 1
    add(f"(lev_t,lev_s) buckets with entries: {nbuckets}",
         {"buckets": nbuckets})
    for chunk in TARGET_CHUNKS:
        sw, tw, padded = [], [], 0
        for b in range(nbuckets):
            lo, hi = bounds[b], bounds[b + 1]
            padded += -(-(hi - lo) // chunk) * chunk
            for c0 in range(lo, hi, chunk):
                c1 = min(c0 + chunk, hi)
                sw.append(int(s3[c0:c1].max() - s3[c0:c1].min() + 1))
                tw.append(int(t3[c0:c1].max() - t3[c0:c1].min() + 1))
        sw, tw = np.array(sw), np.array(tw)
        row = {"order": "lev-bucketed", "chunk": chunk,
               **{f"src_p{x}": int(np.percentile(sw, x))
                  for x in (50, 90, 99)},
               "src_max": int(sw.max()),
               "tgt_p99": int(np.percentile(tw, 99)),
               "tgt_max": int(tw.max()), "pad_waste": (padded - K) / K}
        add(f"chunk={chunk:5d} (lev-bucketed): src-window "
             f"p50={row['src_p50']} p90={row['src_p90']} "
             f"p99={row['src_p99']} max={row['src_max']}; tgt-window "
             f"p99={row['tgt_p99']} max={row['tgt_max']}; bucket-pad "
             f"waste={row['pad_waste']:.3f}", row)
    return lines, rows


def stats(n: int, p: int, r: float, device) -> dict:
    """Build the production lists of the beam on `device` and print their
    window statistics.  Returns the configuration, the printed lines and
    their rows."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine
    cfg = SimConfig(fmm_order=p, tree_radius=r)
    pos, _ = C.beam(n, cfg)
    eng = KdFmmEngine(cfg, n)
    fs = eng.build(torch.from_numpy(pos).to(device))
    src, tgt, val = (x.cpu().numpy() for x in (fs.m2l_src, fs.m2l_tgt,
                                                fs.m2l_valid))
    head = (f"n={n} p={p} r={r} L={eng.L} K(valid)={int(val.sum())} "
            f"cap={len(src)}")
    lines, rows = window_stats(src, tgt, val, eng.L)
    lines = [head] + lines
    for line in lines:
        print(line, flush=True)
    return {"config": {"n": n, "p": p, "r": r, "L": eng.L,
                       "K": int(val.sum()), "cap": len(src)},
            "lines": lines, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("p", nargs="?", type=int, default=6)
    ap.add_argument("r", nargs="?", type=float, default=1.43)
    ap.add_argument("--out", default=None,
                    help="write the rows to this JSON file")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = C.pick_device(args.device)
    out = dict(stats(args.n, args.p, args.r, device),
               device=C.device_info(device))
    C.emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
