"""Source-major M2L layouts on the card: a windowed gather and a
source-broadcast gather, against the production stage.

Twin of ``scripts/m2l_micro2.py``.  ``m2l_window_stats`` shows that only
SOURCE-major chunks of entries read bounded windows of the multipole heap;
a window of Ws rows of S_M floats is what one SM would hold in shared
memory.  The engine is built in stored mode (``CO_M2L_FLY=0``, set only
around its construction).  Variants, in the reference's order:

  full        the production ``_stage_m2l``
  winchunk    the valid entries source-major, cut into chunks of `chunk`
              and re-sorted by target within each; a chunk's multipole
              rows are one contiguous window [slo, slo + Ws) of the heap
              and a one-hot product (``torch.matmul``, float32) picks each
              entry's row from it: no row gather; then ``m2l_sparse_pre``
              and the sorted ``index_add_``.  Chunks run in batches
              (``torch.matmul`` over a batch axis) of the engine's loop
              size, with the one-hot operands under 256 MiB
  winchunk_bf the same with both operands of the one-hot product cast to
              bfloat16 (the reference's ``Precision.DEFAULT``, one
              bfloat16 pass on the TPU): its deviation is reported and
              labelled, not bounded
  srcbcast<g> each source's run padded to a multiple of g; one row gather
              for every g entries, broadcast in registers; the FMAs;
              summed, no scatter

Held, max |dev| / max |ref| <= 1e-5, a miss raises: ``winchunk`` against
``full``, ``srcbcast*`` against ``full.sum(0)``.  The first line is the
reference's window line: K (valid entries), chunk, nch, the largest
window and Ws (it rounded up to 128 rows).

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.m2l_micro2 [n] [p] [r]
      [chunk] [--reps R] [--out FILE] [--device cpu]
The rows go on lines of their own, then one ``@@`` JSON line with the rows
and the card.  On the CPU the times are the host's (``host_ms``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.scripts import _common as C
from coulomb_oscillators_tpu_torch.scripts import m2l_micro as MM

GROUPS = (8, 16)
ONEHOT_BYTES = 1 << 28


def window_layout(src_v: np.ndarray, tgt_v: np.ndarray, Mheap: int,
                  chunk: int) -> dict:
    """The winchunk layout of valid entries (sources, targets, int64, in
    list order): source-major, padded to whole chunks with the last
    source (so that windows stay tight) and the dropped target Mheap,
    re-sorted by target within each chunk.  Returns K, nch, the largest
    window, Ws, each chunk's first row `slo`, and per slot the row within
    the window, the target and the valid entry (-1: pad)."""
    K = len(src_v)
    order = np.lexsort((tgt_v, src_v))              # src major, tgt minor
    Kp = -(-K // chunk) * chunk
    nch = Kp // chunk
    s2 = np.zeros(Kp, np.int64)
    t2 = np.full(Kp, Mheap, np.int64)
    e2 = np.full(Kp, -1, np.int64)
    s2[:K], t2[:K], e2[:K] = src_v[order], tgt_v[order], order
    s2[K:] = s2[K - 1] if K else 0
    slo = s2.reshape(nch, chunk).min(axis=1)
    win = int((s2.reshape(nch, chunk).max(axis=1) - slo + 1).max())
    Ws = -(-win // 128) * 128
    s_loc = s2 - np.repeat(slo, chunk)
    # the window is a set property of the chunk: order within it is free
    o2 = np.lexsort((s2, t2, np.repeat(np.arange(nch), chunk)))
    return {"K": K, "chunk": chunk, "nch": nch, "max_window": win, "Ws": Ws,
            "slo": slo, "s_loc": s_loc[o2], "tgt": t2[o2], "entry": e2[o2]}


def window_line(w: dict) -> str:
    return (f"K={w['K']} chunk={w['chunk']} nch={w['nch']} "
            f"max-window={w['max_window']} Ws={w['Ws']}")


def bcast_layout(src_v: np.ndarray, g: int, chunk: int):
    """The srcbcast layout of valid entries: source-major, each source's
    run padded to a multiple of g, the whole to whole chunks.  Returns
    the row of each group of g slots, the valid entry of each slot (-1:
    pad), the padded runs' length K2 and K2p, K2 padded to whole
    chunks."""
    order = np.argsort(src_v, kind="stable")
    slot, rows, K2, K2p = MM.pad_runs(src_v[order], g, chunk, 0)
    entry = np.full(K2p, -1, np.int64)
    entry[slot] = order
    return rows, entry, K2, K2p


def variants(eng, fs, mh, chunk: int) -> tuple:
    """(window layout, the study's variants on the stored-mode state `fs`
    and heap `mh` in the reference's order)."""
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import _heap_off
    from coulomb_oscillators_tpu_torch.ops.multipole import operators as mop
    t = eng.tables
    S_M, S_Lt = t.S_M, t.S_Lt
    Mheap = _heap_off(eng.L + 1)
    dev = mh.device
    idx, tgt_v, src_v = MM.valid_entries(fs)
    loop = eng._m2l_chunk(fs.m2l_tgt.shape[0])     # the engine's loop size
    out: Dict[str, MM.Variant] = {
        "full": MM.Variant(lambda: eng._stage_m2l(mh, fs),
                           fs.m2l_tgt.shape[0], S_M, "", {})}

    w = window_layout(src_v, tgt_v, Mheap, chunk)
    Ws, nch = w["Ws"], w["nch"]
    H2, wv, logc, _ = MM.payload(fs, np.where(w["entry"] >= 0,
                                              idx[w["entry"]], -1))
    slo = torch.from_numpy(w["slo"]).to(dev)
    s_loc = torch.from_numpy(w["s_loc"]).to(dev).reshape(nch, chunk)
    ta = torch.from_numpy(w["tgt"]).to(dev)
    per = max(1, min(loop // chunk, ONEHOT_BYTES // (chunk * Ws * 4)))
    iota = torch.arange(Ws, device=dev)

    def winchunk(cast=None):
        def run():
            hpad = torch.cat([mh, mh.new_zeros(Ws, S_M)])
            acc = mh.new_zeros(Mheap + 1, S_Lt)
            for c0 in range(0, nch, per):
                c1 = min(c0 + per, nch)
                onehot = (s_loc[c0:c1, :, None] == iota).to(mh.dtype)
                rows = hpad[slo[c0:c1, None] + iota]     # [b, Ws, S_M]
                if cast is None:
                    MbX = torch.matmul(onehot, rows)
                else:
                    MbX = torch.matmul(onehot.to(cast),
                                       rows.to(cast)).to(mh.dtype)
                e = slice(c0 * chunk, c1 * chunk)
                La = mop.m2l_sparse_pre(t, MbX.reshape(-1, S_M), H2[e],
                                        wv[e], logc[e])
                acc.index_add_(0, ta[e], La)
            return acc[:Mheap]
        return run

    info = {"max_window": w["max_window"], "Ws": Ws, "nch": nch,
            "window_bytes": Ws * S_M * 4}
    out["winchunk"] = MM.Variant(winchunk(), nch * Ws, S_M, "full", info)
    out["winchunk_bf"] = MM.Variant(winchunk(torch.bfloat16), nch * Ws, S_M,
                                    "full", dict(info, dtype="bfloat16"))

    for g in GROUPS:
        rows, entry, K2, K2p = bcast_layout(src_v, g, chunk)
        H2b, wb, lgb, keep = MM.payload(fs, np.where(entry >= 0,
                                                     idx[entry], -1))
        rows = torch.from_numpy(rows).to(dev)
        span = chunk * max(1, loop // chunk)

        def srcbcast(g=g, rows=rows, H2b=H2b, wb=wb, lgb=lgb, keep=keep,
                     K2p=K2p, span=span):
            acc = mh.new_zeros(S_Lt)
            for c in range(0, K2p, span):
                e = slice(c, c + span)
                Mrows = mh.index_select(0, rows[c // g:(c + span) // g])
                MbX = Mrows[:, None, :].expand(-1, g, S_M).reshape(-1, S_M)
                La = mop.m2l_sparse_pre(t, MbX, H2b[e], wb[e], lgb[e])
                acc += (La * keep[e, None]).sum(dim=0)
            return acc
        out[f"srcbcast{g}"] = MM.Variant(
            srcbcast, K2p // g, S_M, "full_sum",
            {"K2": K2, "K2p": K2p, "group_waste": K2 / max(1, w["K"]),
             "pad_waste": K2p / max(1, w["K"])})
    return w, out


def study(n: int, p: int, r: float, chunk: int, device,
          reps: int = 5) -> dict:
    """The whole study: the stored-mode engine, its window line, every
    variant timed, checked and printed.  Returns the configuration, the
    window facts and the rows."""
    eng, fs, mh = MM.stored_engine(n, p, r, device)
    w, named = variants(eng, fs, mh, chunk)
    print(window_line(w), flush=True)
    full = named["full"].fn()
    refs = {"full": full.double(), "full_sum": full.double().sum(dim=0)}
    rss = C.host_rss()
    print(f"host RSS after the layouts: {rss / 2**30:.3f} GiB", flush=True)
    rows = MM.run_variants(named, refs, device, reps)
    t = eng.tables
    return {"config": {"n": n, "p": p, "r": r, "chunk": chunk, "L": eng.L,
                       "S_M": t.S_M, "S_H": t.S_H, "S_Lt": t.S_Lt,
                       "reps": reps},
            "window": {k: w[k] for k in ("K", "chunk", "nch", "max_window",
                                         "Ws")},
            "host_rss_bytes": rss, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("p", nargs="?", type=int, default=6)
    ap.add_argument("r", nargs="?", type=float, default=1.43)
    ap.add_argument("chunk", nargs="?", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="write the rows to this JSON file")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = C.pick_device(args.device)
    out = dict(study(args.n, args.p, args.r, args.chunk, device, args.reps),
               device=C.device_info(device))
    C.emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
