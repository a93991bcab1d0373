"""M2L by part: where the stored-fold stage's time goes on the card, and
whether a grouped dense-reduce beats the per-entry scatter.

Twin of ``scripts/m2l_micro.py``.  The engine is built in stored mode
(``CO_M2L_FLY=0``, set only around its construction), so the stage reads
the stored fold and its time is the contraction alone.  Variants, in the
reference's order, each over the production entry list in the engine's
chunks (``KdFmmEngine._m2l_chunk``) unless said otherwise:

  full       the production ``_stage_m2l``: on a card the M2L kernel
             (``csrc/m2l.cu``), one launch; on the CPU the plain loop
  plain      the plain loop (``KdFmmEngine.m2l_plain``) on the same
             device: row gather, ``m2l_sparse_pre``, a dense-reduce of each
             group of ``CO_M2L_GROUP`` entries and the sorted ``index_add_``
  gather     the multipole row gather alone, summed
  gather64   the same from a heap copied into zeroed rows of 64 floats
  gather128  ... of 128 floats (a 53-float row is 212 B and straddles
             32-byte sectors; 64 floats are 256 B, aligned); the copy is
             inside the timed call
  gathersrt  ``gather`` with each chunk's source indices sorted (what a
             source-major layout buys the gather)
  compute    gather + ``m2l_sparse_pre``, summed, no scatter
  segsum     gather + a trivial value an entry (the multipole row's first
             min(S_M, S_Lt) columns, zero-padded to S_Lt, times w, plus
             H2's first S_Lt) + the sorted ``index_add_``: no FMAs
  grouped<g> entries re-padded per target to multiples of g (host index
             arithmetic, payload moved on the device), dense-reduced by
             g, then a g-times-smaller ``index_add_``; with its pad waste

Each float32 variant is held against what it must equal, max |dev| /
max |ref| <= 1e-5, and a miss raises: ``plain`` and ``grouped*`` against
``full``,
``compute`` against ``full.sum(0)``, ``gather*`` against the gathered
rows' sum (a count of each source row times the heap, in float64),
``segsum`` against its own value summed in float64.  Each row carries the
bytes its gather must read (rows x row width x 4) and their floor at the
card's HBM rate (``utils/roofline.py``); the stage's own floor, from the
list's valid entries, is printed first (:func:`stage_floor`).

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.m2l_micro [n] [p] [r]
      [--reps R] [--out FILE] [--device cpu]
The rows go on lines of their own, then one ``@@`` JSON line with the rows
and the card.  On the CPU the times are the host's (``host_ms``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.scripts import _common as C

TOL = 1e-5
PAD_WIDTHS = (64, 128)
GROUPS = (8, 16, 32)
F32 = 4


class Variant(NamedTuple):
    """A nullary variant, the rows and row width its gather reads, the
    name of its identity in :func:`identities` ("" for none) and the
    facts of its layout."""
    fn: Callable[[], torch.Tensor]
    gather_rows: int
    row_floats: int
    ref: str
    info: dict


def stored_engine(n: int, p: int, r: float, device):
    """The kd engine at (p, r) in stored mode, its state on the beam and
    the multipole heap [Mheap, S_M]."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
    cfg = SimConfig(fmm_order=p, tree_radius=r)
    pos, _ = C.beam(n, cfg)
    with C.m2l_env(False):
        eng = KdFmmEngine(cfg, n)
    x = torch.from_numpy(pos).to(device)
    fs = eng.build(x)
    mh = eng._stage_multipoles(eng.pad_array(x, fs, fill=FAR), fs)
    return eng, fs, mh


def valid_entries(fs):
    """Host arrays of the valid entries in list order: (index, target,
    source), int64."""
    val = fs.m2l_valid.cpu().numpy()
    idx = np.flatnonzero(val)
    return (idx, fs.m2l_tgt.cpu().numpy()[idx].astype(np.int64),
            fs.m2l_src.cpu().numpy()[idx].astype(np.int64))


def payload(fs, entry: np.ndarray):
    """The stored fold (H2, w, logc) and the validity of a layout whose
    slot k holds list entry `entry[k]` (-1: a pad slot, zeros)."""
    dev = fs.m2l_h2.device
    keep = torch.from_numpy(entry >= 0).to(dev)
    take = torch.from_numpy(entry[entry >= 0]).to(dev)
    out = []
    for x in (fs.m2l_h2, fs.m2l_w, fs.m2l_logc):
        y = x.new_zeros((len(entry),) + tuple(x.shape[1:]))
        y[keep] = x[take]
        out.append(y)
    return (*out, keep)


def pad_runs(keys: np.ndarray, g: int, chunk: int, fill: int):
    """The reference's host arithmetic for a grouped layout: each run of
    equal values in the sorted `keys` padded to a multiple of g slots, the
    whole padded to whole chunks.  Returns each key's slot, the key of
    each group of g slots (`fill` for the all-pad groups at the end), the
    padded runs' length K2 and K2p, K2 in whole chunks."""
    uniq, start, deg = np.unique(keys, return_index=True, return_counts=True)
    pdeg = -(-deg // g) * g
    K2 = int(pdeg.sum())
    K2p = -(-K2 // chunk) * chunk
    off = np.zeros(len(uniq) + 1, np.int64)
    np.cumsum(pdeg, out=off[1:])
    slot = np.arange(len(keys), dtype=np.int64) \
        + np.repeat(off[:-1] - start, deg)
    gkey = np.full(K2p // g, fill, np.int32)
    gkey[: K2 // g] = np.repeat(uniq, pdeg // g)
    return slot, gkey, K2, K2p


def _grouped_layout(fs, Mheap: int, g: int, chunk: int):
    """The valid entries re-padded per target to multiples of g: each
    slot's list entry (-1: pad), its source, the group targets (Mheap: an
    all-pad group), the grouped count K2 and its length K2p padded to
    whole chunks."""
    idx, tgt_v, src_v = valid_entries(fs)
    slot, gta, K2, K2p = pad_runs(tgt_v, g, chunk, Mheap)
    entry = np.full(K2p, -1, np.int64)
    entry[slot] = idx
    src2 = np.zeros(K2p, np.int32)
    src2[slot] = src_v
    return entry, src2, gta, K2, K2p


def variants(eng, fs, mh) -> Dict[str, Variant]:
    """The study's variants on the stored-mode state `fs` and the heap
    `mh`, as nullary functions in the reference's order."""
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import _heap_off
    from coulomb_oscillators_tpu_torch.ops.multipole import operators as mop
    t = eng.tables
    S_M, S_Lt = t.S_M, t.S_Lt
    Mheap = _heap_off(eng.L + 1)
    K = fs.m2l_tgt.shape[0]
    chunk = eng._m2l_chunk(K)
    cuts = [slice(c, c + chunk) for c in range(0, K, chunk)]
    src = [fs.m2l_src[s] for s in cuts]
    vv = [fs.m2l_valid[s][:, None] for s in cuts]
    ta = [torch.where(fs.m2l_valid[s], fs.m2l_tgt[s], Mheap) for s in cuts]
    fold = [(fs.m2l_h2[s], fs.m2l_w[s], fs.m2l_logc[s]) for s in cuts]
    src_sorted = [torch.sort(b).values for b in src]
    out = {}

    def gather(idx, width=None):
        def run():
            h = mh
            if width is not None:
                h = mh.new_zeros(Mheap, width)
                h[:, :S_M] = mh
            acc = mh.new_zeros(S_M)
            for b in idx:
                acc += h.index_select(0, b)[:, :S_M].sum(dim=0)
            return acc
        return run

    def compute():
        acc = mh.new_zeros(S_Lt)
        for b, v, f in zip(src, vv, fold):
            acc += (mop.m2l_sparse_pre(t, mh.index_select(0, b), *f)
                    * v).sum(dim=0)
        return acc

    def segsum():
        m = min(S_M, S_Lt)
        acc = mh.new_zeros(Mheap + 1, S_Lt)
        for b, v, a, (H2, w, _) in zip(src, vv, ta, fold):
            La = mh.index_select(0, b)[:, :m]
            La = torch.nn.functional.pad(La, (0, S_Lt - m)) * w[:, None] \
                + H2[:, :S_Lt]
            acc.index_add_(0, a, La * v)
        return acc[:Mheap]

    out["full"] = Variant(lambda: eng._stage_m2l(mh, fs), K, S_M, "", {})
    out["plain"] = Variant(lambda: eng.m2l_plain(mh, fs), K, S_M, "full", {})
    out["gather"] = Variant(gather(src), K, S_M, "gather", {})
    for w in PAD_WIDTHS:
        out[f"gather{w}"] = Variant(gather(src, w), K, w, "gather", {})
    out["gathersrt"] = Variant(gather(src_sorted), K, S_M, "gather", {})
    out["compute"] = Variant(compute, K, S_M, "full_sum", {})
    out["segsum"] = Variant(segsum, K, S_M, "segsum", {})

    # the grouped layouts' chunk: the engine's, a multiple of every g
    gchunk = -(-chunk // max(GROUPS)) * max(GROUPS)
    nval = max(1, int(fs.m2l_valid.sum()))
    for g in GROUPS:
        entry, src2, gta, K2, K2p = _grouped_layout(fs, Mheap, g, gchunk)
        H2, w, logc, keep = payload(fs, entry)
        src2 = torch.from_numpy(src2).to(mh.device)
        gta = torch.from_numpy(gta).to(mh.device)

        def grouped(g=g, H2=H2, w=w, logc=logc, keep=keep, src2=src2,
                    gta=gta, K2p=K2p):
            acc = mh.new_zeros(Mheap + 1, S_Lt)
            for c in range(0, K2p, gchunk):
                s = slice(c, c + gchunk)
                La = mop.m2l_sparse_pre(t, mh.index_select(0, src2[s]),
                                        H2[s], w[s], logc[s])
                La = (La * keep[s, None]).reshape(-1, g, S_Lt).sum(dim=1)
                acc.index_add_(0, gta[c // g:(c + gchunk) // g], La)
            return acc[:Mheap]
        out[f"grouped{g}"] = Variant(grouped, K2p, S_M, "full",
                                     {"K2": K2, "K2p": K2p,
                                      "group_waste": K2 / nval,
                                      "pad_waste": K2p / nval})
    return out


def identities(eng, fs, mh, full: torch.Tensor) -> dict:
    """What each kind of variant must equal, in float64: the production
    stage, its sum over targets, the sum of every gathered row (a count of
    each source row times the heap), and segsum's value computed over the
    whole list at once."""
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import _heap_off
    t = eng.tables
    Mheap = _heap_off(eng.L + 1)
    h = mh.double()
    m = min(t.S_M, t.S_Lt)
    La = torch.nn.functional.pad(h.index_select(0, fs.m2l_src)[:, :m],
                                 (0, t.S_Lt - m)) \
        * fs.m2l_w.double()[:, None] + fs.m2l_h2[:, :t.S_Lt].double()
    seg = h.new_zeros(Mheap + 1, t.S_Lt).index_add_(
        0, torch.where(fs.m2l_valid, fs.m2l_tgt, Mheap),
        La * fs.m2l_valid[:, None])
    counts = torch.bincount(fs.m2l_src.long(), minlength=Mheap)
    return {"full": full.double(), "full_sum": full.double().sum(dim=0),
            "gather": counts.double() @ h, "segsum": seg[:Mheap]}


def rel_dev(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref| in float64."""
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


def run_variants(named: Dict[str, Variant], refs: dict, device,
                 reps: int) -> list:
    """Evaluate each variant once and hold it against its identity, time
    it (``_common.time_variants``) and print its row.  Returns the rows;
    raises after the last row if a trace lost its kernels
    (``_common.check_traces``) or a float32 variant missed TOL."""
    from coulomb_oscillators_tpu_torch.utils import roofline
    rows, missed = [], []
    times = C.time_variants({k: v.fn for k, v in named.items()}, device,
                            reps)
    for name, v in named.items():
        got = v.fn()
        gbytes = v.gather_rows * v.row_floats * F32
        row = {"name": name, **times[name],
               "gather_bytes": gbytes,
               "floor_ms": gbytes / roofline.HBM_BYTES * 1e3,
               "finite": bool(torch.isfinite(got).all()), **v.info}
        if v.ref:
            row["rel_dev"] = rel_dev(got, refs[v.ref])
            row["vs"] = v.ref
            if v.info.get("dtype") != "bfloat16" and not (
                    row["rel_dev"] <= TOL and row["finite"]):
                missed.append(f"{name} {row['rel_dev']:.3e} vs {v.ref}")
        rows.append(row)
        print(format_row(row), flush=True)
    C.check_traces(times)
    if missed:
        raise RuntimeError(f"variants off their identity by more than "
                           f"{TOL}: {missed}")
    return rows


def format_row(row: dict) -> str:
    if "event_ms" in row:
        t = (f"{row['event_ms']:9.3f} ms events {row['kernel_ms']:9.3f} ms "
             f"kernels  extra {row['extra_bytes'] / 2**20:8.1f} MiB")
    else:
        t = f"{row['host_ms']:9.3f} ms (host clock)"
    s = (f"{row['name']:<11s}: {t}  gather {row['gather_bytes'] / 1e6:9.1f}"
         f" MB floor {row['floor_ms']:7.3f} ms")
    if "rel_dev" in row:
        s += f"  max rel dev vs {row['vs']}: {row['rel_dev']:.2e}"
        if row.get("dtype"):
            s += f" ({row['dtype']})"
    if "K2" in row:
        s += (f"  (K2={row['K2p']}, pad-waste x{row['pad_waste']:.2f}; "
              f"groups alone {row['K2']}, x{row['group_waste']:.2f})")
    return s


def full_kernels(fn, device, top: int = 12) -> dict:
    """On the card, the kernel ms by name of one traced call of `fn` (the
    production stage), largest first, printed; None on the CPU."""
    import tempfile
    from coulomb_oscillators_tpu_torch.utils import profiling as prof
    if torch.device(device).type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        with prof.trace(tmp):
            fn()
        hist = prof.op_histogram(tmp, top=top)
    for name, ms in hist.items():
        print(f"  full kernel {ms:8.3f} ms  {name[:100]}", flush=True)
    return hist


def stage_floor(eng, fs) -> dict:
    """The least time the card could take for the stage on this list
    (``utils/roofline.py``): its valid entries' inputs read once (the
    heap, the stored fold, target and source indices) and the local heap
    written once, over the HBM rate; its operations over the float32 peak
    (sparse forms: 3 flops a table term an entry, a product and a fused
    multiply-add; dense forms: the H2 @ W product and the contraction)."""
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import _heap_off
    from coulomb_oscillators_tpu_torch.ops.multipole import operators as mop
    from coulomb_oscillators_tpu_torch.utils import roofline
    t = eng.tables
    Mheap = _heap_off(eng.L + 1)
    kv = int(fs.m2l_valid.sum())
    nbytes = F32 * (Mheap * (t.S_M + t.S_Lt) + kv * (t.S_H + 2 + 2))
    if t.p > mop.SPARSE_P_MAX:
        flops = 2 * kv * t.S_Lt * t.S_M * (t.S_H + 1)
    else:
        flops = 3 * kv * int(np.count_nonzero(t.m2l_coef))
    byte_ms = nbytes / roofline.HBM_BYTES * 1e3
    flop_ms = flops / roofline.FP32_FLOPS * 1e3
    return {"entries": kv, "bytes": nbytes, "flops": flops,
            "byte_ms": byte_ms, "flop_ms": flop_ms,
            "bound_ms": max(byte_ms, flop_ms),
            "bound_by": "bytes" if byte_ms >= flop_ms else "operations"}


def study(n: int, p: int, r: float, device, reps: int = 5) -> dict:
    """The whole study: the stored-mode engine, every variant timed,
    checked and printed.  Returns the configuration and the rows."""
    eng, fs, mh = stored_engine(n, p, r, device)
    t = eng.tables
    K = fs.m2l_tgt.shape[0]
    print(f"n={n} p={p} r={r} K(cap)={K} count={eng.last_counts['m2l']} "
          f"chunk={eng._m2l_chunk(K)} S_M={t.S_M} S_H={t.S_H} "
          f"S_Lt={t.S_Lt}", flush=True)
    floor = stage_floor(eng, fs)
    print(f"stage floor: {floor['entries']} valid entries, "
          f"{floor['bytes'] / 1e6:.1f} MB {floor['byte_ms']:.3f} ms, "
          f"{floor['flops'] / 1e9:.2f} GFLOP {floor['flop_ms']:.3f} ms: "
          f"{floor['bound_ms']:.3f} ms by {floor['bound_by']}", flush=True)
    named = variants(eng, fs, mh)
    refs = identities(eng, fs, mh, named["full"].fn())
    rss = C.host_rss()
    print(f"host RSS after the layouts: {rss / 2**30:.3f} GiB", flush=True)
    rows = run_variants(named, refs, device, reps)
    kernels = full_kernels(named["full"].fn, device)
    return {"config": {"n": n, "p": p, "r": r, "L": eng.L, "K": K,
                       "count": eng.last_counts["m2l"],
                       "chunk": eng._m2l_chunk(K), "S_M": t.S_M,
                       "S_H": t.S_H, "S_Lt": t.S_Lt, "reps": reps},
            "stage_floor": floor, "full_kernels": kernels,
            "host_rss_bytes": rss, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("p", nargs="?", type=int, default=6)
    ap.add_argument("r", nargs="?", type=float, default=1.67)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="write the rows to this JSON file")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = C.pick_device(args.device)
    out = dict(study(args.n, args.p, args.r, device, args.reps),
               device=C.device_info(device))
    C.emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
