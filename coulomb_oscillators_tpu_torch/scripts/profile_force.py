"""Stage-level profile of a force evaluation and of the tree rebuild.

Twin of ``scripts/profile_force.py``.  For the kd engines (``fmm3_kd``,
``fmm2_kd``) it times, with CUDA events on the card (the host clock with
``--device cpu``):

  * the full force (pad, padded force, unpad) and the padded force alone,
    the program the Simulator's window loop runs;
  * the gather-only path (perm -> pad -> unpad -> inv_perm);
  * each stage alone on padded blocks: P2M+M2M, M2L, L2L+L2P, P2P, and
    the geometry refresh; with the P2P tile count and G lane-pairs/s;
  * the steady rebuild with the engine's own breakdown;
  * the M2L mode (``CO_M2L_FLY``, read when the engine is made: fly, the
    default, or stored with ``CO_M2L_FLY=0``), the stored fold's size
    (Km x S_H x itemsize, whether or not this mode stores it) and, on the
    card, the peak of allocated device memory.  In stored mode the M2L row
    reads the stored fold and the geometry refresh row folds it again.

P2M+M2M and L2L+L2P each evaluate the leaf-frame monomials, which the
padded force evaluates once: `leaf_frame_ms` is that double count.  For
the uniform-grid engines (``fmm3``, ``fmm3_traceless``, ``appel``; the
uniform box) the stages are those of ``ops/fmm/octree.py`` and
``ops/fmm/appel.py``.

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.profile_force
      [mode] [N] [p] [r] [--engine fmm3_kd] [--out FILE] [--logdir DIR]
      [--device cpu] [--precision float64]
  mode: nothing (print the rows), `artifact` (also write the JSON record
  to --out), `all` (the rows of fmm3_kd at N, fmm2_kd at N=100k and fmm3,
  fmm3_traceless, appel at N on the uniform box), `trace` (3 padded force
  calls of --engine, fmm3_kd or fmm2_kd, under the profiler, the
  device-kernel histogram per call),
  `prodtrace` (production windows of the Simulator of --engine,
  fmm3_kd or fmm2_kd, two re-sort cycles of them under the profiler:
  device ms/step against wall ms/step, the force's stages in ms/step
  (``utils/profiling.stage``), the five longest device-idle gaps with the
  window-pipeline span the host was in and the rebuild thread's parts
  that overlap each, with the steps as CUDA graphs and then eagerly (the
  record's ``eager``); the trace holds the rebuild thread's spans beside
  the main thread's; cadence via env CO_TS / CO_RESORT / CO_PIPE, default
  16/2/2; --precision float64 runs it in double).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.scripts import _common as C
from coulomb_oscillators_tpu_torch.utils import profiling as prof

KD_STAGES = ("p2m_m2m_ms", "m2l_ms", "l2l_l2p_ms", "p2p_ms")
OCT_STAGES = ("p2m_ms", "m2m_ms", "m2l_ms", "l2l_ms", "l2p_ms", "p2p_ms")
APPEL_STAGES = ("monopoles_ms", "c2c_ms", "push_down_ms", "p2p_ms")
# the kd force's timed stages inside a Simulator step (utils/profiling.py)
STEP_STAGES = ("fmm.refresh", "fmm.upward", "fmm.m2l", "fmm.downward",
               "fmm.p2p")
N_KD2 = 100_000           # fmm2_kd's size (the ladder's config 2)


def _positions(engine: str, n: int, cfg):
    """The engine's distribution: the production beam for the kd engines
    (its first two axes in 2D), the uniform box for the grid engines."""
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    dim = cfg.dim
    if engine.endswith("_kd"):
        x = C.X_STD[:dim]
        u = tuple(w * xs for w, xs in zip(cfg.omega0, x))
        return ID.init_gaussian(n, x, u, dim=dim, dtype=np.float32)[0]
    return ID.init_uniform(n, (-0.01,) * dim, (0.01,) * dim, dim=dim)


def _config(engine: str, p: int, r: float):
    from coulomb_oscillators_tpu_torch import SimConfig
    dim = 2 if engine.startswith("fmm2") else 3
    return SimConfig(dim=dim, omega0=(1.095, 1.0, 1.0)[:dim], fmm_order=p,
                     tree_radius=r)


def kd_stages(eng, pos: torch.Tensor, fs) -> dict:
    """The kd engine's timed callables by row name, on the state `fs`."""
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR
    d = eng.dev(pos.device)
    ppad = eng.pad_array(pos, fs, fill=FAR)
    mh = eng._stage_multipoles(ppad, fs)
    lh = eng._stage_m2l(mh, fs)

    def gathers():
        flat = pos[fs.perm.long()][d.pad_gather]
        return flat[d.unpad_gather][fs.inv_perm.long()]

    return {
        "force_full_ms": lambda: eng.force(pos, fs),
        "force_padded_ms": lambda: eng.force_padded(ppad, fs),
        "gathers_ms": gathers,
        "leaf_frame_ms": lambda: eng._leaf_frame(ppad, fs),
        "p2m_m2m_ms": lambda: eng._stage_multipoles(ppad, fs),
        "m2l_ms": lambda: eng._stage_m2l(mh, fs),
        "l2l_l2p_ms": lambda: eng._stage_local(ppad, lh, fs),
        "p2p_ms": lambda: eng._stage_p2p(ppad, fs),
        "geom_refresh_ms": lambda: eng.geom_refresh(ppad, fs),
    }


def oct_stages(eng, pos: torch.Tensor, st) -> dict:
    """The octree engine's timed callables by row name."""
    mats = eng._mats(pos.dtype, pos.device)
    pos_s, e, lam_L = eng._frame(pos, st)
    M_leaf = eng._stage_p2m(e, st, mats)
    M_lvl = eng._stage_m2m(M_leaf, mats)
    L_lvl = eng._stage_m2l(M_lvl, st, mats)
    L_leaf = eng._stage_l2l(L_lvl, mats)
    return {
        "force_full_ms": lambda: eng.force(pos, st),
        "frame_ms": lambda: eng._frame(pos, st),
        "p2m_ms": lambda: eng._stage_p2m(e, st, mats),
        "m2m_ms": lambda: eng._stage_m2m(M_leaf, mats),
        "m2l_ms": lambda: eng._stage_m2l(M_lvl, st, mats),
        "l2l_ms": lambda: eng._stage_l2l(L_lvl, mats),
        "l2p_ms": lambda: eng._stage_l2p(L_leaf, e, st, lam_L),
        "p2p_ms": lambda: eng._stage_p2p(pos_s, st),
    }


def appel_stages(eng, pos: torch.Tensor, st) -> dict:
    """The Appel engine's timed callables by row name."""
    pos_s = eng._sorted(pos, st)
    q_lvl, coc_lvl = eng._stage_monopoles(pos_s, st)
    F_lvl = eng._stage_c2c(q_lvl, coc_lvl)
    return {
        "force_full_ms": lambda: eng.force(pos, st),
        "monopoles_ms": lambda: eng._stage_monopoles(pos_s, st),
        "c2c_ms": lambda: eng._stage_c2c(q_lvl, coc_lvl),
        "push_down_ms": lambda: eng._stage_push_down(F_lvl),
        "p2p_ms": lambda: eng._stage_p2p(pos_s, st),
    }


def profile_engine(engine: str, n: int, p: int, r: float, device,
                   reps: int = 5, rebuilds: int = 2) -> dict:
    """One engine's record: the stage rows (median ms), their sum against
    the whole they were cut from, and the steady rebuild."""
    from coulomb_oscillators_tpu_torch.ops.fmm import make_engine_object
    cfg = _config(engine, p, r)
    pos = torch.from_numpy(_positions(engine, n, cfg)).to(device)
    eng = make_engine_object(cfg, n, engine)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    st = eng.build(pos)
    C.sync(device)
    build_s = time.perf_counter() - t0
    kd = engine.endswith("_kd")
    if kd:
        fns, parts, whole = kd_stages(eng, pos, st), KD_STAGES, \
            "force_padded_ms"
    elif engine == "appel":
        fns, parts, whole = appel_stages(eng, pos, st), APPEL_STAGES, \
            "force_full_ms"
    else:
        fns, parts, whole = oct_stages(eng, pos, st), OCT_STAGES, \
            "force_full_ms"
    record = prof.stage_times(fns, reps, device)
    out = {"metric": "force_eval_stage_breakdown", "engine": engine,
           "config": {"n": n, "p": p, "r": r, "L": eng.L, "dim": cfg.dim},
           "device": C.device_info(device), "first_build_s": build_s,
           "stages_ms": record,
           "summary": prof.stage_summary(record, record[whole], parts)}
    if cuda:
        # the kernels' own time beside the event time: a stage whose event
        # time is far above it waits on the host's launches
        dev_ms = prof.stage_device_times(fns, device)
        out["stages_device_ms"] = dev_ms
        out["summary_device"] = prof.stage_summary(dev_ms, dev_ms[whole],
                                                   parts)
    if kd:
        out["config"]["C"] = eng.st.C
        out["counts"] = dict(eng.last_counts)
        out["m2l_fly"] = eng.m2l_fly
        out["m2l_entries"] = st.m2l_tgt.shape[0]
        out["m2l_fold_bytes"] = (st.m2l_tgt.shape[0] * eng.tables.S_H
                                 * st.center.element_size())
        # tile lane-pairs: each (sub-leaf, block) tile is C x C_blk
        q = int(st.p2p_valid.sum())
        out["p2p_tiles"] = q
        out["p2p_kind"] = ("cuda kernel" if pos.device.type == "cuda"
                           else "plain")
        out["p2p_G_lane_int_per_s"] = (q * eng.st.C * eng.C_blk
                                       / record["p2p_ms"] / 1e6)
        # the near field's share of the work a Simulator step repeats
        step = record["geom_refresh_ms"] + record["force_padded_ms"]
        out["p2p_share_of_padded_force"] = (record["p2p_ms"]
                                            / record["force_padded_ms"])
        out["p2p_share_of_refresh_plus_force"] = record["p2p_ms"] / step
    else:
        out["config"]["cell_cap"] = eng.cell_cap
    # the rebuild, repeated (steady cost)
    tt = build_s
    for _ in range(rebuilds):
        t0 = time.perf_counter()
        eng.build(pos)
        C.sync(device)
        tt = time.perf_counter() - t0
    out["rebuild_steady_ms"] = tt * 1e3
    out["rebuild_breakdown_ms"] = {
        k: v * 1e3 for k, v in getattr(eng, "last_build_times", {}).items()}
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda \
        else None
    return out


def print_record(rec: dict) -> None:
    c = rec["config"]
    mode = ""
    if "m2l_fly" in rec:
        mode = (f" m2l={'fly' if rec['m2l_fly'] else 'stored'} "
                f"fold={rec['m2l_fold_bytes'] / 2**20:.1f} MiB")
    print(f"{rec['engine']} n={c['n']} p={c['p']} r={c['r']} L={c['L']} "
          f"device={rec['device']}{mode}")
    dev_ms = rec.get("stages_device_ms", {})
    for k, v in rec["stages_ms"].items():
        d = f"   device {dev_ms[k]:9.3f} ms" if k in dev_ms else ""
        print(f"  {k:18s}: {v:9.3f} ms{d}")
    for key, what in (("summary", "stage sum"),
                      ("summary_device", "device stage sum")):
        if key in rec:
            s = rec[key]
            print(f"  {what} {s['sum_ms']:.3f} ms = "
                  f"{s['sum_over_whole']:.3f} x the whole "
                  f"({s['whole_ms']:.3f} ms); shares "
                  f"{ {k: round(v, 3) for k, v in s['share'].items()} }")
    if "p2p_tiles" in rec:
        print(f"  P2P ({rec['p2p_kind']}): {rec['p2p_tiles']} tiles, "
              f"{rec['p2p_G_lane_int_per_s']:.1f} G lane-pairs/s; share of "
              f"the padded force {rec['p2p_share_of_padded_force']:.3f}")
    bt = {k: round(v, 1) for k, v in rec["rebuild_breakdown_ms"].items()}
    peak = ("" if rec.get("peak_bytes") is None
            else f"  peak {rec['peak_bytes'] / 2**30:.3f} GiB")
    print(f"  rebuild steady {rec['rebuild_steady_ms']:.1f} ms  breakdown="
          f"{bt} (ms){peak}", flush=True)


def trace_force(n: int, p: int, r: float, device, logdir: str,
                calls: int = 3, engine: str = "fmm3_kd") -> dict:
    """`calls` chained padded force calls of the kd `engine` (``fmm3_kd``
    or ``fmm2_kd``) under the profiler; the device-kernel histogram in ms
    per call."""
    from coulomb_oscillators_tpu_torch.ops.fmm import make_engine_object
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR
    cfg = _config(engine, p, r)
    pos = torch.from_numpy(_positions(engine, n, cfg)).to(device)
    eng = make_engine_object(cfg, n, engine)
    fs = eng.build(pos)
    x = eng.pad_array(pos, fs, fill=FAR)
    x = x + eng.force_padded(x, fs) * 1e-30          # warm-up
    C.sync(device)
    with prof.trace(logdir):
        for _ in range(calls):
            x = x + eng.force_padded(x, fs) * 1e-30
        C.sync(device)
    hist = prof.op_histogram(logdir, top=None)
    tot = sum(hist.values())
    return {"metric": "padded_force_kernel_histogram", "calls": calls,
            "config": {"engine": engine, "n": n, "p": p, "r": r},
            "device": C.device_info(device),
            "device_ms_per_call": tot / calls,
            "kernels_ms_per_call": {k: v / calls for k, v in hist.items()}}


def prod_trace(n: int, p: int, r: float, device, logdir: str, ts: int = 16,
               resort: int = 2, pipeline: int = 2, graphs=None,
               engine: str = "fmm3_kd", precision: str = "float32") -> dict:
    """Production reuse windows of the kd `engine`'s Simulator
    (``fmm3_kd`` on the production beam, or ``fmm2_kd`` on its first two
    axes with ladder row 2's omega0): one untraced, then two re-sort
    cycles (2 x `resort` windows) under :func:`profiling.trace`.  The
    record: device ms/step (the sum of the kernels' durations) of the
    traced windows against the wall ms/step of the untraced one, the
    kernels by name per step, the force's stages in ms/step (their
    sampled times, :data:`STEP_STAGES`), the five longest device-idle
    gaps (:func:`idle_gaps`) and how the rebuild thread's spans were put
    on the trace's clock (``span_clock``).  `graphs` True or False runs
    the steps as CUDA graphs or eagerly (None: as ``CO_CUDA_GRAPHS``
    says); the record says which, with the captures, their seconds and
    the peak of allocated device memory over the windows.  `precision`
    "float64" runs the state and the engine in double."""
    from coulomb_oscillators_tpu_torch.scripts.stale_margin_probe import (
        cadence_config)
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
    if engine == "fmm2_kd":
        from coulomb_oscillators_tpu_torch.models import init_dist as ID
        cfg = cadence_config(p, r, ts, resort, pipeline, dim=2,
                             omega0=(1.095, 1.0))
        u = tuple(w * x for w, x in zip(cfg.omega0, C.X_STD[:2]))
        pos_h, vel_h = ID.init_gaussian(n, C.X_STD[:2], u, dim=2,
                                        dtype=np.float32)
    else:
        cfg = cadence_config(p, r, ts, resort, pipeline)
        pos_h, vel_h = C.beam(n, cfg)
    if precision == "float64":
        cfg = cfg.replace(precision="float64")
        pos_h, vel_h = pos_h.astype(np.float64), vel_h.astype(np.float64)
    with C.graphs_env(graphs):
        sim = Simulator(cfg, n, engine=engine)
    cuda = torch.device(device).type == "cuda"
    try:
        st = sim.init_acc(particle_state_from_numpy(pos_h, vel_h,
                                                    device=device))
        st = sim.run(st, 2)
        st = sim.run(st, 2)
        for _ in range(3):
            sim.advance_padded(2 * ts)
            C.sync(device)
        # wall time from an untraced window (the profiler slows the
        # host's launches), device time from the traced one after it
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        sim.advance_padded(ts)
        C.sync(device)
        wall = time.perf_counter() - t0
        steps = 2 * max(1, resort) * ts
        prof.reset()
        with prof.trace(logdir):
            t0 = time.perf_counter()
            sim.advance_padded(steps)
            C.sync(device)
            wall_traced = time.perf_counter() - t0
        margin = np.asarray(sim._fmm.stale_margin_abs).tolist()
        fly = sim._fmm.m2l_fly
        rebuilds = dict(sim.rebuilds)
        info = C.graph_info(sim)
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
    finally:
        sim.close()      # reads the step graph's last stage sample
    totals = prof.totals()
    hist = prof.op_histogram(logdir, top=None)
    tot = sum(hist.values())
    top = dict(list(hist.items())[:40])
    path = os.path.join(logdir, prof.TRACE_FILE)
    with open(path) as f:
        clock = json.load(f)["programSpans"]
    return {"metric": "production_window_trace",
            "config": {"engine": engine, "precision": precision,
                       "n": n, "p": p, "r": r, "ts": ts,
                       "resort_every": resort, "pipeline": pipeline,
                       "stale_margin": margin, "m2l_fly": fly},
            "device": C.device_info(device), "window_wall_s": wall,
            "traced_steps": steps,
            "wall_ms_per_step": wall / ts * 1e3,
            "traced_wall_ms_per_step": wall_traced / steps * 1e3,
            "device_ms_per_step": tot / steps,
            "stage_ms_per_step": {k: prof.per_step_ms(totals, k)
                                  for k in STEP_STAGES},
            "stage_samples_missed": totals.get(
                "stage.samples_missed", {}).get("count", 0),
            "idle_gaps": idle_gaps(path),
            "span_clock": clock,
            "rebuilds": rebuilds, **info, "peak_bytes": peak,
            "top_ops_ms_per_step": {k: v / steps for k, v in top.items()}}


def idle_gaps(path: str, top: int = 5) -> list:
    """The `top` longest gaps between the device's intervals in the
    Chrome trace at `path` (a :func:`profiling.trace`), longest first,
    each with the innermost main-thread span at its middle (``host``) and
    the ms by which each rebuild-thread span overlaps it (``rebuild``)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("cat") in prof.DEVICE_CATEGORIES)
    merged = []
    for a, b in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)),
                  key=lambda g: g[0] - g[1])[:top]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") == "user_annotation"]
    rebuild = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
               for e in events if e.get("cat") == prof.SPAN_CATEGORY]
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [h for h in host if h[0] <= mid < h[1]]
        parts = {}
        for s0, s1, name in rebuild:
            ov = min(b, s1) - max(a, s0)
            if ov > 0:
                parts[name] = parts.get(name, 0.0) + ov / 1e3
        out.append({"ms": (b - a) / 1e3,
                    "host": (min(inside, key=lambda h: h[1] - h[0])[2]
                             if inside else None),
                    "rebuild": parts})
    return out


def print_histogram(rec: dict, per: str, key: str) -> None:
    tot = sum(rec[key].values())
    print(f"--- {rec['metric']} (ms per {per}) ---")
    for name, ms in list(rec[key].items())[:40]:
        print(f"{ms:9.3f}  {100 * ms / max(tot, 1e-9):5.1f}%  {name[:100]}")
    sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("args", nargs="*",
                    help="[artifact|all|trace|prodtrace] [N] [p] [r]")
    ap.add_argument("--engine", default="fmm3_kd",
                    choices=("fmm3_kd", "fmm2_kd", "fmm3", "fmm3_traceless",
                             "appel"))
    ap.add_argument("--out", default=None,
                    help="write the JSON record to this file")
    ap.add_argument("--logdir", default=None,
                    help="trace directory (a temporary one otherwise)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None)
    ap.add_argument("--precision", default="float32",
                    choices=("float32", "float64"),
                    help="prodtrace: the state's and engine's dtype")
    a = ap.parse_args(argv)
    pos_args = list(a.args)
    mode = ""
    if pos_args and pos_args[0] in ("artifact", "all", "trace", "prodtrace"):
        mode = pos_args.pop(0)
    if mode == "artifact" and not a.out:
        ap.error("artifact needs --out FILE")
    n = int(pos_args[0]) if len(pos_args) > 0 else 1_000_000
    p = int(pos_args[1]) if len(pos_args) > 1 else (6 if mode == "prodtrace"
                                                    else 3)
    r = float(pos_args[2]) if len(pos_args) > 2 else (
        1.43 if mode == "prodtrace" else 1.7)
    device = C.pick_device(a.device)
    with tempfile.TemporaryDirectory() as tmp:
        logdir = a.logdir or tmp
        if mode in ("trace", "prodtrace") and not a.engine.endswith("_kd"):
            ap.error(f"{mode} takes --engine fmm3_kd or fmm2_kd")
        if mode == "trace":
            out = trace_force(n, p, r, device, logdir, engine=a.engine)
            print_histogram(out, "call", "kernels_ms_per_call")
        elif mode == "prodtrace":
            # the steps as CUDA graphs (a user's run), then eagerly
            cad = (int(os.environ.get("CO_TS", "16")),
                   int(os.environ.get("CO_RESORT", "2")),
                   int(os.environ.get("CO_PIPE", "2")))
            recs = [prod_trace(n, p, r, device,
                               os.path.join(logdir, tag), *cad, graphs=g,
                               engine=a.engine, precision=a.precision)
                    for tag, g in (("graph", True), ("eager", False))]
            out = dict(recs[0], eager=recs[1])
            for rec in recs:
                print(f"production window (graphs={rec['graphs']}, "
                      f"captures {rec['captures']} in "
                      f"{rec['capture_s']:.2f} s): wall "
                      f"{rec['wall_ms_per_step']:.2f} ms/step untraced "
                      f"({rec['traced_wall_ms_per_step']:.2f} traced), "
                      f"device {rec['device_ms_per_step']:.2f} ms/step; "
                      f"stages (ms/step) {rec['stage_ms_per_step']}, "
                      f"{rec['stage_samples_missed']} samples missed")
                print(f"  idle gaps: {rec['idle_gaps']}")
                print(f"  rebuild spans on the trace's clock: "
                      f"{rec['span_clock']}")
                print_histogram(rec, "step", "top_ops_ms_per_step")
        elif mode == "all":
            # ladder 2's fmm2_kd (p=4, r=2), the rest at (p, r)
            out = {"records": [
                profile_engine("fmm3_kd", n, p, r, device, a.reps),
                profile_engine("fmm2_kd", min(n, N_KD2), 4, 2.0, device,
                               a.reps),
                profile_engine("fmm3", n, p, 1.0, device, a.reps),
                profile_engine("fmm3_traceless", n, p, 1.0, device, a.reps),
                profile_engine("appel", n, p, 1.0, device, a.reps)]}
            for rec in out["records"]:
                print_record(rec)
        else:
            out = profile_engine(a.engine, n, p, r, device, a.reps)
            print_record(out)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {a.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
