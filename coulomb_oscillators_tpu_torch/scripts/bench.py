"""Benchmark of the port: prints ONE JSON line with the flagship metric.

Twin of the repository's root ``bench.py``, in one process.  Headline: 3D
kd-tree FMM particle-steps/s at N = 1M on one card, leapfrog, the tree
rebuilt every `tree_steps` steps by the asynchronous pipeline, at matched
accuracy: the mean relative force error against the Kahan direct oracle
on 2048 seeded targets is at most 1e-3 on a fresh tree, and over every
measured step of the reuse windows one full re-sort serves (the window
ladder, measured in this run by ``stale_margin_probe.window_ladder`` on
`resort_every` consecutive windows).

Order of work, headline first:

  1. the oracle forces of the 2048 targets, once;
  2. the tuned start point (``DEFAULT_TUNED`` or ``--tuned FILE``): an
     error and cost probe, then the production timing at the tuned cadence
     (tree_steps 16, a full re-sort every 2 boundaries, pipeline depth 2)
     followed by the window ladder on the same run; an over-bound start
     point falls back to a stiffer sub-leaf MAC and then a larger radius;
  3. the same configuration timed at the config's default cadence
     (tree_steps 8, a re-sort every boundary, depth 1);
  4. refinement under a wall-clock budget (env ``CO_BENCH_BUDGET_S``,
     default 2400 s; skipped by ``--quick``): candidates near the tuned
     point are probed, and one that leaves window headroom and scores
     better than 0.95 x the tuned score gets a production timing and its
     own ladder;
  5. (skipped by ``--quick``) the winner timed again at both cadences with
     its steps run eagerly (``CO_CUDA_GRAPHS=0``).

The Simulator runs its steps as CUDA graphs on the card unless
``CO_CUDA_GRAPHS=0`` is set: the headline, its window ladder (the
certification) and the default cadence run so.

The line's fields are the root bench's, without its ratio to an earlier
run, plus ``extra.default_cadence``, ``extra.rebuild_s``,
``extra.rebuild_breakdown_s``, ``extra.boundary_wait_s``,
``extra.certified`` and ``extra.device`` (the card's nvidia-smi name and
power limit, the torch and CUDA versions), ``graphs`` (whether the
headline's steps ran as CUDA graphs) with ``extra.captures``,
``extra.capture_s``, ``extra.peak_bytes`` and ``extra.peak_reserved_bytes``
(allocated and reserved device memory over the timed windows), and in full mode ``extra.eager`` (both cadences timed
eagerly).  A headline whose fresh-tree
error or window error is above the bound says ``"certified": false`` and
why.  No file is read or written unless ``--tuned``, ``--save-tuned`` or
``--oracle-cache`` name one.

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.bench [--quick]
      [--n N] [--tuned FILE] [--save-tuned FILE] [--oracle-cache DIR]
      [--device cpu]
  ... bench probe P R BOOST      one probe row
  ... bench fullgrid             the reference grid p 1-6 x r descending x
                                 boost descending (manual, unbudgeted)
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.scripts import _common as C
from coulomb_oscillators_tpu_torch.scripts import stale_margin_probe as SP

ERR_BOUND = 1e-3           # reference default (main3.cu:236-237)
N_HEAD = 1_000_000
SEARCH_P = [1, 2, 3, 4, 5, 6]
SEARCH_R = [1.11, 1.25, 1.43, 1.67, 2.0, 2.5, 3.0]
# third grid axis: the sub-block MAC acceptance-radius boost.  A lower boost
# is a looser sub-leaf MAC: less near-field work, more error; descending
# from the accuracy-safe default stops at the first over-bound value.
SEARCH_BOOST = [1.5, 1.3, 1.15, 1.0]

DEFAULT_TUNED = {"p": 6, "r": 1.67, "boost": 1.5,
                 # production rebuild cadence: window length, FULL re-sorts
                 # every K boundaries (refreshes between), adoption
                 # pipeline depth
                 "tree_steps": 16, "resort_every": 2, "pipeline": 2}
# the config's own defaults (config.py)
DEFAULT_CADENCE = {"tree_steps": 8, "resort_every": 1, "pipeline": 1}
# refinement candidates probed after the tuned headline exists, in order
REFINE = [
    {"p": 6, "r": 1.43, "boost": 1.5},
    {"p": 5, "r": 1.43, "boost": 1.5},
    {"p": 6, "r": 1.67, "boost": 1.3},
    {"p": 5, "r": 2.0, "boost": 1.5},
    {"p": 4, "r": 2.0, "boost": 1.3},
]
# a refinement candidate needs this much room under the bound for the
# error's growth inside a window, and this much better a score
WINDOW_HEADROOM = 1.5
SCORE_GATE = 0.95
WINDOW_STEPS = 16          # steps per timed window
# a timing block's CUDA-graph facts (scripts/_common.py:graph_info) and
# its peaks of allocated and of reserved device memory (a graph's pool is
# reserved; its replays allocate nothing)
GRAPH_KEYS = ("graphs", "captures", "capture_s", "peak_bytes",
              "peak_reserved_bytes")


def _budget_s() -> float:
    return float(os.environ.get("CO_BENCH_BUDGET_S", "2400"))


def load_tuned(path=None) -> dict:
    """The start point: ``DEFAULT_TUNED``, or the fields a file gives."""
    tuned = dict(DEFAULT_TUNED)
    if path:
        with open(path) as f:
            t = json.load(f)
        tuned.update(p=int(t["p"]), r=float(t["r"]),
                     boost=float(t.get("boost", 1.5)),
                     tree_steps=int(t.get("tree_steps", 8)),
                     resort_every=int(t.get("resort_every", 1)),
                     pipeline=int(t.get("pipeline", 2)))
        if "builder" in t:
            tuned["builder"] = str(t["builder"])
    return tuned


def cadence_of(d: dict) -> dict:
    return {"tree_steps": int(d.get("tree_steps", 8)),
            "resort_every": int(d.get("resort_every", 1)),
            "pipeline": int(d.get("pipeline", 2)),
            "builder": d.get("builder", "host")}


def _score(row, tree_steps):
    """Production cost proxy: frozen-tree force + amortized rebuild."""
    return row["force_s"] + row.get("rebuild_s", 0.0) / max(tree_steps, 1)


def refine_gate(prow, ref_score, tree_steps):
    """Whether a probed refinement candidate earns a production timing:
    (go, why).  It must be under the bound with room for the error's
    growth inside a window, and score under 0.95 x the reference score."""
    if "force_s" not in prow:
        return False, "over bound"
    if prow["err"] * WINDOW_HEADROOM > ERR_BOUND:
        return False, (f"err {prow['err']:.2e} leaves no window headroom")
    sc = _score(prow, tree_steps)
    if not sc < SCORE_GATE * ref_score:
        return False, (f"score {sc:.4f} not under {SCORE_GATE} x "
                       f"{ref_score:.4f}")
    return True, f"score {sc:.4f} under {SCORE_GATE} x {ref_score:.4f}"


def certify(err, ladders) -> tuple:
    """(certified, reason): the fresh-tree error, and the mean and every
    measured step of each window ladder, are within the bound."""
    if not err <= ERR_BOUND:
        return False, f"fresh-tree error {err:.3e} above {ERR_BOUND}"
    if not ladders:
        return False, "no window ladder measured"
    for w, ladder in enumerate(ladders):
        worst = max(ladder.values())
        mean = float(np.mean(list(ladder.values())))
        if not mean <= ERR_BOUND:
            return False, (f"window-mean error {mean:.3e} above "
                           f"{ERR_BOUND} (window {w} of the cycle)")
        if not worst <= ERR_BOUND:
            return False, (f"window step error {worst:.3e} above "
                           f"{ERR_BOUND} (window {w} of the cycle)")
    return True, ""


def _same(a, b) -> bool:
    return all(a.get(k) == b.get(k) for k in ("p", "r", "boost"))


def _emit(best, n, integrator, probes, finals, default_cadence=None,
          device=None, note="", counters=None, eager=None) -> dict:
    """The bench's one JSON object from the winner's timing block `best`
    (p, r, boost, err, cadence, times, windows, ladders, margin).
    ``graphs`` says whether the headline's steps ran as CUDA graphs;
    `eager`, in full mode, holds the same configuration timed eagerly at
    both cadences."""
    med = best["median"]
    cad = best["cadence"]
    # interaction rates: counts per force evaluation from the winner's
    # probe row, over the production median s/step (one evaluation a step)
    prow = next((q for q in probes if _same(q, best)
                 and "p2p_phys_int" in q), None)
    rates = {}
    if prow:
        rates = {
            "p2p_phys_Gint_per_s": prow["p2p_phys_int"] / med / 1e9,
            "p2p_lane_Gint_per_s": prow["p2p_lane_int"] / med / 1e9,
            "m2l_Mtrans_per_s": prow["m2l_entries"] / med / 1e6,
            "p2p_phys_int_per_eval": prow["p2p_phys_int"],
            "p2p_lane_int_per_eval": prow["p2p_lane_int"],
            "m2l_entries_per_eval": prow["m2l_entries"],
        }
    ladders = best.get("ladders") or []
    certified, reason = certify(best["err"], ladders)
    # the cycle's worst window stands for it
    ladder = max(ladders, key=lambda d: max(d.values())) if ladders else {}
    wins = best.get("windows", [])
    extra = {
        "n": n, "p": best["p"], "r": best["r"],
        "sub_boost": best.get("boost", 1.5),
        "force_rel_err": best["err"], "err_bound": ERR_BOUND,
        "sec_per_step_median": med, "sec_per_step_all": best["times"],
        "tree_steps": cad["tree_steps"], "integrator": integrator,
        "resort_every": cad["resort_every"], "pipeline": cad["pipeline"],
        "builder": cad.get("builder", "host"),
        # per-step error ladder across one reuse window at this cadence,
        # measured in this run on the headline's own Simulator: the worst
        # of `resort_every` consecutive windows (lists live that many
        # windows between full re-sorts), and all of them
        "stale_window_errs": {str(k): v for k, v in ladder.items()},
        "stale_window_errs_cycle": [{str(k): v for k, v in d.items()}
                                    for d in ladders],
        "stale_window_mean_err": (float(np.mean(list(ladder.values())))
                                  if ladder else None),
        # the error at the window's last step (the lists at their oldest)
        "stale_window_err": ladder[max(ladder)] if ladder else None,
        "stale_window_max_err": max(ladder.values()) if ladder else None,
        # the per-axis traversal-time MAC slack in effect
        "stale_margin_auto": best.get("margin"),
        "certified": certified, "certified_reason": reason,
        "interaction_rates": rates,
        # host seconds of the rebuild that finished last in each window,
        # its parts for the last window, and the seconds each window's
        # boundaries waited on their background jobs
        "rebuild_s": [w["rebuild_s"] for w in wins],
        "rebuild_breakdown_s": wins[-1]["rebuild_breakdown_s"] if wins
        else {},
        "boundary_wait_s": [w["boundary_wait_s"] for w in wins],
        "default_cadence": default_cadence,
        "eager": eager,
        "device": device,
        "probes": probes, "final_candidates": finals, "note": note,
    }
    extra.update({k: best.get(k) for k in GRAPH_KEYS if k != "graphs"})
    extra.update(counters or {})
    return {"metric": "particle_steps_per_s", "value": n / med,
            "unit": "psteps/s", "graphs": bool(best.get("graphs")),
            "extra": extra}


class Bench:
    """One bench run's data: the beam on the host and the device, the
    oracle targets and their Kahan forces, and the count of force
    evaluations made."""

    def __init__(self, n: int = N_HEAD, device=None, oracle_cache=None):
        from coulomb_oscillators_tpu_torch import SimConfig
        self.n = n
        self.device = C.pick_device(device)
        self.base = SimConfig()
        self.pos_h, self.vel_h = C.beam(n, self.base)
        self.pos_d = torch.from_numpy(self.pos_h).to(self.device)
        self.sub = C.oracle_targets(n)
        self.sub_d = torch.from_numpy(self.sub).to(self.device)
        self.oracle_cache = oracle_cache
        self.acc_ref = None
        self.force_evals = 0

    # ---- the oracle ----
    def oracle(self) -> str:
        """Kahan forces on the targets; "computed" or "cached"."""
        from coulomb_oscillators_tpu_torch.ops import direct as D
        path = (os.path.join(self.oracle_cache,
                             f"bench_oracle_n{self.n}.npz")
                if self.oracle_cache else None)
        if path and os.path.exists(path):
            z = np.load(path)
            if int(z["n"]) == self.n and np.array_equal(z["sub"], self.sub):
                self.acc_ref = torch.from_numpy(z["acc_ref"]).to(self.device)
                return "cached"
        self.acc_ref = D.direct_kahan_targets(
            self.pos_d[self.sub_d], self.pos_d, self.base.eps2,
            self.base.kappa(self.n))
        if path:
            os.makedirs(self.oracle_cache, exist_ok=True)
            np.savez(path, n=self.n, sub=self.sub,
                     acc_ref=self.acc_ref.cpu().numpy())
        return "computed"

    def _bench_margin(self, cadence: dict) -> np.ndarray:
        """The auto per-axis stale margin the production Simulator applies
        at `cadence` (an explicit ``CO_STALE_MARGIN`` still overrides it at
        traversal time)."""
        from coulomb_oscillators_tpu_torch.simulate import auto_stale_margin
        cfg = self.base.replace(
            tree_steps=cadence["tree_steps"],
            tree_resort_every=cadence["resort_every"],
            tree_pipeline=cadence["pipeline"])
        return auto_stale_margin(self.vel_h, cfg)

    # ---- error + cost probe of one config ----
    def _host_tree(self, eng):
        """The host build's ingredients (native kd sort and geometry)."""
        from coulomb_oscillators_tpu_torch import native
        if not native.available():
            raise RuntimeError("the bench probes through the native host "
                               "library (a C++ compiler is needed)")
        perm = native.kdtree_build(self.pos_h, eng.L)
        c_h, lb_h, rb_h, lam_h = native.node_geometry(self.pos_h[perm],
                                                      eng.L)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.n, dtype=perm.dtype)
        return perm, inv, c_h, lb_h, rb_h, lam_h

    def _state(self, eng, tree, m2l, p2p):
        """The state of the host tree `tree` with the host traversal's
        lists: the lists are copied to the bench's device and laid out
        there."""
        perm, inv, c_h, _, _, lam_h = tree
        return eng._lists_to_state(
            perm, inv, c_h, lam_h,
            *(torch.from_numpy(x).to(self.device) for x in (m2l, p2p)), {})

    def _err(self, eng, fs) -> float:
        from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err
        self.force_evals += 1
        return float(mean_rel_err(eng.force(self.pos_d, fs)[self.sub_d],
                                  self.acc_ref))

    def _counts(self, eng, fs, m2l, p2p) -> dict:
        """Interaction counts per force evaluation: physical P2P particle
        pairs (sum of mult_t * mult_s over the directed near list, the
        sub-leaf masks unpacked), padded lane pairs the device runs, and
        directed M2L translations."""
        from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import _heap_off
        S = eng.sub_depth
        mult_leaf = eng.st.mult[_heap_off(eng.L):].astype(np.int64)
        # near rows: [tgt sub-leaf id, src block | sub-leaf mask << shift]
        tb = p2p[:, 0].astype(np.int64)
        pk = p2p[:, 1].astype(np.int64) & 0xFFFFFFFF   # unsigned view
        sb = pk & ((1 << eng.mask_shift) - 1)
        mask = pk >> eng.mask_shift
        src_m = np.zeros(p2p.shape[0], dtype=np.int64)
        for k in range(1 << S):
            src_m += ((mask >> k) & 1) * mult_leaf[(sb << S) + k]
        return {"p2p_phys_int": int(np.sum(mult_leaf[tb] * src_m)),
                "p2p_lane_int": int(int(fs.p2p_valid.sum())
                                    * eng.st.C * eng.C_blk),
                "m2l_entries": int(m2l.shape[0])}

    def _costs(self, eng, fs, tree) -> dict:
        """The padded force's time by the chained timer, and the steady
        rebuild (seeded re-traversal, list prep, upload)."""
        from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR
        from coulomb_oscillators_tpu_torch.utils.timing import (
            test_time_chained)
        c_h, lb_h, rb_h = tree[2:5]
        ppad = eng.pad_array(self.pos_d, fs, fill=FAR)

        def fpad(x):
            self.force_evals += 1
            return x + eng.force_padded(x, fs) * 1e-30

        row = {"force_s": test_time_chained(fpad, ppad, min_loop=1.5)}
        C.sync(self.device)
        t0 = time.perf_counter()
        m2l2, p2p2 = eng._traverse(c_h, lb_h, rb_h)
        self._state(eng, tree, m2l2, p2p2)
        C.sync(self.device)
        row["rebuild_s"] = time.perf_counter() - t0
        return row

    def probe(self, p, r, boost, cadence=None) -> dict:
        """Error against the oracle, interaction counts, and (when under
        the bound) the isolated padded-force and rebuild cost of one
        (p, r, boost).  The traversal uses the stale margin the production
        Simulator applies at `cadence`, so the lists, error and counts
        match what :meth:`final_timing` runs."""
        from coulomb_oscillators_tpu_torch.ops.fmm import KdFmmEngine
        cadence = cadence or cadence_of(DEFAULT_TUNED)
        eng = KdFmmEngine(self.base.replace(fmm_order=p, tree_radius=r,
                                            mac_sub_boost=boost), self.n)
        eng.stale_margin_abs = self._bench_margin(cadence)
        tree = self._host_tree(eng)
        c_h, lb_h, rb_h = tree[2:5]
        t0 = time.perf_counter()
        m2l, p2p = eng._traverse(c_h, lb_h, rb_h)
        t_trav = time.perf_counter() - t0
        fs = self._state(eng, tree, m2l, p2p)
        row = {"p": p, "r": r, "boost": boost, "err": self._err(eng, fs)}
        row.update(self._counts(eng, fs, m2l, p2p))
        if row["err"] < ERR_BOUND:
            row.update(self._costs(eng, fs, tree))
            row["first_traverse_s"] = t_trav
        print("# " + json.dumps(row), flush=True)
        return row

    # ---- the reference grid for one expansion order ----
    def grid_for_p(self, p) -> list:
        """Sweep radii DESCENDING at fixed p, boosts descending inside.
        The error falls with r at fixed p, so the descent stops once the
        error has cleared the bound (one extra radius near the bound, for
        float32 noise).  A configuration that runs out of device memory
        gets an `oom` row and the sweep moves to the next radius."""
        from coulomb_oscillators_tpu_torch.ops.fmm import KdFmmEngine
        eng = KdFmmEngine(self.base.replace(fmm_order=p,
                                            tree_radius=SEARCH_R[-1]),
                          self.n)
        eng.stale_margin_abs = self._bench_margin(cadence_of(DEFAULT_TUNED))
        tree = self._host_tree(eng)
        c_h, lb_h, rb_h = tree[2:5]
        rows = []
        over_bound = 0
        for r in reversed(SEARCH_R):
            eng.config = self.base.replace(fmm_order=p, tree_radius=r)
            first_err = None
            for b in (SEARCH_BOOST if eng.sub_depth else [1.0]):
                eng.mac_sub_boost = b if eng.sub_depth else 1.0
                row = {"p": p, "r": r, "boost": b}
                fs = None
                try:
                    t0 = time.perf_counter()
                    m2l, p2p = eng._traverse(c_h, lb_h, rb_h)
                    t_trav = time.perf_counter() - t0
                    fs = self._state(eng, tree, m2l, p2p)
                    err = row["err"] = self._err(eng, fs)
                    if err < ERR_BOUND:
                        row.update(self._costs(eng, fs, tree))
                        row["first_traverse_s"] = t_trav
                except torch.OutOfMemoryError:
                    row.update(err=None, oom=True)
                    err = None
                del fs
                gc.collect()
                if err is None and self.device.type == "cuda":
                    torch.cuda.empty_cache()
                rows.append(row)
                print("# " + json.dumps(row), flush=True)
                if err is None:
                    break       # the next radius is smaller
                if first_err is None:
                    first_err = err
                if err >= ERR_BOUND:
                    break       # the boost descent only loosens further
            if first_err is not None and first_err >= ERR_BOUND:
                over_bound += 1
                if first_err >= 2 * ERR_BOUND or over_bound >= 2:
                    break
        return rows

    def fullgrid(self) -> list:
        """The full reference grid (manual, unbudgeted)."""
        self.oracle()
        tried = []
        for p in SEARCH_P:
            tried.extend(self.grid_for_p(p))
        return tried

    # ---- production timing of one config at one cadence ----
    def final_timing(self, p, r, boost, cadence, windows=7,
                     early_stop_s=0.0, ladder_every=0, graphs=None) -> dict:
        """The Simulator at `cadence`: two 2-step runs and three windows
        of 2 * tree_steps steps as warm-up (enough boundaries for the list
        caps to settle), then `windows` timed windows of 16 steps, each
        closed by one device synchronize.  With `early_stop_s` > 0 a
        candidate whose best window after two is slower than that stops.
        With `ladder_every` > 0 the window ladder follows on the same
        run, over `resort_every` consecutive windows: the lists of one
        full re-sort serve that many.  `graphs` True or False runs the
        steps as CUDA graphs or eagerly (None: as ``CO_CUDA_GRAPHS``
        says); the block records which, the captures and the peak of
        allocated device memory over the timed windows."""
        from coulomb_oscillators_tpu_torch.models.integrators import (
            FORCE_EVALS)
        from coulomb_oscillators_tpu_torch.simulate import Simulator
        from coulomb_oscillators_tpu_torch.state import (
            particle_state_from_numpy)

        builder = cadence.get("builder", "host")
        ts = cadence["tree_steps"]
        config = SP.cadence_config(p, r, ts, cadence["resort_every"],
                                   cadence["pipeline"], builder,
                                   mac_sub_boost=boost)
        per_step = FORCE_EVALS[config.integrator]
        out = {"p": p, "r": r, "boost": boost, "cadence": dict(cadence),
               "times": [], "windows": [], "ladders": []}
        with SP.builder_env(builder), C.graphs_env(graphs):
            sim = Simulator(config, self.n, engine="fmm3_kd")
            try:
                state = sim.init_acc(particle_state_from_numpy(
                    self.pos_h, self.vel_h, device=self.device))
                state = sim.run(state, 2)
                state = sim.run(state, 2)
                for _ in range(3):
                    sim.advance_padded(2 * max(ts, 1))
                    C.sync(self.device)
                self.force_evals += 1 + (4 + 6 * max(ts, 1)) * per_step
                eng = sim._fmm
                if self.device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(self.device)
                for w in range(windows):
                    w0 = sim.rebuild_wait_total
                    t0 = time.perf_counter()
                    handle = sim.advance_padded(WINDOW_STEPS)
                    handle[0, 0, 0].item()    # one sync a window
                    out["times"].append((time.perf_counter() - t0)
                                        / WINDOW_STEPS)
                    self.force_evals += WINDOW_STEPS * per_step
                    bt = dict(eng.last_build_times)
                    out["windows"].append({
                        "s_per_step": out["times"][-1],
                        "caps": dict(eng.caps),
                        "boundary_wait_s": sim.rebuild_wait_total - w0,
                        "counts": dict(eng.last_counts),
                        "rebuild_s": sum(bt.values()),
                        "rebuild_breakdown_s": bt})
                    print(f"## window {w}: {out['times'][-1]:.4f} s/step  "
                          f"caps={eng.caps}  boundary_wait="
                          f"{out['windows'][-1]['boundary_wait_s']:.3f}  "
                          f"counts={eng.last_counts}  bt="
                          f"{ {k: round(v, 3) for k, v in bt.items()} }",
                          flush=True)
                    if (early_stop_s > 0 and len(out["times"]) >= 2
                            and min(out["times"]) > early_stop_s):
                        break
                for _ in range(cadence["resort_every"]
                               if ladder_every > 0 else 0):
                    before = sim._steps_since_build
                    out["ladders"].append(SP.window_ladder(
                        sim, self.sub_d, ladder_every))
                    stepped = ts + (ts - before if 0 < before < ts else 0)
                    self.force_evals += (stepped * per_step
                                         + SP.ladder_evals(ts, ladder_every))
                    print("## window ladder: "
                          + json.dumps(out["ladders"][-1]), flush=True)
                out["margin"] = np.asarray(eng.stale_margin_abs).tolist()
                out["rebuilds"] = dict(sim.rebuilds)
                out["finite"] = bool(torch.isfinite(sim._padded.vel).all())
                out.update(C.graph_info(sim))
                if self.device.type == "cuda":
                    out["peak_bytes"] = torch.cuda.max_memory_allocated(
                        self.device)
                    out["peak_reserved_bytes"] = \
                        torch.cuda.max_memory_reserved(self.device)
            finally:
                sim.close()
        out["median"] = statistics.median(out["times"])
        return out


def _final_row(t: dict) -> dict:
    """A timed candidate's row of ``extra.final_candidates``."""
    ok, why = certify(t["err"], t["ladders"])
    worst = max((max(d.values()) for d in t["ladders"]), default=None)
    return {"p": t["p"], "r": t["r"], "boost": t["boost"], "err": t["err"],
            "median": t["median"], "stale_window_max_err": worst,
            "certified": ok, "certified_reason": why}


def _cadence_block(t: dict, n: int) -> dict:
    """A timing block's fields for ``extra.default_cadence``."""
    wins = t["windows"]
    return {"tree_steps": t["cadence"]["tree_steps"],
            "resort_every": t["cadence"]["resort_every"],
            "pipeline": t["cadence"]["pipeline"],
            "builder": t["cadence"].get("builder", "host"),
            "particle_steps_per_s": n / t["median"],
            "sec_per_step_median": t["median"],
            "sec_per_step_all": t["times"],
            "rebuild_s": [w["rebuild_s"] for w in wins],
            "rebuild_breakdown_s": wins[-1]["rebuild_breakdown_s"],
            "boundary_wait_s": [w["boundary_wait_s"] for w in wins],
            "stale_margin_auto": t["margin"], "rebuilds": t["rebuilds"],
            **{k: t.get(k) for k in GRAPH_KEYS}}


def run(n=N_HEAD, device=None, quick=False, tuned_path=None,
        save_tuned=None, oracle_cache=None) -> dict:
    """The whole bench; returns the JSON object :func:`main` prints."""
    # a far field in true float32: TF32 would floor the force error near
    # the bound
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("the bench needs float32 matmuls at 'highest' "
                           "precision with TF32 off")
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    t_begin = time.monotonic()
    budget = _budget_s()

    def left():
        return budget - (time.monotonic() - t_begin)

    bench = Bench(n, device, oracle_cache)
    launches0 = p2p_cuda.launches
    windows = 3 if quick else 7
    every = 4 if quick else 1
    print(f"## oracle {bench.oracle()}", flush=True)

    # ---- phase 1: tuned headline, with the over-bound fallback ladder:
    # stiffen the sub-leaf MAC, then widen r ----
    tuned = load_tuned(tuned_path)
    cadence = cadence_of(tuned)
    cands = [{k: tuned[k] for k in ("p", "r", "boost")}]
    for fb in ({"p": tuned["p"], "r": tuned["r"], "boost": 2.0},
               {"p": 6, "r": 2.5, "boost": 2.0}):
        if fb not in cands:
            cands.append(fb)
    probes, finals = [], []
    prow = None
    for cand in cands:
        prow = bench.probe(cand["p"], cand["r"], cand["boost"], cadence)
        probes.append(prow)
        if prow["err"] < ERR_BOUND:
            break
        print(f"## config {cand} over bound; stiffening", flush=True)
    # an over-bound last resort is still timed, and reported uncertified
    best = bench.final_timing(prow["p"], prow["r"], prow["boost"], cadence,
                              windows=windows, ladder_every=every)
    best["err"] = prow["err"]
    finals.append(_final_row(best))
    print(f"## provisional headline: {n / best['median']:.0f} psteps/s @ "
          f"{prow['p']}, {prow['r']}, {prow['boost']}", flush=True)

    # ---- phase 2: the headline config at the config's default cadence ----
    def at_default(t):
        return bench.final_timing(t["p"], t["r"], t["boost"],
                                  dict(DEFAULT_CADENCE, builder="host"),
                                  windows=windows)

    dflt, dflt_of = at_default(best), best

    # ---- phase 3: budget-gated refinement ----
    # keep a reserve able to absorb one more production timing
    final_cost = sum(best["times"]) * WINDOW_STEPS + 240
    tuned_score = (_score(prow, cadence["tree_steps"])
                   if "force_s" in prow else None)
    for cand in ([] if quick else REFINE):
        if left() < final_cost + 360:
            print("## refinement skipped: budget reserve reached",
                  flush=True)
            break
        row = bench.probe(cand["p"], cand["r"], cand["boost"], cadence)
        probes.append(row)
        ref_score = (tuned_score if tuned_score is not None
                     else best["median"])
        go, why = refine_gate(row, ref_score, cadence["tree_steps"])
        print(f"## refine {cand}: {why}", flush=True)
        if not go or left() <= final_cost:
            continue
        t = bench.final_timing(cand["p"], cand["r"], cand["boost"], cadence,
                               windows=windows,
                               early_stop_s=1.5 * best["median"],
                               ladder_every=every)
        t["err"] = row["err"]
        finals.append(_final_row(t))
        # a faster candidate wins only with its own window certification
        if t["median"] < best["median"] and finals[-1]["certified"]:
            best = t
    if dflt_of is not best:
        dflt = at_default(best)
    # full mode: the winner at both cadences with its steps run eagerly
    eager = None
    if not quick:
        eager = {}
        for key, cad in (("tuned", best["cadence"]),
                         ("default", dict(DEFAULT_CADENCE, builder="host"))):
            t = bench.final_timing(best["p"], best["r"], best["boost"], cad,
                                   windows=windows, graphs=False)
            eager[key] = dict(_cadence_block(t, n), finite=t["finite"])

    out = _emit(
        best, n, bench.base.integrator, probes, finals,
        default_cadence=_cadence_block(dflt, n),
        device=C.device_info(bench.device),
        note=f"budget {budget:.0f}s, used "
             f"{time.monotonic() - t_begin:.0f}s"
             + (", quick" if quick else ""),
        counters={"force_evals": bench.force_evals,
                  "p2p_kernel_launches": p2p_cuda.launches - launches0,
                  "finite": bool(best["finite"] and dflt["finite"] and all(
                      e["finite"] for e in (eager or {}).values()))},
        eager=eager)
    if save_tuned:
        with open(save_tuned, "w") as f:
            json.dump({"p": best["p"], "r": best["r"],
                       "boost": best["boost"], "err": best["err"],
                       **best["cadence"],
                       "median_s_per_step": best["median"],
                       "device": out["extra"]["device"]}, f, indent=1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="*", default=[],
                    help="nothing (the bench), 'probe P R BOOST', or "
                         "'fullgrid'")
    ap.add_argument("--n", type=int, default=N_HEAD)
    ap.add_argument("--quick", action="store_true",
                    help="3 timed windows, no refinement, the ladder at "
                         "every 4th step")
    ap.add_argument("--tuned", default=None,
                    help="JSON file with the start point (p, r, boost and "
                         "the cadence)")
    ap.add_argument("--save-tuned", default=None,
                    help="write the winner to this JSON file")
    ap.add_argument("--oracle-cache", default=None,
                    help="directory that keeps the oracle forces between "
                         "runs")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.mode and args.mode[0] == "probe":
        p, r, boost = args.mode[1:4]
        bench = Bench(args.n, args.device, args.oracle_cache)
        bench.oracle()
        row = bench.probe(int(p), float(r), float(boost))
        print(json.dumps(dict(row, device=C.device_info(bench.device))))
    elif args.mode and args.mode[0] == "fullgrid":
        bench = Bench(args.n, args.device, args.oracle_cache)
        print(json.dumps({"grid": bench.fullgrid(),
                          "device": C.device_info(bench.device)}))
    elif args.mode:
        ap.error(f"unknown mode {args.mode[0]!r}")
    else:
        print(json.dumps(run(args.n, args.device, args.quick, args.tuned,
                             args.save_tuned, args.oracle_cache)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
