"""One run of one cell: set-up, the measured window, the comparison that
decides `correct`, and the result line.

Everything is found by name under the benchmark's root (the directory
that holds ``BENCHMARK.json``): the cell in ``BENCHMARK.json``; its
traffic in ``benchmark/workloads/<cell>.json``, which names its
configuration and its driver; the configuration in
``benchmark/configs/<config>.json``; the driver module in
``benchmark/drivers/<driver>.py`` (``setup(ctx)``; ``window(ctx)``, whose
loop calls ``ctx.tick`` with the steps done before each unit of work and
ends when ``ctx.window_done`` says so; ``collect(ctx)``);
each metric's reader in ``benchmark/metrics/<metric>.py`` (``read(ctx)``,
None when it finds nothing to read).  Adding a cell, a configuration, a
traffic mix, a driver or a metric adds files and entries; it edits none.

A run (:func:`run_cell`):

  1. the driver module's ``setup``: the beam from the seed, the program, its
     first build and force, the warm-up; ``setup_s`` ends here;
  2. the driver module's ``window``: a fixed amount of work, the steps
     that the traffic's ``steps_per_s`` (the program's rate on an H100
     when the cell was added) makes of ``seconds``, rounded up by the
     driver to whole units, so that what the window runs, and the state
     it reaches, do not depend on the program's speed; with ``trace`` its
     last ``trace_steps`` (the traffic's; all of it without one)
     profiled; then the peak of device memory is read, and a fixed piece
     of host work is timed (``diag.host``: how fast this run's host was);
  3. with ``trace``: the trace's summary (``trace.py``), which must hold
     as many P2P kernels as ``p2p_cuda.launches`` (and the warm-up of any
     capture) added in the window, or the run fails; and the P2P work
     of the lists the window ran;
  4. the driver module's ``collect``: the states after the window, then the
     program is stopped;
  5. the reference's readings of those states, held to the cell's
     ``limits`` (``reference/compare.py``);
  6. the metrics the cell reports: its end-to-end metrics, or with
     ``trace`` its per-layer ones.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

import numpy as np
import torch

from benchmark import beam as B
from benchmark import program as P
from benchmark import trace as T
from benchmark import work as W

FORBIDDEN = ("jax", "jaxlib", "flax", "coulomb_oscillators_tpu")


def load_json(root: str, *parts) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def load_module(root: str, kind: str, name: str):
    """benchmark/<kind>/<name>.py, loaded from its file (a name may hold
    dots)."""
    path = os.path.join(root, "benchmark", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: with `trace` the per-layer ones,
    else the end-to-end ones; an entry with ``workloads`` only in those
    cells."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def window_steps(seconds: float, workload: dict) -> int:
    """The steps a window runs: `seconds` at the traffic's
    ``steps_per_s`` (the driver rounds them up to its whole units)."""
    return max(1, math.ceil(seconds * float(workload["steps_per_s"])))


def host_probe() -> dict:
    """Seconds of two fixed pieces of host work: filling a fresh 256 MiB
    array (page faults and writes, as the host rebuild's dense partner
    table takes them) and sorting 2^20 float32 values (one core)."""
    t0 = time.perf_counter()
    a = np.full(1 << 26, 7, np.int32)
    fill = time.perf_counter() - t0
    del a
    x = np.random.default_rng(0).random(1 << 20, dtype=np.float32)
    t0 = time.perf_counter()
    np.sort(x)
    return {"fill_s": fill, "sort_s": time.perf_counter() - t0}


def forbidden_modules() -> list:
    """Modules in this process whose top-level name is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Context:
    """What a run knows; the drivers and the metric readers read and
    write it."""

    def __init__(self, root, bench, cell, seed, seconds, trace, device):
        entry = next((w for w in bench["workloads"] if w["name"] == cell),
                     None)
        if entry is None:
            raise KeyError(f"BENCHMARK.json has no cell {cell!r}")
        self.root, self.bench, self.cell = root, bench, cell
        self.entry = entry
        self.workload = load_json(root, "benchmark", "workloads",
                                  f"{cell}.json")
        if self.workload["config"] != entry["config"]:
            raise ValueError(f"{cell}: the traffic names configuration "
                             f"{self.workload['config']!r}, BENCHMARK.json "
                             f"{entry['config']!r}")
        self.config = load_json(root, "benchmark", "configs",
                                f"{entry['config']}.json")
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.sim = self.inst = self.state = None
        self.cleanup = []
        self.tr = None
        self.p2p_bound_ms = 0.0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _environment(config: dict) -> None:
    """The program's knobs as the configuration states them, whatever the
    environment says (the program reads them when its objects are made),
    and float32 matmuls at the stated precision (the far field in true
    float32: TF32 off)."""
    for k, v in config.get("program_env", {}).items():
        os.environ[k] = str(v)
    for k in config.get("program_env_unset", []):
        os.environ.pop(k, None)
    torch.set_float32_matmul_precision(config["matmul_precision"])
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])


def run_cell(root: str, cell: str, seed: int, seconds: float,
             trace: bool = False, device="cuda:0", t_start=None,
             log=sys.stderr, control: bool = False) -> dict:
    """One run; returns the result object (module docstring).  `device`
    "cpu" runs the program on the host (tests: its times are host times,
    and it cannot trace).  With `control` the result also holds every
    reading of the program (``readings``) and of the two controls on the
    same states: ``control``, the reference in bfloat16 in the program's
    place, and ``control_force``, its force alone in bfloat16 with the
    step in float32; the benchmark's own runs compute neither."""
    from benchmark.reference import compare as CMP
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_json(root, "BENCHMARK.json")
    ctx = Context(root, bench, cell, seed, seconds, trace, device)
    if trace and ctx.device.type != "cuda":
        raise ValueError("a traced run reads the card's trace")
    _environment(ctx.config)
    driver = load_module(root, "drivers", ctx.workload["driver"])
    readers = {m["name"]: load_module(root, "metrics", m["name"])
               for m in cell_metrics(bench, cell, trace)}
    cuda = ctx.device.type == "cuda"
    try:
        driver.setup(ctx)
        ctx.setup_s = time.perf_counter() - t_start
        from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
        inst = ctx.inst
        wait0 = ctx.sim.rebuild_wait_total
        cap0 = ctx.sim.graph.capture_seconds if ctx.sim.graph else 0.0
        ctx.work_steps = window_steps(seconds, ctx.workload)
        inst.full_build_s, inst.full_build_parts = [], []
        inst.captures_at = []
        inst.in_window = True
        mark = {}

        def traced_from_here():
            inst.record_lists = True
            mark.update(launches=p2p_cuda.launches, steps=inst.window_steps,
                        captures=len(inst.captures_at))

        # the profiler's cost grows with its events: a cell whose window
        # runs many short steps traces only the window's last steps
        tail = T.Tail(trace, ctx.work_steps, ctx.workload.get("trace_steps"),
                      ctx.sync, traced_from_here, log)
        ctx.tick, ctx.window_done = tail.tick, tail.done
        ctx.caps_setup = dict(ctx.sim._fmm.caps)
        try:
            driver.window(ctx)
        finally:
            t_stop = time.perf_counter()
            prof = tail.stop()
        if trace:
            print(f"trace: profiler stopped in "
                  f"{time.perf_counter() - t_stop:.1f} s", file=log,
                  flush=True)
        inst.record_lists = inst.in_window = False
        ctx.wait_s = ctx.sim.rebuild_wait_total - wait0
        ctx.full_build_s = list(inst.full_build_s)
        ctx.full_build_parts = {
            k: sum(p.get(k, 0.0) for p in inst.full_build_parts)
            / len(inst.full_build_parts)
            for k in (inst.full_build_parts[0] if inst.full_build_parts
                      else {})}
        ctx.captures_at = list(inst.captures_at)
        ctx.captures_in_window = len(ctx.captures_at)
        ctx.capture_s = ((ctx.sim.graph.capture_seconds
                          if ctx.sim.graph else 0.0) - cap0)
        ctx.caps_window = dict(ctx.sim._fmm.caps)
        ctx.memory_peak = (torch.cuda.max_memory_allocated(ctx.device)
                           if cuda else 0)
        ctx.host = host_probe()
        if trace:
            t0 = time.perf_counter()
            ctx.tr = T.summarize(prof)
            del prof
            print(f"trace: {ctx.tr['events']} events read in "
                  f"{time.perf_counter() - t0:.1f} s, by category "
                  f"{ctx.tr['categories']}", file=log, flush=True)
            ctx.tr["steps"] = inst.window_steps - mark["steps"]
            evals = W.FORCE_EVALS[ctx.sim.config.integrator]
            want = (p2p_cuda.launches - mark["launches"]
                    + (len(ctx.captures_at) - mark["captures"]) * evals)
            if ctx.tr["p2p_count"] != want:
                raise RuntimeError(
                    f"the trace holds {ctx.tr['p2p_count']} P2P kernels, "
                    f"the program launched {want}: the trace lost events")
            ctx.p2p_bound_ms = inst.p2p_bound_ms()
        record = driver.collect(ctx)
        P.release(ctx)
        record.update(dt=ctx.config["sim"]["dt"],
                      eps2=ctx.config["sim"]["eps"] ** 2,
                      kappa=ctx.config["sim"]["xi"] / ctx.config["n"],
                      omega0_sq=[w * w for w in ctx.config["sim"]["omega0"]],
                      targets=B.targets(ctx.config["n"],
                                        int(ctx.workload["check"]["targets"]),
                                        seed))
        exact = CMP.Exact(record, ctx.device)
        values = CMP.readings(record, ctx.device, exact=exact)
        ctrl = ({m: CMP.readings(record, ctx.device, control=m, exact=exact)
                 for m in ("all", "force")} if control else None)
        del record, exact
        checks = CMP.judge(values, ctx.workload["limits"])
        metrics = {}
        for m in cell_metrics(bench, cell, trace):
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    finally:
        if ctx.sim is not None:
            ctx.sim.close()
        for fn in ctx.cleanup:
            fn()
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device) if cuda
                    else "cpu"),
           "count": int(ctx.entry["chips"]),
           "memory_peak_bytes": int(ctx.memory_peak)}
    out = {"correct": all(c[3] for c in checks),
           "attempted": len(checks),
           "failed": sum(1 for c in checks if not c[3]),
           "metrics": metrics, "device": dev,
           "diag": {"steps": ctx.steps, "window_s": ctx.window_s,
                    "wait_s": ctx.wait_s, "rebuild_s": ctx.full_build_s,
                    "rebuild_parts_s": ctx.full_build_parts,
                    "captures_in_window": ctx.captures_in_window,
                    "capture_s": ctx.capture_s, "host": ctx.host,
                    "caps": [ctx.caps_setup, ctx.caps_window],
                    "captures_at": ctx.captures_at}}
    if control:
        out.update(readings=values, control=ctrl["all"],
                   control_force=ctrl["force"])
    if trace:
        dev.update(busy_s=ctx.tr["busy_s"], window_s=ctx.tr["window_s"])
        out["breakdown"] = {"device_ops": ctx.tr["device_ops"],
                            "idle_gaps": ctx.tr["idle_gaps"]}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim, _ in checks}
    for name, v, lim, ok in checks:
        print(f"check {name} {v!r} limit {lim!r} "
              f"{'ok' if ok else 'FAILED'}", file=log, flush=True)
    return out


def main(argv=None, t_start=None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="One run of one benchmark "
                                             "cell; prints its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bench = load_json(root, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {entry['chips']} CUDA device(s); {seen} "
              "visible: nothing is measured", file=sys.stderr)
        return 3
    # the program's kernel builds stay in the checkout's build/ (the
    # program fixes it); name the library caches there too, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(root, "build", sub))
    out = run_cell(root, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda:0", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    return 0
