"""Time the direct kernel beside its bound, on the card.

The cases are the CLI's beams (the 3D Gaussian beam, x_std = (0.003,
0.001, 0.01), and the 2D KV beam, as ``cli.py`` and chip_smoke.py phase 6
make them): 3D at N = 4096 (ladder config 1), 30001 (the CLI's default)
and 262144, and 2D at N = 30001.  For each case: the work (N^2 pairs, the
positions read and the forces written once), the bounds
(``utils.roofline.bound``), the split count, the kernel's time with CUDA
events, its pairs a second, and its deviation from the plain version
(max row-norm relative); the device time a call from torch.profiler
beside the CUDA-event time, which at a small N is the host's launch cost.
Two more rows hold each kernel to the Kahan
oracle at n = 1000 (mean relative error, the reference's 1e-6 contract).

    python -m coulomb_oscillators_tpu_torch.scripts.direct_bench \\
        [--baseline OTHER.cu] [--sass DIR] [--step] [--out FILE]

``--baseline`` (repeatable) builds another ``direct.cu`` (with the
earlier entry point's tiles-per-split argument or this one's sources per
split, as its source declares) and times it on the same inputs in turns
with this one (three rounds of base, new, new, base); the rows name it
by its file name.
nvidia-smi's SM clock and power draw are sampled while a case is timed.
``--sass`` writes ``cuobjdump -sass`` of each build into DIR and reports,
for each kernel function, the instructions of its pair loop over the
pairs it evaluates (one special-function op each).  ``--step`` times the
CLI's direct step at N = 30001 (Simulator("direct"), leapfrog), as CUDA
graphs and eagerly, with this kernel and each baseline: ms a step on the
host clock, the kernels' ms and the device's busy share from
``torch.profiler``, the captures and the peak memory.  Prints one JSON row per case and the
card's name and power limit; runs on a CUDA card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from coulomb_oscillators_tpu_torch.scripts.p2p_bench import Clocks, cuda_ms

X_STD = (0.003, 0.001, 0.01)
# (dim, N): the CLI's 3D beam at ladder 1's, the CLI's and a large N, and
# the 2D KV beam at the CLI's N
CASES = ((3, 4096), (3, 30001), (3, 262144), (2, 30001))


def work(n: int, dim: int) -> dict:
    """The pairs and bytes of one call at `n` (positions read once, forces
    written once) and its bounds on the card (utils/roofline.py)."""
    from coulomb_oscillators_tpu_torch.utils import roofline
    pairs = n * n
    nbytes = 2 * n * dim * 4
    return dict(pairs=pairs, bytes=nbytes,
                **roofline.bound(pairs, nbytes, dim=dim))


def beam(n: int, dim: int):
    """The CLI's beam at `n`: (config, float32 positions)."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    from coulomb_oscillators_tpu_torch.models.beams import matched_beam_2d
    if dim == 3:
        cfg = SimConfig()
        u = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
        return cfg, ID.init_gaussian(n, X_STD, u)[0]
    om = (6.22 * 2 * np.pi, 6.21 * 2 * np.pi)
    b = matched_beam_2d(om, (0.03e-3, 0.01e-3), 0.8)
    cfg = SimConfig(dim=2, omega0=om, xi=b["xi"])
    return cfg, ID.init_kv(n, b["A"], b["omega"], dtype=np.float32)[0]


_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"\bBRA(?:\.\S+)?\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")


def sass_loops(text: str) -> dict:
    """The pair loop of each kernel function in ``cuobjdump -sass`` text:
    of the innermost loops (a backward branch and its target, holding no
    other loop) the one with the most pair ops (MUFU.RSQ in a 3D
    function, MUFU.RCP in a 2D one, any MUFU otherwise); its
    instructions, pairs, the instructions a pair and its opcode
    counts."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            funcs[name] = dict(ins=[], labels={}, pending=[])
            continue
        if name is None:
            continue
        f = funcs[name]
        m = _LABEL.match(line)
        if m:
            f["pending"].append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in f["pending"]:
                f["labels"][lab] = addr
            f["pending"] = []
            f["ins"].append((addr, m.group(2).strip()))
    out = {}
    for name, f in funcs.items():
        pair_op = ("MUFU.RSQ" if "ILi3E" in name else
                   "MUFU.RCP" if "ILi2E" in name else "MUFU")
        loops = set()
        for addr, text in f["ins"]:
            m = _TARGET.search(text)
            if not m:
                continue
            tgt = m.group(1)
            start = f["labels"].get(tgt) if tgt.startswith(".") \
                else int(tgt, 16)
            if start is not None and start <= addr:
                loops.add((start, addr))
        best = None
        for start, end in loops:
            if any(start <= s0 and e0 <= end and (s0, e0) != (start, end)
                   for s0, e0 in loops):
                continue
            body = [t for a, t in f["ins"] if start <= a <= end]
            ops = [t.split()[1] if t.startswith("@") else t.split()[0]
                   for t in body]
            pairs = sum(o.startswith(pair_op) for o in ops)
            if pairs and (best is None or pairs > best["pairs"]):
                hist = {}
                for o in ops:
                    hist[o] = hist.get(o, 0) + 1
                best = dict(instructions=len(body), pairs=pairs,
                            per_pair=len(body) / pairs, ops=hist)
        if best is not None:
            out[name] = best
    return out


def _sass(so: str, tag: str, outdir: str) -> dict:
    """cuobjdump -sass of `so` into outdir/<tag>.sass, and its loops."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"{tag}.sass"), "w") as f:
        f.write(text)
    return sass_loops(text)


def old_splits(n: int, sm_count: int) -> tuple:
    """The earlier kernel's split rule (256-source tiles, 8 resident
    256-thread blocks a SM): (S, tiles_per_split)."""
    tiles = -(-n // 256)
    want = max(1, -(-(sm_count * 8) // tiles))
    per = -(-tiles // min(want, tiles))
    return -(-tiles // per), per


def _baseline(path):
    """(launcher, .so path) of another build of the kernel: its entry
    point takes tiles per split (the earlier interface) if its source
    says so, else sources per split with this wrapper's split rule."""
    from coulomb_oscillators_tpu_torch import native
    from coulomb_oscillators_tpu_torch.ops import direct as D
    with open(path) as f:
        tiled = "tiles_per_split" in f.read()
    so, _ = native.build_library(path, "co_direct_base",
                                 [native.nvcc()] + native.NVCC_FLAGS)
    lib = ctypes.CDLL(so)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.co_direct_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, cf, cf, vp]
    lib.co_direct_launch.restype = ci
    if not tiled:
        lib.co_direct_geometry.argtypes = [ci, vp, vp]
        lib.co_direct_geometry.restype = ci
    sm = torch.cuda.get_device_properties(0).multi_processor_count

    def run(pos, eps2, kappa):
        n, dim = pos.shape
        S, per = (old_splits(n, sm) if tiled
                  else D.splits_for(n, sm, *D.geometry(dim, lib)))
        out = torch.empty_like(pos)
        part = torch.empty((S, n, dim), dtype=pos.dtype, device=pos.device) \
            if S > 1 else None
        rc = lib.co_direct_launch(
            pos.data_ptr(), None if part is None else part.data_ptr(),
            out.data_ptr(), n, dim, S, per, float(eps2), float(kappa),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{path}: launch failed: cudaError_t {rc}")
        return out
    return run, so


def _device_events(prof):
    """The kernels' rows of a torch.profiler run's averages."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _self_us(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


def _device_ms(fn, reps):
    """The device time of one call of `fn`: each kernel's mean time a
    launch in a profiled run of `reps` calls (each call launches each of
    its kernels once), summed over the kernels; without the host's launch
    cost, which sets the CUDA-event time of a small call, and immune to a
    launch the trace drops."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_self_us(e) / e.count for e in _device_events(prof)) / 1e3


def _rel_dev(a, b):
    d = torch.linalg.vector_norm(a - b, dim=1).max()
    return float(d / torch.linalg.vector_norm(b, dim=1).max())


def case(dim, n, dev, bases=(), reps=20):
    """One case's row (see the module docstring); `bases` are (name,
    launcher) pairs of other builds."""
    from coulomb_oscillators_tpu_torch.ops import direct as D
    cfg, ph = beam(n, dim)
    p = torch.from_numpy(ph).to(dev)
    eps2, kap = cfg.eps2, cfg.kappa(n)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    S, _ = D.splits_for(n, sm, *D.geometry(dim))
    row = dict(case=f"{dim}d_beam", dim=dim, n=n, splits=S,
               geometry=D.geometry(dim), **work(n, dim))
    got = D.direct(p, eps2, kap)
    row["rel_dev_plain"] = _rel_dev(got, D.direct_plain(p, eps2, kap))
    kern = [lambda: D.direct(p, eps2, kap)]
    for bname, run in bases:
        row[f"rel_dev_{bname}"] = _rel_dev(run(p, eps2, kap), got)
        kern.append(lambda run=run: run(p, eps2, kap))
    # in turns, three rounds of: bases, kernel, kernel, bases
    others = list(range(1, len(kern)))
    seq = (others + [0, 0] + others[::-1]) * 3
    times = [[] for _ in kern]
    with Clocks() as clocks:
        for k in seq:
            times[k].append(cuda_ms(kern[k], reps))
    row.update(clocks.summary())
    row["ms"] = float(np.mean(times[0]))
    row["ms_runs"] = times[0]
    for (bname, _), t in zip(bases, times[1:]):
        row[f"{bname}_ms"] = float(np.mean(t))
        row[f"{bname}_ms_runs"] = t
    row["device_ms"] = _device_ms(kern[0], reps)
    for (bname, _), fn in zip(bases, kern[1:]):
        row[f"{bname}_device_ms"] = _device_ms(fn, reps)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["gpairs_per_s"] = row["pairs"] / row["ms"] / 1e6
    # the split rule against other split counts (each a valid cut)
    row["ms_by_splits"] = {
        s: cuda_ms(lambda s=s: D.launch(p, eps2, kap, splits=s), reps)
        for s in sorted({1, S // 4, S // 2, S, 2 * S, 4 * S})
        if s >= 1 and -(-n // -(-n // s)) == s}
    return row


def kahan_rows(dev, bases=()):
    """Each kernel against the Kahan oracle at n = 1000 (normal * 0.01,
    seed 1234, eps2 = 1e-18, kappa = 2e-9; tests/test_direct.py's
    contract, mean relative error <= 1e-6)."""
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err
    rows = []
    for dim in (3, 2):
        rng = np.random.default_rng(1234)
        p = torch.from_numpy(rng.normal(size=(1000, dim)).astype(np.float32)
                             * 0.01).to(dev)
        ref = D.direct_kahan(p, 1e-18, 2e-9)
        row = dict(case=f"kahan_n1000_{dim}d", dim=dim, n=1000,
                   mean_rel_err=float(mean_rel_err(D.direct(p, 1e-18, 2e-9),
                                                   ref)))
        for bname, run in bases:
            row[f"{bname}_mean_rel_err"] = float(
                mean_rel_err(run(p, 1e-18, 2e-9), ref))
        rows.append(row)
    return rows


def _step_run(dev, cfg, n, ph, vel, steps, graphs):
    """One Simulator("direct") run on the CLI's beam: 20 warm-up steps,
    then `steps` timed (host clock, synchronised) and `steps` profiled.
    Returns (ms a step, kernel ms a step, busy share, captures, capture
    seconds, peak allocated bytes from the warm-up on, final positions)."""
    from coulomb_oscillators_tpu_torch.scripts import _common as C
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
    with C.graphs_env(graphs):
        sim = Simulator(cfg, n, "direct")
    try:
        st = sim.init_acc(particle_state_from_numpy(ph, vel, device=dev))
        torch.cuda.reset_peak_memory_stats(dev)
        st = sim.run(st, 20)
        torch.cuda.synchronize()
        t = time.perf_counter()
        st = sim.run(st, steps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / steps * 1e3
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            st = sim.run(st, steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        dev_us = sum(_self_us(e) for e in _device_events(prof))
        info = C.graph_info(sim)
    finally:
        sim.close()
    return dict(ms_per_step=ms, device_ms_per_step=dev_us / 1e3 / steps,
                busy_share=dev_us / 1e6 / wall, captures=info["captures"],
                capture_s=info["capture_s"],
                peak_bytes=torch.cuda.max_memory_allocated(dev)), st.pos


def step_row(dev, bases=(), n=30001, steps=200):
    """The CLI's direct step at `n` (3D beam, leapfrog, dt = 5e-4) with
    this kernel and each baseline swapped in for ``ops.direct.direct``,
    each with its steps run as CUDA graphs and eagerly
    (``CO_CUDA_GRAPHS=0``), in turns (graph, eager, eager, graph): ms a
    step (host clock, synchronised), the kernels' ms a step and the
    device's busy share over a profiled run of the same length, the
    captures, and the peak of allocated memory; a mode's numbers are the
    mean of its two runs.  The graph and eager positions must be bitwise
    equal."""
    from coulomb_oscillators_tpu_torch.ops import direct as D
    cfg, ph = beam(n, 3)
    vel = np.zeros_like(ph)
    row = dict(case="cli_direct_step", dim=3, n=n, steps=steps)
    kernel = D.direct
    for name, fn in [("kernel", kernel)] + list(bases):
        D.direct = fn if name == "kernel" else (
            lambda pos, eps2, kappa, fn=fn: fn(pos, eps2, kappa))
        runs = {True: [], False: []}
        try:
            for graphs in (True, False, False, True):
                runs[graphs].append(_step_run(dev, cfg, n, ph, vel, steps,
                                              graphs))
        finally:
            D.direct = kernel
        if not torch.equal(runs[True][0][1], runs[False][0][1]):
            raise RuntimeError(f"{name}: graph and eager steps differ")
        pre = "" if name == "kernel" else f"{name}_"
        for graphs, tag in ((True, ""), (False, "eager_")):
            recs = [r for r, _ in runs[graphs]]
            for k in recs[0]:
                row[f"{pre}{tag}{k}"] = float(np.mean([r[k] for r in recs]))
            row[f"{pre}{tag}ms_per_step_runs"] = [r["ms_per_step"]
                                                 for r in recs]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[])
    ap.add_argument("--sass", default=None)
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("direct_bench: no CUDA device", file=sys.stderr)
        return 1
    from coulomb_oscillators_tpu_torch import native
    from coulomb_oscillators_tpu_torch.ops import direct as D
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    D.library.get()
    built = [(os.path.splitext(os.path.basename(p))[0], *_baseline(p))
             for p in a.baseline]
    bases = [(name, run) for name, run, _ in built]
    rows = []

    def emit(row):
        row["card"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)

    if a.sass:
        so, _ = native.build_library(D.SRC, "co_direct",
                                     [native.nvcc()] + native.NVCC_FLAGS)
        row = dict(case="sass", kernel=_sass(so, "direct", a.sass))
        for name, _, bso in built:
            row[name] = _sass(bso, name, a.sass)
        emit(row)
    for row in kahan_rows(dev, bases):
        emit(row)
    for dim, n in CASES:
        emit(case(dim, n, dev, bases, reps=3 if n > 100_000 else 20))
    if a.step:
        emit(step_row(dev, bases))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
