"""Time the P2P kernel beside its bounds, on the card, in dims 3 and 2.

The 3D cases are at N = 1M: chip_smoke.py phase 3's four engines on the
README's Gaussian beam (p = 6, r = 1.67, seed 0: the default engine,
sub_depth = 0, dens_inhom = 0.25 and tree_L = 10) and phase 10's float64
engine (the uniform box, p = 5, r = 2, Morton sort).  The 2D cases run
``fmm2_kd`` at ladder row 2's configuration (p = 4, r = 2, the 2D
Gaussian beam with x_std = X_STD[:2], u = omega0 x x_std, seed 0): at
N = 100k in float32 (``fmm2_kd``) and float64 (``fmm2_kd_float64``), and
the same beam at N = 1M in float32 (``fmm2_kd_1M``).  For each case: the
work counted from the inputs (``p2p_cuda.pair_counts``), the bounds
(``utils.roofline.bound``: in 2D the rsqrt rate bounds float32), the
kernel's time through ``p2p_cuda.p2p`` (in 3D with its heavy-first block
order, and also in grid order; in 2D with its work plan, the
decomposition's small ops included), the plain version's time, and the
kernel's deviation from the plain version.

    python -m coulomb_oscillators_tpu_torch.scripts.p2p_bench \\
        [--baseline OTHER.cu] [--seg 8,32] [--agree-n 10000000] [--out FILE]

``--baseline`` (repeatable) builds another kernel source and times it on
the same inputs in turns with this one (base, new, new, base), and holds
the two against each other; the rows name it by its file name.  A
``p2p.cu`` is bound as its source declares: with or without the block
order argument in its C entry points, with or without the dim-2 entry
points of the earlier design (``co_p2p_launch_2d``, then called with the
heavy-first block order as its wrapper did); a ``p2p2d.cu`` (entry points
``co_p2p2d_launch``) takes the 2D cases with this tree's work plan.  A
baseline without entry points for a case's dim sits it out.  ``--seg``
also times the dim-2 kernel with other segment lengths K (the default is
``p2p_cuda.SEG_ENTRIES``), in the same turns.  nvidia-smi's SM clock and
power draw are sampled while a case is timed.  ``--agree-n`` also runs
the default engine's case at that N (the kernel against the plain
version, and timed).  Prints one JSON row per case and the card's name
and power limit; runs on a CUDA card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

X_STD = (0.003, 0.001, 0.01)


def cuda_ms(fn, reps):
    """CUDA-event ms of one call of `fn`, the mean over `reps` calls after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Device time of one call of `fn` by kernel name (ms): each kernel's
    total in a profiled run of `reps` calls, over `reps`; without the
    host's launch cost, which sets the CUDA-event time of a small call."""
    from coulomb_oscillators_tpu_torch.scripts.direct_bench import (
        _device_events, _self_us)
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: _self_us(e) / reps / 1e3 for e in _device_events(prof)}


def graph_ms(fn, reps):
    """CUDA-event ms of one replay of `fn` captured in a CUDA graph (as a
    Simulator's step runs it): the device's time with no host launch
    between its kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                              # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def _rel_dev(a, b):
    dim = b.shape[-1]
    d = torch.linalg.vector_norm((a - b).reshape(-1, dim), dim=1).max()
    return float(d / torch.linalg.vector_norm(b.reshape(-1, dim),
                                              dim=1).max())


def _baseline(path):
    """The launcher of another build of the kernel, bound as its source
    declares (see the module docstring); ``dims`` on the returned
    launcher says which dims it takes."""
    from coulomb_oscillators_tpu_torch import native
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    with open(path) as f:
        src = f.read()
    ordered = "const int32_t* order" in src
    entries = {}                  # (dim, dtype) -> C entry point name
    if "co_p2p_launch(" in src:
        entries.update(p2p_cuda._ENTRY)
    if "co_p2p_launch_2d" in src:
        entries.update({(2, torch.float32): "co_p2p_launch_2d",
                        (2, torch.float64): "co_p2p_launch_2d_f64"})
    planned = "co_p2p2d_launch" in src
    so, _ = native.build_library(path, "co_p2p_base",
                                 [native.nvcc()] + native.NVCC_FLAGS)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for (dim, dtype), name in entries.items():
        fn = getattr(lib, name)
        eps = ctypes.c_float if dtype == torch.float32 else ctypes.c_double
        fn.argtypes = [vp] * (5 if ordered else 4) + [ci] * 4 + [eps, vp]
        fn.restype = ci
    if planned:
        p2p_cuda.bind_2d(lib)

    def run(pblk, rp, col, nsub, eps2):
        Gb, CB, dim = pblk.shape
        out = torch.empty_like(pblk)
        stream = torch.cuda.current_stream().cuda_stream
        if dim == 2 and planned:
            K = p2p_cuda.SEG_ENTRIES
            work = p2p_cuda.segment_plan(rp, col.shape[1],
                                         CB // nsub // 32, K)
            rc = getattr(lib, p2p_cuda._ENTRY_2D[pblk.dtype])(
                pblk.data_ptr(), rp.data_ptr(), col.data_ptr(),
                work.data_ptr(), torch.empty_like(pblk).data_ptr(),
                out.data_ptr(), Gb, CB, nsub, col.shape[1], K, float(eps2),
                stream)
        else:
            order = ([p2p_cuda.block_order(rp, Gb, CB, nsub,
                                           col.shape[1]).data_ptr()]
                     if ordered else [])
            rc = getattr(lib, entries[dim, pblk.dtype])(
                pblk.data_ptr(), rp.data_ptr(), col.data_ptr(), *order,
                out.data_ptr(), Gb, CB, nsub, col.shape[1], float(eps2),
                stream)
        if rc:
            raise RuntimeError(f"{path}: launch failed: cudaError_t {rc}")
        return out
    run.dims = {d for d, _ in entries} | ({2} if planned else set())
    return run


class Clocks:
    """nvidia-smi's SM clock (MHz) and power draw (W), sampled in a
    background thread while a case is timed."""

    def __init__(self):
        import threading
        self.samples = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            r = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True)
            try:
                self.samples.append([float(x) for x in
                                     r.stdout.strip().split(",")])
            except ValueError:
                pass
            self._stop.wait(0.2)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()

    def summary(self):
        if not self.samples:
            return {}
        a = np.array(self.samples)
        return dict(sm_mhz_median=float(np.median(a[:, 0])),
                    sm_mhz_min=float(a[:, 0].min()),
                    power_w_median=float(np.median(a[:, 1])))


# each case's N: the 3D cases at 1M, fmm2_kd at ladder row 2's 100k and at
# 1M
CASE_N = {"fmm2_kd": 100_000, "fmm2_kd_float64": 100_000}


def _engine(name, n):
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine
    if name.startswith("fmm2_kd"):
        cfg = SimConfig(dim=2, omega0=(1.095, 1.0), fmm_order=4,
                        tree_radius=2.0,
                        precision="float64" if "float64" in name
                        else "float32")
        u = tuple(w * x for w, x in zip(cfg.omega0, X_STD[:2]))
        pos, _ = ID.init_gaussian(n, X_STD[:2], u, dim=2, seed=0)
        if "float64" in name:
            pos = pos.astype(np.float64)
        return cfg, KdFmmEngine(cfg, n), pos
    if name == "float64":
        cfg = SimConfig(fmm_order=5, tree_radius=2.0, precision="float64")
        pos = ID.init_uniform(n, (-0.01,) * 3, (0.01,) * 3).astype(np.float64)
        return cfg, KdFmmEngine(cfg, n, sort_mode="morton"), pos
    cfg = SimConfig(fmm_order=6, tree_radius=1.67)
    u = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
    pos, _ = ID.init_gaussian(n, X_STD, u, seed=0)
    if name == "dens_inhom=0.25":
        cfg = cfg.replace(dens_inhom=0.25)
    elif name == "tree_L=10":
        cfg = cfg.replace(tree_L=10)
    sub = {"sub_depth": 0} if name == "sub_depth=0" else {}
    return cfg, KdFmmEngine(cfg, n, **sub), pos


def case(name, n, dev, bases=(), reps=10, segs=()):
    """One case's row (see the module docstring); `bases` are (name,
    launcher) pairs of other builds, `segs` other segment lengths K of
    the dim-2 kernel."""
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR
    from coulomb_oscillators_tpu_torch.utils import roofline
    cfg, eng, pos_h = _engine(name, n)
    pos = torch.from_numpy(pos_h).to(dev)
    fs = eng.build(pos)
    pblk = eng.pad_array(pos, fs, fill=FAR).reshape(
        eng.G_blk, eng.C_blk, cfg.dim).contiguous()
    args = (pblk, fs.p2p_row_ptr, fs.p2p_col2d, eng.nsub, cfg.eps2)
    double = pblk.dtype == torch.float64
    counts = p2p_cuda.pair_counts(*args[:4])
    b = roofline.bound(counts["real_pairs"], counts["bytes"], dim=cfg.dim,
                       double=double)
    row = dict(case=name, n=n, dim=cfg.dim,
               dtype=str(pblk.dtype).split(".")[-1], Gb=eng.G_blk,
               CB=eng.C_blk, nsub=eng.nsub, dmax=fs.p2p_col2d.shape[1],
               **counts, **b)
    got = p2p_cuda.p2p(*args)
    row["bitwise_repeat"] = bool(torch.equal(got, p2p_cuda.p2p(*args)))
    row["rel_dev_plain"] = _rel_dev(got, p2p_cuda.p2p_plain(*args))
    row["plain_ms"] = cuda_ms(lambda: p2p_cuda.p2p_plain(*args),
                              max(1, reps // 10))
    # the timed calls by the row's key: p2p() first, then in 3D the grid
    # order, in 2D the other segment lengths, then the bases
    kern = {"ms": lambda: p2p_cuda.p2p(*args)}
    if cfg.dim == 3:
        kern["ms_grid_order"] = lambda: p2p_cuda.launch(*args, order=None)
    else:
        deg = np.minimum(np.diff(fs.p2p_row_ptr.cpu().numpy()), row["dmax"])
        R, ntile = deg.shape[0], eng.C_blk // eng.nsub // 32
        work = p2p_cuda.segment_plan(fs.p2p_row_ptr, row["dmax"], ntile)
        row.update(seg_entries=p2p_cuda.SEG_ENTRIES,
                   segments=int(work[R]) + R * ntile,
                   row_entries=dict(median=float(np.median(deg)),
                                    p99=float(np.percentile(deg, 99)),
                                    max=int(deg.max())))
        for K in segs:
            kern[f"ms_K{K}"] = lambda K=K: p2p_cuda.launch_2d(*args, K=K)
            row[f"rel_dev_plain_K{K}"] = _rel_dev(kern[f"ms_K{K}"](),
                                                  p2p_cuda.p2p_plain(*args))
    for bname, run in bases:
        if cfg.dim in run.dims:
            row[f"rel_dev_{bname}"] = _rel_dev(run(*args), got)
            row[f"bitwise_{bname}"] = bool(torch.equal(run(*args), got))
            kern[f"{bname}_ms"] = lambda run=run: run(*args)
    # in turns: bases, variants, p2p(), p2p(), variants, bases
    keys = list(kern)
    seq = keys[:0:-1] + [keys[0], keys[0]] + keys[1:]
    times = {k: [] for k in keys}
    with Clocks() as clocks:
        for k in seq:
            times[k].append(cuda_ms(kern[k], reps))
    row.update(clocks.summary())
    for k in keys:
        row[k] = float(np.mean(times[k]))
        row[f"{k}_runs"] = times[k]
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["real_pairs_per_s"] = counts["real_pairs"] / row["ms"] * 1e3
    # the device's share: p2p() and each base by kernel, and in a graph
    for k in keys:
        by = device_ms(kern[k], reps)
        row[f"device_{k}"] = sum(by.values())
        if k == "ms" or k.endswith("_ms"):
            row[f"device_{k}_by_kernel"] = by
            row[f"graph_{k}"] = graph_ms(kern[k], reps)
    row["graph_bound_share"] = row["bound_ms"] / row["graph_ms"]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[])
    ap.add_argument("--agree-n", type=int, default=0)
    ap.add_argument("--seg", default="",
                    help="other segment lengths K of the dim-2 kernel")
    ap.add_argument("--cases", default="default,sub_depth=0,"
                    "dens_inhom=0.25,tree_L=10,float64,fmm2_kd,"
                    "fmm2_kd_float64,fmm2_kd_1M")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("p2p_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    bases = [(os.path.splitext(os.path.basename(p))[0], _baseline(p))
             for p in a.baseline]
    rows = []
    for name in a.cases.split(","):
        row = case(name, CASE_N.get(name, 1_000_000), dev, bases,
                   reps=3 if name == "float64" else 10,
                   segs=[int(k) for k in a.seg.split(",") if k])
        row["card"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)
    if a.agree_n:
        row = case("default", a.agree_n, dev, reps=3)
        row["card"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
