#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main path — the kd-tree FMM Simulator at N=1,000,000
(the README's Gaussian beam, p=6, r=1.67) — through the entry points a user
calls, and checks it:

  1. device: a CUDA card, its name and power limit, the toolchain, and
     float32 matmuls kept out of TF32;
  2. build: the P2P kernel (csrc/p2p.cu, nvcc for sm_90a) and the native
     host library (g++), from the sources in this checkout;
  3. P2P kernel vs its plain PyTorch version on the card, on the real
     N=1M engine state (nsub=4) and on a sub_depth=0 engine (nsub=1):
     max|da| / max|a| <= 1e-5, with CUDA-event times of both;
  4. accuracy: engine.force at N=1M against the Kahan direct oracle on
     1,000 seeded targets, mean relative error <= 1e-3;
  5. simulator: a small run on the card against the same run on the CPU,
     then init_acc + 4 windows of tree_steps=8 at N=1M with the default
     async rebuild pipeline (the first boundary primes it, the next two
     adopt background re-sorts with a repad); positions stay finite and
     the kernel's launch count equals the number of force evaluations.

Any failure raises: the script then exits non-zero without its last line.
Usage, from the repository root:  python3 chip_smoke.py
"""

import json
import os
import subprocess
import sys
import time

N = 1_000_000
X_STD = (0.003, 0.001, 0.01)
SEED = 0
N_TARGETS = 1000
WINDOWS = 4
P2P_TOL = 1e-5          # the reference's own kernel contract
FORCE_TOL = 1e-3        # mean relative force error against Kahan


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _cuda_ms(fn, reps, torch):
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


def _rel_dev(a, b):
    """(max row-norm of a - b) / (max row-norm of b), and max |a - b|."""
    import torch
    d = (a - b).reshape(-1, a.shape[-1])
    scale = torch.linalg.vector_norm(b.reshape(-1, b.shape[-1]), dim=1).max()
    return (float(torch.linalg.vector_norm(d, dim=1).max() / scale),
            float(d.abs().max()))


def main() -> int:
    import numpy as np
    import torch

    # ---- 1. device -----------------------------------------------------
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from coulomb_oscillators_tpu_torch import SimConfig
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 1
    from coulomb_oscillators_tpu_torch import native
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
    from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

    dev = torch.device("cuda", 0)
    smi = _smi()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(subprocess.run([p2p_cuda.nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1])
    _require(torch.backends.cuda.matmul.allow_tf32 is False,
             "TF32 matmuls are off")
    _require(torch.get_float32_matmul_precision() == "highest",
             "float32 matmul precision is 'highest'")
    _phase("device", t0)

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    p2p_cuda.get_lib()
    native.get_lib()
    print(f"build: p2p.cu {p2p_cuda.build_seconds:.2f} s, co_native.cpp "
          f"{native.build_seconds:.2f} s")
    for line in p2p_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    _phase("build", t0)

    # ---- 3. P2P kernel vs plain ----------------------------------------
    t0 = time.perf_counter()
    cfg = SimConfig(fmm_order=6, tree_radius=1.67)
    u_std = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
    pos_h, vel_h = ID.init_gaussian(N, X_STD, u_std, seed=SEED)
    pos = torch.from_numpy(pos_h).to(dev)
    p2p_rows = []
    for sub_depth in (2, 0):
        eng = KdFmmEngine(cfg, N, sub_depth=sub_depth)
        tb = time.perf_counter()
        fs = eng.build(pos)
        torch.cuda.synchronize()
        tb = time.perf_counter() - tb
        ppad = eng.pad_array(pos, fs, fill=FAR)
        pblk = ppad.reshape(eng.G_blk, eng.C_blk, 3)

        def kern():
            return eng._stage_p2p(ppad, fs)

        def plain():
            return p2p_cuda.p2p_plain(pblk, fs.p2p_row_ptr, fs.p2p_col2d,
                                      eng.nsub, cfg.eps2)

        got = kern().reshape(pblk.shape)
        ref = plain()
        torch.cuda.synchronize()
        _require(bool(torch.isfinite(got).all()), "finite kernel output")
        rel, mabs = _rel_dev(got, ref)
        ms = _cuda_ms(kern, 10, torch)
        plain_ms = _cuda_ms(plain, 2, torch)
        tiles = int(fs.p2p_valid.sum())
        # pair evaluations the kernel makes: C targets x C sources per set
        # mask bit of every (sub-leaf, block) entry, pad lanes included
        bits = (fs.p2p_src[fs.p2p_valid].long() & 0xFFFFFFFF) \
            >> eng.mask_shift
        pairs = eng.st.C ** 2 * int(sum((bits >> q) & 1
                                        for q in range(eng.nsub)).sum())
        print(f"p2p nsub={eng.nsub} L={eng.L} C={eng.st.C} Gb={eng.G_blk} "
              f"CB={eng.C_blk} dmax={fs.p2p_col2d.shape[1]} tiles={tiles} "
              f"pairs={pairs} build_s={tb:.3f}: rel_dev={rel:.3e} "
              f"max_abs={mabs:.3e} kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"kernel_Gpairs_per_s={pairs / ms / 1e6:.1f}")
        _require(rel <= P2P_TOL, f"P2P kernel vs plain at nsub={eng.nsub}: "
                 f"{rel:.3e} <= {P2P_TOL}")
        p2p_rows.append(dict(nsub=eng.nsub, rel=rel, max_abs=mabs, ms=ms,
                             plain_ms=plain_ms,
                             max_ref=float(ref.abs().max())))
        del eng, fs, ppad, pblk, got, ref
    _phase("p2p", t0)

    # ---- 4. accuracy ---------------------------------------------------
    t0 = time.perf_counter()
    eng = KdFmmEngine(cfg, N)
    fs = eng.build(pos)
    tf = time.perf_counter()
    acc = eng.force(pos, fs)
    torch.cuda.synchronize()
    tf = time.perf_counter() - tf
    idx = torch.from_numpy(np.random.default_rng(SEED).choice(
        N, N_TARGETS, replace=False)).to(dev)
    ref = D.direct_kahan_targets(pos[idx], pos, cfg.eps2, cfg.kappa(N))
    err = float(mean_rel_err(acc[idx], ref))
    print(f"accuracy: force {tf:.3f} s (first call), mean rel err vs "
          f"Kahan on {N_TARGETS} targets = {err:.3e} (bound {FORCE_TOL}); "
          f"lists m2l={eng.last_counts['m2l']} p2p={eng.last_counts['p2p']}")
    _require(bool(torch.isfinite(acc).all()) and acc.shape == (N, 3),
             "finite [N, 3] force")
    _require(err <= FORCE_TOL, f"force error {err:.3e} <= {FORCE_TOL}")
    del eng, fs, acc
    _phase("accuracy", t0)

    # ---- 5. simulator --------------------------------------------------
    t0 = time.perf_counter()
    # small run on the card against the same run on the CPU plain path
    n_small = 4096
    small = SimConfig(fmm_order=4, tree_radius=2.0, tree_steps=3)
    ps, vs = ID.init_gaussian(n_small, X_STD, u_std, seed=SEED)
    outs = []
    for device in ("cpu", dev):
        sim = Simulator(small, n_small)
        st = sim.init_acc(particle_state_from_numpy(ps, vs, device=device))
        outs.append(sim.run(st, 7).pos.cpu())
        sim.close()
    small_dev = float((outs[1] - outs[0]).abs().max() / outs[0].abs().max())
    print(f"simulator N={n_small}: cuda vs cpu max|dpos|/max|pos| = "
          f"{small_dev:.3e}")
    _require(small_dev <= 1e-5, f"small run cuda vs cpu {small_dev:.3e} <= 1e-5")

    sim = Simulator(cfg, N)
    state = particle_state_from_numpy(pos_h, vel_h, device=dev)
    torch.cuda.synchronize()
    p2p_cuda.launches = 0
    ti = time.perf_counter()
    sim.init_acc(state)
    torch.cuda.synchronize()
    ti = time.perf_counter() - ti
    ts = sim.config.tree_steps
    win_s, wait_s, job_s = [], [], []
    for _ in range(WINDOWS):
        tw = time.perf_counter()
        sim.advance_padded(ts)
        torch.cuda.synchronize()
        win_s.append(time.perf_counter() - tw)
        wait_s.append(sim.last_rebuild_wait)
        # host time of the latest rebuild that finished (kd sort,
        # geometry, traversal, lists, upload)
        job_s.append(sum(sim._fmm.last_build_times.values()))
    final = sim.current_state()
    torch.cuda.synchronize()
    launches = p2p_cuda.launches
    sim.close()
    evals = 1 + WINDOWS * ts
    _require(bool(torch.isfinite(final.pos).all())
             and final.pos.shape == (N, 3), "finite [N, 3] positions")
    _require(launches == evals,
             f"{launches} P2P kernel launches == {evals} force evaluations")
    _require(sim.rebuilds["adopt_full"] == WINDOWS - 2,
             f"{WINDOWS - 2} adopted background rebuilds: {dict(sim.rebuilds)}")
    _require(native._lib is not None, "the native host library was used")
    per_step = sorted(w / ts for w in win_s[1:])
    print(f"simulator N={N}: init_acc {ti:.3f} s; window s {win_s}; "
          f"median s/step (windows 2-{WINDOWS}) {per_step[len(per_step) // 2]:.4f}; "
          f"rebuilds {dict(sim.rebuilds)}; boundary wait s {wait_s}; "
          f"host rebuild s {job_s}; "
          f"last rebuild breakdown {sim._fmm.last_build_times}; "
          f"p2p launches {launches} = force evals {evals}")
    _phase("simulator", t0)

    row = p2p_rows[0]
    print(json.dumps({"kernels": [{
        "name": "p2p", "route": "cuda",
        "source": "coulomb_oscillators_tpu_torch/csrc/p2p.cu",
        "replaces": "coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py:52",
        "also_replaces": "coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py:110",
        "launches": launches, "max_abs_err": row["max_abs"],
        "max_abs_ref": row["max_ref"], "max_rel_err": row["rel"],
        "ms": row["ms"], "plain_ms": row["plain_ms"]}]}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
