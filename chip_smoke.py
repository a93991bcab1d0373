#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's paths through the entry points a user calls, and checks
them: the kd-tree FMM Simulator at N=1,000,000 (the README's Gaussian beam,
p=6, r=1.67), and the CLI's direct engine at its default N=30001.

  1. device: a CUDA card, its name and power limit, the toolchain, and
     float32 matmuls kept out of TF32;
  2. build: the two kernels (csrc/p2p.cu, csrc/direct.cu; nvcc for sm_90a)
     and the native host library (g++), all from the sources in this
     checkout and all started together;
  3. P2P kernel vs its plain PyTorch version on the card at N=1M, on the
     real engine state (nsub=4, CB=128), a sub_depth=0 engine (nsub=1),
     dens_inhom=0.25 (CB=512) and tree_L=10 (CB=1024): max|da| / max|a|
     <= 1e-5, with CUDA-event times of both;
  4. accuracy: engine.force at N=1M against the Kahan direct oracle on
     1,000 seeded targets, mean relative error <= 1e-3;
  5. simulator: a small run on the card against the same run on the CPU,
     then init_acc + 4 windows of tree_steps=8 at N=1M with the default
     async rebuild pipeline (the first boundary primes it, the next two
     adopt background re-sorts with a repad); positions stay finite and
     the P2P kernel's launch count equals the number of force evaluations;
  6. the direct kernel: at n=1000 (dims 2 and 3) against Kahan, mean
     relative error <= 1e-6; at N=30001 (the CLI's 3D Gaussian beam and
     2D KV beam) against the plain version, max|da| / max|a| <= 1e-5, and
     against Kahan within max(1e-5, 2x the plain version's error), with
     CUDA-event times of both;
  7. the CLI on the card (cli.main): a 3D direct run with snapshots, a
     resume from its last snapshot, a 2D direct run (float64 files), and
     -test; snapshot names and byte sizes as the reference writes them, and
     the direct kernel's launch count equals the force evaluations;
  8. energy: Simulator("direct") at N=30001, dt=2e-5, 2000 leapfrog steps
     in blocks of 500, relative drift of total_energy_kahan <= 1e-6; and
     the kd engine's potential (p=5, r=2.5) against Kahan pair rows, mean
     relative error <= 2e-3;
  9. the uniform-grid engines: the CLI's 2D default (fmm2, p=3, r=1) on
     the N=30001 KV beam, a run with snapshots and -test; fmm3 and
     fmm3_traceless at N=1M on the uniform box of ladder 3b (p=3 timed,
     p=5 against Kahan on 1,000 targets <= 5e-3, the two storages within
     1e-5 of max|a|); appel at N=1M in 3D and 2D (<= 0.09 against Kahan);
     each engine on the card against itself on the CPU at N=100k (<= 1e-5
     of max|a|); a Simulator("fmm3_traceless") run of 2 windows of 8 steps
     at N=1M;
 10. kd in 2D and float64: fmm2_kd at ladder 2's size (N=100k, p=4, r=2,
     2D Gaussian beam) against Kahan (<= 2e-3) and a 12-step Simulator
     timing; fmm3_kd in float64 at N=1M with sort_mode="morton" on the
     uniform box: the double P2P kernel against its plain float64 version
     (<= 1e-12 of max|a|, both timed), the force against a float64 Kahan
     oracle (<= 1e-3), and a Simulator run with tree_async_build="device"
     over 3 windows of 8 steps (one device rebuild adopted; P2P launches ==
     force evaluations);
 11. the native library: every N=1M kd build of phases 3-5 went through
     co_native, none through the numpy traversal.

Any failure raises: the script then exits non-zero without its last line.
Usage, from the repository root:  python3 chip_smoke.py
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

N = 1_000_000
X_STD = (0.003, 0.001, 0.01)
SEED = 0
N_TARGETS = 1000
WINDOWS = 4
P2P_TOL = 1e-5          # the reference's own kernel contract
FORCE_TOL = 1e-3        # mean relative force error against Kahan
N_CLI = 30001           # the CLI's default -n
DIRECT_KAHAN_TOL = 1e-6  # direct kernel vs Kahan at n=1000 (test_direct.py)
DRIFT_TOL = 1e-6        # energy drift bound (README north star)
POT_TOL = 2e-3          # FMM potential vs Kahan rows (test_fmm_kd.py)
N_GRID = 100_000        # uniform-grid engines, card vs CPU
OCT_TOL = 5e-3          # octree p=5 vs Kahan (tests/test_octree.py:35)
APPEL_TOL = 0.09        # Appel vs Kahan (tests/test_octree.py:53)
KD2_TOL = 2e-3          # fmm2_kd vs Kahan (test_fmm_kd_variants.py:31)
F64_P2P_TOL = 1e-12     # double P2P kernel vs its plain float64 version


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


def _p2p_case(cfg, sub_depth, pos, torch):
    """P2P kernel vs plain on one engine built from `pos`."""
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
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
    bits = (fs.p2p_src[fs.p2p_valid].long() & 0xFFFFFFFF) >> eng.mask_shift
    pairs = eng.st.C ** 2 * int(sum((bits >> q) & 1
                                    for q in range(eng.nsub)).sum())
    print(f"p2p nsub={eng.nsub} L={eng.L} C={eng.st.C} Gb={eng.G_blk} "
          f"CB={eng.C_blk} dmax={fs.p2p_col2d.shape[1]} tiles={tiles} "
          f"pairs={pairs} build_s={tb:.3f}: rel_dev={rel:.3e} "
          f"max_abs={mabs:.3e} kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
          f"kernel_Gpairs_per_s={pairs / ms / 1e6:.1f}")
    _require(rel <= P2P_TOL, f"P2P kernel vs plain at nsub={eng.nsub}, "
             f"CB={eng.C_blk}: {rel:.3e} <= {P2P_TOL}")
    return dict(nsub=eng.nsub, CB=eng.C_blk, max_rel_err=rel, max_abs_err=mabs,
                max_abs_ref=float(ref.abs().max()), ms=ms, plain_ms=plain_ms)


def _cli_beams(n):
    """The CLI's default 3D Gaussian beam and 2D KV beam at `n`: (config,
    float32 positions, velocities) per dim."""
    import numpy as np
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    from coulomb_oscillators_tpu_torch.models.beams import matched_beam_2d
    cfg3 = SimConfig()
    u = tuple(w * x for w, x in zip(cfg3.omega0, X_STD))
    p3, v3 = ID.init_gaussian(n, X_STD, u)
    om = (6.22 * 2 * np.pi, 6.21 * 2 * np.pi)
    beam = matched_beam_2d(om, (0.03e-3, 0.01e-3), 0.8)
    cfg2 = SimConfig(dim=2, omega0=om, xi=beam["xi"])
    p2, v2 = ID.init_kv(n, beam["A"], beam["omega"], dtype=np.float32)
    return {3: (cfg3, p3, v3), 2: (cfg2, p2, v2)}


def _uniform_box(n, dim, dtype=None):
    """Ladder 3b's uniform box (sides +-0.01) at `n`, float32 or `dtype`."""
    import numpy as np
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    pos = ID.init_uniform(n, (-0.01,) * dim, (0.01,) * dim, dim=dim)
    return pos if dtype is None else pos.astype(dtype)


def _kahan_err(acc, pos, cfg, n, torch, seed=SEED):
    """Mean relative error of `acc` against the Kahan oracle on N_TARGETS
    seeded targets."""
    import numpy as np
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err
    idx = torch.from_numpy(np.random.default_rng(seed).choice(
        n, N_TARGETS, replace=False)).to(pos.device)
    ref = D.direct_kahan_targets(pos[idx], pos, cfg.eps2, cfg.kappa(n))
    return float(mean_rel_err(acc[idx], ref))


def _phase_grid_engines(dev, torch):
    """Phase 9: the uniform-grid engines on the card."""
    import numpy as np
    from coulomb_oscillators_tpu_torch import SimConfig, cli
    from coulomb_oscillators_tpu_torch.ops.fmm import make_engine_object
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
    from coulomb_oscillators_tpu_torch.utils import io as SIO

    rows = {}
    # the CLI's 2D default: fmm2 on the N=30001 KV beam, float32 on the card
    with tempfile.TemporaryDirectory() as tmp:
        tc = time.perf_counter()
        _require(cli.main(["-dim", "2", "-n", str(N_CLI), "-iters", "100",
                           "-steps", "100", "-o", tmp]) == 0, "cli 2d fmm2")
        tc = time.perf_counter() - tc
        want = ["out0_0.000500.bin", "out100_0.000500.bin"]
        got = sorted(f for f in os.listdir(tmp) if f.endswith(".bin"))
        _require(got == want, f"cli 2d fmm2 snapshots {got} == {want}")
        for f in got:
            _require(os.path.getsize(os.path.join(tmp, f))
                     == 2 * N_CLI * 2 * 8, f"cli 2d fmm2 {f} float64 bytes")
        sp, sv = SIO.read_state(os.path.join(tmp, want[-1]), dim=2,
                                dtype=np.float64)
        _require(np.isfinite(sp).all() and np.isfinite(sv).all(),
                 "cli 2d fmm2 finite")
    tt = time.perf_counter()
    _require(cli.main(["-test", "-dim", "2", "-n", str(N_CLI)]) == 0,
             "cli 2d fmm2 -test")
    tt = time.perf_counter() - tt
    print(f"cli 2d default (fmm2): 100 iterations in {tc:.3f} s "
          f"({101 * N_CLI / tc / 1e6:.2f} M particle-steps/s incl. start-up "
          f"and snapshots); -test (orders 1-10) {tt:.3f} s")
    rows["cli_2d_fmm2_s"] = tc

    def force(name, cfg, x, reps=3):
        eng = make_engine_object(cfg, x.shape[0], name)
        tb = time.perf_counter()
        st = eng.build(x)
        torch.cuda.synchronize()
        tb = time.perf_counter() - tb
        acc = eng.force(x, st)
        ms = _cuda_ms(lambda: eng.force(x, st), reps, torch)
        _require(bool(torch.isfinite(acc).all()) and acc.shape == x.shape,
                 f"{name} finite force")
        return eng, st, acc, tb, ms

    # fmm3 / fmm3_traceless at N=1M: p=3 timed, p=5 against Kahan
    x3 = torch.from_numpy(_uniform_box(N, 3)).to(dev)
    accs = {}
    for p in (3, 5):
        for name in ("fmm3", "fmm3_traceless"):
            cfg = SimConfig(fmm_order=p)
            eng, _, acc, tb, ms = force(name, cfg, x3)
            err = _kahan_err(acc, x3, cfg, N, torch) if p == 5 else None
            accs[name, p] = acc
            print(f"{name} N={N} uniform p={p}: L={eng.L} cap="
                  f"{eng.cell_cap} build {tb:.3f} s force {ms:.2f} ms"
                  + ("" if err is None else
                     f"; mean rel err vs Kahan {err:.3e} (bound {OCT_TOL})"))
            rows[f"{name}_p{p}_ms"] = ms
            if err is not None:
                _require(err <= OCT_TOL, f"{name} p=5 {err:.3e} <= {OCT_TOL}")
        d, _ = _rel_dev(accs["fmm3_traceless", p], accs["fmm3", p])
        print(f"fmm3 vs fmm3_traceless p={p}: {d:.3e} of max|a|")
        _require(d <= 1e-5, f"symmetric vs traceless p={p} {d:.3e} <= 1e-5")
    del accs
    # appel at N=1M, 3D and 2D
    for dim in (3, 2):
        x = x3 if dim == 3 else torch.from_numpy(_uniform_box(N, 2)).to(dev)
        cfg = SimConfig(dim=dim, omega0=(1.095, 1.0, 1.0)[:dim])
        eng, _, acc, tb, ms = force("appel", cfg, x)
        err = _kahan_err(acc, x, cfg, N, torch)
        print(f"appel dim={dim} N={N} uniform: L={eng.L} cap={eng.cell_cap} "
              f"build {tb:.3f} s force {ms:.2f} ms; mean rel err vs Kahan "
              f"{err:.3e} (bound {APPEL_TOL})")
        _require(err <= APPEL_TOL, f"appel dim={dim} {err:.3e}")
        rows[f"appel{dim}d_ms"] = ms
    # each engine on the card against itself on the CPU at N=100k
    for name, dim in (("fmm2", 2), ("fmm3", 3), ("fmm3_traceless", 3),
                      ("appel", 3), ("appel", 2)):
        cfg = SimConfig(dim=dim, omega0=(1.095, 1.0, 1.0)[:dim])
        xh = torch.from_numpy(_uniform_box(N_GRID, dim))
        outs = []
        for x in (xh, xh.to(dev)):
            eng = make_engine_object(cfg, N_GRID, name)
            outs.append(eng.force(x, eng.build(x)).cpu())
        d, _ = _rel_dev(outs[1], outs[0])
        print(f"{name} dim={dim} N={N_GRID}: card vs CPU {d:.3e} of max|a|")
        _require(d <= 1e-5, f"{name} dim={dim} card vs CPU {d:.3e} <= 1e-5")
    # a Simulator run of the traceless octree: 2 windows of 8 steps
    cfg = SimConfig(fmm_order=3, tree_steps=8)
    sim = Simulator(cfg, N, "fmm3_traceless")
    try:
        st = sim.init_acc(particle_state_from_numpy(
            _uniform_box(N, 3), np.zeros((N, 3), np.float32), device=dev))
        torch.cuda.synchronize()
        tw = time.perf_counter()
        st = sim.run(st, 16)
        torch.cuda.synchronize()
        tw = time.perf_counter() - tw
    finally:
        sim.close()
    _require(bool(torch.isfinite(st.pos).all()) and st.pos.shape == (N, 3),
             "fmm3_traceless Simulator finite positions")
    print(f"simulator fmm3_traceless N={N} p=3: 16 steps in {tw:.3f} s "
          f"({tw / 16:.4f} s/step, {16 * N / tw / 1e6:.2f} M "
          f"particle-steps/s); rebuilds {dict(sim.rebuilds)}")
    rows["fmm3_traceless_s_per_step"] = tw / 16
    return rows


def _phase_kd_variants(dev, torch):
    """Phase 10: the kd engine in 2D and in float64 on the card.  Returns
    the float64 P2P kernel's row of the kernels line."""
    import numpy as np
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

    # fmm2_kd at ladder 2's size: N=100k, p=4, r=2, the 2D Gaussian beam
    n2 = 100_000
    cfg = SimConfig(dim=2, omega0=(1.095, 1.0), fmm_order=4, tree_radius=2.0)
    u = tuple(w * x for w, x in zip(cfg.omega0, X_STD[:2]))
    ph, vh = ID.init_gaussian(n2, X_STD[:2], u, dim=2, seed=SEED)
    x = torch.from_numpy(ph).to(dev)
    eng = KdFmmEngine(cfg, n2)
    acc = eng.force(x, eng.build(x))
    err = _kahan_err(acc, x, cfg, n2, torch)
    _require(bool(torch.isfinite(acc).all()), "fmm2_kd finite force")
    sim = Simulator(cfg, n2, "fmm2_kd")
    try:
        st = sim.init_acc(particle_state_from_numpy(ph, vh, device=dev))
        st = sim.run(st, 2)
        torch.cuda.synchronize()
        tw = time.perf_counter()
        st = sim.run(st, 12)
        torch.cuda.synchronize()
        tw = time.perf_counter() - tw
    finally:
        sim.close()
    _require(bool(torch.isfinite(st.pos).all()), "fmm2_kd Simulator finite")
    print(f"fmm2_kd N={n2} p=4 r=2 (L={eng.L}, C={eng.st.C}): mean rel err "
          f"vs Kahan {err:.3e} (bound {KD2_TOL}); Simulator 12 steps "
          f"{tw:.3f} s ({tw / 12:.4f} s/step, {12 * n2 / tw / 1e6:.2f} M "
          f"particle-steps/s)")
    _require(err <= KD2_TOL, f"fmm2_kd {err:.3e} <= {KD2_TOL}")

    # fmm3_kd in float64, Morton sort, N=1M on the uniform box
    cfg = SimConfig(fmm_order=5, tree_radius=2.0, precision="float64")
    ph = _uniform_box(N, 3, np.float64)
    x = torch.from_numpy(ph).to(dev)
    eng = KdFmmEngine(cfg, N, sort_mode="morton")
    tb = time.perf_counter()
    fs = eng.build(x)
    torch.cuda.synchronize()
    tb = time.perf_counter() - tb
    ppad = eng.pad_array(x, fs, fill=FAR)
    pblk = ppad.reshape(eng.G_blk, eng.C_blk, 3)

    def kern():
        return eng._stage_p2p(ppad, fs)

    def plain():
        return p2p_cuda.p2p_plain(pblk, fs.p2p_row_ptr, fs.p2p_col2d,
                                  eng.nsub, cfg.eps2)

    got = kern().reshape(pblk.shape)
    ref = plain()
    rel, mabs = _rel_dev(got, ref)
    ms = _cuda_ms(kern, 5, torch)
    plain_ms = _cuda_ms(plain, 1, torch)
    acc = eng.force(x, fs)
    err = _kahan_err(acc, x, cfg, N, torch)
    print(f"p2p float64 N={N} morton L={eng.L} C={eng.st.C} build {tb:.3f} "
          f"s: kernel vs plain {rel:.3e} of max|a| (max_abs {mabs:.3e}); "
          f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}; force (p=5, r=2) "
          f"mean rel err vs float64 Kahan {err:.3e} (bound {FORCE_TOL})")
    _require(got.dtype == torch.float64 and acc.dtype == torch.float64,
             "float64 outputs")
    _require(rel <= F64_P2P_TOL, f"float64 P2P {rel:.3e} <= {F64_P2P_TOL}")
    _require(err <= FORCE_TOL, f"float64 force {err:.3e} <= {FORCE_TOL}")
    row = dict(max_rel_err=rel, max_abs_err=mabs,
               max_abs_ref=float(ref.abs().max()), ms=ms, plain_ms=plain_ms)
    del got, ref, ppad, pblk, acc, fs, eng

    # the main path in float64: a Simulator with the device builder
    windows = 3
    sim = Simulator(cfg.replace(tree_async_build="device"), N)
    try:
        torch.cuda.synchronize()
        p2p_cuda.launches = 0
        st = sim.init_acc(particle_state_from_numpy(
            ph, np.zeros_like(ph), device=dev))
        torch.cuda.synchronize()
        tw = time.perf_counter()
        st = sim.run(st, 8 * windows)
        torch.cuda.synchronize()
        tw = time.perf_counter() - tw
        row["launches"] = p2p_cuda.launches
    finally:
        sim.close()
    evals = 1 + 8 * windows
    print(f"simulator float64 N={N} tree_async_build=device: "
          f"{8 * windows} steps in {tw:.3f} s ({tw / (8 * windows):.4f} "
          f"s/step); rebuilds {dict(sim.rebuilds)}; p2p launches "
          f"{row['launches']} = force evals {evals}")
    _require(bool(torch.isfinite(st.pos).all()), "float64 Simulator finite")
    _require(row["launches"] == evals, f"float64 P2P launches "
             f"{row['launches']} == force evaluations {evals}")
    _require(sim.rebuilds["adopt_device"] == windows - 2,
             f"{windows - 2} adopted device rebuilds: {dict(sim.rebuilds)}")
    return row


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
    from coulomb_oscillators_tpu_torch import cli, native
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    from coulomb_oscillators_tpu_torch.models import integrators as I
    from coulomb_oscillators_tpu_torch.models import oscillator as M
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.ops import energy as E
    from coulomb_oscillators_tpu_torch.ops.fmm import kdtree, p2p_cuda
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine
    from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
    from coulomb_oscillators_tpu_torch.utils import io as SIO

    dev = torch.device("cuda", 0)
    smi = _smi()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(subprocess.run([native.nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1])
    _require(torch.backends.cuda.matmul.allow_tf32 is False,
             "TF32 matmuls are off")
    _require(torch.get_float32_matmul_precision() == "highest",
             "float32 matmul precision is 'highest'")
    _phase("device", t0)

    # ---- 2. build: one compiler per source, all started together --------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for f in [pool.submit(p2p_cuda.library.get),
                  pool.submit(D.library.get), pool.submit(native.get_lib)]:
            f.result()
    print(f"build: p2p.cu {p2p_cuda.library.build_seconds:.2f} s, direct.cu "
          f"{D.library.build_seconds:.2f} s, co_native.cpp "
          f"{native.build_seconds:.2f} s (concurrent)")
    for lib in (p2p_cuda.library, D.library):
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {lib.name}: {line.strip()}")
    _phase("build", t0)

    # ---- 3. P2P kernel vs plain ----------------------------------------
    t0 = time.perf_counter()
    kdtree.raw_traversals = 0
    cfg = SimConfig(fmm_order=6, tree_radius=1.67)
    u_std = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
    pos_h, vel_h = ID.init_gaussian(N, X_STD, u_std, seed=SEED)
    pos = torch.from_numpy(pos_h).to(dev)
    # the main path's engine, sub_depth=0, and the two blocks wider than
    # 256 slots that the CLI's -i 0.25 and -maxlevel 10 reach
    p2p_rows = [_p2p_case(c, sd, pos, torch) for c, sd in (
        (cfg, 2), (cfg, 0), (cfg.replace(dens_inhom=0.25), 2),
        (cfg.replace(tree_L=10), 2))]
    _require([r["CB"] for r in p2p_rows[2:]] == [512, 1024],
             f"wide-block engines: {[r['CB'] for r in p2p_rows]}")
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
    p2p_launches = p2p_cuda.launches
    sim.close()
    evals = 1 + WINDOWS * ts
    _require(bool(torch.isfinite(final.pos).all())
             and final.pos.shape == (N, 3), "finite [N, 3] positions")
    _require(p2p_launches == evals,
             f"{p2p_launches} P2P kernel launches == {evals} force evaluations")
    _require(sim.rebuilds["adopt_full"] == WINDOWS - 2,
             f"{WINDOWS - 2} adopted background rebuilds: {dict(sim.rebuilds)}")
    _require(native._lib is not None, "the native host library was used")
    per_step = sorted(w / ts for w in win_s[1:])
    print(f"simulator N={N}: init_acc {ti:.3f} s; window s {win_s}; "
          f"median s/step (windows 2-{WINDOWS}) {per_step[len(per_step) // 2]:.4f}; "
          f"rebuilds {dict(sim.rebuilds)}; boundary wait s {wait_s}; "
          f"host rebuild s {job_s}; "
          f"last rebuild breakdown {sim._fmm.last_build_times}; "
          f"p2p launches {p2p_launches} = force evals {evals}")
    del sim, state, final, pos
    raw_main = kdtree.raw_traversals
    _phase("simulator", t0)

    # ---- 6. direct kernel vs plain and Kahan ---------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(1234)
    for dim in (2, 3):
        p = torch.from_numpy(rng.normal(size=(1000, dim)).astype(np.float32)
                             * 0.01).to(dev)
        e = float(mean_rel_err(D.direct(p, 1e-18, 2e-9),
                               D.direct_kahan(p, 1e-18, 2e-9)))
        print(f"direct n=1000 dim={dim}: mean rel err vs Kahan {e:.3e} "
              f"(bound {DIRECT_KAHAN_TOL})")
        _require(e <= DIRECT_KAHAN_TOL, f"direct n=1000 dim={dim} vs Kahan "
                 f"{e:.3e} <= {DIRECT_KAHAN_TOL}")
    beams = _cli_beams(N_CLI)
    direct_rows = {}
    for dim in (3, 2):
        c, ph, _ = beams[dim]
        p = torch.from_numpy(ph).to(dev)
        eps2, kap = c.eps2, c.kappa(N_CLI)
        got = D.direct(p, eps2, kap)
        plain = D.direct_plain(p, eps2, kap)
        kahan = D.direct_kahan(p, eps2, kap)
        rel, mabs = _rel_dev(got, plain)
        e_k = float(mean_rel_err(got, kahan))
        e_p = float(mean_rel_err(plain, kahan))
        ms = _cuda_ms(lambda: D.direct(p, eps2, kap), 20, torch)
        plain_ms = _cuda_ms(lambda: D.direct_plain(p, eps2, kap), 3, torch)
        pairs = N_CLI * N_CLI
        print(f"direct N={N_CLI} dim={dim} splits="
              f"{D.splits_for(N_CLI, torch.cuda.get_device_properties(dev).multi_processor_count)}: "
              f"kernel vs plain rel_dev={rel:.3e} max_abs={mabs:.3e}; mean "
              f"rel err vs Kahan kernel {e_k:.3e} plain {e_p:.3e}; "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"kernel_Gpairs_per_s={pairs / ms / 1e6:.1f} "
              f"plain_Gpairs_per_s={pairs / plain_ms / 1e6:.2f}")
        _require(bool(torch.isfinite(got).all()), "finite direct output")
        _require(rel <= P2P_TOL, f"direct dim={dim} vs plain {rel:.3e} <= "
                 f"{P2P_TOL}")
        _require(e_k <= max(1e-5, 2 * e_p), f"direct dim={dim} vs Kahan "
                 f"{e_k:.3e} <= max(1e-5, 2 x {e_p:.3e})")
        direct_rows[dim] = dict(dim=dim, max_rel_err=rel, max_abs_err=mabs,
                                max_abs_ref=float(plain.abs().max()),
                                kahan_mean_rel_err=e_k,
                                plain_kahan_mean_rel_err=e_p, ms=ms,
                                plain_ms=plain_ms)
    _phase("direct", t0)

    # ---- 7. the CLI on the card ----------------------------------------
    t0 = time.perf_counter()
    # an independent count of force evaluations: every "direct" Coulomb
    # force the CLI builds goes through make_coulomb_force
    make_coulomb = M.make_coulomb_force
    force_evals = [0]

    def counting_coulomb(config, n, engine="direct"):
        f = make_coulomb(config, n, engine)
        if engine != "direct":
            return f

        def counted(p):
            force_evals[0] += 1
            return f(p)
        return counted

    per_step = I.FORCE_EVALS["leapfrog"]
    with tempfile.TemporaryDirectory() as tmp:
        runs = [
            ("3d", ["-n", str(N_CLI), "-iters", "200", "-steps", "100",
                    "-engine", "direct"], 3, np.float32, [0, 100, 200]),
            ("resume", [None, "-iters", "100", "-steps", "100",
                        "-engine", "direct"], 3, np.float32, [0, 100]),
            ("2d", ["-dim", "2", "-engine", "direct", "-n", str(N_CLI),
                    "-iters", "100", "-steps", "100"], 2, np.float64,
             [0, 100]),
        ]
        M.make_coulomb_force = counting_coulomb
        D.launches = 0
        try:
            for name, args, dim, fdt, its in runs:
                out = os.path.join(tmp, name)
                if args[0] is None:          # resume from the 3D run's last
                    args = [SIO.snapshot_name(os.path.join(tmp, "3d"), 200,
                                              5e-4)] + args[1:]
                tc = time.perf_counter()
                _require(cli.main(args + ["-o", out]) == 0, f"cli {name}")
                tc = time.perf_counter() - tc
                iters = int(args[args.index("-iters") + 1])
                want = sorted(f"out{i}_0.000500.bin" for i in its)
                got = sorted(f for f in os.listdir(out) if f.endswith(".bin"))
                _require(got == want, f"cli {name} snapshots {got} == {want}")
                _require(os.path.exists(os.path.join(out, "args.txt")),
                         f"cli {name} args.txt")
                size = 2 * N_CLI * dim * np.dtype(fdt).itemsize
                for f in got:
                    _require(os.path.getsize(os.path.join(out, f)) == size,
                             f"cli {name} {f} is {size} bytes")
                sp, sv = SIO.read_state(os.path.join(out, want[-1]), dim=dim,
                                        dtype=fdt)
                _require(sp.shape == (N_CLI, dim) and np.isfinite(sp).all()
                         and np.isfinite(sv).all(), f"cli {name} finite")
                print(f"cli {name}: {iters} iterations in {tc:.3f} s "
                      f"({(iters + 1) * N_CLI / tc / 1e6:.2f} M "
                      f"particle-steps/s incl. start-up and snapshots); "
                      f"{len(got)} snapshots of {size} bytes")
            sim_evals = sum(1 + (int(a[a.index("-iters") + 1]) + 1) * per_step
                            for _, a, *_ in runs)
            _require(force_evals[0] == sim_evals == D.launches,
                     f"direct launches {D.launches} == force evaluations "
                     f"{force_evals[0]} == {sim_evals}")
            tc = time.perf_counter()
            _require(cli.main(["-test", "-engine", "direct", "-n",
                               str(N_CLI)]) == 0, "cli -test")
            tc = time.perf_counter() - tc
        finally:
            M.make_coulomb_force = make_coulomb
        direct_launches = D.launches
    _require(direct_launches == force_evals[0] > sim_evals,
             f"direct launches {direct_launches} == force evaluations "
             f"{force_evals[0]} (with -test)")
    print(f"cli -test: {tc:.3f} s; direct launches {direct_launches} = "
          f"force evals {force_evals[0]}")
    _phase("cli", t0)

    # ---- 8. energy -----------------------------------------------------
    t0 = time.perf_counter()
    c3, p3, v3 = beams[3]
    ecfg = c3.replace(dt=2e-5)
    sim = Simulator(ecfg, N_CLI, "direct")
    kap, om2 = ecfg.kappa(N_CLI), ecfg.omega0_sq()
    st = sim.init_acc(particle_state_from_numpy(p3, v3, device=dev))
    te = time.perf_counter()
    e0 = E.total_energy_kahan(st.pos, st.vel, ecfg.eps2, kap, om2)
    te = time.perf_counter() - te
    drifts = []
    tr = time.perf_counter()
    for _ in range(4):
        st = sim.run(st, 500)
        e = E.total_energy_kahan(st.pos, st.vel, ecfg.eps2, kap, om2)
        drifts.append(abs(e - e0) / abs(e0))
    tr = time.perf_counter() - tr
    sim.close()
    print(f"energy: direct N={N_CLI} dt={ecfg.dt} leapfrog, 2000 steps: "
          f"relative drift after each 500 {drifts}; max {max(drifts):.3e} "
          f"(bound {DRIFT_TOL}); E0={e0:.12e}; total_energy_kahan "
          f"{te:.3f} s; 2000 steps + 4 energies {tr:.3f} s")
    _require(max(drifts) <= DRIFT_TOL, f"drift {max(drifts):.3e} <= "
             f"{DRIFT_TOL} at dt={ecfg.dt}")
    pcfg = SimConfig(fmm_order=5, tree_radius=2.5)
    p = torch.from_numpy(p3).to(dev)
    eng = KdFmmEngine(pcfg, N_CLI)
    fs = eng.build(p)
    tp = time.perf_counter()
    phi = eng.potential(p, fs)
    torch.cuda.synchronize()
    tp = time.perf_counter() - tp
    rows = pcfg.kappa(N_CLI) * E.potential_rows_kahan(p, pcfg.eps2)
    pe = float(((phi - rows).abs() / rows.abs()).mean())
    print(f"potential: kd p=5 r=2.5 N={N_CLI} ({tp:.3f} s) mean rel err "
          f"vs Kahan rows {pe:.3e} (bound {POT_TOL})")
    _require(bool(torch.isfinite(phi).all()) and phi.shape == (N_CLI,),
             "finite [N] potential")
    _require(pe <= POT_TOL, f"potential {pe:.3e} <= {POT_TOL}")
    _phase("energy", t0)

    # ---- 9. uniform-grid engines ---------------------------------------
    t0 = time.perf_counter()
    _phase_grid_engines(dev, torch)
    _phase("grid engines", t0)

    # ---- 10. kd in 2D and float64 --------------------------------------
    t0 = time.perf_counter()
    f64_row = _phase_kd_variants(dev, torch)
    _phase("kd 2D and float64", t0)

    # ---- 11. the native library was used -------------------------------
    t0 = time.perf_counter()
    print(f"native: co_native built in {native.build_seconds} s; numpy "
          f"traversals in phases 3-5: {raw_main}")
    _require(native._lib is not None and raw_main == 0,
             "the N=1M kd builds of phases 3-5 went through co_native")
    _phase("native", t0)

    row, drow = p2p_rows[0], direct_rows[3]
    print(json.dumps({"kernels": [
        {"name": "p2p", "route": "cuda",
         "source": "coulomb_oscillators_tpu_torch/csrc/p2p.cu",
         "replaces": "coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py:52",
         "also_replaces": "coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py:110",
         "launches": p2p_launches, "max_abs_err": row["max_abs_err"],
         "max_abs_ref": row["max_abs_ref"],
         "max_rel_err": row["max_rel_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "cases": p2p_rows},
        {"name": "p2p_float64", "route": "cuda",
         "source": "coulomb_oscillators_tpu_torch/csrc/p2p.cu",
         "replaces": "coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py:52",
         "launches": f64_row["launches"],
         "max_abs_err": f64_row["max_abs_err"],
         "max_abs_ref": f64_row["max_abs_ref"],
         "max_rel_err": f64_row["max_rel_err"], "ms": f64_row["ms"],
         "plain_ms": f64_row["plain_ms"]},
        {"name": "direct", "route": "cuda",
         "source": "coulomb_oscillators_tpu_torch/csrc/direct.cu",
         "replaces": "coulomb_oscillators_tpu/ops/direct.py:161",
         "launches": direct_launches, "max_abs_err": drow["max_abs_err"],
         "max_abs_ref": drow["max_abs_ref"],
         "max_rel_err": drow["max_rel_err"], "ms": drow["ms"],
         "plain_ms": drow["plain_ms"], "cases": [direct_rows[3],
                                                 direct_rows[2]]}]}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
