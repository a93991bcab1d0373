#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's paths through the entry points a user calls, and checks
them: the kd-tree FMM Simulator at N=1,000,000 (the README's Gaussian beam,
p=6, r=1.67), and the CLI's direct engine at its default N=30001.  The
Simulator runs its window steps as CUDA graphs unless ``CO_CUDA_GRAPHS=0``.

  1. device: a CUDA card, its name and power limit, the toolchain, and
     float32 matmuls kept out of TF32;
  2. build: the two kernels (csrc/p2p.cu, csrc/direct.cu; nvcc for sm_90a)
     and the native host library (g++), all from the sources in this
     checkout and all started together;
  3. P2P kernel vs its plain PyTorch version on the card at N=1M, on the
     real engine state (nsub=4, CB=128), a sub_depth=0 engine (nsub=1),
     dens_inhom=0.25 (CB=512) and tree_L=10 (CB=1024): max|da| / max|a|
     <= 1e-5, with CUDA-event times of both; each case's work counted from
     its inputs (entries, slot pairs, real pairs, bytes), its flop, rsqrt
     and byte bounds (utils/roofline.py) and the kernel's share of the
     largest;
  4. accuracy: engine.force at N=1M against the Kahan direct oracle on
     1,000 seeded targets, mean relative error <= 1e-3;
  5. simulator: a small run on the card against the same run on the CPU,
     then init_acc + 3 windows of tree_steps=8 at N=1M with the default
     async rebuild pipeline (the first boundary primes it, the next one
     adopts a background re-sort with a repad); positions stay finite and
     the P2P kernel's launch count equals the number of force evaluations;
  6. the direct kernel: at n=1000 (dims 2 and 3) against Kahan, mean
     relative error <= 1e-6; on the CLI's 3D Gaussian beam at N=4096
     (ladder 1), 30001 (the CLI's default) and 262144, and on its 2D KV
     beam at N=30001, against the plain version, max|da| / max|a| <=
     1e-5, with CUDA-event times of both, the split count, the bound
     (utils/roofline.py) and the kernel's share of it; at N=30001 also
     against Kahan, within max(1e-5, 2x the plain version's error);
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
     (<= 1e-12 of max|a|, both timed, with its work and bounds as in
     phase 3), the force against a float64 Kahan
     oracle (<= 1e-3), and a Simulator run with tree_async_build="device"
     over 3 windows of 8 steps (one device rebuild adopted; P2P launches ==
     force evaluations);
 11. bench: scripts.bench in --quick mode at N=1M, full width (p=6,
     r=1.67, boost 1.5): the fresh-tree error and every measured step of
     the reuse window at the tuned cadence (16 / 2 / 2) <= 1e-3 against
     the Kahan oracle on 2048 targets, the headline timed at the tuned and
     at the default cadence (8 / 1 / 1), finite state, and the P2P
     kernel's launch count equals the force evaluations the bench made;
     the bench's JSON is printed on a line of its own;
 12. profile: scripts.profile_force stage rows (CUDA events) for fmm3_kd
     at N=1M (p=6, r=1.67) and fmm2_kd at N=100k (p=4, r=2) with each
     stage's own kernel time beside them, the stage sum within 0.8-1.5x of
     the padded force by kernel times (0.8-3.0x by CUDA-event times, which
     hold the host's launch gaps); a torch.profiler trace of 3
     padded force calls whose kernel histogram names the P2P kernel; P2P
     launches == the profile's own count of its force evaluations;
 13. viewer: the port's CLI writes 2 snapshots on the card, the port's
     view renders them, the PNGs decode to 792 x 792 with a non-empty red
     channel;
 14. the native library: every N=1M kd build of phases 3-5 went through
     co_native, none through the numpy traversal;
 15. multi-device (parallel/*, Simulator(mesh=), cli -chips) at N=1M, p=6,
     r=1.67: ranks started by parallel.mesh.spawn, 2 and then 4 of them
     sharing cuda:0 (gloo, collectives through host memory), then 1 with
     the default placement (NCCL).  Each run: the particle-sharded
     force_padded against the single-device force_padded on the same tree
     (<= 1e-5 of max|a|) and the Kahan oracle on 1,000 targets (<= 1e-3),
     the hop histogram, the bytes a rank hands to each collective in one
     force evaluation, the force and its far / halo / near parts timed,
     then the mesh-mode Simulator: init_acc + 3 windows of tree_steps=8
     with the async pipeline (one priming refresh, one adopted background
     rebuild), finite, all ranks equal, and on every rank as many P2P
     kernel launches as force evaluations.  Then make_sharded_direct, ring
     and all-gather, on 2 ranks sharing the card at N=30001 against the
     single-device direct kernel (<= 1e-5), the direct kernel's
     separate-targets entry against the plain block-on-block form (<=
     1e-5, CUDA-event times of both), and the CLI with -chips 1 (snapshot
     names and sizes; -chips 2 is refused with -1), and the dry run of
     scripts/graft_entry.py on 2 ranks sharing the card (with the default
     placement it raises: one device).  A rank that raises fails the run.
     The timings are labelled "N ranks sharing one <card>";
 16. graphs: the Simulator's CUDA graphs (utils/graphs.py; every phase
     above runs with them, as a user's run does) against the same steps
     run eagerly (CO_CUDA_GRAPHS=0) from one start: Simulator("direct") on
     the CLI's 3D beam at N=30001, 200 steps, positions bitwise equal;
     fmm3_kd at N=1M, p=6, r=1.67, 16/2/2, three windows and a step (one
     adopted full re-sort with its repad), twice eagerly and once with
     graphs, graph against eager within max(2 x eager against eager, 1e-6)
     of max|pos|; fmm3_traceless at N=1M (uniform box) and fmm2_kd at
     N=100k, 2 windows of 8 steps, within 1e-5; the kernels' launches
     equal the force evaluations in both modes; s/step, CUDA-event
     ms/step, captures, capture seconds and peak memory of each run,
     printed with the card's name and power limit;
 17. probes: the four probe twins of scripts/ through their functions at
     N=1M on the production beam, one JSON line each with its seconds and
     the card: stale_anatomy (p=6, r=1.43, boost 1.5, 16/2/2): 17 rows,
     every error finite and positive, the fresh rebuild's <= 1e-3, P2P
     launches (graph replays included) == the force evaluations it
     reports; err_diag (p=6, r=1.67, 8192 targets): mean error <= 1e-3,
     the P2P kernel's near field against the compensated plain pass
     (p2p_kahan) finite with a mean relative difference <= P2P_NOISE_TOL,
     2 P2P and 1 direct launch (the direct kernel at N=1M);
     leaf_size_probe at the production level L=15: its p2p and m2l counts
     equal the production engine's last_counts of a margin-free build of
     the same beam; sortmode_probe (p=6, r=1.67): kd_native and kd_device
     <= 1e-3, morton <= MORTON_TOL (2e-3: its elongated leaves), one P2P
     launch each.

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
import types

N = 1_000_000
X_STD = (0.003, 0.001, 0.01)
SEED = 0
N_TARGETS = 1000
WINDOWS = 3
P2P_TOL = 1e-5          # the reference's own kernel contract
FORCE_TOL = 1e-3        # mean relative force error against Kahan
N_CLI = 30001           # the CLI's default -n
# the direct kernel's cases (dim, N): the CLI's 3D beam at ladder 1's N,
# the CLI's N and a large N; the CLI's 2D beam at its N
DIRECT_CASES = ((3, 4096), (3, N_CLI), (3, 262144), (2, N_CLI))
DIRECT_KAHAN_TOL = 1e-6  # direct kernel vs Kahan at n=1000 (test_direct.py)
DRIFT_TOL = 1e-6        # energy drift bound (README north star)
POT_TOL = 2e-3          # FMM potential vs Kahan rows (test_fmm_kd.py)
N_GRID = 100_000        # uniform-grid engines, card vs CPU
OCT_TOL = 5e-3          # octree p=5 vs Kahan (tests/test_octree.py:35)
APPEL_TOL = 0.09        # Appel vs Kahan (tests/test_octree.py:53)
KD2_TOL = 2e-3          # fmm2_kd vs Kahan (test_fmm_kd_variants.py:31)
F64_P2P_TOL = 1e-12     # double P2P kernel vs its plain float64 version
# eager stages' sum over the padded force they make: of the kernels' own
# times, and of the CUDA-event times (which hold the host's launch gaps,
# overlapped in the whole force)
STAGE_SUM = (0.8, 1.5)
STAGE_SUM_EVENTS = (0.8, 3.0)
# mean relative difference, over the real slots at N=1M (p=6, r=1.67), of
# the P2P kernel's near field from the compensated plain pass
# (scripts/err_diag.py:p2p_kahan): 1.605e-7 measured on an H100, bound ~6x
P2P_NOISE_TOL = 1e-6
# the Morton builder's force error at N=1M, p=6, r=1.67: its keys scale
# each axis to the beam's box, so its leaves are long thin boxes (median
# side ratio ~9, the kd builders' ~2) whose particles reach farther from
# the expansion centre, against the same MAC; its error 1.146e-3 measured
# on an H100 is 3.5x the kd builders' (the reference's Morton error equals
# the port's on the CPU: PERF.md section 7); it is held to twice the
# production bound, the kd builders to the bound
MORTON_TOL = 2e-3


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
    work = _p2p_work(pblk, fs, eng, ms, torch)
    print(f"p2p nsub={eng.nsub} L={eng.L} C={eng.st.C} Gb={eng.G_blk} "
          f"CB={eng.C_blk} dmax={fs.p2p_col2d.shape[1]} build_s={tb:.3f}: "
          f"rel_dev={rel:.3e} max_abs={mabs:.3e} kernel_ms={ms:.3f} "
          f"plain_ms={plain_ms:.3f}; {work['text']}")
    _require(rel <= P2P_TOL, f"P2P kernel vs plain at nsub={eng.nsub}, "
             f"CB={eng.C_blk}: {rel:.3e} <= {P2P_TOL}")
    return dict(nsub=eng.nsub, CB=eng.C_blk, max_rel_err=rel, max_abs_err=mabs,
                max_abs_ref=float(ref.abs().max()), ms=ms, plain_ms=plain_ms,
                **work["row"])


def _p2p_work(pblk, fs, eng, ms, torch):
    """The P2P call's work counted from its inputs (entries, slot pairs,
    real pairs, bytes) and its bounds on the card (utils/roofline.py):
    a line of text and the kernels line's fields."""
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.utils import roofline
    c = p2p_cuda.pair_counts(pblk, fs.p2p_row_ptr, fs.p2p_col2d, eng.nsub)
    double = pblk.dtype == torch.float64
    b = roofline.bound(c["real_pairs"], c["bytes"], double=double)
    share = b["bound_ms"] / ms
    peak = roofline.FP64_FLOPS if double else roofline.FP32_FLOPS
    text = (f"entries={c['entries']} pairs={c['pairs']} "
            f"real_pairs={c['real_pairs']}; bounds: flop "
            f"{b['flop_ms']:.4f} ms ({roofline.FLOPS_PER_PAIR[3]} flops a "
            f"real pair at {peak / 1e12:g} TFLOP/s), rsqrt "
            f"{b['mufu_ms']:.4f} ms, bytes "
            f"{b['byte_ms']:.4f} ms ({c['bytes']} B); kernel at "
            f"{100 * share:.1f}% of the {b['bound_by']} bound "
            f"{b['bound_ms']:.4f} ms; "
            f"{c['real_pairs'] / ms / 1e9:.3f}T real pairs/s")
    return dict(text=text, row=dict(
        pairs=c["pairs"], real_pairs=c["real_pairs"], entries=c["entries"],
        bytes=c["bytes"], flop_ms=b["flop_ms"], mufu_ms=b["mufu_ms"],
        byte_ms=b["byte_ms"], bound_ms=b["bound_ms"], bound_by=b["bound_by"],
        bound_share=share))


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
    work = _p2p_work(pblk, fs, eng, ms, torch)
    acc = eng.force(x, fs)
    err = _kahan_err(acc, x, cfg, N, torch)
    print(f"p2p float64 N={N} morton L={eng.L} C={eng.st.C} build {tb:.3f} "
          f"s: kernel vs plain {rel:.3e} of max|a| (max_abs {mabs:.3e}); "
          f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}; {work['text']}; "
          f"force (p=5, r=2) mean rel err vs float64 Kahan {err:.3e} "
          f"(bound {FORCE_TOL})")
    _require(got.dtype == torch.float64 and acc.dtype == torch.float64,
             "float64 outputs")
    _require(rel <= F64_P2P_TOL, f"float64 P2P {rel:.3e} <= {F64_P2P_TOL}")
    _require(err <= FORCE_TOL, f"float64 force {err:.3e} <= {FORCE_TOL}")
    row = dict(max_rel_err=rel, max_abs_err=mabs,
               max_abs_ref=float(ref.abs().max()), ms=ms, plain_ms=plain_ms,
               **work["row"])
    del got, ref, ppad, pblk, acc, fs, eng

    # the main path in float64: a Simulator with the device builder
    windows = 3
    sim = Simulator(cfg.replace(tree_async_build="device"), N,
                    engine="fmm3_kd")
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


def _phase_bench(torch):
    """Phase 11: the port's bench in --quick mode at N=1M, full width.
    Returns the bench's JSON object."""
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.scripts import bench as B
    torch.cuda.synchronize()
    p2p_cuda.launches = 0
    out = B.run(n=N, quick=True)
    launches = p2p_cuda.launches
    x = out["extra"]
    print(json.dumps(out), flush=True)
    _require((x["p"], x["r"], x["sub_boost"]) == (6, 1.67, 1.5)
             and (x["tree_steps"], x["resort_every"], x["pipeline"])
             == (16, 2, 2), "the bench's headline is the tuned config at "
             "the tuned cadence")
    _require(x["force_rel_err"] <= FORCE_TOL,
             f"bench fresh-tree error {x['force_rel_err']:.3e} <= {FORCE_TOL}")
    ladder = x["stale_window_errs"]
    _require(sorted(map(int, ladder)) == [0, 4, 8, 12, 16],
             f"window ladder steps {sorted(ladder)}")
    _require(all(v <= FORCE_TOL for v in ladder.values()),
             f"every measured step of the window <= {FORCE_TOL}: {ladder}")
    _require(x["certified"], f"certified: {x['certified_reason']}")
    d = x["default_cadence"]
    _require((d["tree_steps"], d["resort_every"], d["pipeline"])
             == (8, 1, 1) and d["sec_per_step_median"] > 0,
             "the default cadence was timed")
    _require(x["finite"], "bench: finite state")
    _require(launches == x["force_evals"] == x["p2p_kernel_launches"],
             f"bench: {launches} P2P kernel launches == {x['force_evals']} "
             f"force evaluations")
    print(f"bench N={N}: {out['value']:.0f} particle-steps/s at 16/2/2 "
          f"({x['sec_per_step_median']:.4f} s/step), "
          f"{d['particle_steps_per_s']:.0f} at 8/1/1 "
          f"({d['sec_per_step_median']:.4f} s/step); fresh err "
          f"{x['force_rel_err']:.3e}, window errs {ladder}; boundary wait s "
          f"{x['boundary_wait_s']} (tuned) {d['boundary_wait_s']} (default); "
          f"p2p launches {launches} = force evals {x['force_evals']}")
    return out, launches


def _phase_profile(dev, torch):
    """Phase 12: stage rows of fmm3_kd and fmm2_kd and a kernel trace."""
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.scripts import profile_force as PF
    reps, rebuilds, calls = 5, 1, 3
    torch.cuda.synchronize()
    p2p_cuda.launches = 0
    recs = [PF.profile_engine("fmm3_kd", N, 6, 1.67, dev, reps, rebuilds),
            PF.profile_engine("fmm2_kd", PF.N_KD2, 4, 2.0, dev, reps,
                              rebuilds)]
    for rec in recs:
        PF.print_record(rec)
        for key, (lo, hi) in (("summary_device", STAGE_SUM),
                              ("summary", STAGE_SUM_EVENTS)):
            ratio = rec[key]["sum_over_whole"]
            _require(lo <= ratio <= hi, f"{rec['engine']} {key}: stage sum "
                     f"{ratio:.3f} x the padded force within {(lo, hi)}")
        _require(all(v > 0 for v in rec["stages_ms"].values()),
                 f"{rec['engine']} stage times are positive")
    with tempfile.TemporaryDirectory() as tmp:
        tr = PF.trace_force(N, 6, 1.67, dev, tmp, calls)
    PF.print_histogram(tr, "call", "kernels_ms_per_call")
    named = {k: v for k, v in tr["kernels_ms_per_call"].items()
             if "p2p_kernel" in k}
    _require(bool(named), f"the trace names the P2P kernel: "
             f"{list(tr['kernels_ms_per_call'])[:8]}")
    # dim 3 only launches the kernel: the stage rows' force_full,
    # force_padded and p2p (a warm-up and `reps` timed calls each, then a
    # warm-up and one traced call each), and the trace's warm-up and
    # `calls`
    evals = 3 * (1 + reps) + 3 * 2 + 1 + calls
    _require(p2p_cuda.launches == evals, f"profile: {p2p_cuda.launches} P2P "
             f"kernel launches == {evals} force evaluations")
    print(f"profile: P2P kernel in the trace {sum(named.values()):.3f} ms a "
          f"padded force call of {tr['device_ms_per_call']:.2f} ms device "
          f"time; p2p launches {p2p_cuda.launches} = evals {evals}")
    return recs, tr, p2p_cuda.launches


def _phase_viewer():
    """Phase 13: CLI snapshots on the card rendered by the port's viewer."""
    import struct
    import zlib

    import numpy as np
    from coulomb_oscillators_tpu_torch import cli
    from coulomb_oscillators_tpu_torch.scripts import view
    with tempfile.TemporaryDirectory() as tmp:
        out, img = os.path.join(tmp, "run"), os.path.join(tmp, "img")
        _require(cli.main(["-n", str(N_CLI), "-iters", "10", "-steps", "10",
                           "-engine", "direct", "-o", out]) == 0,
                 "cli run for the viewer")
        _require(view.main([out, "-o", img, "--dim", "3", "--dtype", "f4",
                            "--dt", "0.0005", "--stride", "10", "--scale",
                            "auto"]) == 0, "view renders the snapshots")
        frames = sorted(os.listdir(img))
        _require(frames == ["image0.png", "image1.png"], f"frames {frames}")
        for f in frames:
            raw = open(os.path.join(img, f), "rb").read()
            w, h = struct.unpack(">II", raw[16:24])
            idat = raw[raw.index(b"IDAT") + 4:raw.rindex(b"IEND") - 4]
            rgb = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
                h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)
            red = int((rgb[..., 0] > 0).sum())
            _require((w, h) == (792, 792) and red > 0,
                     f"{f}: {w} x {h}, {red} red pixels")
            print(f"viewer {f}: {w} x {h}, {red} red pixels")


def _mesh_rank(mesh, windows):
    """One rank of the multi-device phase at N=1M (p=6, r=1.67, the
    README's Gaussian beam, seed 0): the particle-sharded force against the
    single-device padded force on the same tree (no geometry refresh in
    either) and against the Kahan oracle, the hop histogram, the bytes each
    collective is handed in one force evaluation, the force's parts timed,
    then the mesh-mode Simulator over `windows` windows of 8 steps.
    Returns rank 0's record; a failed check raises on the rank that sees
    it."""
    import torch
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
    from coulomb_oscillators_tpu_torch.parallel.fmm_pshard import (
        PShardedKdFmm, shard_pair_lists)
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

    dev, P = mesh.device, mesh.ndev
    _require(dev == torch.device("cuda", 0), f"rank on cuda:0, got {dev}")
    cfg = SimConfig(fmm_order=6, tree_radius=1.67)
    u_std = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
    pos_h, vel_h = ID.init_gaussian(N, X_STD, u_std, seed=SEED)
    pos = torch.from_numpy(pos_h).to(dev)
    _require(pos.device == dev, "tensors on cuda:0")
    eng = KdFmmEngine(cfg, N)
    fs = eng.build(pos)
    ps = PShardedKdFmm(eng, mesh)
    lists, hops = shard_pair_lists(eng, fs, P)
    ppad = eng.pad_array(pos, fs, fill=FAR)
    ppad_l = ps.shard_padded(ppad)
    _require(tuple(ppad_l.shape) == (eng.G_sub // P, eng.st.C, 3),
             f"shard shape {tuple(ppad_l.shape)}")
    loc = ps.localize(lists, hops, dev)

    torch.cuda.synchronize()
    p2p_cuda.launches = 0
    mesh.bytes.clear()
    mesh.calls.clear()
    acc_l = ps.force_padded(ppad_l, fs, lists, hops)
    torch.cuda.synchronize()
    one_eval = p2p_cuda.launches
    moved, calls = dict(mesh.bytes), dict(mesh.calls)
    _require(one_eval == 1, f"one P2P launch a force evaluation: {one_eval}")
    acc = eng.unpad_array(ps.gather_padded(acc_l), fs)
    rec = dict(P=P, backend=mesh.backend, L=eng.L, C=eng.st.C, hops=hops,
               halo_hops=loc.hops, dmax=int(loc.col2d.shape[1]),
               bytes_per_eval=moved, calls_per_eval=calls,
               hop_hist={str(h): int(lists.p2p_val[i].sum())
                         for i, h in enumerate(hops)})
    if mesh.rank == 0:
        single = eng.unpad_array(eng.force_padded(ppad, fs), fs)
        rec["vs_single"], _ = _rel_dev(acc, single)
        rec["vs_kahan"] = _kahan_err(acc, pos, cfg, N, torch)
        _require(bool(torch.isfinite(acc).all()), "finite sharded force")
        _require(rec["vs_single"] <= P2P_TOL, f"sharded vs single-device "
                 f"force {rec['vs_single']:.3e} <= {P2P_TOL}")
        _require(rec["vs_kahan"] <= FORCE_TOL, f"sharded force vs Kahan "
                 f"{rec['vs_kahan']:.3e} <= {FORCE_TOL}")
        del single
    del acc

    # the force's parts on this rank, host clock around a synchronize (the
    # ranks run at once on the one card, so each part holds its wait for
    # the others)
    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, out

    rec["force_ms"], _ = timed(lambda: ps.force_padded(ppad_l, fs, lists,
                                                       hops))
    rec["far_ms"], _ = timed(lambda: ps.far_padded(ppad_l, fs, loc))
    rec["halo_ms"], cat = timed(lambda: ps.halo_blocks(ppad_l, loc))
    rec["near_ms"], _ = timed(lambda: ps.near_padded(cat, loc))
    del cat, ppad, ppad_l, acc_l, loc, lists, fs, eng, ps

    # mesh-mode Simulator: init_acc + `windows` windows of tree_steps=8
    # with the async pipeline (the first boundary primes it, the next
    # adopts the background rebuild)
    sim = Simulator(cfg, N, engine="fmm3_kd", mesh=mesh)
    try:
        torch.cuda.synchronize()
        p2p_cuda.launches = 0
        sim.init_acc(particle_state_from_numpy(pos_h, vel_h, device=dev))
        ts = sim.config.tree_steps
        win_s = []
        for _ in range(windows):
            torch.cuda.synchronize()
            mesh.barrier()
            tw = time.perf_counter()
            sim.advance_padded(ts)
            torch.cuda.synchronize()
            win_s.append(time.perf_counter() - tw)
        final = sim.current_state()
        torch.cuda.synchronize()
        launches = p2p_cuda.launches
        fstate = sim._fstate
    finally:
        sim.close()
    evals = 1 + windows * ts
    # every rank holds the same state and adopted the same lists
    digest = torch.stack(
        [final.pos.double().sum(), final.vel.double().abs().sum(),
         final.pos[::997].double().abs().sum()]
        + [getattr(fstate, f).double().sum() for f in (
            "perm", "p2p_src", "m2l_tgt", "m2l_src", "p2p_row_ptr",
            "p2p_col2d", "m2l_gtgt")])
    rows = mesh.all_gather(digest[None].contiguous())
    counts = mesh.all_gather(torch.tensor([launches], device=dev))
    _require(bool((rows == rows[0]).all()), "all ranks hold the same state "
             "and adopted the same lists")
    _require(bool(torch.isfinite(final.pos).all())
             and final.pos.shape == (N, 3), "finite [N, 3] positions")
    _require(launches == evals, f"rank {mesh.rank}: {launches} P2P kernel "
             f"launches == {evals} force evaluations")
    _require(sim.rebuilds["adopt_full"] == windows - 2
             and sim.rebuilds["sync_refresh"] == 1,
             f"{windows - 2} adopted rebuilds: {dict(sim.rebuilds)}")
    rec.update(sim_launches=counts.tolist(), sim_evals=evals, win_s=win_s,
               rebuilds=dict(sim.rebuilds), wait_s=sim.rebuild_wait_total)
    return rec


def _mesh_direct_rank(mesh, n):
    """The sharded direct force, ring and all-gather, on the CLI's 3D beam
    at `n`: rank 0 holds both against the single-device direct kernel."""
    import torch
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.parallel import mesh as PM
    cfg, ph, _ = _cli_beams(n)[3]
    dev = mesh.device
    pos = torch.from_numpy(ph).to(dev)
    eps2, kap = cfg.eps2, cfg.kappa(n)
    ppos, _ = PM.pad_to_multiple(pos, mesh.ndev)
    m = ppos.shape[0] // mesh.ndev
    local = ppos[mesh.rank * m:(mesh.rank + 1) * m].contiguous()
    rec = {}
    for scheme in ("ring", "allgather"):
        fn = PM.make_sharded_direct(mesh, eps2, kap, dim=3, scheme=scheme)
        torch.cuda.synchronize()
        D.launches = 0
        acc = mesh.all_gather(fn(local))[:n]
        torch.cuda.synchronize()
        rec[scheme + "_launches"] = D.launches
        want = mesh.ndev if scheme == "ring" else 1
        _require(D.launches == want, f"{scheme}: {D.launches} direct kernel "
                 f"launches == {want} block-on-block forces")
        if mesh.rank == 0:
            rec[scheme], _ = _rel_dev(acc, D.direct(pos, eps2, kap))
            _require(rec[scheme] <= P2P_TOL, f"sharded direct ({scheme}) vs "
                     f"single-device {rec[scheme]:.3e} <= {P2P_TOL}")
    return rec


def _phase_multi_device(dev, smi, torch):
    """Phase 15: the multi-device layer on the one card.  Returns (per-rank
    P2P launches by run, the direct kernel's launches by scheme, the
    separate-targets entry's row)."""
    import numpy as np
    from coulomb_oscillators_tpu_torch import cli
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.parallel import mesh as PM
    from coulomb_oscillators_tpu_torch.utils import roofline

    windows = 3
    p2p_by_run = {}
    # 2 and 4 ranks sharing the card (gloo, collectives through host
    # memory), then 1 rank with the default placement (NCCL on cuda:0)
    for P, kw in ((2, dict(device="cuda:0", share_device=True)),
                  (4, dict(device="cuda:0", share_device=True)),
                  (1, dict())):
        t0 = time.perf_counter()
        r = PM.spawn(_mesh_rank, P, windows, timeout=300, **kw)
        label = (f"{P} ranks sharing one {smi}" if P > 1
                 else f"1 rank (NCCL) on {smi}")
        _require(r["backend"] == ("gloo" if P > 1 else "nccl"),
                 f"backend {r['backend']}")
        total = max(sum(r["hop_hist"].values()), 1)
        per_step = sorted(w / 8 for w in r["win_s"][1:])
        print(f"mesh [{label}]: L={r['L']} C={r['C']} hops={r['hops']} "
              f"dmax={r['dmax']}; sharded force vs single-device "
              f"{r['vs_single']:.3e} of max|a| (bound {P2P_TOL}), vs Kahan "
              f"{r['vs_kahan']:.3e} (bound {FORCE_TOL}); hop histogram "
              f"{r['hop_hist']} (hop 0: {r['hop_hist']['0'] / total:.4f}); "
              f"bytes a rank hands to each collective in one force "
              f"evaluation {r['bytes_per_eval']} (calls "
              f"{r['calls_per_eval']}); rank 0 force {r['force_ms']:.2f} ms "
              f"= far {r['far_ms']:.2f} + halo {r['halo_ms']:.2f} + near "
              f"{r['near_ms']:.2f} ms; simulator window s {r['win_s']} "
              f"(median s/step of windows 2-{windows} "
              f"{per_step[len(per_step) // 2]:.4f}); rebuilds "
              f"{r['rebuilds']}, boundary wait {r['wait_s']:.3f} s; p2p "
              f"launches per rank {r['sim_launches']} = force evals "
              f"{r['sim_evals']}; spawn {time.perf_counter() - t0:.1f} s")
        _require(all(c == r["sim_evals"] for c in r["sim_launches"])
                 and len(r["sim_launches"]) == P,
                 f"P2P launches on every rank {r['sim_launches']} == "
                 f"{r['sim_evals']}")
        p2p_by_run[f"mesh_{P}" + ("_nccl" if P == 1 else "")] = \
            r["sim_launches"][0]

    # the sharded direct force, 2 ranks sharing the card
    r = PM.spawn(_mesh_direct_rank, 2, N_CLI, device="cuda:0",
                 share_device=True)
    print(f"mesh direct [2 ranks sharing one {smi}] N={N_CLI}: ring "
          f"{r['ring']:.3e}, allgather {r['allgather']:.3e} of max|a| "
          f"against the single-device kernel (bound {P2P_TOL}); direct "
          f"launches a rank: ring {r['ring_launches']}, allgather "
          f"{r['allgather_launches']}")
    direct_by_scheme = {"mesh_ring": r["ring_launches"],
                        "mesh_allgather": r["allgather_launches"]}

    # the kernel's separate-targets entry against the plain block-on-block
    # form, at the all-gather scheme's shapes (a rank's rows x all sources)
    cfg, ph, _ = _cli_beams(N_CLI)[3]
    src = torch.from_numpy(ph).to(dev)
    tgt = src[:-(-N_CLI // 2)].contiguous()
    eps2, kap = cfg.eps2, cfg.kappa(N_CLI)
    got = D.direct_targets(tgt, src, eps2, kap)
    plain = D.direct_targets_plain(tgt, src, eps2, kap)
    rel, mabs = _rel_dev(got, plain)
    ms = _cuda_ms(lambda: D.direct_targets(tgt, src, eps2, kap), 20, torch)
    plain_ms = _cuda_ms(lambda: D.direct_targets_plain(tgt, src, eps2, kap),
                        3, torch)
    pairs = tgt.shape[0] * src.shape[0]
    b = roofline.bound(pairs, (2 * tgt.numel() + src.numel()) * 4, dim=3)
    ts_row = dict(dim=3, n_targets=tgt.shape[0], n=N_CLI, max_rel_err=rel,
                  max_abs_err=mabs, max_abs_ref=float(plain.abs().max()),
                  ms=ms, plain_ms=plain_ms, pairs=pairs,
                  bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                  bound_share=b["bound_ms"] / ms)
    print(f"direct targets [{tgt.shape[0]} x {N_CLI}] on {smi}: kernel vs "
          f"plain rel_dev={rel:.3e} max_abs={mabs:.3e}; kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.3f}; bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}; kernel at {100 * ts_row['bound_share']:.1f}%)")
    _require(rel <= P2P_TOL, f"direct targets entry vs plain {rel:.3e} <= "
             f"{P2P_TOL}")

    # the CLI with -chips 1 on the card (NCCL, world size 1)
    with tempfile.TemporaryDirectory() as tmp:
        tc = time.perf_counter()
        _require(cli.main(["-n", str(N_CLI), "-iters", "16", "-steps", "8",
                           "-chips", "1", "-engine", "fmm3_kd", "-o", tmp])
                 == 0, "cli -chips 1")
        tc = time.perf_counter() - tc
        want = [f"out{i}_0.000500.bin" for i in (0, 16, 8)]
        got = sorted(f for f in os.listdir(tmp) if f.endswith(".bin"))
        _require(got == sorted(want), f"cli -chips 1 snapshots {got}")
        for f in got:
            _require(os.path.getsize(os.path.join(tmp, f))
                     == 2 * N_CLI * 3 * 4, f"cli -chips 1 {f} bytes")
        _require(os.path.exists(os.path.join(tmp, "args.txt")),
                 "cli -chips 1 args.txt")
        sp = np.fromfile(os.path.join(tmp, "out16_0.000500.bin"), np.float32)
        _require(bool(np.isfinite(sp).all()), "cli -chips 1 finite")
    _require(cli.main(["-n", "64", "-chips", "2", "-engine", "fmm3_kd"])
             == -1, "cli -chips 2 on one card returns -1")
    print(f"cli -chips 1 N={N_CLI} fmm3_kd: 16 iterations in {tc:.3f} s; "
          f"{len(got)} snapshots of {2 * N_CLI * 3 * 4} bytes; -chips 2 "
          f"refused (one device visible)")

    # the dry run: its default placement needs a card a rank
    from coulomb_oscillators_tpu_torch.scripts import graft_entry
    try:
        graft_entry.dryrun_multichip(2)
    except RuntimeError as e:
        _require("devices visible" in str(e), f"dry run placement: {e}")
    else:
        _require(False, "dryrun_multichip(2) on one card must raise")
    td = time.perf_counter()
    graft_entry.dryrun_multichip(2, device="cuda:0", share_device=True)
    print(f"dryrun_multichip ok: 2 ranks sharing one {smi}, "
          f"{time.perf_counter() - td:.1f} s")
    return p2p_by_run, direct_by_scheme, ts_row


def _sim_windows(torch, graphs_on, cfg, n, engine, pos_h, vel_h, windows,
                 dev, busy=False):
    """init_acc, then one ``run`` per entry of `windows` (its step count) on
    a Simulator built with ``CO_CUDA_GRAPHS`` 1 or 0.  Returns the final
    positions, each run's host s/step (synchronised) and CUDA-event
    ms/step, the captures and their seconds, the peaks of allocated and of
    reserved device memory from init_acc on (a graph's pool is reserved),
    the kernels' launches and the rebuilds.  With `busy`, one more run of
    the last window's length under torch.profiler gives the kernels'
    device ms/step, and the busy share is that over the last untraced
    run's ms/step (both runs start with their window's rebuild)."""
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
    os.environ["CO_CUDA_GRAPHS"] = "1" if graphs_on else "0"
    try:
        sim = Simulator(cfg, n, engine)
    finally:
        del os.environ["CO_CUDA_GRAPHS"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p2p_cuda.launches = D.launches = 0
    out = dict(s_per_step=[], event_ms_per_step=[])
    try:
        st = sim.init_acc(particle_state_from_numpy(pos_h, vel_h, device=dev))
        for k in windows:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            tw = time.perf_counter()
            e0.record()
            st = sim.run(st, k)
            e1.record()
            torch.cuda.synchronize()
            out["s_per_step"].append((time.perf_counter() - tw) / k)
            out["event_ms_per_step"].append(e0.elapsed_time(e1) / k)
        if busy:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                st = sim.run(st, windows[-1])
                torch.cuda.synchronize()
            us = sum(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0)
                     for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
            out["device_ms_per_step"] = us / 1e3 / windows[-1]
            out["busy_share"] = (out["device_ms_per_step"]
                                 / (1e3 * out["s_per_step"][-1]))
    finally:
        sim.close()
    g = sim.graph
    out.update(pos=st.pos, graphs=graphs_on,
               captures=g.captures if g else 0,
               capture_s=g.capture_seconds if g else 0.0,
               peak_bytes=torch.cuda.max_memory_allocated(),
               peak_reserved_bytes=torch.cuda.max_memory_reserved(),
               p2p_launches=p2p_cuda.launches, direct_launches=D.launches,
               rebuilds=dict(getattr(sim, "rebuilds", {})))
    _require(bool(torch.isfinite(st.pos).all()), f"{engine} finite "
             f"(graphs={graphs_on})")
    return out


def _phase_graphs(dev, smi, torch):
    """Phase 16: the Simulator's CUDA graphs against its eager steps."""
    import numpy as np
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID

    def line(name, r):
        keys = ("s_per_step", "event_ms_per_step", "captures", "capture_s",
                "peak_bytes", "peak_reserved_bytes", "p2p_launches",
                "direct_launches", "rebuilds", "device_ms_per_step",
                "busy_share")
        print(f"graphs {name} graphs={r['graphs']} ({smi}): "
              + json.dumps({k: r[k] for k in keys if k in r}))

    rows = {}
    # (a) the direct engine on the CLI's 3D beam: bitwise equal
    c3, p3, v3 = _cli_beams(N_CLI)[3]
    a = [_sim_windows(torch, g, c3, N_CLI, "direct", p3, v3, (20, 180), dev)
         for g in (True, False)]
    for r in a:
        line(f"direct N={N_CLI}", r)
        _require(r["direct_launches"] == 1 + 200, f"direct launches "
                 f"{r['direct_launches']} == 201 force evaluations")
    _require(a[0]["captures"] == 1, f"direct: one capture ({a[0]['captures']})")
    _require(torch.equal(a[0]["pos"], a[1]["pos"]),
             "direct: graph and eager positions bitwise equal")
    print(f"graphs direct N={N_CLI}: 200 steps bitwise equal; ms/step "
          f"(CUDA events, 180 steps) graph "
          f"{a[0]['event_ms_per_step'][1]:.4f} eager "
          f"{a[1]['event_ms_per_step'][1]:.4f} ({smi})")
    rows["direct"] = a

    # (b) the kd window at N=1M, p=6, r=1.67, 16/2/2: 3 windows and one
    # step, so that the full re-sort submitted at the first boundary is
    # adopted with its repad; eager twice, then graphs
    cfg = SimConfig(fmm_order=6, tree_radius=1.67, tree_steps=16,
                    tree_resort_every=2, tree_pipeline=2)
    u = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
    ph, vh = ID.init_gaussian(N, X_STD, u, seed=SEED)
    wins = (16, 16, 16, 1)
    b = [_sim_windows(torch, g, cfg, N, "fmm3_kd", ph, vh, wins, dev)
         for g in (False, False, True)]
    for r in b:
        line(f"fmm3_kd N={N} 16/2/2", r)
        _require(r["p2p_launches"] == 1 + sum(wins), f"kd: P2P launches "
                 f"{r['p2p_launches']} == {1 + sum(wins)} force evaluations")
        _require(r["rebuilds"].get("adopt_full") == 1,
                 f"kd: one adopted re-sort {r['rebuilds']}")
    ee, _ = _rel_dev(b[1]["pos"], b[0]["pos"])
    ge, _ = _rel_dev(b[2]["pos"], b[0]["pos"])
    print(f"graphs fmm3_kd N={N}: max|dpos|/max|pos| graph vs eager {ge:.3e},"
          f" eager vs eager {ee:.3e}; s/step (window 3) graph "
          f"{b[2]['s_per_step'][2]:.4f} eager {b[0]['s_per_step'][2]:.4f} / "
          f"{b[1]['s_per_step'][2]:.4f}; captures {b[2]['captures']} in "
          f"{b[2]['capture_s']:.2f} s; peak GiB allocated / reserved: "
          f"graph {b[2]['peak_bytes'] / 2**30:.2f} / "
          f"{b[2]['peak_reserved_bytes'] / 2**30:.2f}, eager "
          f"{b[0]['peak_bytes'] / 2**30:.2f} / "
          f"{b[0]['peak_reserved_bytes'] / 2**30:.2f} ({smi})")
    _require(ge <= max(2 * ee, 1e-6), f"kd graph vs eager {ge:.3e} <= "
             f"max(2 x {ee:.3e}, 1e-6)")
    rows["fmm3_kd"] = b

    # (c) fmm3_traceless at N=1M (uniform box) and fmm2_kd at N=100k (2D
    # beam): 2 windows of 8 steps
    n2 = 100_000
    c2 = SimConfig(dim=2, omega0=(1.095, 1.0), fmm_order=4, tree_radius=2.0)
    u2 = tuple(w * x for w, x in zip(c2.omega0, X_STD[:2]))
    p2, v2 = ID.init_gaussian(n2, X_STD[:2], u2, dim=2, seed=SEED)
    pu = _uniform_box(N, 3)
    for name, cfg, n, ph, vh in (
            ("fmm3_traceless", SimConfig(fmm_order=3, tree_steps=8), N, pu,
             np.zeros_like(pu)),
            ("fmm2_kd", c2, n2, p2, v2)):
        c = [_sim_windows(torch, g, cfg, n, name, ph, vh, (8, 8), dev,
                          busy=True) for g in (True, False)]
        for r in c:
            line(f"{name} N={n}", r)
        d, _ = _rel_dev(c[0]["pos"], c[1]["pos"])
        print(f"graphs {name} N={n}: graph vs eager {d:.3e} of max|pos|; "
              f"s/step (window 2) graph {c[0]['s_per_step'][1]:.4f} eager "
              f"{c[1]['s_per_step'][1]:.4f}; busy graph "
              f"{100 * c[0]['busy_share']:.1f}% eager "
              f"{100 * c[1]['busy_share']:.1f}%; captures {c[0]['captures']} "
              f"in {c[0]['capture_s']:.2f} s ({smi})")
        _require(d <= 1e-5, f"{name} graph vs eager {d:.3e} <= 1e-5")
        rows[name] = c
    return rows


def _phase_probes(dev, smi, torch):
    """Phase 17: the four probe twins of scripts/, each once through its
    function on the card at N=1M on the production beam.  Returns the P2P
    and the direct kernel's launches in the phase."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine
    from coulomb_oscillators_tpu_torch.scripts import _common as C
    from coulomb_oscillators_tpu_torch.scripts import err_diag as ED
    from coulomb_oscillators_tpu_torch.scripts import leaf_size_probe as LP
    from coulomb_oscillators_tpu_torch.scripts import sortmode_probe as SM
    from coulomb_oscillators_tpu_torch.scripts import stale_anatomy as SA

    def emit(name, t, out):
        print(json.dumps({"probe": name, "seconds": time.perf_counter() - t,
                          "card": smi, **out}), flush=True)

    launches = {"p2p": 0, "direct": 0}

    # stale_anatomy: p=6, r=1.43, boost 1.5, 16/2/2
    t = time.perf_counter()
    torch.cuda.synchronize()
    p2p_cuda.launches = 0
    out = SA.anatomy(N, 6, 1.43, 1.5, 16, 2, 2, dev)
    torch.cuda.synchronize()
    n_p2p = p2p_cuda.launches
    launches["p2p"] += n_p2p
    emit("stale_anatomy", t, dict(out, p2p_launches=n_p2p))
    rows = out["ladder"]
    vals = [r[k] for r in rows for k in ("prod", "geo", "rfsh", "fresh")
            if k in r]
    _require(len(rows) == 17, f"stale_anatomy: 17 rows ({len(rows)})")
    _require(all(v == v and 0 < v < float("inf") for v in vals),
             "stale_anatomy: every error finite and positive")
    _require(rows[-1]["fresh"] <= FORCE_TOL,
             f"stale_anatomy: fresh {rows[-1]['fresh']:.3e} <= {FORCE_TOL}")
    _require(n_p2p == out["force_evals"], f"stale_anatomy: {n_p2p} P2P "
             f"launches == {out['force_evals']} force evaluations")

    # err_diag: p=6, r=1.67 (the production pair); the P2P kernel and the
    # direct kernel at N=1M
    t = time.perf_counter()
    p2p_cuda.launches = 0
    D.launches = 0
    out = ED.diag(N, 6, 1.67, dev)
    torch.cuda.synchronize()
    launches["p2p"] += p2p_cuda.launches
    launches["direct"] += D.launches
    emit("err_diag", t, dict(out, p2p_launches=p2p_cuda.launches,
                             direct_launches=D.launches))
    noise = out["p2p_noise"]
    _require(out["force"]["mean"] <= FORCE_TOL,
             f"err_diag: mean error {out['force']['mean']:.3e} <= "
             f"{FORCE_TOL}")
    _require(all(v == v and v < float("inf") for v in noise.values())
             and noise["mean"] <= P2P_NOISE_TOL,
             f"err_diag: P2P plain-vs-Kahan noise {noise} finite, mean <= "
             f"{P2P_NOISE_TOL}")
    _require(p2p_cuda.launches == 2 and D.launches == 1,
             f"err_diag: P2P launches {p2p_cuda.launches} == 2 (force, "
             f"plain pass), direct launches {D.launches} == 1")

    # leaf_size_probe at the production level against the production
    # engine's margin-free build of the same beam
    t = time.perf_counter()
    cfg = SimConfig(fmm_order=6, tree_radius=1.67)
    eng = KdFmmEngine(cfg, N)
    pos_h, _ = C.beam(N, cfg)
    eng.build(torch.from_numpy(pos_h).to(dev))
    want = dict(eng.last_counts)
    leaf = LP.probe(N, 6, 1.67, (eng.L,))
    emit("leaf_size_probe", t, {"rows": leaf, "engine_L": eng.L,
                                "engine_counts": want})
    _require(eng.L == 15, f"leaf_size_probe: production level {eng.L} == 15")
    _require({k: leaf[0][k] for k in ("p2p", "m2l")} == want,
             f"leaf_size_probe: L=15 counts {leaf[0]} == the engine's "
             f"{want}")

    # sortmode_probe: p=6, r=1.67: the kd builders within the force bound,
    # Morton within MORTON_TOL
    t = time.perf_counter()
    p2p_cuda.launches = 0
    rows = SM.probe(N, 6, 1.67, dev)
    torch.cuda.synchronize()
    launches["p2p"] += p2p_cuda.launches
    emit("sortmode_probe", t, {"rows": rows,
                               "p2p_launches": p2p_cuda.launches})
    for r in rows:
        tol = MORTON_TOL if r["mode"] == "morton" else FORCE_TOL
        _require(r["err"] <= tol, f"sortmode_probe {r['mode']}: "
                 f"error {r['err']:.3e} <= {tol}")
    _require(p2p_cuda.launches == len(rows), f"sortmode_probe: P2P "
             f"launches {p2p_cuda.launches} == {len(rows)} force evaluations")
    return launches


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
    from coulomb_oscillators_tpu_torch.utils import graphs, roofline

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
        fn = ""
        for line in lib.build_log.splitlines():
            if "Compiling entry" in line:
                fn = line.split("'")[1]
            if "registers" in line or "spill" in line:
                print(f"ptxas {lib.name} {fn}: {line.strip()}")
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
        sim = Simulator(small, n_small, engine="fmm3_kd")
        st = sim.init_acc(particle_state_from_numpy(ps, vs, device=device))
        outs.append(sim.run(st, 7).pos.cpu())
        sim.close()
    small_dev = float((outs[1] - outs[0]).abs().max() / outs[0].abs().max())
    print(f"simulator N={n_small}: cuda vs cpu max|dpos|/max|pos| = "
          f"{small_dev:.3e}")
    _require(small_dev <= 1e-5, f"small run cuda vs cpu {small_dev:.3e} <= 1e-5")

    sim = Simulator(cfg, N, engine="fmm3_kd")
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
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    direct_rows = {}
    for dim, n in DIRECT_CASES:
        c, ph, _ = beams[dim] if n == N_CLI else _cli_beams(n)[dim]
        p = torch.from_numpy(ph).to(dev)
        eps2, kap = c.eps2, c.kappa(n)
        got = D.direct(p, eps2, kap)
        plain = D.direct_plain(p, eps2, kap)
        rel, mabs = _rel_dev(got, plain)
        big = n > N_CLI
        ms = _cuda_ms(lambda: D.direct(p, eps2, kap), 3 if big else 20,
                      torch)
        plain_ms = _cuda_ms(lambda: D.direct_plain(p, eps2, kap),
                            1 if big else 3, torch)
        pairs = n * n
        b = roofline.bound(pairs, 2 * p.numel() * 4, dim=dim)
        row = dict(dim=dim, n=n,
                   splits=D.splits_for(n, sm_count, *D.geometry(dim)),
                   max_rel_err=rel, max_abs_err=mabs,
                   max_abs_ref=float(plain.abs().max()), ms=ms,
                   plain_ms=plain_ms, pairs=pairs, bound_ms=b["bound_ms"],
                   bound_by=b["bound_by"], bound_share=b["bound_ms"] / ms)
        text = ""
        if n == N_CLI:            # the CLI's size: also against Kahan
            kahan = D.direct_kahan(p, eps2, kap)
            row["kahan_mean_rel_err"] = e_k = float(mean_rel_err(got, kahan))
            row["plain_kahan_mean_rel_err"] = e_p = float(
                mean_rel_err(plain, kahan))
            text = f"; mean rel err vs Kahan kernel {e_k:.3e} plain {e_p:.3e}"
            _require(e_k <= max(1e-5, 2 * e_p), f"direct dim={dim} vs Kahan "
                     f"{e_k:.3e} <= max(1e-5, 2 x {e_p:.3e})")
        print(f"direct N={n} dim={dim} bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}: {roofline.FLOPS_PER_PAIR[dim]} flops and "
              f"one special-function op a pair; kernel at "
              f"{100 * row['bound_share']:.1f}%) splits={row['splits']}: "
              f"kernel vs plain rel_dev={rel:.3e} max_abs={mabs:.3e}{text}; "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
              f"kernel_Gpairs_per_s={pairs / ms / 1e6:.1f} "
              f"plain_Gpairs_per_s={pairs / plain_ms / 1e6:.2f}")
        _require(bool(torch.isfinite(got).all()) and got.shape == (n, dim),
                 f"finite [{n}, {dim}] direct output")
        _require(rel <= P2P_TOL, f"direct N={n} dim={dim} vs plain "
                 f"{rel:.3e} <= {P2P_TOL}")
        direct_rows[dim, n] = row
        del p, got, plain
    _phase("direct", t0)

    # ---- 7. the CLI on the card ----------------------------------------
    t0 = time.perf_counter()
    # an independent count of force evaluations: every "direct" Coulomb
    # force the CLI builds goes through make_coulomb_force
    make_coulomb = M.make_coulomb_force

    def counting_coulomb(config, n, engine="direct"):
        f = make_coulomb(config, n, engine)
        if engine != "direct":
            return f

        def counted(p):
            counter.evals += 1
            return f(p)
        return counted

    # a captured step calls `counted` once; each replay advances the
    # count by what the capture added, as it does the launch counters
    counter = types.SimpleNamespace(evals=0)
    graphs.register_counter(counter, "evals")
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
            _require(counter.evals == sim_evals == D.launches,
                     f"direct launches {D.launches} == force evaluations "
                     f"{counter.evals} == {sim_evals}")
            tc = time.perf_counter()
            _require(cli.main(["-test", "-engine", "direct", "-n",
                               str(N_CLI)]) == 0, "cli -test")
            tc = time.perf_counter() - tc
        finally:
            M.make_coulomb_force = make_coulomb
            graphs.unregister_counter(counter, "evals")
        direct_launches = D.launches
    _require(direct_launches == counter.evals > sim_evals,
             f"direct launches {direct_launches} == force evaluations "
             f"{counter.evals} (with -test)")
    print(f"cli -test: {tc:.3f} s; direct launches {direct_launches} = "
          f"force evals {counter.evals}")
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

    # ---- 11. the port's bench ------------------------------------------
    t0 = time.perf_counter()
    _, bench_launches = _phase_bench(torch)
    _phase("bench", t0)

    # ---- 12. stage profile and kernel trace ----------------------------
    t0 = time.perf_counter()
    _, _, profile_launches = _phase_profile(dev, torch)
    _phase("profile", t0)

    # ---- 13. the viewer ------------------------------------------------
    t0 = time.perf_counter()
    _phase_viewer()
    _phase("viewer", t0)

    # ---- 14. the native library was used -------------------------------
    t0 = time.perf_counter()
    print(f"native: co_native built in {native.build_seconds} s; numpy "
          f"traversals in phases 3-5: {raw_main}")
    _require(native._lib is not None and raw_main == 0,
             "the N=1M kd builds of phases 3-5 went through co_native")
    _phase("native", t0)

    # ---- 15. the multi-device layer ------------------------------------
    t0 = time.perf_counter()
    mesh_p2p, mesh_direct, ts_row = _phase_multi_device(dev, smi, torch)
    _phase("multi-device", t0)

    # ---- 16. CUDA graphs against eager steps ---------------------------
    t0 = time.perf_counter()
    _phase_graphs(dev, smi, torch)
    _phase("graphs", t0)

    # ---- 17. the probe twins at N=1M ----------------------------------
    t0 = time.perf_counter()
    probe_launches = _phase_probes(dev, smi, torch)
    _phase("probes", t0)

    row, drow = p2p_rows[0], direct_rows[3, N_CLI]
    # no single PyTorch call computes a masked leaf-pair sum or an
    # all-pairs softened Coulomb sum, so library_ms is null
    bound_keys = ("bound_ms", "bound_by", "bound_share")
    print(json.dumps({"kernels": [
        {"name": "p2p", "route": "cuda",
         "source": "coulomb_oscillators_tpu_torch/csrc/p2p.cu",
         "replaces": "coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py:52",
         "also_replaces": "coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py:110",
         "launches": p2p_launches,
         "launches_by_path": {"simulator": p2p_launches,
                              "bench": bench_launches,
                              "profile": profile_launches,
                              "probes": probe_launches["p2p"], **mesh_p2p},
         "max_abs_err": row["max_abs_err"],
         "max_abs_ref": row["max_abs_ref"],
         "max_rel_err": row["max_rel_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "pairs": row["pairs"],
         "real_pairs": row["real_pairs"],
         **{k: row[k] for k in bound_keys}, "library_ms": None,
         "cases": p2p_rows},
        {"name": "p2p_float64", "route": "cuda",
         "source": "coulomb_oscillators_tpu_torch/csrc/p2p.cu",
         "replaces": "coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py:52",
         "launches": f64_row["launches"],
         "max_abs_err": f64_row["max_abs_err"],
         "max_abs_ref": f64_row["max_abs_ref"],
         "max_rel_err": f64_row["max_rel_err"], "ms": f64_row["ms"],
         "plain_ms": f64_row["plain_ms"], "pairs": f64_row["pairs"],
         "real_pairs": f64_row["real_pairs"],
         **{k: f64_row[k] for k in bound_keys}, "library_ms": None},
        {"name": "direct", "route": "cuda",
         "source": "coulomb_oscillators_tpu_torch/csrc/direct.cu",
         "replaces": "coulomb_oscillators_tpu/ops/direct.py:161",
         "launches": direct_launches,
         "launches_by_path": {"cli": direct_launches,
                              "probes": probe_launches["direct"],
                              **mesh_direct},
         "targets_entry": ts_row, "max_abs_err": drow["max_abs_err"],
         "max_abs_ref": drow["max_abs_ref"],
         "max_rel_err": drow["max_rel_err"], "ms": drow["ms"],
         "plain_ms": drow["plain_ms"], "pairs": drow["pairs"],
         **{k: drow[k] for k in bound_keys}, "library_ms": None,
         "cases": [direct_rows[c] for c in DIRECT_CASES]}]}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
