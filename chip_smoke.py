#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's paths through the entry points a user calls, and checks
them: the kd-tree FMM Simulator at N=1,000,000 (the README's Gaussian beam,
p=6, r=1.67), and the CLI's direct engine at its default N=30001.  The
Simulator runs its window steps as CUDA graphs unless ``CO_CUDA_GRAPHS=0``.

  1. device: a CUDA card, its name and power limit, the toolchain, and
     float32 matmuls kept out of TF32;
  2. build: the three kernels (csrc/p2p.cu in dim 3 and csrc/p2p2d.cu in
     dim 2, float and double each, and csrc/direct.cu; nvcc for sm_90a,
     ptxas registers and spills printed for every instantiation) and the
     native host library (g++), all from the sources in this checkout and
     all started together;
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
     every traversal of that run (the build, the priming refresh, the
     re-sorts) ran on the card, none on the host, with one to 2L + 1
     launches of the traversal kernel each;
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
     2D Gaussian beam): the dim-2 P2P kernel (csrc/p2p2d.cu, segments of
     p2p_cuda.SEG_ENTRIES partner entries) against its plain version on
     the engine state in float32 (<= 1e-5 of max|a|) and float64 (<=
     1e-12), and in float32 on the same beam at N=1M (its heaviest row
     ~2,000 entries), each with its work, segments, bounds, share and
     CUDA-event times as in phase 3, and bitwise the same in a second
     call; on seeded synthetic lists with rows of 1, K, K+1 and 1,600
     entries (the last many segments long), float32 and float64, against
     the plain version and bitwise repeatable; the force against Kahan
     (<= 2e-3); a 12-step Simulator
     timing and a float64 Simulator of 8 steps, dim-2 P2P launches ==
     force evaluations in both; fmm3_kd in float64 at N=1M with
     sort_mode="morton" on the
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
     hold the host's launch gaps), the P2P stage the kernel in both; a
     torch.profiler trace of 3 padded force calls of each engine whose
     kernel histogram names the P2P kernel; P2P launches of each dim ==
     the profile's own count of that engine's force evaluations;
 13. viewer: the port's CLI writes 2 snapshots on the card, the port's
     view renders them, the PNGs decode to 792 x 792 with a non-empty red
     channel;
 14. the native library: every N=1M kd build of phases 3-5 went through
     co_native (the kd sort and the geometry; their traversals ran on the
     card, phase 5), none through the numpy traversal;
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
     rebuild) with CUDA graphs cut at the collectives, and at 1 and 2
     ranks twice more with CO_CUDA_GRAPHS=0 from the same start: finite,
     all ranks equal, on every rank as many P2P kernel launches as force
     evaluations in both modes, with graphs a capture on every rank and
     as many on each, the same collective calls a step in both modes, and
     graphs against eager within max(2 x eager against eager, 1e-6) of
     max|pos|; s/step, captures, capture seconds, segments a step,
     collective calls a step and peak memory per rank printed.  Then
     fmm2_kd at N=100k on 2 ranks sharing the card: the particle-sharded
     (fmm_pshard) and the pair-sharded (fmm_shard) force against the
     single-device force (<= 1e-5 of max|a|), one dim-2 P2P launch a
     force on every rank, and the mesh-mode Simulator (3 windows of 8
     with graphs) with as many dim-2 P2P launches as force evaluations on
     every rank.  Then
     make_sharded_direct, ring and all-gather, on 2 ranks sharing the card
     at N=30001 against the single-device direct kernel (<= 1e-5), the
     direct kernel's separate-targets entry against the plain
     block-on-block form (<= 1e-5, CUDA-event times of both), and the CLI
     with -chips 1 (snapshot names and sizes; -chips 2 is refused with
     -1; the CLI's rank function replays a captured step 17 times), and
     the dry run of scripts/graft_entry.py on 2 ranks sharing the card
     (with the default placement it raises: one device).  A rank that
     raises fails the run.  The timings are labelled "N ranks sharing one
     <card>";
 16. graphs: the Simulator's CUDA graphs (utils/graphs.py; every phase
     above runs with them, as a user's run does) against the same steps
     run eagerly (CO_CUDA_GRAPHS=0) from one start: Simulator("direct") on
     the CLI's 3D beam at N=30001, 200 steps, positions bitwise equal;
     fmm3_kd at N=1M, p=6, r=1.67, 16/2/2, three windows and a step (one
     adopted full re-sort with its repad), twice eagerly and once with
     graphs, graph against eager within max(2 x eager against eager, 1e-6)
     of max|pos|; fmm3_traceless at N=1M (uniform box) and fmm2_kd at
     N=100k, 2 windows of 8 steps, within 1e-5 (fmm2_kd run eagerly twice
     and held within max(2 x eager against eager, 1e-6)); the kernels'
     launches equal the force evaluations in both modes (fmm2_kd's on the
     dim-2 P2P kernel); s/step, CUDA-event ms/step, captures, capture
     seconds and peak memory of each run,
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
     launch each;
 18. ladder and drift: the CLI's -accuracy 1e-3 with -chips 1 (NCCL, one
     rank) at N=30001, fmm3_kd, 16 iterations: one (p, r) search, in this
     process before the rank starts ("Best parameters" printed once, by
     this process and the rank together), its seconds, choice and error
     printed; the snapshots named and sized as those of the single-device
     run of the chosen (p, r), within 1e-4 of max|pos|; -chips 2
     -accuracy refused with -1 on one card.  Ladder rows 1 (direct,
     N=4096) and 3a (kd, N=1M, p=3, r=1.7) through scripts.ladder.run,
     with geometry refresh and then with CO_GEOM_REFRESH=0, and row 2
     (fmm2_kd, N=100k, p=4, r=2) with geometry refresh: finite, the
     mode in the row, 1-2 step-graph captures, the direct and P2P
     kernels' launches (row 2's on the dim-2 kernel) == the force
     evaluations each row made; one JSON line a row with the card.  The
     north-star drift artifact
     (scripts.energy_drift.artifact: N=30001, p=6, r=2.5, dt=2e-5, its
     stiffening ladder) cut to 2000 steps: max drift <= 1e-6, P2P launches
     == the force evaluations of its rungs; the first rung's drift and
     whether it stiffened printed;
 19. stored fold: the stored-fold M2L (CO_M2L_FLY=0) against fly mode.
     fmm3_kd at N=1M, p=6, r=1.67, boost 1.5, built once in each mode from
     the same beam: the stored fold's shape [Km, S_H] (fly mode's
     placeholders [1, 1]), two force evaluations in each mode, stored
     against fly within max(2 x the larger eager-against-eager spread,
     1e-6) of max|a| (index_add_ adds in no fixed order), the stored-mode
     force against Kahan on 2,048 targets (<= 1e-3), P2P launches == the 4
     force evaluations, and one line of both modes' CUDA-event ms of
     _stage_m2l and geom_refresh, the fold's bytes and its adoption ms;
     three 16/2/2 windows and a step with graphs in each mode (refresh on,
     an adopted re-sort, folded on the rebuild thread in stored mode):
     finite, a capture, P2P launches == 50 force evaluations, stored
     against fly within 1e-5 of max|pos|; fmm2_kd at N=100k, p=4, r=2
     with frozen geometry (CO_GEOM_REFRESH=0's config), 12 steps in each
     mode: dim-2 P2P launches == 13, stored against fly within 1e-5;
 20. far-field studies: the four study twins of scripts/ through their
     functions on the card at N=100k, p=6, r=1.67, 2 repetitions:
     m2l_window_stats (its lines), m2l_micro and m2l_micro2 (each engine
     in stored mode, CO_M2L_FLY=0 set only around its construction; every
     float32 variant within 1e-5 of max|ref| of its identity, or the
     study raises) and l2p_micro at p=6 (G=8192, C=128: the batched
     product and l2p_field_blocked within 1e-5 of the einsum); every row
     finite and timed by CUDA events and by its kernels (a trace that
     lost its kernels makes its study raise), CO_M2L_FLY as it was; one
     JSON line with the rows and the card.  The studies run in a process
     of their own (one that traced the earlier phases lost kernel events
     from later traces; the cause is not known);
 21. the traversal kernel (csrc/traverse.cu, through ops/fmm/traverse.py)
     at the main path's shapes: the 1M production beam (its auto stale
     margin at 16/2/2) and the CLI's N=30001 in dim 3, fmm2_kd's 2D beam
     at N=1M and 30001 in dim 2 (scripts.traverse_bench): the engine's
     card lists equal the native traversal's (near element for element,
     m2l after a (target, source) sort), and so do the lists made from
     the plain version's pairs on the same card tensors; the frontier
     timed by CUDA events beside the plain version and its byte bound.

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
# fmm2_kd's config at ladder row 2 (scripts/ladder.py), on the 2D beam
KD2_CFG = dict(dim=2, omega0=(1.095, 1.0), fmm_order=4, tree_radius=2.0)
N_KD2 = 100_000
N_FAR = 100_000         # the far-field studies of phase 20
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


def _p2p_case(cfg, sub_depth, pos, torch, n=N, tol=P2P_TOL, reps=(10, 2)):
    """P2P kernel vs plain on one engine of `cfg` (its dim and dtype) built
    from `pos` [n, dim], within `tol` of max|a|; `reps` CUDA-event calls
    of the kernel and of the plain version.  Returns the case's row, and
    the engine and its state."""
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
    eng = KdFmmEngine(cfg, n, sub_depth=sub_depth)
    tb = time.perf_counter()
    fs = eng.build(pos)
    torch.cuda.synchronize()
    tb = time.perf_counter() - tb
    ppad = eng.pad_array(pos, fs, fill=FAR)
    pblk = ppad.reshape(eng.G_blk, eng.C_blk, cfg.dim)

    def kern():
        return eng._stage_p2p(ppad, fs)

    def plain():
        return p2p_cuda.p2p_plain(pblk, fs.p2p_row_ptr, fs.p2p_col2d,
                                  eng.nsub, cfg.eps2)

    got = kern().reshape(pblk.shape)
    again = kern().reshape(pblk.shape)
    ref = plain()
    torch.cuda.synchronize()
    _require(bool(torch.isfinite(got).all()), "finite kernel output")
    _require(bool(torch.equal(got, again)),
             f"P2P kernel bitwise repeatable at dim={cfg.dim} N={n}")
    rel, mabs = _rel_dev(got, ref)
    ms = _cuda_ms(kern, reps[0], torch)
    plain_ms = _cuda_ms(plain, reps[1], torch)
    work = _p2p_work(pblk, fs, eng, ms, torch)
    what = "" if (cfg.dim, pblk.dtype) == (3, torch.float32) else \
        f" dim={cfg.dim} {str(pblk.dtype).split('.')[-1]} N={n}"
    print(f"p2p{what} nsub={eng.nsub} L={eng.L} C={eng.st.C} Gb={eng.G_blk} "
          f"CB={eng.C_blk} dmax={fs.p2p_col2d.shape[1]} build_s={tb:.3f}: "
          f"rel_dev={rel:.3e} max_abs={mabs:.3e} kernel_ms={ms:.3f} "
          f"plain_ms={plain_ms:.3f}; {work['text']}")
    _require(got.dtype == pos.dtype, f"P2P kernel output {got.dtype}")
    _require(rel <= tol, f"P2P kernel vs plain{what} at nsub={eng.nsub}, "
             f"CB={eng.C_blk}: {rel:.3e} <= {tol}")
    return dict(n=n, nsub=eng.nsub, CB=eng.C_blk, max_rel_err=rel,
                max_abs_err=mabs,
                max_abs_ref=float(ref.abs().max()), ms=ms, plain_ms=plain_ms,
                **work["row"]), eng, fs


def _p2p_work(pblk, fs, eng, ms, torch):
    """The P2P call's work counted from its inputs (entries, slot pairs,
    real pairs, bytes) and its bounds on the card (utils/roofline.py):
    a line of text and the kernels line's fields."""
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.utils import roofline
    c = p2p_cuda.pair_counts(pblk, fs.p2p_row_ptr, fs.p2p_col2d, eng.nsub)
    double = pblk.dtype == torch.float64
    dim = pblk.shape[-1]
    b = roofline.bound(c["real_pairs"], c["bytes"], dim=dim, double=double)
    share = b["bound_ms"] / ms
    seg = {}
    if dim == 2:                    # the dim-2 kernel's items (segments)
        R, ntile = fs.p2p_row_ptr.shape[0] - 1, eng.st.C // 32
        work = p2p_cuda.segment_plan(fs.p2p_row_ptr, fs.p2p_col2d.shape[1],
                                     ntile)
        seg = dict(seg_entries=p2p_cuda.SEG_ENTRIES,
                   segments=int(work[R]) + R * ntile)
    peak = roofline.FP64_FLOPS if double else roofline.FP32_FLOPS
    text = (f"entries={c['entries']} pairs={c['pairs']} "
            f"real_pairs={c['real_pairs']}; bounds: flop "
            f"{b['flop_ms']:.4f} ms ({roofline.FLOPS_PER_PAIR[dim]} flops a "
            f"real pair at {peak / 1e12:g} TFLOP/s), rsqrt "
            f"{b['mufu_ms']:.4f} ms, bytes "
            f"{b['byte_ms']:.4f} ms ({c['bytes']} B); kernel at "
            f"{100 * share:.1f}% of the {b['bound_by']} bound "
            f"{b['bound_ms']:.4f} ms; "
            f"{c['real_pairs'] / ms / 1e9:.3f}T real pairs/s"
            + (f"; {seg['segments']} segments of <= {seg['seg_entries']} "
               f"entries" if seg else ""))
    return dict(text=text, row=dict(**seg,
        pairs=c["pairs"], real_pairs=c["real_pairs"], entries=c["entries"],
        bytes=c["bytes"], flop_ms=b["flop_ms"], mufu_ms=b["mufu_ms"],
        byte_ms=b["byte_ms"], bound_ms=b["bound_ms"], bound_by=b["bound_by"],
        bound_share=share))


def _p2p2d_synthetic(dev, torch, dtype, tol):
    """The dim-2 P2P kernel on a seeded synthetic list (64 blocks of 128
    slots, 4 sub-leaves, trailing FAR pads, the sentinel block and mask-0
    entries among random ones) whose rows hold 1, K, K + 1 and 1,600
    entries, K = p2p_cuda.SEG_ENTRIES (the last row 1600 / K segments):
    against its plain version within `tol` of max|a| and bitwise the same
    in a second call.  Returns the case's row."""
    import numpy as np
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    rng = np.random.default_rng(SEED)
    Gb, CB, nsub, K = 64, 128, 4, p2p_cuda.SEG_ENTRIES
    C, R = CB // nsub, Gb * nsub
    pos = rng.normal(scale=0.01, size=(Gb, nsub, C, 2))
    nreal = rng.integers(1, C + 1, size=(Gb, nsub))
    pos[np.arange(C)[None, None, :] >= nreal[..., None]] = p2p_cuda.FAR
    deg = rng.integers(0, 7, size=R)
    deg[:4] = (1, K, K + 1, 1600)
    dmax = int(deg.max())
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    blk = rng.integers(0, Gb + 1, size=(R, dmax))    # Gb: the sentinel
    bits = rng.integers(0, 1 << nsub, size=(R, dmax))
    col = (blk | bits << (32 - nsub)).astype(np.uint32).view(np.int32)
    args = (torch.from_numpy(pos.reshape(Gb, CB, 2)).to(dev, dtype),
            torch.from_numpy(rp).to(dev), torch.from_numpy(col).to(dev),
            nsub, 1e-18)
    got = p2p_cuda.p2p(*args)
    again = p2p_cuda.p2p(*args)
    ref = p2p_cuda.p2p_plain(*args)
    torch.cuda.synchronize()
    rel, mabs = _rel_dev(got, ref)
    work = p2p_cuda.segment_plan(args[1], dmax)
    row = dict(case="synthetic", dtype=str(dtype).split(".")[-1],
               degrees=[1, K, K + 1, 1600], seg_entries=K,
               segments=int(work[R]) + R, max_rel_err=rel, max_abs_err=mabs,
               bitwise_repeat=bool(torch.equal(got, again)))
    print(f"p2p dim=2 synthetic {row['dtype']}: rows of 1, {K}, {K + 1} and "
          f"1600 entries, {row['segments']} segments: rel_dev={rel:.3e} "
          f"max_abs={mabs:.3e}, bitwise repeatable "
          f"{row['bitwise_repeat']}")
    _require(bool(torch.isfinite(got).all()) and rel <= tol,
             f"dim-2 P2P kernel vs plain on the synthetic list "
             f"({row['dtype']}): {rel:.3e} <= {tol}")
    _require(row["bitwise_repeat"], "dim-2 P2P kernel bitwise repeatable")
    return row


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
    the rows of the kernels line of the float64 P2P kernel and of the
    dim-2 P2P kernel in float32 and float64."""
    import numpy as np
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

    # fmm2_kd at ladder 2's size: N=100k, p=4, r=2, the 2D Gaussian beam;
    # the dim-2 P2P kernel against its plain version on its engine state,
    # in float32 and in float64
    n2 = N_KD2
    cfg = SimConfig(**KD2_CFG)
    u = tuple(w * x for w, x in zip(cfg.omega0, X_STD[:2]))
    ph, vh = ID.init_gaussian(n2, X_STD[:2], u, dim=2, seed=SEED)
    x = torch.from_numpy(ph).to(dev)
    rows2 = {}
    for name, c, tol in (
            ("p2p_dim2_float64", cfg.replace(precision="float64"),
             F64_P2P_TOL),
            ("p2p_dim2", cfg, P2P_TOL)):
        xc = x.to(torch.float64) if c.precision == "float64" else x
        rows2[name], eng, fs = _p2p_case(c, 2, xc, torch, n=n2, tol=tol,
                                         reps=(20, 3))
    # the same beam at N=1M, whose heaviest partner row spans ~2,000
    # entries; seeded lists whose longest row spans many segments
    p1m, _ = ID.init_gaussian(N, X_STD[:2], u, dim=2, seed=SEED)
    rows2["p2p_dim2"]["cases"] = [_p2p_case(
        cfg, 2, torch.from_numpy(p1m).to(dev), torch, n=N, reps=(10, 1))[0]]
    del p1m
    for name, dtype, tol in (("p2p_dim2", torch.float32, P2P_TOL),
                             ("p2p_dim2_float64", torch.float64,
                              F64_P2P_TOL)):
        rows2[name].setdefault("cases", []).append(
            _p2p2d_synthetic(dev, torch, dtype, tol))
    acc = eng.force(x, fs)          # the float32 engine, built last
    err = _kahan_err(acc, x, cfg, n2, torch)
    _require(bool(torch.isfinite(acc).all()), "fmm2_kd finite force")
    sim = Simulator(cfg, n2, "fmm2_kd")
    try:
        torch.cuda.synchronize()
        p2p_cuda.launches_2d = 0
        st = sim.init_acc(particle_state_from_numpy(ph, vh, device=dev))
        st = sim.run(st, 2)
        torch.cuda.synchronize()
        tw = time.perf_counter()
        st = sim.run(st, 12)
        torch.cuda.synchronize()
        tw = time.perf_counter() - tw
        launches = p2p_cuda.launches_2d
    finally:
        sim.close()
    evals = 1 + 2 + 12
    rows2["p2p_dim2"]["launches"] = launches
    _require(bool(torch.isfinite(st.pos).all()), "fmm2_kd Simulator finite")
    print(f"fmm2_kd N={n2} p=4 r=2 (L={eng.L}, C={eng.st.C}): mean rel err "
          f"vs Kahan {err:.3e} (bound {KD2_TOL}); Simulator 12 steps "
          f"{tw:.3f} s ({tw / 12:.4f} s/step, {12 * n2 / tw / 1e6:.2f} M "
          f"particle-steps/s); dim-2 p2p launches {launches} = force evals "
          f"{evals}")
    _require(err <= KD2_TOL, f"fmm2_kd {err:.3e} <= {KD2_TOL}")
    _require(launches == evals, f"fmm2_kd: {launches} dim-2 P2P kernel "
             f"launches == {evals} force evaluations")

    # fmm2_kd in float64: init_acc + 8 steps on the dim-2 double kernel
    sim = Simulator(cfg.replace(precision="float64"), n2, "fmm2_kd")
    try:
        torch.cuda.synchronize()
        p2p_cuda.launches_2d = 0
        st = sim.init_acc(particle_state_from_numpy(
            ph.astype(np.float64), vh.astype(np.float64), device=dev))
        tw = time.perf_counter()
        st = sim.run(st, 8)
        torch.cuda.synchronize()
        tw = time.perf_counter() - tw
        launches = p2p_cuda.launches_2d
    finally:
        sim.close()
    rows2["p2p_dim2_float64"]["launches"] = launches
    print(f"fmm2_kd float64 N={n2}: 8 steps {tw:.3f} s ({tw / 8:.4f} "
          f"s/step); dim-2 p2p launches {launches} = force evals 9")
    _require(st.pos.dtype == torch.float64
             and bool(torch.isfinite(st.pos).all()),
             "fmm2_kd float64 Simulator finite float64")
    _require(launches == 9, f"fmm2_kd float64: {launches} dim-2 P2P kernel "
             f"launches == 9 force evaluations")
    del eng, fs, acc, x

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
    return row, rows2


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
    """Phase 12: stage rows of fmm3_kd and fmm2_kd and a kernel trace of
    each.  Returns the records, the traces and the P2P launches of each
    dim."""
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.scripts import profile_force as PF
    reps, rebuilds, calls = 5, 1, 3
    torch.cuda.synchronize()
    p2p_cuda.launches = p2p_cuda.launches_2d = 0
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
        _require(rec["p2p_kind"] == "cuda kernel",
                 f"{rec['engine']}: the P2P stage is the kernel")
    trs = {}
    for engine, n, p, r in (("fmm3_kd", N, 6, 1.67),
                            ("fmm2_kd", PF.N_KD2, 4, 2.0)):
        with tempfile.TemporaryDirectory() as tmp:
            tr = trs[engine] = PF.trace_force(n, p, r, dev, tmp, calls,
                                              engine=engine)
        PF.print_histogram(tr, "call", "kernels_ms_per_call")
        named = {k: v for k, v in tr["kernels_ms_per_call"].items()
                 if "p2p_kernel" in k or "p2p2d_kernel" in k}
        _require(bool(named), f"the {engine} trace names the P2P kernel: "
                 f"{list(tr['kernels_ms_per_call'])[:8]}")
        print(f"profile {engine}: P2P kernel in the trace "
              f"{sum(named.values()):.3f} ms a padded force call of "
              f"{tr['device_ms_per_call']:.2f} ms device time")
    # each engine's stage rows launch the kernel in force_full,
    # force_padded and p2p (a warm-up and `reps` timed calls each, then a
    # warm-up and one traced call each), and its trace in a warm-up and
    # `calls`
    evals = 3 * (1 + reps) + 3 * 2 + 1 + calls
    by_dim = {3: p2p_cuda.launches - p2p_cuda.launches_2d,
              2: p2p_cuda.launches_2d}
    _require(by_dim == {3: evals, 2: evals}, f"profile: P2P kernel "
             f"launches by dim {by_dim} == {evals} force evaluations each")
    print(f"profile: p2p launches by dim {by_dim} = evals {evals} each")
    return recs, trs, by_dim


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


def _mesh_rank(mesh, windows, modes):
    """One rank of the multi-device phase at N=1M (p=6, r=1.67, the
    README's Gaussian beam, seed 0): the particle-sharded force against the
    single-device padded force on the same tree (no geometry refresh in
    either) and against the Kahan oracle, the hop histogram, the bytes each
    collective is handed in one force evaluation, the force's parts timed,
    then the mesh-mode Simulator over `windows` windows of 8 steps from one
    start in each of `modes` (True: CUDA graphs; False: eager), and with
    two eager runs the graphs within max(2 x eager against eager, 1e-6) of
    max|pos| of the first.  Returns rank 0's record; a failed check raises
    on the rank that sees it."""
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

    # the mesh-mode Simulator from one start in each of `modes` (CUDA
    # graphs on or off); graphs against eager on every rank
    sims, finals = [], []
    for graphs_on in modes:
        r, final = _mesh_sim(mesh, cfg, pos_h, vel_h, windows, graphs_on)
        sims.append(r)
        finals.append(final)
    rec["sims"] = sims
    eager = [f for f, g in zip(finals, modes) if not g]
    if len(eager) >= 2:
        rec["eager_vs_eager"], _ = _rel_dev(eager[1], eager[0])
        rec["graph_vs_eager"], _ = _rel_dev(finals[modes.index(True)],
                                            eager[0])
        bound = max(2 * rec["eager_vs_eager"], 1e-6)
        _require(rec["graph_vs_eager"] <= bound, f"rank {mesh.rank}: mesh "
                 f"graphs vs eager {rec['graph_vs_eager']:.3e} <= "
                 f"max(2 x {rec['eager_vs_eager']:.3e}, 1e-6)")
    return rec


def _mesh_sim(mesh, cfg, pos_h, vel_h, windows, graphs_on, n=N,
              engine="fmm3_kd"):
    """One rank's mesh-mode Simulator of the kd `engine` at `n` (N=1M
    unless given) with ``CO_CUDA_GRAPHS`` 1 or
    0: init_acc + `windows` windows of tree_steps=8 with the async
    pipeline (the first boundary primes it, the next adopts the background
    rebuild), each window run as its first step (the boundary, the ranks'
    re-capture vote, a capture), timed, and then the rest, whose
    collective calls a step are counted and whose s/step is timed alone;
    the captures so far are read after each window.  Checks on every
    rank: all ranks hold the same state and adopted the same lists, finite
    [n, dim] positions, P2P launches (of the dim-2 instantiation alone in
    2D) == force evaluations, the rebuilds; with graphs, captures >= 1
    and the same on every rank.  Returns (the record, with per-rank lists,
    the final positions)."""
    import torch
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

    dev = mesh.device
    counter = "launches_2d" if cfg.dim == 2 else "launches"
    os.environ["CO_CUDA_GRAPHS"] = "1" if graphs_on else "0"
    try:
        sim = Simulator(cfg, n, engine=engine, mesh=mesh)
    finally:
        del os.environ["CO_CUDA_GRAPHS"]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        setattr(p2p_cuda, counter, 0)
        sim.init_acc(particle_state_from_numpy(pos_h, vel_h, device=dev))
        ts = sim.config.tree_steps
        win_s, first_s, rest_s, step_calls, caps = [], [], [], [], []
        for _ in range(windows):
            torch.cuda.synchronize()
            mesh.barrier()
            tw = time.perf_counter()
            sim.advance_padded(1)
            torch.cuda.synchronize()
            tr = time.perf_counter()
            before = dict(mesh.calls)
            sim.advance_padded(ts - 1)
            torch.cuda.synchronize()
            win_s.append(time.perf_counter() - tw)
            first_s.append(tr - tw)
            rest_s.append((time.perf_counter() - tr) / (ts - 1))
            g = sim.graph
            caps.append([g.captures, round(g.capture_seconds, 4)] if g
                        else [0, 0.0])
            step_calls.append({k: (v - before.get(k, 0)) / (ts - 1)
                               for k, v in mesh.calls.items()})
        final = sim.current_state()
        torch.cuda.synchronize()
        launches = getattr(p2p_cuda, counter)
        fstate = sim._fstate
        g = sim.graph
        graph = ([g.captures, g.segments, g.capture_seconds] if g
                 else [0, 0, 0.0])
        peak = [torch.cuda.max_memory_allocated() / 2**30,
                torch.cuda.max_memory_reserved() / 2**30]
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
    per_rank = mesh.all_gather(torch.tensor(
        [[launches, graph[0], graph[1], graph[2]] + peak],
        dtype=torch.float64, device=dev)).cpu()
    _require(bool((rows == rows[0]).all()), "all ranks hold the same state "
             "and adopted the same lists")
    _require(bool(torch.isfinite(final.pos).all())
             and final.pos.shape == (n, cfg.dim),
             f"finite [{n}, {cfg.dim}] positions")
    _require(launches == evals, f"rank {mesh.rank} (graphs={graphs_on}): "
             f"{launches} P2P kernel launches == {evals} force evaluations")
    _require(sim.rebuilds["adopt_full"] == windows - 2
             and sim.rebuilds["sync_refresh"] == 1,
             f"{windows - 2} adopted rebuilds: {dict(sim.rebuilds)}")
    captures = per_rank[:, 1]
    if graphs_on:
        _require(bool((captures >= 1).all())
                 and bool((captures == captures[0]).all()),
                 f"every rank captured, as often as the others: "
                 f"{captures.tolist()}")
    else:
        _require(not bool(captures.any()), "eager: no capture")
    _require(all(c == step_calls[0] for c in step_calls),
             f"the same collectives every step: {step_calls}")
    r = dict(graphs=graphs_on, win_s=win_s, first_step_s=first_s,
             rest_s_per_step=rest_s, captures_after_window=caps,
             calls_per_step=step_calls[0],
             launches=per_rank[:, 0].long().tolist(), evals=evals,
             captures=captures.long().tolist(),
             segments=per_rank[:, 2].long().tolist(),
             capture_s=per_rank[:, 3].tolist(),
             peak_gib=per_rank[:, 4].tolist(),
             peak_reserved_gib=per_rank[:, 5].tolist(),
             rebuilds=dict(sim.rebuilds), wait_s=sim.rebuild_wait_total)
    return r, final.pos


def _mesh_rank_2d(mesh, windows):
    """One rank of the 2D mesh run: fmm2_kd at N_KD2 (ladder 2's config,
    the 2D beam, seed 0).  The particle-sharded force_padded
    (parallel/fmm_pshard.py) and the pair-sharded force
    (parallel/fmm_shard.py) against the single-device force on the same
    tree (<= 1e-5 of max|a| on rank 0), one dim-2 P2P launch a force
    evaluation on every rank, then the mesh-mode Simulator with CUDA
    graphs (:func:`_mesh_sim`).  Returns rank 0's record."""
    import torch
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
    from coulomb_oscillators_tpu_torch.parallel.fmm_pshard import (
        PShardedKdFmm, shard_pair_lists)
    from coulomb_oscillators_tpu_torch.parallel.fmm_shard import (
        make_sharded_force)

    dev, P = mesh.device, mesh.ndev
    cfg = SimConfig(**KD2_CFG)
    u = tuple(w * x for w, x in zip(cfg.omega0, X_STD[:2]))
    pos_h, vel_h = ID.init_gaussian(N_KD2, X_STD[:2], u, dim=2, seed=SEED)
    pos = torch.from_numpy(pos_h).to(dev)
    eng = KdFmmEngine(cfg, N_KD2)
    fs = eng.build(pos)
    ps = PShardedKdFmm(eng, mesh)
    lists, hops = shard_pair_lists(eng, fs, P)
    ppad = eng.pad_array(pos, fs, fill=FAR)
    force = make_sharded_force(eng, mesh)
    rec = dict(P=P, L=eng.L, C=eng.st.C, hops=hops)
    outs = {}
    for name, fn in (
            ("pshard", lambda: eng.unpad_array(ps.gather_padded(
                ps.force_padded(ps.shard_padded(ppad), fs, lists, hops)),
                fs)),
            ("shard", lambda: force(pos, fs))):
        torch.cuda.synchronize()
        p2p_cuda.launches_2d = 0
        outs[name] = fn()
        torch.cuda.synchronize()
        rec[name + "_launches"] = p2p_cuda.launches_2d
        _require(rec[name + "_launches"] == 1, f"rank {mesh.rank}: {name} "
                 f"force, {rec[name + '_launches']} dim-2 P2P launches == 1")
    if mesh.rank == 0:
        single = eng.unpad_array(eng.force_padded(ppad, fs), fs)
        for name, acc in outs.items():
            rec[name + "_vs_single"], _ = _rel_dev(acc, single)
            _require(bool(torch.isfinite(acc).all())
                     and acc.shape == (N_KD2, 2), f"finite {name} force")
            _require(rec[name + "_vs_single"] <= P2P_TOL,
                     f"2D {name} force vs single-device "
                     f"{rec[name + '_vs_single']:.3e} <= {P2P_TOL}")
    del outs, ppad, lists, fs, eng, ps
    rec["sim"], _ = _mesh_sim(mesh, cfg, pos_h, vel_h, windows, True,
                              n=N_KD2, engine="fmm2_kd")
    return rec


def _cli_graph_rank(mesh, argv):
    """The CLI's rank function (what ``cli.main`` spawns for ``-chips``)
    on `argv`, with every StepGraph it makes recorded: (its return code,
    the graphs' captures, their replays)."""
    from coulomb_oscillators_tpu_torch import cli
    from coulomb_oscillators_tpu_torch.utils import graphs
    made = []
    init = graphs.StepGraph.__init__

    def record(self, body):
        init(self, body)
        made.append(self)

    graphs.StepGraph.__init__ = record
    try:
        rc = cli._rank_main(mesh, cli.build_parser().parse_args(argv),
                            ["nbco3-torch"] + argv)
    finally:
        graphs.StepGraph.__init__ = init
    return rc, [g.captures for g in made], [g.replays for g in made]


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
    P2P launches by run in 3D and in 2D, the direct kernel's launches by
    scheme, the separate-targets entry's row)."""
    import numpy as np
    from coulomb_oscillators_tpu_torch import cli
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.parallel import mesh as PM
    from coulomb_oscillators_tpu_torch.utils import roofline

    windows = 3
    p2p_by_run = {}
    # 2 and 4 ranks sharing the card (gloo, collectives through host
    # memory), then 1 rank with the default placement (NCCL on cuda:0);
    # the mesh Simulator with CUDA graphs, and at 1 and 2 ranks twice
    # eagerly from the same start
    for P, kw, modes in ((2, dict(device="cuda:0", share_device=True),
                          (True, False, False)),
                         (4, dict(device="cuda:0", share_device=True),
                          (True,)),
                         (1, dict(), (True, False, False))):
        t0 = time.perf_counter()
        r = PM.spawn(_mesh_rank, P, windows, modes, timeout=300, **kw)
        label = (f"{P} ranks sharing one {smi}" if P > 1
                 else f"1 rank (NCCL) on {smi}")
        _require(r["backend"] == ("gloo" if P > 1 else "nccl"),
                 f"backend {r['backend']}")
        total = max(sum(r["hop_hist"].values()), 1)
        print(f"mesh [{label}]: L={r['L']} C={r['C']} hops={r['hops']} "
              f"dmax={r['dmax']}; sharded force vs single-device "
              f"{r['vs_single']:.3e} of max|a| (bound {P2P_TOL}), vs Kahan "
              f"{r['vs_kahan']:.3e} (bound {FORCE_TOL}); hop histogram "
              f"{r['hop_hist']} (hop 0: {r['hop_hist']['0'] / total:.4f}); "
              f"bytes a rank hands to each collective in one force "
              f"evaluation {r['bytes_per_eval']} (calls "
              f"{r['calls_per_eval']}); rank 0 force {r['force_ms']:.2f} ms "
              f"= far {r['far_ms']:.2f} + halo {r['halo_ms']:.2f} + near "
              f"{r['near_ms']:.2f} ms; spawn "
              f"{time.perf_counter() - t0:.1f} s")
        for sim in r["sims"]:
            per_step = sorted(w / 8 for w in sim["win_s"][1:])
            print(f"mesh simulator [{label}] graphs={sim['graphs']}: window "
                  f"s {sim['win_s']} (median s/step of windows 2-{windows} "
                  f"{per_step[len(per_step) // 2]:.4f}); its first step "
                  f"(the boundary, a vote, a capture) s "
                  f"{sim['first_step_s']}; s/step of the 7 steps after it "
                  f"{sim['rest_s_per_step']}; rank 0's captures and their "
                  f"s after each window {sim['captures_after_window']}; "
                  f"captures per rank "
                  f"{sim['captures']} in {sim['capture_s']} s, segments a "
                  f"step {sim['segments']}; collective calls a step "
                  f"{sim['calls_per_step']}; peak GiB allocated per rank "
                  f"{[round(x, 3) for x in sim['peak_gib']]} (reserved "
                  f"{[round(x, 3) for x in sim['peak_reserved_gib']]}); "
                  f"rebuilds {sim['rebuilds']}, boundary wait "
                  f"{sim['wait_s']:.3f} s; p2p launches per rank "
                  f"{sim['launches']} = force evals {sim['evals']}")
            _require(all(c == sim["evals"] for c in sim["launches"])
                     and len(sim["launches"]) == P,
                     f"P2P launches on every rank {sim['launches']} == "
                     f"{sim['evals']}")
            _require(sim["calls_per_step"] == r["sims"][0]["calls_per_step"],
                     "the same collective calls a step in both modes")
        if "graph_vs_eager" in r:
            print(f"mesh simulator [{label}]: max|dpos|/max|pos| graphs vs "
                  f"eager {r['graph_vs_eager']:.3e}, eager vs eager "
                  f"{r['eager_vs_eager']:.3e} (bound max(2 x eager vs "
                  f"eager, 1e-6))")
        key = f"mesh_{P}" + ("_nccl" if P == 1 else "")
        for sim in r["sims"][:2]:
            p2p_by_run[key + ("" if sim["graphs"] else "_eager")] = \
                sim["launches"][0]

    # fmm2_kd on 2 ranks sharing the card: the dim-2 P2P kernel on the
    # sharded near fields and in the mesh-mode Simulator
    t0 = time.perf_counter()
    r = PM.spawn(_mesh_rank_2d, 2, windows, timeout=300, device="cuda:0",
                 share_device=True)
    sim = r["sim"]
    print(f"mesh 2D [2 ranks sharing one {smi}] fmm2_kd N={N_KD2}: "
          f"L={r['L']} C={r['C']} hops={r['hops']}; particle-sharded force "
          f"vs single-device {r['pshard_vs_single']:.3e}, pair-sharded "
          f"{r['shard_vs_single']:.3e} of max|a| (bound {P2P_TOL}); dim-2 "
          f"p2p launches a force {r['pshard_launches']} / "
          f"{r['shard_launches']}; mesh simulator with graphs: window s "
          f"{sim['win_s']}, captures per rank {sim['captures']}, segments "
          f"{sim['segments']}, rebuilds {sim['rebuilds']}; dim-2 p2p "
          f"launches per rank {sim['launches']} = force evals "
          f"{sim['evals']}; spawn {time.perf_counter() - t0:.1f} s")
    _require(len(sim["launches"]) == 2
             and all(c == sim["evals"] for c in sim["launches"]),
             f"2D mesh: dim-2 P2P launches on every rank {sim['launches']} "
             f"== {sim['evals']}")
    p2p2_by_run = {"mesh_2": sim["launches"][0],
                   "mesh_2_pshard_force": r["pshard_launches"],
                   "mesh_2_shard_force": r["shard_launches"]}

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
    # a -chips rank is the CLI's own rank function; it inherits
    # CO_CUDA_GRAPHS (unset here: graphs) and takes graphs on the card
    with tempfile.TemporaryDirectory() as tmp:
        rc, caps, reps = PM.spawn(_cli_graph_rank, 1, [
            "-n", str(N_CLI), "-iters", "16", "-steps", "8", "-chips", "1",
            "-engine", "fmm3_kd", "-o", tmp])
    print(f"cli -chips 1 rank: rc {rc}, its step graphs' captures {caps}, "
          f"replays {reps}")
    # the reference's cadence steps at iteration 0, then -iters times
    _require(rc == 0 and len(caps) == 1 and caps[0] >= 1
             and reps == [1 + 16], f"the -chips rank replayed a captured "
             f"step 17 times: rc {rc}, captures {caps}, replays {reps}")

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
    return p2p_by_run, p2p2_by_run, direct_by_scheme, ts_row


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
    p2p_cuda.launches = p2p_cuda.launches_2d = D.launches = 0
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
               p2p_launches=p2p_cuda.launches,
               p2p_launches_2d=p2p_cuda.launches_2d,
               direct_launches=D.launches,
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
                "p2p_launches_2d", "direct_launches", "rebuilds",
                "device_ms_per_step",
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
    # beam): 2 windows of 8 steps; fmm2_kd eagerly twice, so that its
    # graph is held to the eager-against-eager spread
    n2 = 100_000
    c2 = SimConfig(dim=2, omega0=(1.095, 1.0), fmm_order=4, tree_radius=2.0)
    u2 = tuple(w * x for w, x in zip(c2.omega0, X_STD[:2]))
    p2, v2 = ID.init_gaussian(n2, X_STD[:2], u2, dim=2, seed=SEED)
    pu = _uniform_box(N, 3)
    for name, cfg, n, ph, vh in (
            ("fmm3_traceless", SimConfig(fmm_order=3, tree_steps=8), N, pu,
             np.zeros_like(pu)),
            ("fmm2_kd", c2, n2, p2, v2)):
        modes = (True, False, False) if name == "fmm2_kd" else (True, False)
        c = [_sim_windows(torch, g, cfg, n, name, ph, vh, (8, 8), dev,
                          busy=True) for g in modes]
        for r in c:
            line(f"{name} N={n}", r)
            if name == "fmm2_kd":
                # init_acc, 2 windows of 8 and the profiled window of 8
                evals = 1 + 8 + 8 + 8
                _require(r["p2p_launches"] == r["p2p_launches_2d"] == evals,
                         f"fmm2_kd (graphs={r['graphs']}): dim-2 P2P "
                         f"launches {r['p2p_launches_2d']} (all "
                         f"{r['p2p_launches']}) == {evals} force "
                         f"evaluations")
        d, _ = _rel_dev(c[0]["pos"], c[1]["pos"])
        tol = 1e-5
        if name == "fmm2_kd":
            ee, _ = _rel_dev(c[2]["pos"], c[1]["pos"])
            tol = max(2 * ee, 1e-6)
            print(f"graphs {name} N={n}: eager vs eager {ee:.3e} of "
                  f"max|pos|")
        print(f"graphs {name} N={n}: graph vs eager {d:.3e} of max|pos|; "
              f"s/step (window 2) graph {c[0]['s_per_step'][1]:.4f} eager "
              f"{c[1]['s_per_step'][1]:.4f}; busy graph "
              f"{100 * c[0]['busy_share']:.1f}% eager "
              f"{100 * c[1]['busy_share']:.1f}%; captures {c[0]['captures']} "
              f"in {c[0]['capture_s']:.2f} s ({smi})")
        _require(d <= tol, f"{name} graph vs eager {d:.3e} <= {tol:.3e}")
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


def _fd1_captured(fn):
    """Run fn() with file descriptor 1 sent to a temporary file, so what
    this process and the ranks it spawns print is read back; the text is
    printed afterwards.  Returns (fn's result, the text)."""
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile("w+") as f:
        os.dup2(f.fileno(), 1)
        try:
            out = fn()
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        text = f.read()
    sys.stdout.write(text)
    return out, text


def _phase_ladder_drift(dev, smi, torch):
    """Phase 18: the CLI's -accuracy with -chips 1, ladder rows 1 and 3a in
    both geometry modes, and the north-star drift artifact.  Returns the
    P2P and direct kernels' launches by path."""
    import numpy as np
    from coulomb_oscillators_tpu_torch import cli
    from coulomb_oscillators_tpu_torch.models import integrators as I
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.scripts import energy_drift, ladder
    from coulomb_oscillators_tpu_torch.utils import io as SIO

    # -accuracy with -chips 1 (NCCL, one rank): one search, in this process
    # before the rank starts; the rank runs its choice without searching
    tunes = []
    search = cli.autotune

    def timed_search(*a):
        t = time.perf_counter()
        out = search(*a)
        tunes.append((time.perf_counter() - t,) + tuple(out))
        return out

    base = ["-n", str(N_CLI), "-iters", "16", "-steps", "8", "-engine",
            "fmm3_kd"]
    cli.autotune = timed_search
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tc = time.perf_counter()
            rc, text = _fd1_captured(lambda: cli.main(
                ["-chips", "1", "-accuracy", "1e-3"] + base
                + ["-o", os.path.join(tmp, "tuned")]))
            tc = time.perf_counter() - tc
            _require(rc == 0, f"cli -chips 1 -accuracy 1e-3: rc {rc}")
            _require(len(tunes) == 1 and tunes[0][1] is not None,
                     f"one search in this process: {len(tunes)}")
            _require(text.count("Best parameters") == 1, "'Best parameters' "
                     f"printed {text.count('Best parameters')} times (once)")
            tune_s, cfg, err = tunes[0]
            _require(cfg.coll and cfg.accuracy == 1e-3,
                     f"tuned config {cfg}")
            # the single-device run of the tuned (p, r)
            one = os.path.join(tmp, "one")
            _require(cli.main(base + ["-p", str(cfg.fmm_order), "-r",
                                      str(cfg.tree_radius), "-o", one]) == 0,
                     "cli single-device run of the tuned (p, r)")
            names = sorted(f for f in os.listdir(one) if f.endswith(".bin"))
            got = sorted(f for f in os.listdir(os.path.join(tmp, "tuned"))
                         if f.endswith(".bin"))
            _require(got == names == sorted(f"out{i}_0.000500.bin"
                                            for i in (0, 8, 16)),
                     f"snapshots {got} == {names}")
            dpos = 0.0
            for f in names:
                a = os.path.join(tmp, "tuned", f)
                _require(os.path.getsize(a) == os.path.getsize(
                    os.path.join(one, f)) == 2 * N_CLI * 3 * 4, f"{f} bytes")
                p1, _ = SIO.read_state(os.path.join(one, f), dim=3,
                                       dtype=np.float32)
                p2, v2 = SIO.read_state(a, dim=3, dtype=np.float32)
                _require(bool(np.isfinite(p2).all() and np.isfinite(v2).all()),
                         f"{f} finite")
                dpos = max(dpos, float(np.abs(p2 - p1).max()
                                       / np.abs(p1).max()))
            _require(dpos <= 1e-4, f"-chips 1 -accuracy vs the single-device "
                     f"run of its (p, r): {dpos:.3e} <= 1e-4")
    finally:
        cli.autotune = search
    _require(cli.main(["-n", "64", "-chips", "2", "-engine", "fmm3_kd",
                       "-accuracy", "1e-3"]) == -1,
             "cli -chips 2 -accuracy on one card returns -1")
    print(f"cli -chips 1 -accuracy 1e-3 N={N_CLI} on {smi}: search "
          f"{tune_s:.3f} s (42 candidates, one in this process, none on "
          f"the rank), chosen p={cfg.fmm_order} r={cfg.tree_radius} error "
          f"{err:.3e}; whole run {tc:.3f} s; snapshots {got} as the "
          f"single-device run's, max|dpos|/max|pos| {dpos:.3e}; -chips 2 "
          f"refused", flush=True)

    # ladder rows 1 and 3a at their published sizes, geometry refresh on
    # and then off (CO_GEOM_REFRESH=0, the twin's freeze-and-drift mode),
    # and row 2 (fmm2_kd, the dim-2 P2P kernel) with geometry refresh
    rows = [r for r in ladder.configs({1, 2, 3})
            if r[0] != ladder.OCTREE_ROW]
    launches = {"ladder": {"p2p": 0, "direct": 0}, "ladder_2": 0}
    saved = os.environ.pop("CO_GEOM_REFRESH", None)
    try:
        for mode in ("1", "0"):
            os.environ["CO_GEOM_REFRESH"] = mode
            for tag, cfg, n, engine, kw in rows:
                if cfg.dim == 2 and mode == "0":
                    continue
                torch.cuda.synchronize()
                p2p_cuda.launches = p2p_cuda.launches_2d = 0
                D.launches = 0
                row = ladder.run(tag, cfg, n, engine, dev, **kw)
                torch.cuda.synchronize()
                # init_acc, then every step the row ran
                evals = 1 + row["steps_run"] * I.FORCE_EVALS[cfg.integrator]
                seen = {"p2p": p2p_cuda.launches, "direct": D.launches}
                want = ({"p2p": 0, "direct": evals} if engine == "direct"
                        else {"p2p": evals, "direct": 0})
                if cfg.dim == 2:
                    seen["p2p_dim2"] = p2p_cuda.launches_2d
                    want["p2p_dim2"] = evals
                print(json.dumps(dict(row, card=smi, launches=seen)),
                      flush=True)
                print(f"ladder {tag} geom_refresh={row['geom_refresh']} on "
                      f"{smi}: {row['sec_per_step']:.6f} s/step, captures "
                      f"{row['captures']}", flush=True)
                _require("error" not in row and row["finite"]
                         and 0 < row["sec_per_step"] < float("inf"),
                         f"ladder {tag}: finite")
                _require(row["geom_refresh"] is (mode == "1"),
                         f"ladder {tag}: geom_refresh {row['geom_refresh']}")
                _require(seen == want, f"ladder {tag}: launches {seen} == "
                         f"{want} ({evals} force evaluations)")
                _require(1 <= row["captures"] <= 2, f"ladder {tag}: "
                         f"captures {row['captures']} in 1-2")
                if cfg.dim == 2:
                    launches["ladder_2"] += seen["p2p_dim2"]
                else:
                    for k in seen:
                        launches["ladder"][k] += seen[k]
    finally:
        if saved is None:
            os.environ.pop("CO_GEOM_REFRESH", None)
        else:
            os.environ["CO_GEOM_REFRESH"] = saved

    # the north-star drift artifact, cut to 2000 steps
    steps = 2000
    torch.cuda.synchronize()
    p2p_cuda.launches = 0
    res = energy_drift.artifact(steps=steps)
    torch.cuda.synchronize()
    rungs = res["rung_max_drifts"]
    launches["drift_artifact"] = p2p_cuda.launches
    print(json.dumps(dict(res, card=smi, p2p_launches=p2p_cuda.launches)),
          flush=True)
    print(f"drift artifact on {smi}: {steps} steps, first rung max drift "
          f"{rungs[0]:.3e} ({res['config']}), "
          f"{'stiffened' if len(rungs) > 1 else 'not stiffened'}; final max "
          f"drift {res['max_drift']:.3e} (bound {DRIFT_TOL})", flush=True)
    _require(res["pass"] and res["max_drift"] <= DRIFT_TOL,
             f"drift artifact {res['max_drift']:.3e} <= {DRIFT_TOL}")
    _require(p2p_cuda.launches == len(rungs) * (1 + steps),
             f"drift artifact: {p2p_cuda.launches} P2P launches == "
             f"{len(rungs)} x {1 + steps} force evaluations")
    return launches


def _phase_stored_fold(dev, smi, torch):
    """Phase 19: the stored-fold M2L (CO_M2L_FLY=0) against fly mode.
    Returns the P2P launches of its paths by dim."""
    import numpy as np
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    from coulomb_oscillators_tpu_torch.ops import direct as D
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
    from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err
    from coulomb_oscillators_tpu_torch.scripts._common import m2l_env
    from coulomb_oscillators_tpu_torch.scripts.stale_margin_probe import (
        cadence_config)

    # (a) the bench's configuration: both modes' states, forces, stages
    cfg = SimConfig(fmm_order=6, tree_radius=1.67)      # boost 1.5
    u_std = tuple(w * x for w, x in zip(cfg.omega0, X_STD))
    pos_h, vel_h = ID.init_gaussian(N, X_STD, u_std, seed=SEED)
    pos = torch.from_numpy(pos_h).to(dev)
    forces, rows = {}, {}
    p2p_cuda.launches = 0
    for mode, fly in (("fly", True), ("stored", False)):
        with m2l_env(fly):
            eng = KdFmmEngine(cfg, N)
        _require(eng.m2l_fly is fly, f"CO_M2L_FLY read ({mode})")
        fs = eng.build(pos)
        Km, S_H = fs.m2l_tgt.shape[0], eng.tables.S_H
        want = (Km, S_H) if mode == "stored" else (1, 1)
        _require(tuple(fs.m2l_h2.shape) == want,
                 f"{mode} m2l_h2 {tuple(fs.m2l_h2.shape)} == {want}")
        forces[mode] = [eng.force(pos, fs) for _ in range(2)]
        ppad = eng.pad_array(pos, fs, fill=FAR)
        mh = eng._stage_multipoles(ppad, fs)
        rows[mode] = dict(
            m2l_ms=_cuda_ms(lambda: eng._stage_m2l(mh, fs), 5, torch),
            geom_refresh_ms=_cuda_ms(lambda: eng.geom_refresh(ppad, fs), 5,
                                     torch),
            m2l_entries=Km, fold_bytes=Km * S_H * fs.center.element_size(),
            state_fold_bytes=sum(x.numel() * x.element_size() for x in
                                 (fs.m2l_h2, fs.m2l_w, fs.m2l_logc)),
            adopt_fold_ms=1e3 * eng.last_build_times.get("m2l_fold", 0.0))
        del eng, fs, ppad, mh
    torch.cuda.synchronize()
    force_launches = p2p_cuda.launches
    _require(force_launches == 4, f"{force_launches} P2P launches == 4 "
             f"force evaluations")
    spread = max(_rel_dev(*forces[m])[0] for m in forces)
    bound = max(2 * spread, 1e-6)
    dev_sf = _rel_dev(forces["stored"][0], forces["fly"][0])[0]
    idx = torch.from_numpy(np.random.default_rng(SEED).choice(
        N, 2048, replace=False)).to(dev)
    ref = D.direct_kahan_targets(pos[idx], pos, cfg.eps2, cfg.kappa(N))
    err = {m: float(mean_rel_err(forces[m][0][idx], ref)) for m in forces}
    print(f"stored fold N={N} p=6 r=1.67 ({smi}): stored vs fly force "
          f"{dev_sf:.3e} (bound max(2 x eager spread {spread:.3e}, 1e-6)); "
          f"mean rel err vs Kahan on 2048 targets stored {err['stored']:.3e}"
          f" fly {err['fly']:.3e} (bound {FORCE_TOL}); P2P launches "
          f"{force_launches} = force evals 4")
    print("stored fold timings (CUDA events, ms): " + json.dumps(rows))
    _require(all(bool(torch.isfinite(f[0]).all()) for f in forces.values()),
             "finite forces in both modes")
    _require(dev_sf <= bound, f"stored vs fly {dev_sf:.3e} <= {bound:.3e}")
    _require(err["stored"] <= FORCE_TOL,
             f"stored-fold force error {err['stored']:.3e} <= {FORCE_TOL}")
    del forces, ref, pos

    # (b) 16/2/2 windows with graphs, refresh on, in both modes: three
    # windows and a step, so that a background re-sort (folded on the
    # rebuild thread in stored mode) is adopted
    ccfg = cadence_config(6, 1.67, 16, 2, 2)
    win = {}
    for mode, fly in (("fly", True), ("stored", False)):
        with m2l_env(fly):
            win[mode] = _sim_windows(torch, True, ccfg, N, "fmm3_kd", pos_h,
                                     vel_h, [16, 16, 16, 1], dev)
        r = win[mode]
        _require(r["p2p_launches"] == 50, f"{mode} window: "
                 f"{r['p2p_launches']} P2P launches == 50 force evaluations")
        _require(r["captures"] >= 1, f"{mode} window captured its step")
        _require(r["rebuilds"].get("adopt_full", 0) >= 1,
                 f"{mode} window adopted a re-sort: {r['rebuilds']}")
    d_win = float((win["stored"]["pos"] - win["fly"]["pos"]).abs().max()
                  / win["fly"]["pos"].abs().max())
    print(f"stored fold windows 16/2/2 N={N} graphs ({smi}): stored vs fly "
          f"max|dpos|/max|pos| {d_win:.3e} (bound 1e-5); " + json.dumps(
              {m: {k: win[m][k] for k in ("s_per_step", "event_ms_per_step",
                                          "captures", "capture_s",
                                          "peak_bytes", "p2p_launches",
                                          "rebuilds")} for m in win}))
    _require(d_win <= 1e-5, f"stored vs fly window {d_win:.3e} <= 1e-5")

    # (c) fmm2_kd, ladder row 2's configuration, frozen geometry
    cfg2 = SimConfig(dim=2, omega0=(1.095, 1.0), fmm_order=4,
                     tree_radius=2.0, geom_refresh=False)
    u2 = tuple(w * x for w, x in zip(cfg2.omega0, X_STD[:2]))
    p2, v2 = ID.init_gaussian(N_KD2, X_STD[:2], u2, dim=2, seed=SEED)
    w2 = {}
    for mode, fly in (("fly", True), ("stored", False)):
        with m2l_env(fly):
            w2[mode] = _sim_windows(torch, True, cfg2, N_KD2, "fmm2_kd", p2,
                                    v2, [12], dev)
        _require(w2[mode]["p2p_launches_2d"] == 13, f"fmm2_kd {mode}: "
                 f"{w2[mode]['p2p_launches_2d']} dim-2 P2P launches == 13")
    d2 = float((w2["stored"]["pos"] - w2["fly"]["pos"]).abs().max()
               / w2["fly"]["pos"].abs().max())
    print(f"stored fold fmm2_kd N={N_KD2} p=4 r=2 CO_GEOM_REFRESH=0 "
          f"({smi}): stored vs fly max|dpos|/max|pos| {d2:.3e} (bound "
          f"1e-5); " + json.dumps({m: {k: w2[m][k] for k in (
              "s_per_step", "captures", "p2p_launches_2d", "rebuilds")}
              for m in w2}))
    _require(d2 <= 1e-5, f"fmm2_kd stored vs fly {d2:.3e} <= 1e-5")
    return {3: {"forces": force_launches,
                "window": {m: win[m]["p2p_launches"] for m in win}},
            2: {m: w2[m]["p2p_launches_2d"] for m in w2}}


def _far_studies_child(path):
    """The four far-field study twins of scripts/ through their functions
    on cuda:0; their results, the seconds of each and whether CO_M2L_FLY
    is as it was go to the JSON file `path`.  Each study raises where a
    variant misses its identity or a trace lost its kernels."""
    import torch
    from coulomb_oscillators_tpu_torch.scripts import l2p_micro as LM
    from coulomb_oscillators_tpu_torch.scripts import m2l_micro as MM
    from coulomb_oscillators_tpu_torch.scripts import m2l_micro2 as MM2
    from coulomb_oscillators_tpu_torch.scripts import m2l_window_stats as WS

    dev = torch.device("cuda", 0)
    knob = os.environ.get("CO_M2L_FLY")
    out = {}
    for name, run in (
            ("m2l_window_stats", lambda: WS.stats(N_FAR, 6, 1.67, dev)),
            ("m2l_micro", lambda: MM.study(N_FAR, 6, 1.67, dev, reps=2)),
            ("m2l_micro2", lambda: MM2.study(N_FAR, 6, 1.67, 2048, dev,
                                             reps=2)),
            ("l2p_micro", lambda: LM.study(6, dev, reps=2))):
        t = time.perf_counter()
        out[name] = dict(run(), seconds=time.perf_counter() - t)
    out["knob_kept"] = os.environ.get("CO_M2L_FLY") == knob
    with open(path, "w") as f:
        json.dump(out, f)


def _phase_far_studies(smi):
    """Phase 20: the far-field study twins, in a process of their own: a
    process that has traced the earlier phases loses kernel events from
    its later traces (zeros and partial sums in the studies' kernel
    times), and the studies time every variant by its kernels."""
    from coulomb_oscillators_tpu_torch.scripts.m2l_micro import TOL

    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "far_studies.json")
        res = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke._far_studies_child({path!r})"], cwd=here,
            capture_output=True, text=True, timeout=600)
        print(res.stdout, end="", flush=True)
        _require(res.returncode == 0, f"far-field studies exited "
                 f"{res.returncode}: {res.stderr[-3000:]}")
        with open(path) as f:
            out = json.load(f)
    print(json.dumps({"far_studies": out, "card": smi}), flush=True)
    _require(out.pop("knob_kept"), "CO_M2L_FLY as it was after the studies")
    ws = out["m2l_window_stats"]
    _require(ws["config"]["K"] > 0 and len(ws["lines"]) == 13,
             f"window stats: K {ws['config']['K']} > 0, 13 lines")
    names = {"m2l_micro": ["full", "gather", "gather64", "gather128",
                           "gathersrt", "compute", "segsum", "grouped8",
                           "grouped16", "grouped32"],
             "m2l_micro2": ["full", "winchunk", "winchunk_bf", "srcbcast8",
                            "srcbcast16"],
             "l2p_micro": ["monomials", "expand+W", "final einsum",
                           "final batchmatmul", "l2p_field_blocked",
                           "l2l (G nodes)"]}
    for study, want in names.items():
        rows = out[study]["rows"]
        _require([r["name"] for r in rows] == want,
                 f"{study}: rows {[r['name'] for r in rows]} == {want}")
        for r in rows:
            # a trace that lost its kernels made the study raise
            _require(r.get("finite", True) and r["event_ms"] > 0
                     and r["kernel_ms"] > 0,
                     f"{study} {r['name']}: finite, timed on the card "
                     f"({r.get('event_ms')}, {r.get('kernel_ms')} ms)")
    held = [r["rel_dev"] for s in ("m2l_micro", "m2l_micro2")
            for r in out[s]["rows"]
            if "rel_dev" in r and r.get("dtype") != "bfloat16"]
    _require(len(held) == 12 and max(held) <= TOL,
             f"{len(held)} float32 variants == 12, each <= {TOL}")


def _phase_traversal(dev, smi):
    """Phase 21: the traversal kernel against the native traversal and the
    plain version at the main path's shapes, in dims 3 and 2.  Returns
    the rows, the 1M production beam's first, and the kernel's launches
    in the phase."""
    from coulomb_oscillators_tpu_torch.ops.fmm import traverse
    from coulomb_oscillators_tpu_torch.scripts import traverse_bench as TB

    launches = traverse.launches
    rows = []
    for name in ("1m", "30001", "2d_1m", "2d_30001"):
        row = TB.run_case(name, 3, True, dev)
        print(json.dumps({"traversal": row, "card": smi}), flush=True)
        _require(row["equal"] and row["plain_equal"],
                 f"traversal {name}: the card's lists and the plain "
                 f"version's equal the native's")
        _require(row["reruns"] == 0 and row["levels"] <= 2 * row["L"] + 1,
                 f"traversal {name}: {row['levels']} launches, no rerun "
                 f"with buffers sized by an earlier traversal")
        rows.append(row)
    _require([r["dim"] for r in rows] == [3, 3, 2, 2],
             f"dims {[r['dim'] for r in rows]}")
    return rows, traverse.launches - launches


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
    from coulomb_oscillators_tpu_torch.ops.fmm import (kdtree, p2p_cuda,
                                                       traverse)
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
    libs = (p2p_cuda.library, p2p_cuda.library_2d, D.library)
    with concurrent.futures.ThreadPoolExecutor(len(libs) + 1) as pool:
        for f in [pool.submit(lib.get) for lib in libs] + [
                pool.submit(native.get_lib)]:
            f.result()
    print(f"build: p2p.cu {p2p_cuda.library.build_seconds:.2f} s, p2p2d.cu "
          f"{p2p_cuda.library_2d.build_seconds:.2f} s, direct.cu "
          f"{D.library.build_seconds:.2f} s, co_native.cpp "
          f"{native.build_seconds:.2f} s (concurrent)")
    for lib in libs:
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
    p2p_rows = [_p2p_case(c, sd, pos, torch)[0] for c, sd in (
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
    traverse.launches = traverse.reruns = 0
    trav0 = (kdtree.device_traversals, kdtree.native_traversals,
             kdtree.raw_traversals)
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
    card_trav, host_trav, raw_trav = (
        now - was for now, was in zip((kdtree.device_traversals,
                                       kdtree.native_traversals,
                                       kdtree.raw_traversals), trav0))
    trav_launches, trav_runs = traverse.launches, traverse.reruns + card_trav
    evals = 1 + WINDOWS * ts
    _require(bool(torch.isfinite(final.pos).all())
             and final.pos.shape == (N, 3), "finite [N, 3] positions")
    _require(p2p_launches == evals,
             f"{p2p_launches} P2P kernel launches == {evals} force evaluations")
    _require(sim.rebuilds["adopt_full"] == WINDOWS - 2,
             f"{WINDOWS - 2} adopted background rebuilds: {dict(sim.rebuilds)}")
    _require(native._lib is not None, "the native host library was used")
    # the build, the priming refresh and every re-sort, adopted or not
    _require(host_trav == 0 and raw_trav == 0
             and card_trav >= 1 + sum(sim.rebuilds.values()),
             f"every traversal on the card: {card_trav} on the card, "
             f"{host_trav} native, {raw_trav} numpy; rebuilds "
             f"{dict(sim.rebuilds)}")
    _require(trav_runs <= trav_launches <= trav_runs * (2 * sim._fmm.L + 1),
             f"{trav_launches} traversal kernel launches for {trav_runs} "
             f"runs, one a level")
    per_step = sorted(w / ts for w in win_s[1:])
    print(f"simulator N={N}: init_acc {ti:.3f} s; window s {win_s}; "
          f"median s/step (windows 2-{WINDOWS}) {per_step[len(per_step) // 2]:.4f}; "
          f"rebuilds {dict(sim.rebuilds)}; boundary wait s {wait_s}; "
          f"host rebuild s {job_s}; "
          f"last rebuild breakdown {sim._fmm.last_build_times}; "
          f"p2p launches {p2p_launches} = force evals {evals}; "
          f"traversals on the card {card_trav} ({trav_launches} kernel "
          f"launches)")
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
    f64_row, kd2_rows = _phase_kd_variants(dev, torch)
    _phase("kd 2D and float64", t0)

    # ---- 11. the port's bench ------------------------------------------
    t0 = time.perf_counter()
    _, bench_launches = _phase_bench(torch)
    _phase("bench", t0)

    # ---- 12. stage profile and kernel trace ----------------------------
    t0 = time.perf_counter()
    _, _, profile_launches = _phase_profile(dev, torch)   # by dim
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
    mesh_p2p, mesh_p2p2, mesh_direct, ts_row = _phase_multi_device(
        dev, smi, torch)
    _phase("multi-device", t0)

    # ---- 16. CUDA graphs against eager steps ---------------------------
    t0 = time.perf_counter()
    graph_rows = _phase_graphs(dev, smi, torch)
    _phase("graphs", t0)

    # ---- 17. the probe twins at N=1M ----------------------------------
    t0 = time.perf_counter()
    probe_launches = _phase_probes(dev, smi, torch)
    _phase("probes", t0)

    # ---- 18. -accuracy with -chips, the ladder and the drift artifact --
    t0 = time.perf_counter()
    ld_launches = _phase_ladder_drift(dev, smi, torch)
    _phase("ladder and drift", t0)

    # ---- 19. the stored-fold M2L against fly mode ----------------------
    t0 = time.perf_counter()
    sf_launches = _phase_stored_fold(dev, smi, torch)
    _phase("stored fold", t0)

    # ---- 20. the far-field studies --------------------------------------
    t0 = time.perf_counter()
    _phase_far_studies(smi)
    _phase("far-field studies", t0)

    # ---- 21. the traversal kernel at the main path's shapes -------------
    t0 = time.perf_counter()
    trav_rows, trav_phase_launches = _phase_traversal(dev, smi)
    _phase("traversal", t0)

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
                              "profile": profile_launches[3],
                              "probes": probe_launches["p2p"],
                              "ladder": ld_launches["ladder"]["p2p"],
                              "drift_artifact": ld_launches["drift_artifact"],
                              "stored_fold": sf_launches[3],
                              **mesh_p2p},
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
        *[{"name": name, "route": "cuda",
           "source": "coulomb_oscillators_tpu_torch/csrc/p2p2d.cu",
           "replaces": "coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py:52",
           "also_replaces":
               "coulomb_oscillators_tpu/ops/fmm/p2p_pallas.py:110",
           "replaces_bodies": "_p2p_kernel and _p2p_stream_kernel with "
                              "dim=2 (w = r*r)",
           "dim": 2, "dtype": dtype, "launches": r["launches"],
           "launches_by_path": paths,
           "max_abs_err": r["max_abs_err"], "max_abs_ref": r["max_abs_ref"],
           "max_rel_err": r["max_rel_err"], "ms": r["ms"],
           "plain_ms": r["plain_ms"], "pairs": r["pairs"],
           "real_pairs": r["real_pairs"], "entries": r["entries"],
           "seg_entries": r["seg_entries"], "segments": r["segments"],
           **{k: r[k] for k in bound_keys + ("flop_ms", "mufu_ms",
                                            "byte_ms")},
           "library_ms": None, "cases": r["cases"]}
          for name, dtype, r, paths in (
              ("p2p_dim2", "float32", kd2_rows["p2p_dim2"],
               {"kd_variants": kd2_rows["p2p_dim2"]["launches"],
                "graphs": {"graphs": graph_rows["fmm2_kd"][0]
                           ["p2p_launches_2d"],
                           "eager": graph_rows["fmm2_kd"][1]
                           ["p2p_launches_2d"]},
                "profile": profile_launches[2], **mesh_p2p2,
                "ladder_2": ld_launches["ladder_2"],
                "stored_fold": sf_launches[2]}),
              ("p2p_dim2_float64", "float64",
               kd2_rows["p2p_dim2_float64"],
               {"kd_variants": kd2_rows["p2p_dim2_float64"]["launches"]}))],
        {"name": "direct", "route": "cuda",
         "source": "coulomb_oscillators_tpu_torch/csrc/direct.cu",
         "replaces": "coulomb_oscillators_tpu/ops/direct.py:161",
         "launches": direct_launches,
         "launches_by_path": {"cli": direct_launches,
                              "probes": probe_launches["direct"],
                              "ladder": ld_launches["ladder"]["direct"],
                              **mesh_direct},
         "targets_entry": ts_row, "max_abs_err": drow["max_abs_err"],
         "max_abs_ref": drow["max_abs_ref"],
         "max_rel_err": drow["max_rel_err"], "ms": drow["ms"],
         "plain_ms": drow["plain_ms"], "pairs": drow["pairs"],
         **{k: drow[k] for k in bound_keys}, "library_ms": None,
         "cases": [direct_rows[c] for c in DIRECT_CASES]},
        {"name": "traverse", "route": "cuda",
         "source": "coulomb_oscillators_tpu_torch/csrc/traverse.cu",
         "replaces": None,
         "replaces_host": "coulomb_oscillators_tpu_torch/native/"
                          "co_native.cpp co_traverse_fine",
         "launches": trav_launches,
         "launches_by_path": {"simulator": trav_launches,
                              "traversal": trav_phase_launches},
         "equal": True, "ms": trav_rows[0]["frontier_ms"],
         "plain_ms": trav_rows[0]["plain_frontier_ms"],
         "bound_ms": trav_rows[0]["frontier_bound_ms"],
         "bound_by": "bytes",
         "bound_share": trav_rows[0]["frontier_share"],
         "library_ms": None, "cases": trav_rows}]}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
