"""Weak-scaling smoke of the particle-sharded kd-FMM: fixed n/P at
P = 1, 2, 4, 8 ranks.

Twin of the repository root's ``scripts/pshard_scaling.py``.  For each P it
spawns P ranks, runs the mesh-mode Simulator's window loop, and records

  * the per-hop near-field pair-count histogram from ``shard_pair_lists``
    (kd order is spatial, so the mass sits at hop 0 with a thin halo);
  * the bytes one force evaluation hands to each collective on one rank,
    counted from the tensors the three collectives of ``parallel.mesh.Mesh``
    are given (not modelled), beside the bytes of the rank's state;
  * s/step of the window loop.  With ``--device cpu`` the ranks are CPU
    processes on one host; on a card every rank shares the one device
    (``share_device=True``) and its collectives go through host memory.
    Either way the ranks share one machine, so s/step measures the total
    work serialized and is labelled so: it is NOT a scaling figure;
  * beside it, per rank: the captures of the window's CUDA graphs, their
    seconds, the graph segments a step (its collectives + 1; on a card,
    unless ``CO_CUDA_GRAPHS=0``; 0 on CPU ranks, which run eagerly) and
    the peak device memory allocated and reserved (null on CPU ranks).

One JSON line on stdout (also written to ``--out``).

Usage:
  python -m coulomb_oscillators_tpu_torch.scripts.pshard_scaling
      [n_per_rank] [p] [r] [--ranks 1,2,4,8] [--windows 3] [--device cpu]
      [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from coulomb_oscillators_tpu_torch.scripts import _common as C

TREE_STEPS = 8


def _scaling_rank(mesh, npp: int, p: int, r: float, windows: int) -> dict:
    """One rank of one row: the mesh-mode Simulator at n = npp * P."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import _heap_off
    from coulomb_oscillators_tpu_torch.simulate import Simulator
    from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

    P, dev, ts = mesh.ndev, mesh.device, TREE_STEPS
    n = npp * P
    cfg = SimConfig(fmm_order=p, tree_radius=r, tree_steps=ts)
    pos, vel = C.beam(n, cfg)
    sim = Simulator(cfg, n, engine="fmm3_kd", mesh=mesh)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        st = sim.init_acc(particle_state_from_numpy(pos, vel, device=dev))
        sim.run(st, 2 + ts)                      # warm-up, one boundary
        C.sync(dev)
        mesh.barrier()
        t0 = time.perf_counter()
        sim.advance_padded(windows * ts)
        C.sync(dev)
        mesh.barrier()
        sps = (time.perf_counter() - t0) / (windows * ts)
        eng, ps = sim._fmm, sim._ps
        lists, hops = sim._plists, sim._phops
        mesh.bytes.clear()
        mesh.calls.clear()
        acc = ps.force_padded(sim._padded.pos, sim._fstate, lists, hops)
        finite = bool(torch.isfinite(acc).all())
        moved, calls = dict(mesh.bytes), dict(mesh.calls)
        g = sim.graph
        mine = [g.captures if g else 0, g.capture_seconds if g else 0.0,
                g.segments if g else 0]
        if cuda:
            mine += [torch.cuda.max_memory_allocated(dev) / 2**30,
                     torch.cuda.max_memory_reserved(dev) / 2**30]
    finally:
        sim.close()
    ranks = mesh.all_gather(torch.tensor([mine], dtype=torch.float64,
                                         device=dev)).cpu()
    G, Cl = eng.G_sub, eng.st.C
    item = acc.element_size()
    hist = {str(h): int(lists.p2p_val[i].sum()) for i, h in enumerate(hops)}
    return {
        "P": P, "n": n, "L": eng.L, "G": G, "C": Cl,
        "s_per_step_ranks_sharing_one_machine": sps,
        "captures_per_rank": ranks[:, 0].long().tolist(),
        "capture_seconds_per_rank": ranks[:, 1].tolist(),
        "segments_per_step_per_rank": ranks[:, 2].long().tolist(),
        "peak_gib_per_rank": ranks[:, 3].tolist() if cuda else None,
        "peak_reserved_gib_per_rank": ranks[:, 4].tolist() if cuda else None,
        "finite": finite, "rebuilds": dict(sim.rebuilds),
        "p2p_hop_hist": hist,
        "p2p_hop0_frac": hist["0"] / max(sum(hist.values()), 1),
        "bytes_per_eval_handed_to": moved,
        "bytes_per_eval_total": sum(moved.values()),
        "collective_calls_per_eval": calls,
        "shapes": {"all_gather": [G // P, eng.tables.S_M],
                   "all_reduce_sum": [_heap_off(eng.L + 1),
                                      eng.tables.S_Lt],
                   "ring_shift": [G // P, Cl, 3]},
        "state_bytes_per_rank": (G // P) * Cl * 3 * item * 3}


def run(npp: int, p: int, r: float, ranks, windows: int, device) -> dict:
    from coulomb_oscillators_tpu_torch.parallel import mesh as PM
    dev = C.pick_device(device)
    rows = [PM.spawn(_scaling_rank, P, npp, p, r, windows, device=str(dev),
                     share_device=dev.type == "cuda", timeout=600)
            for P in ranks]
    info = C.device_info(dev)
    return {"n_per_rank": npp, "p": p, "r": r, "tree_steps": TREE_STEPS,
            "device": info,
            "caveat": ("all ranks share one machine (one card with "
                       "share_device=True, collectives through host "
                       "memory; or CPU processes of one host), so s/step "
                       "measures the total work serialized and is no "
                       "scaling figure; the hop histogram and the bytes "
                       "handed to the collectives are the structural "
                       "quantities"),
            "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_per_rank", nargs="?", type=int, default=16384)
    ap.add_argument("p", nargs="?", type=int, default=5)
    ap.add_argument("r", nargs="?", type=float, default=1.67)
    ap.add_argument("--ranks", default="1,2,4,8")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = run(args.n_per_rank, args.p, args.r,
              [int(x) for x in args.ranks.split(",")], args.windows,
              args.device)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
