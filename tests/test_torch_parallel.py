"""Port vs reference: the multi-device modules ``parallel/{mesh,fmm_shard,
fmm_pshard}.py``.

The same numpy inputs go to both packages.  The reference runs on its
virtual CPU mesh, or single-device where its sharded form is held against
it in its own tests; the port's ranks are real gloo processes on the CPU,
one spawn per rank count (``ranks`` below), and the rank side lives in
tests/torch_parallel_workers.py.  Where forces are compared both packages
evaluate on the SAME lists (the reference's ``FmmState`` carried over with
``fmm_state_from_numpy``), so a difference is arithmetic, not another tree.

The reference engine is built with ``use_pallas=True`` (the port's one
layout); that build runs on the CPU and never calls its Pallas kernel.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_parallel_workers as W
from coulomb_oscillators_tpu import ParticleState as JState
from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu.models import init_dist as ID
from coulomb_oscillators_tpu.ops import direct as JD
from coulomb_oscillators_tpu.ops.fmm.kdtree import KdFmmEngine as JEngine
from coulomb_oscillators_tpu.ops.reductions import mean_rel_err as j_mre
from coulomb_oscillators_tpu.parallel import fmm_pshard as JPS
from coulomb_oscillators_tpu.parallel import mesh as JPM
from coulomb_oscillators_tpu.simulate import Simulator as JSim
from coulomb_oscillators_tpu_torch import SimConfig as TConfig
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (
    KdFmmEngine, fmm_state_from_numpy)
from coulomb_oscillators_tpu_torch.parallel import fmm_pshard as TPS
from coulomb_oscillators_tpu_torch.parallel import mesh as PM

torch.set_num_threads(1)

X_STD = (0.003, 0.001, 0.01)
CFG = dict(fmm_order=3, tree_radius=2.0)
N = 4096            # the sharded lists, force and step
N_PAIR = 1200       # the pair-sharded force (tests/test_fmm_shard.py)
N_SMALL, L_SMALL = 1024, 3   # the dry run's forced level
N_DIRECT = 1001     # not a multiple of any rank count: pad_to_multiple
EPS2, KAPPA = 1e-18, 2e-9


def _np_state(fs):
    return {f: np.asarray(getattr(fs, f)) for f in fs._fields}


def _beam(n, dim=3):
    u = tuple(w * x for w, x in zip(JConfig().omega0, X_STD))
    return ID.init_gaussian(n, X_STD[:dim], u[:dim], dim=dim)


def _rel(a, b):
    """max row norm of a - b over max row norm of b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.linalg.norm(a - b, axis=-1).max()
            / np.linalg.norm(b, axis=-1).max())


def _reference(n, L=None):
    """The reference engine and its state on the beam at `n`, with M2L
    group 8 and 1."""
    import os
    pos, vel = _beam(n)
    out = {"pos": pos, "vel": vel}
    for key, g in (("g8", "8"), ("g1", "1")):
        old = os.environ.get("CO_M2L_GROUP")
        os.environ["CO_M2L_GROUP"] = g
        try:
            eng = JEngine(JConfig(**CFG), n, use_pallas=True, L=L)
        finally:
            if old is None:
                del os.environ["CO_M2L_GROUP"]
            else:
                os.environ["CO_M2L_GROUP"] = old
        fs = eng.build(jnp.asarray(pos))
        out[key] = (eng, fs)
    out["states"] = {k: _np_state(out[k][1]) for k in ("g8", "g1")}
    return out


def _jforce(jeng, pos, jfs):
    """The reference's single-device force on its use_pallas layout
    through its scan branch (the Pallas kernel has no CPU mode)."""
    jeng.use_pallas = False
    try:
        return np.asarray(jeng.force(jnp.asarray(pos), jfs))
    finally:
        jeng.use_pallas = True


@pytest.fixture(scope="module")
def ref():
    return {N: _reference(N), N_PAIR: _reference(N_PAIR),
            N_SMALL: _reference(N_SMALL, L=L_SMALL)}


@pytest.fixture(scope="module")
def direct_cases():
    return {f"{s}{d}": (s, _beam(N_DIRECT, d)[0])
            for s in ("ring", "allgather") for d in (2, 3)}


@pytest.fixture(scope="module")
def ranks(ref, direct_cases):
    """ranks(ndev): rank 0's results of one spawn of `ndev` CPU ranks
    (made at first use, kept for the module)."""
    cache = {}

    def args(n, L=None):
        r = ref[n]
        return (CFG, r["pos"], r["vel"], r["states"], L)

    def get(ndev):
        if ndev not in cache:
            spec = {"seed": 100 + ndev}
            if ndev in (2, 4):
                spec["forces"] = {"main": args(N), "pair": args(N_PAIR)}
                spec["direct"] = (direct_cases, EPS2, KAPPA)
            if ndev == 2:
                spec["forces"]["small"] = args(N_SMALL, L_SMALL)
            cache[ndev] = PM.spawn(W.parallel_scenarios, ndev, spec,
                                   device="cpu", timeout=120)
        return cache[ndev]

    return get


# ---------------- host-side lists (no ranks needed) ----------------

def test_signed_hop_matches_reference_on_a_grid():
    for ndev in range(1, 10):
        s, t = np.meshgrid(np.arange(ndev), np.arange(ndev))
        got = TPS._signed_hop(s, t, ndev)
        assert np.array_equal(got, JPS._signed_hop(s, t, ndev))
        assert got.min() >= -(ndev // 2)
        assert got.max() <= ndev - 1 - ndev // 2
        assert np.array_equal((t + got) % ndev, s)


def _assert_lists_equal(tl, th, jl, jh):
    assert th == jh
    for f in ("p2p_tgt", "p2p_src", "p2p_val"):
        for a, b in zip(getattr(tl, f), getattr(jl, f), strict=True):
            b = np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("m2l_tgt", "m2l_src", "m2l_val", "m2l_gtgt"):
        a, b = getattr(tl, f).numpy(), np.asarray(getattr(jl, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_shard_pair_lists_equal_reference(ref, ndev):
    """hops and every integer and boolean field equal the reference's,
    at the first call and after a second build on moved particles (the
    per-hop capacities never shrink, in both)."""
    r = ref[N]
    jeng = JEngine(JConfig(**CFG), N, use_pallas=True)
    teng = KdFmmEngine(TConfig(**CFG), N)
    pos = r["pos"]
    caps = {}
    for scale in (1.0, 0.7):
        jfs = jeng.build(jnp.asarray(pos * np.float32(scale)))
        tfs = fmm_state_from_numpy(_np_state(jfs), "cpu")
        jl, jh = JPS.shard_pair_lists(jeng, jfs, ndev)
        tl, th = TPS.shard_pair_lists(teng, tfs, ndev)
        _assert_lists_equal(tl, th, jl, jh)
        # the counts of test_hop_grouping_covers_all_pairs
        assert sum(int(v.sum()) for v in tl.p2p_val) == \
            int(np.asarray(jfs.p2p_valid).sum())
        assert int(tl.m2l_val.sum()) == int(np.asarray(jfs.m2l_valid).sum())
        for h, v in zip(th, tl.p2p_val):
            assert v.shape[1] >= caps.get(h, 0)
            caps[h] = v.shape[1]
        assert {h: teng._pshard_caps[h] for h in th} == \
            {h: jeng._pshard_caps[h] for h in jh}


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_local_csr_covers_every_pair_once(ref, ndev):
    """The per-rank CSR over [own | halo] blocks, expanded back to global
    (target sub-leaf, packed source block) pairs, is the engine's P2P list
    as a multiset; halo rows have no entries and the layout is the
    kernel's."""
    jeng, jfs = ref[N]["g8"]
    teng = KdFmmEngine(TConfig(**CFG), N)
    tfs = fmm_state_from_numpy(_np_state(jfs), "cpu")
    lists, hops = TPS.shard_pair_lists(teng, tfs, ndev)
    Gl, Glb = teng.G_sub // ndev, teng.G_blk // ndev
    shift = teng.mask_shift
    pairs = []
    for d in range(ndev):
        halo, row_ptr, col2d = TPS.local_csr(teng, lists, hops, ndev, d)
        rows = Gl * (1 + len(halo))
        assert halo == tuple(h for h in hops if h != 0)
        assert row_ptr.dtype == col2d.dtype == np.int32
        assert row_ptr.shape == (rows + 1,) and col2d.shape[0] == rows
        assert col2d.shape[1] % 128 == 0
        deg = np.diff(row_ptr)
        assert (deg[Gl:] == 0).all() and deg.max() <= col2d.shape[1]
        for t in range(Gl):
            e = col2d[t, :deg[t]].view(np.uint32).astype(np.int64)
            blk, bits = e & ((1 << shift) - 1), e >> shift
            assert (blk < Glb * (1 + len(halo))).all()
            hop = np.asarray((0,) + halo)[blk // Glb]
            gblk = ((d + hop) % ndev) * Glb + blk % Glb
            pairs.append(np.stack([np.full_like(gblk, d * Gl + t),
                                   gblk | (bits << shift)], axis=1))
        # entries past the degree hold the sentinel block id
        past = np.arange(col2d.shape[1])[None, :] >= deg[:, None]
        assert (col2d[past] == Glb * (1 + len(halo))).all()
    got = np.concatenate(pairs)
    v = np.asarray(jfs.p2p_valid)
    want = np.stack([np.asarray(jfs.p2p_tgt)[v].astype(np.int64),
                     np.asarray(jfs.p2p_src)[v].view(np.uint32).astype(
                         np.int64)], axis=1)
    assert got.shape == want.shape
    key = lambda a: a[np.lexsort((a[:, 1], a[:, 0]))]
    assert np.array_equal(key(got), key(want))


def test_make_mesh_raises_without_enough_cuda_devices():
    """The default placement is one CUDA device a rank and never falls
    back: asking for more than there are raises."""
    k = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"only {k} devices visible"):
        PM.make_mesh(k + 1)
    with pytest.raises(RuntimeError, match="devices visible"):
        PM.spawn(W.collectives, k + 1, 0)
    with pytest.raises(ValueError, match="share_device"):
        PM.spawn(W.collectives, 2, 0, device="cuda:0")
    # a mesh of several ranks is made inside its ranks
    with pytest.raises(RuntimeError, match="spawn"):
        PM.make_mesh(2, device="cpu")


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ENV_RANK = """
import numpy as np, torch
from coulomb_oscillators_tpu_torch.parallel import mesh as PM
torch.set_num_threads(1)
m = PM.make_mesh(device="cpu")
x = torch.full((2, 3), float(m.rank + 1), dtype=torch.float64)
assert m.backend == "gloo" and m.device.type == "cpu"
assert float(m.all_reduce_sum(x)[0, 0]) == m.ndev * (m.ndev + 1) / 2
assert m.all_gather(x)[:, 0].tolist() == [r + 1.0 for r in range(m.ndev)
                                          for _ in range(2)]
assert float(m.ring_shift(x, 1)[0, 0]) == (m.rank + 1) % m.ndev + 1
print("mesh", m.ndev, m.rank)
"""


@pytest.mark.parametrize("ndev", [1, 2])
def test_make_mesh_joins_from_the_launcher_environment(ndev):
    """Under a launcher that sets RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT (torchrun), make_mesh initialises the group from the
    environment; the three collectives then run across the processes."""
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(ndev):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ndev),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _ENV_RANK], env=env, cwd=_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=150)
            assert p.returncode == 0, err[-2000:]
            assert out.split()[-3:] == ["mesh", str(ndev), str(r)]
    finally:
        for p in procs:
            p.kill()


def test_make_mesh_alone_is_a_group_of_one():
    """In a lone process with no launcher, make_mesh gives a mesh of one
    rank with a group of its own; a second call joins that group."""
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE")}
    code = _ENV_RANK.replace(
        'print("mesh"', 'assert PM.make_mesh(1, device="cpu").ndev == 1\n'
        'print("mesh"')
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=_ROOT,
                       timeout=150,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split()[-3:] == ["mesh", "1", "0"]


def test_pad_to_multiple_matches_reference():
    pos = _beam(N_DIRECT)[0]
    for m in (1, 2, 4, 7):
        got, n = PM.pad_to_multiple(torch.from_numpy(pos), m)
        want, nj = JPM.pad_to_multiple(jnp.asarray(pos), m)
        assert n == nj == N_DIRECT
        assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------- spawned ranks ----------------

@pytest.mark.parametrize("ndev", [1, 2, 3, 4])
def test_collectives_match_numpy(ranks, ndev):
    """all_gather, all_reduce_sum and ring_shift by +-1, +-2 places: rank
    0's results against numpy here, every rank's against numpy on the
    rank; ring_shift is the identity where k is a multiple of ndev."""
    r = ranks(ndev)["collectives"]
    full = np.random.default_rng(100 + ndev).normal(size=(ndev, 5, 3))
    assert r["ndev"] == ndev and r["backend"] == "gloo"
    assert np.array_equal(r["all_gather"], full.reshape(ndev * 5, 3))
    np.testing.assert_allclose(r["all_reduce_sum"], full.sum(0), rtol=1e-12)
    for k in W.SHIFTS:
        assert np.array_equal(r[f"ring_shift_{k}"], full[k % ndev]), k
    assert r["every_rank_ok"]
    moved = sum(1 for k in W.SHIFTS if k % ndev)
    assert r["calls"].get("ring_shift", 0) == moved
    assert r["bytes"].get("ring_shift", 0) == moved * 5 * 3 * 8


@pytest.mark.parametrize("ndev", [2, 4])
def test_pshard_force_matches_reference_engine(ref, ranks, ndev):
    """PShardedKdFmm.force_padded, gathered and unpadded, against the
    reference's single-device force on the same lists: max|da| / max|a| <
    1e-5 (the reference's own bound for its sharded force, float32 sums in
    another order); against the port's single-device padded force < 2e-6
    (the same operations on leaf runs, the near field summed per hop
    group); each rank holds G / ndev leaf blocks; on CPU ranks the near
    field is the plain version (no kernel launch)."""
    jeng, jfs = ref[N]["g8"]
    r = ranks(ndev)["main"]
    G, C = r["G_C"]
    assert (G, C) == (1 << jeng.L, jeng.st.C)
    assert r["shard_shape"] == (G // ndev, C, 3)
    assert 0 in r["hops"] and r["p2p_launches"] == 0
    want = _jforce(jeng, ref[N]["pos"], jfs)
    assert _rel(r["pshard_force"], want) < 1e-5
    assert _rel(r["pshard_force"], r["single_force"]) < 2e-6


def test_pshard_force_at_the_dry_run_level_matches_reference_engine(ref,
                                                                   ranks):
    """Two ranks at n = 1024 with the dry run's forced level (L = 3, so
    C = 128 and one 512-slot block a rank) against the reference's
    single-device force on the same lists: < 1e-5 of max|a|.  The
    reference's own PShardedKdFmm on its virtual mesh is not run here: its
    shard_map program takes minutes to compile on the CPU at any size (its
    own tests mark it slow); its lists are held integer for integer above
    and its sharded force against this same single-device force in its own
    tests."""
    r = ref[N_SMALL]
    jeng, jfs = r["g8"]
    got = ranks(2)["small"]
    assert got["G_C"] == (1 << L_SMALL, jeng.st.C)
    assert got["hops"] == JPS.shard_pair_lists(jeng, jfs, 2)[1]
    assert _rel(got["pshard_force"], _jforce(jeng, r["pos"], jfs)) < 1e-5
    assert _rel(got["pshard_force"], got["single_force"]) < 2e-6


@pytest.mark.parametrize("ndev", [2, 4])
def test_psharded_step_matches_reference_simulator(ref, ranks, ndev):
    """make_psharded_step, one leapfrog step on the shards, against the
    reference's single-device Simulator(...).run(st, 1):
    max|dpos| / max|pos| < 1e-5 (tests/test_fmm_pshard.py)."""
    pos, vel = ref[N]["pos"], ref[N]["vel"]
    sim = JSim(JConfig(**CFG), N, engine="fmm3_kd")
    st = sim.init_acc(JState(jnp.asarray(pos), jnp.asarray(vel),
                             jnp.zeros((N, 3), jnp.float32)))
    want = np.asarray(sim.run(st, 1).pos)
    got = ranks(ndev)["main"]["step_pos"]
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


@pytest.mark.parametrize("group", ["g8", "g1"])
@pytest.mark.parametrize("ndev", [2, 4])
def test_pair_sharded_force_matches_reference(ref, ranks, ndev, group):
    """make_sharded_force at n = 1200 with the grouped (g = 8) and the
    ungrouped M2L layout against the reference's eng.force on the same
    lists: mean relative error < 1e-6 (tests/test_fmm_shard.py); every
    rank returns the same replicated force."""
    jeng, jfs = ref[N_PAIR][group]
    r = ranks(ndev)["pair"]
    want = jnp.asarray(_jforce(jeng, ref[N_PAIR]["pos"], jfs))
    err = float(j_mre(jnp.asarray(r[f"shard_force_{group}"]), want))
    assert err < 1e-6, err
    assert r[f"shard_force_{group}_equal"]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("scheme", ["ring", "allgather"])
@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_direct_matches_reference(ranks, direct_cases, ndev, scheme,
                                          dim):
    """make_sharded_direct on n = 1001 rows padded to the rank count
    against the reference's plain direct force: < 1e-5 of max|a| (float32
    sums over the sources in another order)."""
    _, pos = direct_cases[f"{scheme}{dim}"]
    want = np.asarray(JD.direct_jnp(jnp.asarray(pos), EPS2, KAPPA))
    got = ranks(ndev)["direct"][f"{scheme}{dim}"]
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-5


TEARDOWN_SPAWNS = 10     # 2-rank spawns, TEARDOWN_AT_ONCE at a time
TEARDOWN_AT_ONCE = 5
TEARDOWN_LIMIT_S = 60.0  # the whole test's own time limit


def test_rank_teardown_frees_the_group_before_exit():
    """Ten spawns of two gloo ranks that end as a -chips run's ranks end
    (a mesh-mode Simulator holding the mesh in a reference cycle, closed,
    then parallel.mesh's teardown), five at a time so that they load the
    host.  Every spawn returns, and no rank reaches its exit with a thread
    of the gloo group alive (the rank ends with code 3 if one is: a group
    freed only as the interpreter finalises aborts the process when its
    worker thread frees a collective's tensor).  The spawns finish within
    TEARDOWN_LIMIT_S, checked by the test itself; past it the ranks still
    running are stopped and their spawns joined before the test fails, so
    that none outlives it."""
    import multiprocessing
    import threading
    import time

    results = []

    def one():
        try:
            results.append(PM.spawn(W.teardown, 2, 5, device="cpu",
                                    timeout=30))
        except Exception as e:          # noqa: BLE001 - reported below
            results.append(e)

    t0 = time.monotonic()
    for _ in range(TEARDOWN_SPAWNS // TEARDOWN_AT_ONCE):
        threads = [threading.Thread(target=one, daemon=True)
                   for _ in range(TEARDOWN_AT_ONCE)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(0.0, TEARDOWN_LIMIT_S - (time.monotonic() - t0)))
        late = any(t.is_alive() for t in threads)
        while any(t.is_alive() for t in threads):
            # the ranks are this process's children: a stopped rank fails
            # its spawn, which returns
            for child in multiprocessing.active_children():
                child.kill()
            for t in threads:
                t.join(1.0)
        assert not late, f"spawns still running after {TEARDOWN_LIMIT_S} s"
    assert results == [True] * TEARDOWN_SPAWNS, results
