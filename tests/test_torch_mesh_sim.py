"""Port vs reference: the Simulator's mesh mode, the CLI's ``-chips`` and
the multi-device dry run.

The port's ranks are gloo processes on the CPU (one spawn per rank count;
the rank side is tests/torch_parallel_workers.py).  Trajectories are held
against the reference's SINGLE-device Simulator with the same config, as
the reference's own mesh tests do (tests/test_fmm_pshard.py): the same
numpy beam goes to both.
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
from coulomb_oscillators_tpu.parallel import mesh as JPM
from coulomb_oscillators_tpu.simulate import Simulator as JSim
from coulomb_oscillators_tpu_torch import cli
from coulomb_oscillators_tpu_torch.parallel import mesh as PM
from coulomb_oscillators_tpu_torch.scripts import graft_entry
from coulomb_oscillators_tpu_torch.utils import io as cio

torch.set_num_threads(1)

N = 2048
X_STD = (0.003, 0.001, 0.01)
CFG = dict(fmm_order=3, tree_radius=2.0)
# name: (config, steps): one sync boundary; two async boundaries (a
# priming refresh, then an adopted background rebuild), also with the
# resort/pipeline cadence 2/2, which mesh mode ignores as the reference's
# does
RUNS = {"sync": (dict(CFG, tree_steps=4, tree_async=False), 6),
        "async": (dict(CFG, tree_steps=3, tree_async=True), 8),
        "async_resort2": (dict(CFG, tree_steps=3, tree_async=True,
                               tree_resort_every=2, tree_pipeline=2), 8)}


@pytest.fixture(scope="module")
def beam():
    u = tuple(w * x for w, x in zip(JConfig().omega0, X_STD))
    return ID.init_gaussian(N, X_STD, u)


@pytest.fixture(scope="module")
def reference(beam):
    """The reference's single-device trajectories of RUNS."""
    pos, vel = beam
    out = {}
    for name, (kw, steps) in RUNS.items():
        sim = JSim(JConfig(**kw), N, engine="fmm3_kd")
        st = sim.init_acc(JState(jnp.asarray(pos), jnp.asarray(vel),
                                 jnp.zeros((N, 3), jnp.float32)))
        out[name] = np.asarray(sim.run(st, steps).pos)
    return out


@pytest.fixture(scope="module")
def ranks(beam):
    cache = {}

    def get(ndev):
        if ndev not in cache:
            cache[ndev] = PM.spawn(W.mesh_simulator, ndev, RUNS, *beam,
                                   device="cpu", timeout=120)
        return cache[ndev]

    return get


@pytest.mark.parametrize("mode", sorted(RUNS))
@pytest.mark.parametrize("ndev", [2, 4])
def test_mesh_trajectory_matches_reference(reference, ranks, ndev, mode):
    """max|dpos| / max|pos| < 1e-4 against the reference's single-device
    Simulator (its own bound for its mesh mode: the sharded window has no
    geometry refresh, the single-device one has); every rank returned the
    same state and adopted the same integer lists; the state really is
    distributed.  Mesh mode adopts a re-sort at every boundary whatever
    the resort/pipeline cadence: "async_resort2" runs "async"'s rebuilds
    and ends at its positions, bit for bit."""
    r = ranks(ndev)[mode]
    want = reference[mode]
    assert np.abs(r["pos"] - want).max() / np.abs(want).max() < 1e-4
    assert np.isfinite(r["vel"]).all()
    assert r["states_equal"] and r["lists_equal"]
    G, C = r["G_C"]
    assert r["shard_shape"] == (G // ndev, C, 3)
    assert r["rebuilds"] == ({"sync_full": 1} if mode == "sync" else
                             {"sync_refresh": 1, "adopt_full": 1})
    if mode == "async_resort2":
        assert np.array_equal(r["pos"], ranks(ndev)["async"]["pos"])


def test_mesh_mode_needs_a_kd_engine(ranks):
    """Simulator("fmm3", mesh=...) raises the reference's ValueError."""
    with pytest.raises(ValueError) as e:
        JSim(JConfig(), N, engine="fmm3", mesh=JPM.make_mesh(2))
    assert ranks(2)["fmm3_error"] == str(e.value)


def test_cli_chips_flag(tmp_path, beam):
    """-chips 2 with CPU ranks runs the particle-sharded simulator end to
    end (tests/test_fmm_pshard.py:176-183): rank 0 alone writes args.txt
    and the reference's snapshot names; the files have the single-process
    run's sizes and agree with it to 1e-4 of max|pos|."""
    args = ["-cpu", "-n", "1024", "-iters", "8", "-steps", "4",
            "-engine", "fmm3_kd"]
    one, two = tmp_path / "one", tmp_path / "two"
    assert cli.main(args + ["-o", str(one)]) == 0
    assert cli.main(args + ["-chips", "2", "-o", str(two)]) == 0
    names = sorted(os.listdir(one))
    assert names == sorted(os.listdir(two))
    assert "out8_0.000500.bin" in names and "args.txt" in names
    assert "-chips 2" in (two / "args.txt").read_text()
    for f in names:
        if not f.endswith(".bin"):
            continue
        assert os.path.getsize(one / f) == os.path.getsize(two / f) \
            == 2 * 1024 * 3 * 4
        p1, v1 = cio.read_state(str(one / f), dim=3, dtype=np.float32)
        p2, v2 = cio.read_state(str(two / f), dim=3, dtype=np.float32)
        assert np.abs(p2 - p1).max() / np.abs(p1).max() <= 1e-4
        assert np.isfinite(v2).all()


def test_cli_chips_beyond_the_visible_devices(tmp_path, capsys):
    """More ranks than CUDA devices, without -cpu: the reference's message
    and -1; nothing is written."""
    k = torch.cuda.device_count()
    out = tmp_path / "none"
    rc = cli.main(["-n", "64", "-chips", str(k + 9), "-engine", "fmm3_kd",
                   "-o", str(out)])
    assert rc == -1
    assert f"-chips {k + 9}: only {k} devices visible" in \
        capsys.readouterr().out
    assert not out.exists()


ACC_ARGS = ["-n", "1024", "-iters", "8", "-steps", "4", "-engine",
            "fmm3_kd", "-accuracy", "0.05"]


def _stub_autotune(calls, fail=False):
    """A stand-in for the CLI's timed (p, r) search: records the process
    that called it and returns one fixed candidate (or the failure), so
    timing noise cannot pick another (p, r)."""
    def tune(config, n, pos, engine, bound):
        calls.append((os.getpid(), config.accuracy, bound))
        if fail:
            return None, None
        return config.replace(fmm_order=4, tree_radius=2.0, coll=True), 0.01
    return tune


def _snapshots(path):
    return {f: cio.read_state(str(path / f), dim=3, dtype=np.float32)
            for f in sorted(os.listdir(path)) if f.endswith(".bin")}


def _agree(got, want):
    """The same snapshot names and sizes, positions within 1e-4 of
    max|pos| (test_cli_chips_flag's bound), finite velocities."""
    assert sorted(got) == sorted(want) and "out8_0.000500.bin" in got
    for f, (p1, _) in want.items():
        p2, v2 = got[f]
        assert p2.shape == p1.shape == (1024, 3)
        assert np.abs(p2 - p1).max() / np.abs(p1).max() <= 1e-4
        assert np.isfinite(v2).all()


def _port_run(monkeypatch, out, extra):
    """The port's -cpu -accuracy 0.05 run with the stubbed search:
    (snapshots, the search's calls)."""
    calls = []
    monkeypatch.setattr(cli, "autotune", _stub_autotune(calls))
    assert cli.main(["-cpu"] + ACC_ARGS + extra + ["-o", str(out)]) == 0
    return _snapshots(out), calls


def test_cli_chips_accuracy(tmp_path, monkeypatch, capfd):
    """-accuracy with -chips 2 on CPU ranks: one search, made in this
    process before the ranks start; every rank runs its choice (the
    snapshots equal the single-device -accuracy run's, which ran the same
    candidate), and no rank searches again (rank 0 would print the real
    search's progress line)."""
    one, calls1 = _port_run(monkeypatch, tmp_path / "one", [])
    capfd.readouterr()
    two, calls2 = _port_run(monkeypatch, tmp_path / "two", ["-chips", "2"])
    assert calls1 == calls2 == [(os.getpid(), 0.05, 0.05)]
    assert "-accuracy 0.05 -chips 2" in (tmp_path / "two" / "args.txt"
                                         ).read_text()
    _agree(two, one)
    out = capfd.readouterr().out
    assert "0 4 8" in out                    # rank 0's output is read here
    assert "Parameter optimization" not in out


def test_cli_chips_accuracy_hands_every_tuned_value(monkeypatch):
    """The ranks receive (p, r), the bound and the near field of the one
    tune, and a mark that tells them not to tune."""
    monkeypatch.setattr(cli, "autotune", _stub_autotune([]))
    args = cli.build_parser().parse_args(
        ["-cpu", "-p", "1", "-r", "1.11", "-ncoll"] + ACC_ARGS)
    assert cli._tune_for_ranks(args)
    assert (args.fmm_order, args.tree_radius, args.ncoll, args.accuracy,
            args.tuned) == (4, 2.0, False, 0.05, True)


def test_cli_chips_accuracy_matches_the_reference(tmp_path, monkeypatch):
    """The reference CLI's -chips 2 -accuracy 0.05 run on the virtual CPU
    devices (tests/test_fmm_pshard.py:176-183), its search stubbed to the
    same candidate: the port's -chips 2 snapshots agree with it to 1e-4
    of max|pos|."""
    from coulomb_oscillators_tpu import cli as jcli
    calls = []
    monkeypatch.setattr(jcli, "autotune", _stub_autotune(calls))
    ref = tmp_path / "ref"
    assert jcli.main(ACC_ARGS + ["-chips", "2", "-o", str(ref)]) == 0
    assert len(calls) == 1
    two, _ = _port_run(monkeypatch, tmp_path / "two", ["-chips", "2"])
    _agree(two, _snapshots(ref))


def test_cli_chips_accuracy_failed(tmp_path, monkeypatch, capsys):
    """No candidate meets the bound: the single-device path's message and
    -1; no rank starts and nothing is written."""
    from coulomb_oscillators_tpu_torch.parallel import mesh as PM

    def no_spawn(*a, **k):
        raise AssertionError("a rank started")

    calls = []
    monkeypatch.setattr(cli, "autotune", _stub_autotune(calls, fail=True))
    monkeypatch.setattr(PM, "spawn", no_spawn)
    out = tmp_path / "none"
    assert cli.main(["-cpu", "-chips", "2"] + ACC_ARGS + ["-o", str(out)]) \
        == -1
    assert "Optimization failed!" in capsys.readouterr().out
    assert len(calls) == 1 and not out.exists()


def test_dryrun_multichip():
    """The five checks of the reference's dry run on two CPU ranks; the
    default placement is one CUDA device a rank and raises without them."""
    graft_entry.dryrun_multichip(2, device="cpu")
    k = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"only {k} devices visible"):
        graft_entry.dryrun_multichip(k + 1)


def test_entry_returns_a_step():
    fn, args = graft_entry.entry("cpu")
    out = fn(*args)
    assert len(out) == 3
    for x, y in zip(out, args):
        assert x.shape == y.shape == (4096, 3)
        assert bool(torch.isfinite(x).all())
    assert not torch.equal(out[0], args[0])
