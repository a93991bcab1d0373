"""Port vs reference: the CLI's run modes with ``-cpu`` (twins of
tests/test_cli_modes.py), the snapshots it writes against the reference
CLI's, snapshot I/O (twins of tests/test_io_init.py), the 2D beam algebra,
the timing harness, and the refusal to run without a card."""

import os

import numpy as np
import jax
import pytest
import torch

from coulomb_oscillators_tpu import cli as jcli
from coulomb_oscillators_tpu.models import beams as JB
from coulomb_oscillators_tpu.utils import io as JIO
from coulomb_oscillators_tpu_torch import cli
from coulomb_oscillators_tpu_torch.models import beams as TB
from coulomb_oscillators_tpu_torch.utils import io as cio
from coulomb_oscillators_tpu_torch.utils import timing

torch.set_num_threads(1)


def _snapshots(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".bin"))


def test_simulate_snapshot_resume_roundtrip(tmp_path):
    out1 = tmp_path / "o1"
    rc = cli.main(["-n", "256", "-iters", "10", "-steps", "5",
                   "-engine", "direct", "-o", str(out1), "-cpu"])
    assert rc == 0
    snap = out1 / "out10_0.000500.bin"
    assert snap.exists()
    assert (out1 / "args.txt").exists()
    # resume from the snapshot (N inferred from file size, main3.cu:636)
    out2 = tmp_path / "o2"
    rc = cli.main([str(snap), "-iters", "5", "-steps", "5",
                   "-engine", "direct", "-o", str(out2), "-cpu"])
    assert rc == 0
    pos, vel = cio.read_state(str(out2 / "out5_0.000500.bin"), dim=3,
                              dtype=np.float32)
    assert pos.shape == (256, 3) and np.isfinite(pos).all()


@pytest.fixture
def x64_restored():
    """The reference CLI switches JAX to float64 for a CPU 2D run; put the
    process-wide flag back for the tests that follow."""
    before = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.mark.parametrize("dim,tol", [(3, 1e-5), (2, 1e-10)],
                         ids=["3d_f32", "2d_f64"])
def test_snapshots_match_reference_cli(tmp_path, x64_restored, dim, tol):
    """The same arguments to both CLIs: snapshots with equal names and byte
    sizes (3D float32, 2D float64), positions within `tol` of the
    reference's relative to max|pos| (float32 sums in another order; the
    2D CPU run computes in float64 in both)."""
    args = ["-n", "256", "-iters", "10", "-steps", "5", "-engine", "direct",
            "-dim", str(dim)]
    assert cli.main(args + ["-o", str(tmp_path / "t"), "-cpu"]) == 0
    assert jcli.main(args + ["-o", str(tmp_path / "j"), "-cpu"]) == 0
    names = _snapshots(tmp_path / "t")
    assert names == _snapshots(tmp_path / "j") == [
        "out0_0.000500.bin", "out10_0.000500.bin", "out5_0.000500.bin"]
    fdt = np.float32 if dim == 3 else np.float64
    for f in names:
        t, j = tmp_path / "t" / f, tmp_path / "j" / f
        assert os.path.getsize(t) == os.path.getsize(j) == 2 * 256 * dim * \
            np.dtype(fdt).itemsize
        tp, _ = cio.read_state(str(t), dim=dim, dtype=fdt)
        jp, _ = cio.read_state(str(j), dim=dim, dtype=fdt)
        assert np.abs(tp - jp).max() <= tol * np.abs(jp).max()


def test_dim2_default_engine_matches_reference(tmp_path, x64_restored):
    """-dim 2 -cpu with no -engine runs fmm2 in float64 and writes the
    reference's snapshot names and float64 bytes.  The reference CLI's own
    run of these arguments raises (its octree's M2L dynamic_slice mixes
    int32 and int64 indices once the CLI turns jax_enable_x64 on), so the
    positions are held against the reference Simulator("fmm2") in float32
    from the same initial state and cadence: within 1e-5 of max|pos|
    (float32 rounding of the reference)."""
    import jax.numpy as jnp
    from coulomb_oscillators_tpu import ParticleState as JState
    from coulomb_oscillators_tpu import SimConfig as JConfig
    from coulomb_oscillators_tpu.simulate import Simulator as JSim
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID

    n = 300
    args = ["-n", str(n), "-iters", "10", "-steps", "5", "-dim", "2"]
    assert cli.main(args + ["-o", str(tmp_path / "t"), "-cpu"]) == 0
    with pytest.raises(TypeError, match="dynamic_slice"):
        jcli.main(args + ["-o", str(tmp_path / "j"), "-cpu"])
    names = _snapshots(tmp_path / "t")
    assert names == ["out0_0.000500.bin", "out10_0.000500.bin",
                     "out5_0.000500.bin"]
    om = [6.22 * 2 * np.pi, 6.21 * 2 * np.pi]
    beam = TB.matched_beam_2d(om, [0.03e-3, 0.01e-3], 0.8)
    assert cli.default_engine(SimConfig(dim=2, omega0=tuple(om))) == "fmm2"
    jax.config.update("jax_enable_x64", False)
    pos, vel = ID.init_kv(n, beam["A"], beam["omega"], dtype=np.float64)
    js = JSim(JConfig(dim=2, omega0=tuple(om), xi=beam["xi"]), n, "fmm2")
    st = js.init_acc(JState(jnp.asarray(pos, jnp.float32),
                            jnp.asarray(vel, jnp.float32),
                            jnp.zeros((n, 2), jnp.float32)))
    for it, k in ((0, 1), (5, 5), (10, 5)):
        st = js.run(st, k)
        f = tmp_path / "t" / f"out{it}_0.000500.bin"
        assert os.path.getsize(f) == 2 * n * 2 * 8
        tp, _ = cio.read_state(str(f), dim=2, dtype=np.float64)
        jp = np.asarray(st.pos, np.float64)
        assert np.abs(tp - jp).max() <= 1e-5 * np.abs(jp).max()


def test_test_mode_sweeps_orders_dim2(capsys):
    """-test on the 2D default engine (fmm2): ten error rows for orders
    1..10, converging with the order."""
    assert cli.main(["-test", "-dim", "2", "-n", "600", "-cpu"]) == 0
    out = capsys.readouterr().out
    rows = [l for l in out.splitlines() if "Relative error" in l]
    assert len(rows) == 10
    errs = [float(l.split(":")[-1]) for l in rows]
    assert errs[-1] < errs[0] * 0.5, errs
    assert "Average time" in out


@pytest.mark.slow
def test_test_mode_sweeps_orders(capsys):
    """Ten engines up to p=10 (about a minute on one CPU thread); the
    reference's twin is slow-marked too."""
    # -maxlevel forces a real far field at this small N (at auto level the
    # tree has ~4 leaves and every pair is P2P, so all orders tie)
    rc = cli.main(["-test", "-n", "800", "-engine", "fmm3_kd", "-p", "3",
                   "-maxlevel", "4", "-r", "1.5", "-cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    # reference prints one error row per order 1..10 (main3.cu:799-810)
    rows = [l for l in out.splitlines() if "Relative error" in l]
    assert len(rows) == 10
    errs = [float(l.split(":")[-1]) for l in rows]
    assert errs[-1] < errs[0] * 0.5    # converges with order
    assert "Average time" in out


def test_test_mode_direct(capsys):
    rc = cli.main(["-test", "-n", "300", "-engine", "direct", "-cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    rows = [l for l in out.splitlines() if "Relative error" in l]
    assert len(rows) == 1 and float(rows[0].split(":")[-1]) < 1e-5
    assert "Average time" in out


def test_test2_mode_reuse_drift(capsys):
    rc = cli.main(["-test2", "-n", "400", "-engine", "fmm3_kd", "-cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    rows = [l for l in out.splitlines() if "Relative error after" in l]
    # tree_steps + 1 = 9 rows (main3.cu:812-831)
    assert len(rows) == 9
    errs = [float(l.split(":")[-1]) for l in rows]
    assert all(np.isfinite(errs)) and max(errs) < 1.0


def test_accuracy_autotune(tmp_path, capsys):
    rc = cli.main(["-accuracy", "0.05", "-n", "400", "-iters", "1",
                   "-steps", "1", "-engine", "fmm3_kd", "-o",
                   str(tmp_path / "acc"), "-cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Best parameters" in out


def test_cli_needs_a_card_or_cpu(tmp_path, monkeypatch, capsys):
    """Without a CUDA device and without -cpu the CLI exits non-zero, says
    why, and writes nothing; -chips is not ported."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "none"
    rc = cli.main(["-n", "64", "-iters", "1", "-steps", "1",
                   "-engine", "direct", "-o", str(out)])
    assert rc != 0
    assert "-cpu" in capsys.readouterr().err
    assert not out.exists()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["-chips", "2", "-cpu"])


def test_roundtrip_3d_f32_bytes_equal_reference(tmp_path, rng):
    n = 123
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    p, q = tmp_path / "t.bin", tmp_path / "j.bin"
    cio.write_state(str(p), pos, vel)
    JIO.write_state(str(q), pos, vel)
    assert p.read_bytes() == q.read_bytes()
    raw = np.fromfile(p, dtype=np.float32)
    assert raw.size == 2 * n * 3
    np.testing.assert_array_equal(raw[: n * 3].reshape(n, 3), pos)
    rp, rv = cio.read_state(str(p), dim=3, dtype=np.float32)
    np.testing.assert_array_equal(rp, pos)
    np.testing.assert_array_equal(rv, vel)


def test_roundtrip_2d_f64_bytes_equal_reference(tmp_path, rng):
    n = 50
    pos = rng.normal(size=(n, 2))
    vel = rng.normal(size=(n, 2))
    p, q = tmp_path / "t.bin", tmp_path / "j.bin"
    cio.write_state(str(p), pos, vel)
    JIO.write_state(str(q), pos, vel)
    assert p.read_bytes() == q.read_bytes()
    rp, rv = cio.read_state(str(p), dim=2, dtype=np.float64)
    np.testing.assert_array_equal(rp, pos)
    np.testing.assert_array_equal(rv, vel)
    with pytest.raises(ValueError):
        cio.read_state(str(p), dim=3, dtype=np.float64)   # 200 % 6 != 0


def test_snapshot_name_and_args_match_reference(tmp_path):
    assert cio.snapshot_name("out", 200, 5e-4) == JIO.snapshot_name(
        "out", 200, 5e-4)
    assert cio.snapshot_name("out", 200, 5e-4).endswith("out200_0.000500.bin")
    cio.write_args(str(tmp_path), ["nbco3-torch", "-n", 5])
    assert (tmp_path / "args.txt").read_text() == "nbco3-torch -n 5 "


@pytest.mark.parametrize("tune", [0.8, 0.5])
def test_matched_beam_2d_equals_reference(tune):
    om = [6.22 * 2 * np.pi, 6.21 * 2 * np.pi]
    t = TB.matched_beam_2d(om, [0.03e-3, 0.01e-3], tune)
    j = JB.matched_beam_2d(om, [0.03e-3, 0.01e-3], tune)
    assert t.keys() == j.keys()
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])


def test_timing_harness_completes_and_counts():
    calls = []

    def f():
        calls.append(1)
        return torch.ones(3)

    assert timing.test_time(f, min_loop=0.0) > 0.0
    assert len(calls) == 2                    # warm-up + one timed call
    t = timing.test_time_chained(lambda s: (s[0] + 1, s[1]),
                                 (torch.zeros(2), "x"), min_loop=0.0)
    assert t > 0.0
