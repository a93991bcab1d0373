"""The harness: every entry found by its file name, a cell added by files
and entries alone, the frozen work count, the trace's reading, the seeded
inputs, and no measurement without a card."""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import beam as B
from benchmark import harness as H
from benchmark import trace as T
from benchmark import work as W
from benchmark.tests.conftest import REPO, add_tiny_cells, copy_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    return H.load_json(REPO, "BENCHMARK.json")


def test_every_entry_is_found_by_its_file_name():
    bench = _bench()
    assert bench["command"][:3] == ["python3", "-m", "benchmark.run"]
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert H.load_json(REPO, c["file"])["name"] == c["name"]
    used = set()
    for cell in bench["workloads"]:
        assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
        wl = H.load_json(REPO, "benchmark", "workloads",
                         f"{cell['name']}.json")
        assert wl["config"] == cell["config"] in configs
        used.add(cell["config"])
        drv = H.load_module(REPO, "drivers", wl["driver"])
        assert all(callable(getattr(drv, f))
                   for f in ("setup", "window", "collect"))
        for m in H.cell_metrics(bench, cell["name"], False):
            assert m["source"] in ("host_clock", "device_trace")
        assert {m["name"] for m in H.cell_metrics(bench, cell["name"],
                                                  False)} >= {"setup_s"}
        assert H.cell_metrics(bench, cell["name"], True)
    assert used == configs
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(H.load_module(REPO, "metrics", m["name"]).read)
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in bench["per_layer"]:
        assert m["moves"] == "particle_steps_per_s"
        assert set(m["workloads"]) <= {c["name"] for c in bench["workloads"]}
    with pytest.raises(FileNotFoundError):
        H.load_module(REPO, "metrics", "no_such_metric")


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_cell_added_by_files_and_entries_runs(tmp_path):
    root = copy_benchmark(str(tmp_path / "copy"))
    before = _digests(root)
    add_tiny_cells(root)
    with open(os.path.join(root, "benchmark", "metrics",
                           "steps_in_window.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.steps\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "steps_in_window", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "window pipeline",
        "moves": "particle_steps_per_s", "workloads": ["tiny_cli.s"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())
    assert {m["name"] for m in H.cell_metrics(bench, "tiny_cli.s", True)} \
        >= {"steps_in_window", "snapshot_ms"}
    torch.set_num_threads(2)
    out = H.run_cell(root, "tiny_cli.s", 2 ** 31 + 11, 0.3, device="cpu")
    assert out["correct"] and out["failed"] == 0
    # 0.3 s at the traffic's 100 steps a second, in whole blocks of 20
    assert out["diag"]["steps"] == 40
    assert set(out["metrics"]) == {"particle_steps_per_s", "setup_s"}
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"drift_err", "kick_err", "nonfinite",
                                  "snapshot_mismatch"}
    # a 2D configuration of fmm2_kd (KV beam) added the same way
    out = H.run_cell(root, "tiny_kd2.w", 2 ** 31 + 13, 0.3, device="cpu")
    assert out["correct"] and out["failed"] == 0
    assert out["diag"]["steps"] == 8
    assert set(out["checks"]) == {"force_err", "drift_err", "kick_err",
                                  "nonfinite"}


def _brute(row_ptr, col2d, nsub, n, L):
    mult = W.subleaf_counts(n, L)
    gb = (1 << L) // nsub
    pairs = entries = 0
    for t in range(1 << L):
        for k in range(row_ptr[t + 1] - row_ptr[t]):
            entries += 1
            v = int(col2d[t, k]) & 0xFFFFFFFF
            blk = v & ((1 << (32 - nsub)) - 1)
            if blk >= gb:
                continue
            for q in range(nsub):
                if (v >> (32 - nsub + q)) & 1:
                    pairs += int(mult[t]) * int(mult[blk * nsub + q])
    return pairs, entries


def _random_lists(nsub):
    """(row_ptr, col2d, nsub, n, L, slots, dim) of a random CSR."""
    rng = np.random.default_rng(nsub)
    n, L, dmax = 1000, 5, 9
    g = 1 << L
    gb = g // nsub
    deg = rng.integers(0, dmax + 1, g)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col2d = np.zeros((g, dmax), np.uint32)
    for t in range(g):
        for k in range(deg[t]):
            blk = rng.integers(0, gb + 1)          # gb: the sentinel
            mask = rng.integers(1, 1 << nsub)
            col2d[t, k] = blk | (mask << (32 - nsub))
    return row_ptr, col2d.view(np.int32), nsub, n, L, 32, 3


def _fmm2_kd_lists():
    """(row_ptr, col2d, nsub, n, L, slots, dim) of the near lists the
    program's fmm2_kd engine builds for the tiny 2D cell's KV beam, with
    the sub-leaves' particle counts as its pad mask gives them (the real
    slots the dim-2 kernel reads)."""
    from benchmark.tests.conftest import KD2
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine
    n = 2000
    pos, _ = B.kv(n, KD2["beam"]["A"], KD2["beam"]["omega"], 5)
    cfg = SimConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in KD2["sim"].items()})
    eng = KdFmmEngine(cfg, n)
    fs = eng.build(torch.from_numpy(pos))
    real = eng.mask3("cpu").sum(1).numpy()
    np.testing.assert_array_equal(real, W.subleaf_counts(n, eng.L))
    assert eng.nsub > 1 and fs.p2p_col2d.shape[0] == 1 << eng.L
    return (fs.p2p_row_ptr.numpy(), fs.p2p_col2d.numpy(), eng.nsub, n,
            eng.L, eng.st.C, eng.dim)


@pytest.mark.parametrize("nsub", [1, 2, 4, "fmm2_kd"])
def test_work_count_equals_a_brute_count(nsub):
    row_ptr, col2d, nsub, n, L, slots, dim = (
        _fmm2_kd_lists() if nsub == "fmm2_kd" else _random_lists(nsub))
    g = 1 << L
    got = W.p2p_work(torch.from_numpy(row_ptr), torch.from_numpy(col2d),
                     nsub, n, L, slots=slots, dim=dim)
    pairs, entries = _brute(row_ptr, col2d, nsub, n, L)
    assert (got["pairs"], got["entries"]) == (pairs, entries) != (0, 0)
    assert got["bytes"] == 2 * g * slots * dim * 4 + 4 * (entries + g + 1)


def test_subleaf_counts_split_evenly():
    c = W.subleaf_counts(1_000_000, 15)
    assert c.sum() == 1_000_000 and c.max() - c.min() <= 1


def test_bound_is_the_largest_of_flops_rsqrt_and_bytes():
    pairs = 5.92e9
    assert W.bound_ms(pairs, 0) == pytest.approx(
        pairs * 20 / 67e12 * 1e3)
    assert W.bound_ms(1.0, 3.35e9) == pytest.approx(1.0)
    assert W.bound_ms(1e9, 0, dim=2) > 1e9 / W.MUFU_PER_S * 1e3 * 0.99


def test_trace_summary_unions_device_time_and_labels_gaps(monkeypatch):
    ev = [("user_annotation", "bench.window", 0.0, 100.0),
          ("user_annotation", "bench.boundary", 40.0, 30.0),
          ("user_annotation", "bench.replay", 0.0, 40.0),
          ("kernel", "void p2p_kernel<float, true>(...)", 5.0, 10.0),
          ("kernel", "other", 10.0, 20.0),
          ("gpu_memcpy", "Memcpy HtoD", 80.0, 5.0),
          ("kernel", "before the window", -20.0, 10.0),
          ("cuda_runtime", "cudaGraphLaunch", 1.0, 1.0)]
    monkeypatch.setattr(T, "_events", lambda prof: ev)
    s = T.summarize(None)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["p2p_count"] == 1 and s["p2p_ms"] == pytest.approx(0.01)
    assert s["other_ms"] == pytest.approx(0.025)
    assert s["idle_gaps"][0] == ["bench.boundary", pytest.approx(50e-6)]
    assert [g[0] for g in s["idle_gaps"]] == ["bench.boundary", "host.other",
                                             "bench.replay"]
    monkeypatch.setattr(T, "_events", lambda prof: ev[:3])
    with pytest.raises(RuntimeError, match="no kernel"):
        T.summarize(None)


def test_trace_counts_the_dim2_p2p_kernel(monkeypatch):
    """``p2p2d_kernel`` counts as P2P beside ``p2p_kernel``, and nothing
    else does: a 3D trace, which holds no ``p2p2d_kernel``, reads as
    before."""
    ev = [("user_annotation", "bench.window", 0.0, 100.0),
          ("kernel", "void p2p2d_kernel<float>(float const*, int)", 5.0,
           4.0),
          ("kernel", "void p2p2d_kernel<float>(float const*, int)", 20.0,
           6.0),
          ("kernel", "void p2p_kernel<float, true>(...)", 30.0, 10.0),
          ("kernel", "p2p_plan_cumsum", 50.0, 2.0),
          ("gpu_memcpy", "Memcpy HtoD (p2p2d_kernel)", 60.0, 1.0)]
    monkeypatch.setattr(T, "_events", lambda prof: ev)
    s = T.summarize(None)
    assert s["p2p_count"] == 3 and s["p2p_ms"] == pytest.approx(0.02)
    assert s["other_ms"] == pytest.approx(0.003)
    assert s["busy_s"] == pytest.approx(23e-6)


def test_the_trace_has_one_source_of_events():
    """The events come from the profiler's Chrome-trace export alone: its
    complete events are read with their categories, and a profiler that
    cannot export raises; nothing is read from elsewhere."""
    class Exporting:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": [
                    {"ph": "X", "cat": "Kernel", "name": "k", "ts": 5,
                     "dur": 2},
                    {"ph": "i", "cat": "kernel", "name": "mark", "ts": 6},
                    {"ph": "X", "cat": "user_annotation",
                     "name": "bench.window", "ts": 0.5, "dur": 10}]}, f)

    assert T._events(Exporting()) == [
        ("kernel", "k", 5.0, 2.0),
        ("user_annotation", "bench.window", 0.5, 10.0)]

    class Bare:
        pass
    with pytest.raises(AttributeError):
        T._events(Bare())


def test_the_window_is_a_fixed_number_of_steps():
    wl = {"steps_per_s": 10.0}
    assert H.window_steps(51, wl) == 510
    assert H.window_steps(0.01, wl) == 1
    seen = []
    tail = T.Tail(False, 510, 112, lambda: None, lambda: None)
    steps = 0
    while not tail.done(steps):
        tail.tick(steps)
        seen.append(steps)
        steps += 16
    assert steps == 512 and len(seen) == 32
    assert tail.stop() is None


def test_the_seed_reorders_one_draw():
    std = ((0.003, 0.001, 0.01), (0.004, 0.001, 0.01))
    p1, v1 = B.gaussian(5000, *std, 2 ** 31 + 3)
    p1b, v1b = B.gaussian(5000, *std, 2 ** 31 + 3)
    p2, v2 = B.gaussian(5000, *std, -7)
    np.testing.assert_array_equal(p1, p1b)
    np.testing.assert_array_equal(v1, v1b)
    assert not np.array_equal(p1, p2)
    o1, o2 = np.lexsort(p1.T), np.lexsort(p2.T)
    np.testing.assert_array_equal(p1[o1], p2[o2])
    np.testing.assert_array_equal(v1[o1], v2[o2])
    np.testing.assert_allclose(np.sqrt((p1.astype(np.float64) ** 2)
                                       .mean(0)), std[0], rtol=1e-6)
    np.testing.assert_allclose(p1.astype(np.float64).mean(0), 0,
                               atol=1e-9)
    t = B.targets(5000, 100, 9)
    assert len(set(t.tolist())) == 100
    np.testing.assert_array_equal(B.targets(50, 100, 9), np.arange(50))


def test_the_seed_reorders_one_kv_draw():
    A, omega = (0.0018633884990322802, 0.0011320074052916915), (34.56, 31.21)
    p1, v1 = B.kv(5000, A, omega, 2 ** 31 + 3)
    p1b, v1b = B.kv(5000, A, omega, 2 ** 31 + 3)
    p2, v2 = B.kv(5000, A, omega, -7)
    assert p1.shape == v1.shape == (5000, 2) and p1.dtype == np.float32
    np.testing.assert_array_equal(p1, p1b)
    np.testing.assert_array_equal(v1, v1b)
    assert not np.array_equal(p1, p2)
    o1, o2 = np.lexsort(p1.T), np.lexsort(p2.T)
    np.testing.assert_array_equal(p1[o1], p2[o2])
    np.testing.assert_array_equal(v1[o1], v2[o2])
    for a, rms in ((p1, np.array(A) / 2),
                   (v1, np.array(omega) * np.array(A) / 2)):
        a = a.astype(np.float64)
        np.testing.assert_allclose(np.sqrt((a ** 2).mean(0)), rms,
                                   rtol=1e-6)
        np.testing.assert_allclose(a.mean(0), 0, atol=1e-9)
    # a KV beam fills its ellipse, (x / A_x)^2 + (y / A_y)^2 <= 1, up to
    # the few per cent of the exact rms rescale (a Gaussian of the same
    # rms reaches 4 and more)
    x = p1.astype(np.float64) / np.array(A)
    assert 0.9 < (x ** 2).sum(1).max() <= 1.1
    # its own stream: not the Gaussian's draw
    g, _ = B.gaussian(5000, np.array(A) / 2, (1.0, 1.0), 2 ** 31 + 3)
    assert not np.array_equal(np.lexsort(g.T), o1)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    base = set(H.forbidden_modules())
    me = sys.modules[__name__]
    monkeypatch.setitem(sys.modules, "coulomb_oscillators_tpu_torch.fake", me)
    monkeypatch.setitem(sys.modules, "jaxlibrary", me)
    assert set(H.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "coulomb_oscillators_tpu.fake", me)
    monkeypatch.setitem(sys.modules, "jaxlib", me)
    assert set(H.forbidden_modules()) == base | {"coulomb_oscillators_tpu",
                                                 "jaxlib"}


def test_no_card_no_measurement():
    """Without a card the run exits non-zero and prints no result (on a
    machine with one this checks nothing)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure it")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "kd3_cli_30k.snap200", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert not any(line.startswith("{") for line in res.stdout.splitlines())
    assert "CUDA device" in res.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """The CLI cell for two seconds on the card: a result line, correct,
    on the GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "kd3_cli_30k.snap200", "--seed", "3", "--seconds", "2",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"


def test_calibration_refuses_without_a_card(monkeypatch, capsys):
    """The readings behind the limits are taken on the card or not at
    all."""
    from benchmark import calibrate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert calibrate.main(["--workload", "kd3_cli_30k.snap200",
                           "--seeds", "1"]) != 0
    assert "card" in capsys.readouterr().err
