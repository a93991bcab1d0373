"""Port vs reference: the far-field study twins ``scripts/{m2l_window_stats,
m2l_micro,m2l_micro2,l2p_micro}.py`` of the port.

* The window statistics are integers and ratios of integers: the twin's
  lines equal the reference script's exactly, and so does m2l_micro2's
  window line at p=3 (both reference scripts run as subprocesses on the
  CPU, started together when the module starts, so that they run beside
  its in-process work; they write nothing here).
* Every float32 M2L variant runs on the REFERENCE engine's stored-mode
  state (its ``_stage_multipoles`` heap, its lists and stored fold,
  converted with ``fmm_state_from_numpy``) and is held against its
  identity, built in numpy float64 from that state and from the
  reference's stored-mode ``_stage_m2l``: max |dev| / max |ref| <= 1e-5
  (``MM.TOL``; float32 sums in another order).  ``winchunk_bf`` is
  bfloat16 by design: reported and labelled, not bounded.
* Each L2P stage against the reference operator on the same
  ``default_rng(0)`` inputs at a small G and C.
* The stored mode is set only around an engine's construction.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu.ops.fmm.kdtree import KdFmmEngine as JEngine
from coulomb_oscillators_tpu.ops.fmm.kdtree import _heap_off
from coulomb_oscillators_tpu.ops.multipole import harmonics as jhm
from coulomb_oscillators_tpu.ops.multipole import operators as jmop
from coulomb_oscillators_tpu.ops.multipole.tables import (
    build_tables as jbuild_tables)
from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (
    KdFmmEngine, fmm_state_from_numpy)
from coulomb_oscillators_tpu_torch.ops.multipole.tables import build_tables
from coulomb_oscillators_tpu_torch.scripts import _common as C
from coulomb_oscillators_tpu_torch.scripts import l2p_micro as LM
from coulomb_oscillators_tpu_torch.scripts import m2l_micro as MM
from coulomb_oscillators_tpu_torch.scripts import m2l_micro2 as MM2
from coulomb_oscillators_tpu_torch.scripts import m2l_window_stats as WS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16384
R = {3: 1.43, 6: 1.67}            # m2l_micro2's default r, the bench's r
CHUNK = 2048                      # m2l_micro2's default chunk
MICRO = ["full", "plain", "gather", "gather64", "gather128", "gathersrt",
         "compute", "segsum", "grouped8", "grouped16", "grouped32"]
MICRO2 = ["full", "winchunk", "winchunk_bf", "srcbcast8", "srcbcast16"]
L2P_STAGES = ["monomials", "expand+W", "final einsum", "final batchmatmul",
              "l2p_field_blocked", "l2l (G nodes)"]
# L2P stages: float32 contractions in another order, against max |ref|
L2P_TOL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


class _Script:
    """A reference script running in the background on the CPU, its
    output read on demand."""

    def __init__(self, tmp, name, *argv):
        env = dict(os.environ, JAX_PLATFORMS="cpu", CO_M2L_FLY="0",
                   CO_JAX_CACHE_DIR=str(tmp / "jax_cache"))
        env.pop("PYTHONPATH", None)
        self.err = open(tmp / f"{name}.err", "w+")
        self.proc = subprocess.Popen(
            [sys.executable, f"scripts/{name}.py", *argv], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=self.err, text=True)

    def stderr(self) -> str:
        self.err.seek(0)
        return self.err.read()[-3000:]

    def lines(self) -> list:
        """Every line, once the script has ended (rc 0)."""
        out, _ = self.proc.communicate(timeout=300)
        assert self.proc.returncode == 0, self.stderr()
        return out.strip().splitlines()

    def first(self, prefix: str) -> str:
        """The first line that starts with `prefix`; the script is then
        stopped."""
        for line in self.proc.stdout:
            if line.startswith(prefix):
                self.stop()
                return line.strip()
        raise AssertionError(f"no line {prefix!r}: {self.stderr()}")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.proc.stdout.close()
        self.err.close()


@pytest.fixture(scope="module", autouse=True)
def reference_scripts(tmp_path_factory):
    """The reference's m2l_window_stats.py (to its end) and m2l_micro2.py
    (up to its window line, ~9 s here: it then goes on timing, and is
    stopped) at N=16384, p=3, r=1.43, chunk 2048, started together when
    the module starts."""
    tmp = tmp_path_factory.mktemp("reference_scripts")
    runs = {"window_stats": _Script(tmp, "m2l_window_stats", str(N), "3",
                                    "1.43"),
            "micro2": _Script(tmp, "m2l_micro2", str(N), "3", "1.43",
                              str(CHUNK))}
    yield runs
    for run in runs.values():
        run.stop()


def test_window_stats_skips_a_chunk_with_no_full_chunk(capsys):
    """At N=4096 (1,706 valid entries) every chunk size above K gets a
    skipped row where the reference raises; the rest are rows."""
    out = WS.stats(4096, 3, 1.43, "cpu")
    K = out["config"]["K"]
    assert K < 2048
    skipped = [r for r in out["rows"] if r.get("skipped")]
    assert [(r["order"], r["chunk"]) for r in skipped] == \
        [("target-sorted", c) for c in (2048, 4096, 8192)] + \
        [("source-sorted", c) for c in (2048, 8192)]
    assert sum("skipped (K < chunk)" in s for s in out["lines"]) == 5
    assert "skipped" in capsys.readouterr().out


def _reference_heap(jeng, jfs, ppad):
    """The reference's multipole heap: its P2M at the leaves, then its
    ``mop.m2m`` level by level as ``m2m_up`` applies it.  ``m2m_up`` under
    one jit traces the unrolled operator once a level (~13 s at p=6 on the
    CPU); here the operator is compiled once, at the leaf level's width,
    and each level's rows are zero-padded to it (~2 s)."""
    L, t = jeng.L, jeng.tables
    G, leaf0 = 1 << L, _heap_off(L)
    ml = jax.jit(jeng.p2m_blocks)(ppad, jeng.mask3,
                                  jfs.center[leaf0:leaf0 + G],
                                  jfs.lam[leaf0:leaf0 + G])
    m2m = jax.jit(lambda M, s, rho: jmop.m2m(t, M, s, rho))
    center, lam = np.asarray(jfs.center), np.asarray(jfs.lam)
    mpoles = [None] * L + [np.asarray(ml)]
    for l in range(L - 1, -1, -1):
        m, oc, op = 1 << l, _heap_off(l + 1), _heap_off(l)
        pc = np.repeat(center[op:op + m], 2, axis=0)
        pl = np.repeat(lam[op:op + m], 2, axis=0)
        s = np.zeros((G, center.shape[1]), np.float32)
        rho = np.ones(G, np.float32)
        M = np.zeros((G, t.S_M), np.float32)
        s[:2 * m] = (center[oc:oc + 2 * m] - pc) / pl[:, None]
        rho[:2 * m] = lam[oc:oc + 2 * m] / pl
        M[:2 * m] = mpoles[l + 1]
        shifted = np.asarray(m2m(M, s, rho))[:2 * m]
        mpoles[l] = shifted.reshape(m, 2, -1).sum(axis=1)
    return jnp.asarray(np.concatenate(mpoles, axis=0))


def _reference_state(p):
    """The reference engine in stored mode on the beam (use_pallas=True:
    the port's one layout): its state as host arrays, its multipole heap
    (at p=3 also held to ``_stage_multipoles``'s own, 1e-6) and its
    stored-mode M2L stage.  The build's stored fold runs op by op
    (``jax.disable_jit``): compiling its unrolled harmonics takes ~8 s at
    p=6 on the CPU.  Both packages' stages read this one fold."""
    n, r = N, R[p]
    pos, _ = C.beam(n)
    with C.m2l_env(False):
        jeng = JEngine(JConfig(fmm_order=p, tree_radius=r), n,
                       use_pallas=True)
    assert jeng.m2l_fly is False
    geo = jeng._m2l_geo_jit

    def eager_geo(*a):
        with jax.disable_jit():
            return geo(*a)
    jeng._m2l_geo_jit = eager_geo
    x = jnp.asarray(pos)
    jfs = jeng.build(x)
    ppad = jeng._pad_jit(x, jfs)
    mh = _reference_heap(jeng, jfs, ppad)
    if p == 3:
        stage = jax.jit(lambda pp, m3, s: jeng._stage_multipoles(pp, m3, s))(
            ppad, jeng.mask3, jfs)
        assert _rel(mh, stage) <= 1e-6
    full = jax.jit(lambda h, s: jeng._stage_m2l(h, s))(mh, jfs)
    state = {f: np.asarray(getattr(jfs, f)) for f in jfs._fields}
    return state, np.asarray(mh), np.asarray(full), jeng.L


def _identities(state, mh, full, L, t):
    """Each identity in numpy float64 from the reference's arrays."""
    Mheap = _heap_off(L + 1)
    h = mh.astype(np.float64)
    src, tgt, val = state["m2l_src"], state["m2l_tgt"], state["m2l_valid"]
    m = min(t.S_M, t.S_Lt)
    La = np.zeros((len(src), t.S_Lt))
    La[:, :m] = h[src, :m]
    La = (La * state["m2l_w"][:, None]
          + state["m2l_h2"][:, :t.S_Lt]) * val[:, None]
    seg = np.zeros((Mheap + 1, t.S_Lt))
    np.add.at(seg, np.where(val, tgt, Mheap), La)
    f64 = full.astype(np.float64)
    return {"full": f64, "full_sum": f64.sum(axis=0),
            "gather": np.bincount(src, minlength=Mheap) @ h,
            "segsum": seg[:Mheap]}


def _window_line(state, L, chunk):
    """The reference script's window line by its own arithmetic
    (scripts/m2l_micro2.py:81-104) in numpy from the reference's lists:
    held to the script's printed line at p=3, and the expected line at
    p=6, where the script takes ~31 s here before it prints the line (its
    p=6 compiles), beyond this file's budget."""
    Mheap = _heap_off(L + 1)
    val = state["m2l_valid"].astype(bool)
    tgt_v = state["m2l_tgt"][val].astype(np.int64)
    src_v = state["m2l_src"][val].astype(np.int64)
    K = len(src_v)
    sv = src_v[np.lexsort((tgt_v, src_v))]
    Kp = -(-K // chunk) * chunk
    nch = Kp // chunk
    s2 = np.zeros(Kp, np.int64)
    s2[:K] = sv
    s2[K:] = s2[K - 1]
    slo = s2.reshape(nch, chunk).min(axis=1)
    win = int((s2.reshape(nch, chunk).max(axis=1) - slo + 1).max())
    assert Mheap > win
    return (f"K={K} chunk={chunk} nch={nch} max-window={win} "
            f"Ws={-(-win // 128) * 128}")


@pytest.fixture(scope="module", params=[6, 3], ids=["p6", "p3"])
def studied(request):
    """Both M2L twins' variants evaluated once on the reference's state,
    with the identities and the window line from that state (p=6 first,
    so that the reference script's p=3 window line is printed by the time
    the p=3 test reads it)."""
    p = request.param
    state, mh, full, L = _reference_state(p)
    with C.m2l_env(False):
        eng = KdFmmEngine(SimConfig(fmm_order=p, tree_radius=R[p]), N)
    assert eng.L == L
    fs = fmm_state_from_numpy(state, "cpu")
    hm = torch.from_numpy(mh.copy())
    got = {k: v.fn().numpy() for k, v in MM.variants(eng, fs, hm).items()}
    w, named2 = MM2.variants(eng, fs, hm, CHUNK)
    got2 = {k: got[k] if k == "full" else v.fn().numpy()
            for k, v in named2.items()}
    return {"p": p, "got": got, "got2": got2, "named2": named2,
            "line": MM2.window_line(w), "want_line": _window_line(
                state, L, CHUNK),
            "refs": _identities(state, mh, full, L, eng.tables)}


MICRO_IDENTITY = {"full": "full", "plain": "full", "gather": "gather",
                  "gather64": "gather", "gather128": "gather",
                  "gathersrt": "gather", "compute": "full_sum",
                  "segsum": "segsum", "grouped8": "full", "grouped16": "full",
                  "grouped32": "full"}


@pytest.mark.parametrize("name", MICRO)
def test_m2l_micro_variant_holds_its_identity(studied, name):
    """Each m2l_micro variant (full and plain against the reference's
    stored-mode stage, gather* against the gathered rows' sum, compute
    against the stage's sum over targets, segsum against its value in
    float64, grouped* against the stage) within 1e-5 of max |ref|, at p=3
    and p=6 (segsum and grouped* run at p=3, where S_M < S_Lt)."""
    ref = studied["refs"][MICRO_IDENTITY[name]]
    got = studied["got"][name]
    assert got.shape == ref.shape and got.dtype == np.float32
    assert _rel(got, ref) <= MM.TOL


@pytest.mark.parametrize("name", ["full", "winchunk", "srcbcast8",
                                  "srcbcast16"])
def test_m2l_micro2_variant_holds_its_identity(studied, name):
    """winchunk against the reference's stage, srcbcast* against its sum
    over targets: within 1e-5 of max |ref|."""
    ref = studied["refs"]["full_sum" if name.startswith("srcbcast")
                          else "full"]
    got = studied["got2"][name]
    assert got.shape == ref.shape and got.dtype == np.float32
    assert _rel(got, ref) <= MM.TOL


def test_m2l_micro2_bfloat16_row_is_labelled(studied):
    """winchunk_bf is the one bfloat16 variant: labelled so, finite, of
    the stage's shape; its deviation is reported, not bounded."""
    v = studied["named2"]["winchunk_bf"]
    assert v.info["dtype"] == "bfloat16"
    assert [k for k, x in studied["named2"].items()
            if x.info.get("dtype")] == ["winchunk_bf"]
    got = studied["got2"]["winchunk_bf"]
    assert got.shape == studied["refs"]["full"].shape
    assert np.isfinite(got).all()


def test_m2l_micro2_window_line_equals_reference(studied,
                                                  reference_scripts):
    """K, chunk, nch, the largest window and Ws: at p=3 (r=1.43) the
    reference script's printed line, at p=6 (r=1.67) the line from the
    reference's lists by that script's arithmetic (``_window_line``, held
    to the script at p=3)."""
    if studied["p"] == 3:
        printed = reference_scripts["micro2"].first("K=")
        assert studied["want_line"] == printed
    assert studied["line"] == studied["want_line"]


@pytest.fixture(scope="module")
def l2p_case():
    """Both packages' stages at p=5 (the reference's default) on the
    reference's inputs at G=64, C=16."""
    p, G, c = 5, 64, 16
    t = build_tables(3, p)
    x = LM.inputs(t.S_Lt, G, c)
    st = LM.stages(t, {k: torch.from_numpy(v) for k, v in x.items()})
    jt = jbuild_tables(3, p)
    w, Lt, lam, s, rho = (jnp.asarray(x[k]) for k in
                          ("w", "Lt", "lam", "s", "rho"))
    V = jhm.eval_monomials(w.reshape(G * c, 3), jt.PL, 3).reshape(G, c, -1)
    D = jnp.asarray(jt.l2p_D)
    W = jnp.einsum("akj,gj->gak", D, jmop.expand_L(jt, Lt),
                   precision=jmop.PREC)
    F = -jnp.einsum("gck,gak->gca", V, W, precision=jmop.PREC)
    want = {"monomials": V, "expand+W": W, "final einsum": F,
            "final batchmatmul": F,
            "l2p_field_blocked": jmop.l2p_field_blocked(jt, Lt, w, lam),
            "l2l (G nodes)": jmop.l2l(jt, Lt, s, rho)}
    return st, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("name", L2P_STAGES)
def test_l2p_micro_stage_matches_reference(l2p_case, name):
    """Each stage within 1e-5 of max |ref| of the reference operator on
    the same inputs (the batched product against the reference's
    einsum)."""
    st, want = l2p_case
    assert list(st) == L2P_STAGES
    got = st[name][0]().numpy()
    assert got.shape == want[name].shape
    assert _rel(got, want[name]) <= L2P_TOL


def test_l2p_inputs_are_the_references_draws():
    """The seeded inputs in the reference's draw order and dtypes."""
    rng = np.random.default_rng(0)
    x = LM.inputs(16, 8, 4)
    np.testing.assert_array_equal(
        x["w"], rng.normal(size=(8, 4, 3)).astype(np.float32) * 0.3)
    np.testing.assert_array_equal(
        x["Lt"], rng.normal(size=(8, 16)).astype(np.float32))
    np.testing.assert_array_equal(
        x["lam"], np.abs(rng.normal(size=(8,)).astype(np.float32)) + 0.5)
    np.testing.assert_array_equal(
        x["s"], rng.normal(size=(8, 3)).astype(np.float32) * 0.1)
    assert all(v.dtype == np.float32 for v in x.values())


@pytest.mark.parametrize("saved", [None, "1"], ids=["unset", "set"])
def test_stored_mode_only_around_the_engine(monkeypatch, saved):
    """A study's engine is in stored mode; afterwards CO_M2L_FLY is as it
    was and a new engine is in fly mode."""
    if saved is None:
        monkeypatch.delenv("CO_M2L_FLY", raising=False)
    else:
        monkeypatch.setenv("CO_M2L_FLY", saved)
    eng, fs, _ = MM.stored_engine(2048, 3, 1.43, "cpu")
    assert eng.m2l_fly is False
    assert fs.m2l_h2.shape == (fs.m2l_tgt.shape[0], eng.tables.S_H)
    assert os.environ.get("CO_M2L_FLY") == saved
    assert KdFmmEngine(SimConfig(), 2048).m2l_fly is True


@pytest.mark.parametrize("mod, argv, names", [
    (MM, ["2048", "3", "1.43"], MICRO),
    (MM2, ["2048", "3", "1.43", "512"], MICRO2),
    (LM, ["3"], L2P_STAGES),
    (WS, ["2048", "3", "1.43"], None)],
    ids=["m2l_micro", "m2l_micro2", "l2p_micro", "m2l_window_stats"])
def test_main_prints_and_writes_its_rows(monkeypatch, tmp_path, capsys, mod,
                                         argv, names):
    """--device cpu runs; the @@ line and --out hold the same result, the
    device named as the host, the rows in the reference's order, host
    times only."""
    import json
    if mod is LM:
        monkeypatch.setattr(LM, "LEAVES", 64)
        monkeypatch.setattr(LM, "C_LEAF", 16)
    out = tmp_path / "rows.json"
    extra = [] if mod is WS else ["--reps", "1"]
    assert mod.main(argv + extra + ["--device", "cpu", "--out",
                                    str(out)]) == 0
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("@@ ")][-1]
    printed = json.loads(line[3:])
    assert printed == json.loads(out.read_text())
    assert printed["device"]["device"] == "cpu"
    if names is not None:
        assert [r["name"] for r in printed["rows"]] == names
        assert all("host_ms" in r and "event_ms" not in r
                   for r in printed["rows"])


def test_a_miss_raises(monkeypatch):
    """With a bound no float32 sum in another order meets, the study
    raises after printing its rows."""
    monkeypatch.setattr(MM, "TOL", -1.0)
    with pytest.raises(RuntimeError, match="off their identity"):
        MM.study(2048, 3, 1.43, "cpu", reps=1)


def test_pad_runs_pads_each_run_then_the_whole():
    """Runs of 3, 1 and 2 equal keys padded to pairs (4 + 2 + 2 slots),
    the whole to chunks of 5: each key's slot, each pair's key, `fill`
    for the all-pad pair."""
    slot, gkey, K2, K2p = MM.pad_runs(np.array([2, 2, 2, 5, 7, 7]), 2, 5,
                                      -1)
    assert slot.tolist() == [0, 1, 2, 4, 6, 7]
    assert gkey.tolist() == [2, 2, 5, 7, -1]
    assert (K2, K2p) == (8, 10)


@pytest.mark.parametrize("kernel_ms, event_ms, lost", [
    (0.0, 0.2, True), (0.05, 0.4, False), (0.592, 2.288, True),
    (1.9, 2.0, False)],
    ids=["short-none", "short-launch-bound", "partial", "whole"])
def test_check_traces(kernel_ms, event_ms, lost):
    """A card row whose kernels sum to nothing, or to less than half of
    its events where those are 1 ms or more (0.592 of 2.288 ms: a loss
    seen on the card), raises; a short launch-bound row and host rows
    pass."""
    rows = {"a": {"event_ms": event_ms, "kernel_ms": kernel_ms},
            "b": {"host_ms": 3.0}}
    if lost:
        with pytest.raises(RuntimeError, match="lost their kernels"):
            C.check_traces(rows)
    else:
        C.check_traces(rows)


@pytest.mark.parametrize("mod", [MM, MM2, LM],
                         ids=["m2l_micro", "m2l_micro2", "l2p_micro"])
def test_a_lost_trace_raises(monkeypatch, mod):
    """Each study raises after its rows where a trace lost its kernels."""
    def lose_first(fns, device, reps):
        out = {k: {"event_ms": 2.0, "kernel_ms": 1.9, "peak_bytes": 0,
                   "extra_bytes": 0} for k in fns}
        out[next(iter(fns))]["kernel_ms"] = 0.0
        return out
    monkeypatch.setattr(C, "time_variants", lose_first)
    monkeypatch.setattr(LM, "LEAVES", 64)
    monkeypatch.setattr(LM, "C_LEAF", 16)
    run = {MM: lambda: MM.study(2048, 3, 1.43, "cpu", reps=1),
           MM2: lambda: MM2.study(2048, 3, 1.43, 512, "cpu", reps=1),
           LM: lambda: LM.study(3, "cpu", reps=1)}[mod]
    with pytest.raises(RuntimeError, match="lost their kernels"):
        run()


def test_window_stats_lines_equal_reference(reference_scripts):
    """The twin's lines at N=16384, p=3, r=1.43 equal, one for one, the
    reference script's output on the CPU (last in the file: the script
    runs while the tests above do)."""
    got = WS.stats(N, 3, 1.43, "cpu")["lines"]
    assert got == reference_scripts["window_stats"].lines()
