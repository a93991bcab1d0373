"""The port's profiling harness and stage profile on the CPU.

`op_histogram` aggregates a recorded CPU profile and a hand-made event
list; `stage_times` and `stage_summary` time and sum named stages; the
engines' stage methods compose to their force bit for bit; and
`profile_force` at N=2048 on ``--device cpu`` gives the stage names of
the original's record.  No time measured here is a device time.
"""

import json

import numpy as np
import pytest
import torch

from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.ops.fmm import make_engine_object
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR
from coulomb_oscillators_tpu_torch.scripts import profile_force as PF
from coulomb_oscillators_tpu_torch.utils import profiling as P

torch.set_num_threads(1)

X_STD = (0.003, 0.001, 0.01)


# ---- op_histogram ----------------------------------------------------------

EVENTS = [
    {"ph": "X", "cat": "kernel", "name": "p2p_kernel<float>", "dur": 4000},
    {"ph": "X", "cat": "kernel", "name": "p2p_kernel<float>", "dur": 4100},
    {"ph": "X", "cat": "kernel", "name": "gemm", "dur": 40000},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 250},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 99999},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "dur": 7},
    {"ph": "M", "cat": "kernel", "name": "thread_name"},
    {"ph": "i", "cat": "kernel", "name": "instant"},
    {"ph": "X", "cat": "kernel", "name": "no_duration"},
]


def test_histogram_sums_device_events_by_name_largest_first():
    h = P.histogram(EVENTS)
    assert list(h) == ["gemm", "p2p_kernel<float>", "Memcpy HtoD"]
    assert h["gemm"] == pytest.approx(40.0)
    assert h["p2p_kernel<float>"] == pytest.approx(8.1)
    assert h["Memcpy HtoD"] == pytest.approx(0.25)
    assert list(P.histogram(EVENTS, top=1)) == ["gemm"]
    assert P.histogram(EVENTS, categories=("cpu_op",)) == {
        "aten::mm": pytest.approx(99.999)}
    assert P.histogram([]) == {}


def test_op_histogram_reads_trace_files(tmp_path):
    """Plain and gzipped Chrome traces under a directory are summed."""
    import gzip
    (tmp_path / "a").mkdir()
    with open(tmp_path / "a" / "x.json", "w") as f:
        json.dump({"traceEvents": EVENTS}, f)
    with gzip.open(tmp_path / "y.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": EVENTS[:1]}, f)
    h = P.op_histogram(str(tmp_path), top=None)
    assert h["p2p_kernel<float>"] == pytest.approx(12.1)
    assert h["gemm"] == pytest.approx(40.0)
    assert "aten::mm" not in h
    assert P.op_histogram(str(tmp_path / "none")) == {}


def test_trace_records_a_cpu_profile(tmp_path):
    """A recorded CPU profile: host operators only, so the device
    histogram is empty and the host one names the matmul; the block's
    program span is on the trace, and its alignment is written beside
    it."""
    x = torch.randn(64, 64)
    with P.trace(str(tmp_path / "tr")):
        for _ in range(3):
            with P.span("test.matmul"):
                x = x @ x * 0.01
    assert (tmp_path / "tr" / P.TRACE_FILE).exists()
    assert P.op_histogram(str(tmp_path / "tr")) == {}
    host = P.op_histogram(str(tmp_path / "tr"), top=None,
                          categories=("cpu_op",))
    assert "aten::mm" in host and host["aten::mm"] > 0
    spans = P.op_histogram(str(tmp_path / "tr"), top=None,
                           categories=("user_annotation",))
    assert spans["test.matmul"] > 0
    with open(tmp_path / "tr" / P.TRACE_FILE) as f:
        clock = json.load(f)["programSpans"]
    assert clock["matched"] == 3 and clock["merged"] == 0


def test_trace_propagates_the_blocks_error(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with P.trace(str(tmp_path / "tr")):
            1 / 0


# ---- stage_times / stage_summary -------------------------------------------

def test_stage_times_on_the_cpu():
    calls = {"a": 0, "b": 0}

    def stage(name, n):
        def fn():
            calls[name] += 1
            return torch.ones(n, n) @ torch.ones(n, n)
        return fn

    out = P.stage_times({"a": stage("a", 8), "b": stage("b", 128)}, reps=3)
    assert list(out) == ["a", "b"]
    assert calls == {"a": 4, "b": 4}          # one warm-up and 3 timed
    assert all(v > 0 and np.isfinite(v) for v in out.values())


def test_stage_device_times_needs_a_card():
    with pytest.raises(ValueError, match="no device time"):
        P.stage_device_times({"a": lambda: None}, "cpu")


def test_stage_summary():
    s = P.stage_summary({"x_ms": 1.0, "y_ms": 3.0, "whole_ms": 5.0}, 5.0,
                        parts=("x_ms", "y_ms"))
    assert s["sum_ms"] == 4.0 and s["sum_over_whole"] == pytest.approx(0.8)
    assert s["share"] == {"x_ms": 0.25, "y_ms": 0.75}
    assert P.stage_summary({"a": 2.0}, 4.0)["sum_over_whole"] == 0.5


# ---- the stage split equals the fused force, bit for bit --------------------

def _kd(dim, n=2048, p=3):
    cfg = SimConfig(dim=dim, omega0=(1.095, 1.0, 1.0)[:dim], fmm_order=p,
                    tree_radius=2.0)
    x = X_STD[:dim]
    pos = torch.from_numpy(ID.init_gaussian(n, x, x, dim=dim)[0])
    eng = make_engine_object(cfg, n, "fmm3_kd" if dim == 3 else "fmm2_kd")
    return eng, pos, eng.build(pos)


@pytest.mark.parametrize("dim", [3, 2])
def test_kd_stage_split_is_bitwise_force_padded(dim):
    """The reference's four private stages, run one at a time, give the
    padded force bit for bit."""
    eng, pos, fs = _kd(dim)
    ppad = eng.pad_array(pos, fs, fill=FAR)
    whole = eng.force_padded(ppad, fs)
    mh = eng._stage_multipoles(ppad, fs)
    lh = eng._stage_m2l(mh, fs)
    far = eng._stage_local(ppad, lh, fs)
    near = eng._stage_p2p(ppad, fs)
    assert torch.equal((far + near) * eng._kappa(ppad.dtype), whole)
    assert mh.shape == ((1 << (eng.L + 1)) - 1, eng.tables.S_M)
    assert lh.shape == (mh.shape[0], eng.tables.S_Lt)
    assert far.shape == near.shape == ppad.shape
    # and the potential's pipeline is the same stages
    V, leaf_local, leafl = eng._leaf_expansions(ppad, fs)
    assert torch.equal(leaf_local, eng.l2l_down(lh, fs))
    assert torch.equal(eng._l2p(V, leafl, leaf_local), far)


@pytest.mark.parametrize("name,dim", [("fmm3", 3), ("fmm3_traceless", 3),
                                      ("fmm2", 2), ("appel", 3),
                                      ("appel", 2)])
def test_grid_stage_split_is_bitwise_force(name, dim):
    """The uniform-grid engines' stage callables, as profile_force chains
    them, compose to `force` bit for bit."""
    n = 3000
    cfg = SimConfig(dim=dim, omega0=(1.095, 1.0, 1.0)[:dim])
    pos = torch.from_numpy(ID.init_uniform(n, (-0.01,) * dim, (0.01,) * dim,
                                           dim=dim))
    eng = make_engine_object(cfg, n, name)
    st = eng.build(pos)
    whole = eng.force(pos, st)
    from coulomb_oscillators_tpu_torch.ops.fmm import octree as oc
    if name == "appel":
        fns = PF.appel_stages(eng, pos, st)
        q_lvl, coc_lvl = fns["monopoles_ms"]()
        far = eng._stage_push_down(eng._stage_c2c(q_lvl, coc_lvl))[
            st.key.long()]
        assert torch.equal(fns["push_down_ms"](),
                           eng._stage_push_down(fns["c2c_ms"]()))
    else:
        fns = PF.oct_stages(eng, pos, st)
        mats = eng._mats(pos.dtype, pos.device)
        _, e, lam_L = fns["frame_ms"]()
        L_lvl = eng._stage_m2l(eng._stage_m2m(fns["p2m_ms"](), mats), st,
                               mats)
        assert all(torch.equal(a, b) for a, b in zip(L_lvl,
                                                     fns["m2l_ms"]()))
        far = eng._stage_l2p(eng._stage_l2l(L_lvl, mats), e, st, lam_L)
        assert torch.equal(far, fns["l2p_ms"]())
    acc_s = (far + fns["p2p_ms"]()) * oc._kappa(cfg, n, pos.dtype)
    assert torch.equal(oc._unsort(acc_s, st.perm), whole)
    assert torch.equal(fns["force_full_ms"](), whole)


# ---- profile_force ----------------------------------------------------------

# the stage names of the original's record (scripts/profile_force.py)
ORIGINAL_ROWS = ("force_full_ms", "force_padded_ms", "gathers_ms",
                 "p2m_m2m_ms", "m2l_ms", "l2l_l2p_ms", "p2p_ms")


@pytest.mark.parametrize("engine,p,r", [("fmm3_kd", 3, 1.7),
                                        ("fmm2_kd", 4, 2.0)])
def test_profile_force_kd_rows(engine, p, r):
    rec = PF.profile_engine(engine, 2048, p, r, torch.device("cpu"), reps=1,
                            rebuilds=1)
    rows = rec["stages_ms"]
    assert set(ORIGINAL_ROWS) <= set(rows)
    assert {"geom_refresh_ms", "leaf_frame_ms"} <= set(rows)
    assert all(v > 0 for v in rows.values())
    s = rec["summary"]
    assert set(s["share"]) == set(PF.KD_STAGES)
    assert s["whole_ms"] == rows["force_padded_ms"]
    assert s["sum_ms"] == pytest.approx(sum(rows[k] for k in PF.KD_STAGES))
    assert sum(s["share"].values()) == pytest.approx(1.0)
    assert rec["p2p_kind"] == "plain"        # a CPU tensor, in either dim
    assert rec["p2p_tiles"] > 0 and rec["p2p_G_lane_int_per_s"] > 0
    assert 0 < rec["p2p_share_of_refresh_plus_force"] \
        < rec["p2p_share_of_padded_force"]
    assert rec["device"]["device"] == "cpu"
    assert "stages_device_ms" not in rec      # device times: the card only
    assert set(rec["rebuild_breakdown_ms"]) >= {"kd", "traverse", "lists",
                                                "upload"}
    assert rec["config"]["dim"] == (3 if engine == "fmm3_kd" else 2)
    json.dumps(rec)


@pytest.mark.parametrize("engine,stages", [
    ("fmm3", PF.OCT_STAGES), ("fmm3_traceless", PF.OCT_STAGES),
    ("appel", PF.APPEL_STAGES)])
def test_profile_force_grid_rows(engine, stages):
    rec = PF.profile_engine(engine, 2048, 3, 1.0, torch.device("cpu"),
                            reps=1, rebuilds=1)
    assert set(stages) | {"force_full_ms"} <= set(rec["stages_ms"])
    assert set(rec["summary"]["share"]) == set(stages)
    assert rec["summary"]["whole_ms"] == rec["stages_ms"]["force_full_ms"]
    assert rec["config"]["cell_cap"] > 0
    json.dumps(rec)


def test_profile_force_fmm2_kd_traces(tmp_path):
    """trace and prodtrace of fmm2_kd on --device cpu: the records name
    the engine (and prodtrace its precision, float32 or float64), the
    window runs in 2D and, with no card, no kernel shows in the device
    histograms."""
    assert PF.main(["trace", "1024", "3", "2.0", "--engine", "fmm2_kd",
                    "--device", "cpu", "--out",
                    str(tmp_path / "tr.json")]) == 0
    tr = json.loads((tmp_path / "tr.json").read_text())
    assert tr["config"]["engine"] == "fmm2_kd"
    assert tr["kernels_ms_per_call"] == {}
    rec = PF.prod_trace(1024, 3, 2.0, torch.device("cpu"),
                        str(tmp_path / "pt"), ts=4, resort=1, pipeline=1,
                        graphs=False, engine="fmm2_kd")
    assert rec["config"]["engine"] == "fmm2_kd" and rec["config"]["ts"] == 4
    assert rec["wall_ms_per_step"] > 0 and rec["graphs"] is False
    assert rec["config"]["precision"] == "float32"
    # two re-sort cycles traced; each stage of the step timed (host times
    # here), no graph sample to miss, no device interval to leave a gap
    assert rec["traced_steps"] == 8
    assert set(rec["stage_ms_per_step"]) == set(PF.STEP_STAGES)
    assert all(v > 0 for v in rec["stage_ms_per_step"].values())
    assert rec["stage_samples_missed"] == 0 and rec["idle_gaps"] == []
    assert rec["span_clock"]["matched"] > 0 and rec["span_clock"]["merged"] > 0
    assert "device_busy_share" not in rec
    rec = PF.prod_trace(1024, 3, 2.0, torch.device("cpu"),
                        str(tmp_path / "pt64"), ts=4, resort=1, pipeline=1,
                        graphs=False, engine="fmm2_kd", precision="float64")
    assert rec["config"]["precision"] == "float64"
    assert rec["wall_ms_per_step"] > 0
    with pytest.raises(SystemExit):
        PF.main(["trace", "1024", "--engine", "fmm3", "--device", "cpu"])


def test_profile_force_cli_modes(tmp_path, capsys, monkeypatch):
    """plain, artifact, trace and prodtrace on --device cpu; the record
    goes to --out and nowhere else."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "rec.json"
    assert PF.main(["artifact", "1024", "3", "1.7", "--device", "cpu",
                    "--reps", "1", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["metric"] == "force_eval_stage_breakdown"
    assert set(ORIGINAL_ROWS) <= set(rec["stages_ms"])
    assert "P2M+M2M" not in capsys.readouterr().out    # rows by field name
    with pytest.raises(SystemExit):
        PF.main(["artifact", "1024", "--device", "cpu"])    # needs --out
    assert PF.main(["trace", "1024", "3", "1.7", "--device", "cpu",
                    "--logdir", str(tmp_path / "tr"), "--out",
                    str(tmp_path / "tr.json")]) == 0
    tr = json.loads((tmp_path / "tr.json").read_text())
    assert tr["calls"] == 3 and tr["kernels_ms_per_call"] == {}   # no card
    assert (tmp_path / "tr" / P.TRACE_FILE).exists()
    monkeypatch.setenv("CO_TS", "4")
    assert PF.main(["prodtrace", "1024", "3", "1.7", "--device", "cpu",
                    "--out", str(tmp_path / "prod.json")]) == 0
    pr = json.loads((tmp_path / "prod.json").read_text())
    assert pr["config"]["ts"] == 4 and pr["wall_ms_per_step"] > 0
    assert pr["device_ms_per_step"] == 0                 # nothing on a card
    # the graph run and the eager one: both eager on the CPU
    assert pr["graphs"] is False and pr["captures"] == 0
    assert pr["eager"]["graphs"] is False and pr["eager"]["config"]["ts"] == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "prod.json", "rec.json", "tr", "tr.json"]
