"""The port's program spans, counters and timed stages
(``utils/profiling.py``) on the CPU: nothing records without a profiler;
under one, the window pipeline, the host rebuild (on its own thread) and
the force's stages record what the Simulator did; the exporter puts the
rebuild thread's spans on the trace's clock; and the step graph's pending
stage sample is read, or counted as missed, without blocking.  No time
here is a device time."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coulomb_oscillators_tpu_torch import SimConfig, native
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.simulate import Simulator
from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy
from coulomb_oscillators_tpu_torch.utils import profiling as P
from coulomb_oscillators_tpu_torch.utils.graphs import StepGraph

torch.set_num_threads(1)

N = 2048
X_STD = (0.003, 0.001, 0.01)
STAGES = ("fmm.upward", "fmm.m2l", "fmm.downward", "fmm.p2p")
# the parts a background full re-sort and a refresh time
# (KdFmmEngine.last_build_times)
BUILD_KEYS = {"unpad_host", "kd", "geom", "traverse", "lists", "upload"}
REFRESH_KEYS = {"geom_dev", "geom_host", "traverse", "lists", "upload"}


@pytest.fixture
def clean():
    P.reset()
    yield
    P.reset()


@pytest.fixture(scope="module")
def beam():
    u = tuple(w * x for w, x in zip((1.095, 1.0, 1.0), X_STD))
    return ID.init_gaussian(N, X_STD, u)


@pytest.fixture
def async_host():
    """The host-async rebuild pipeline runs on the native library."""
    if not native.available():
        pytest.skip("the native library did not build here: no "
                    "background host rebuild")


class _Calls:
    """Counts the calls of a bound method, replaced on its instance."""

    def __init__(self, obj, name):
        self.n = 0
        fn = getattr(obj, name)

        def counted(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)

        setattr(obj, name, counted)


def _run(beam, windows=3, resort=2, pipeline=1, counters=False):
    """An async fmm3_kd Simulator: `windows` windows of 3 steps after the
    first build; returns the Simulator's rebuild counts, the engine's
    last build parts and, with `counters`, the calls made."""
    pos, vel = beam
    cfg = SimConfig(fmm_order=3, tree_radius=2.0, tree_steps=3,
                    tree_resort_every=resort, tree_pipeline=pipeline)
    sim = Simulator(cfg, N, engine="fmm3_kd")
    eng = sim._fmm
    calls = ({k: _Calls(eng, k) for k in ("force_padded", "geom_refresh",
                                          "_traverse")}
             if counters else {})
    try:
        st = sim.init_acc(particle_state_from_numpy(pos, vel, device="cpu"))
        sim.run(st, 3 * windows)
        out = (dict(sim.rebuilds), dict(eng.last_build_times),
               {k: c.n for k, c in calls.items()})
    finally:
        sim.close()
    return out


def test_nothing_records_without_a_profiler(beam, async_host, clean):
    assert P.span("sim.window") is P._NULL
    P.stage("fmm.m2l", "cpu")
    P.stage(None, "cpu")
    job = object()
    assert P.carry(job) is job
    timed = {}
    with P.span("kd.sort", timed, "kd"):
        pass
    assert set(timed) == {"kd"} and timed["kd"] >= 0.0
    rebuilds, parts, _ = _run(beam)
    assert rebuilds.get("adopt_full", 0) >= 1
    assert set(parts) in (BUILD_KEYS, REFRESH_KEYS)
    assert P.totals() == {}


def test_a_profiler_records_every_layer(beam, async_host, clean):
    with profile(activities=[ProfilerActivity.CPU]):
        rebuilds, parts, calls = _run(beam, windows=4, counters=True)
    tot = P.totals()
    adopted = rebuilds.get("adopt_full", 0) + rebuilds.get("adopt_refresh", 0)
    assert adopted >= 2
    assert tot["sim.boundary.wait"]["count"] == adopted
    assert tot["sim.boundary"]["count"] == 3      # before windows 2-4
    assert tot["sim.boundary.refresh"]["count"] == rebuilds["sync_refresh"]
    # one traversal a host build or refresh, on either thread
    assert tot["kd.traverse"]["count"] == calls["_traverse"] >= 3
    # every stage once a force evaluation (init_acc's one included), the
    # geometry refresh once a step, host-timed on the CPU
    for name in STAGES:
        assert tot[name]["count"] == calls["force_padded"] == 13, name
    assert tot["fmm.refresh"]["count"] == calls["geom_refresh"] == 12
    assert tot["stage.steps"]["count"] == 12
    assert tot["sim.window"]["count"] == 4
    # the gaps between the 4 runs, counted by the steps they open
    assert tot["sim.boundary.device"]["count"] == 3 * 3
    assert set(parts) in (BUILD_KEYS, REFRESH_KEYS)


@pytest.mark.parametrize("recorded", [False, True])
def test_build_parts_keep_their_keys(beam, async_host, clean, recorded):
    """Each kind of rebuild fills ``last_build_times`` with the parts it
    had before the spans timed them, whether or not a profiler runs."""
    from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR
    pos = torch.from_numpy(beam[0])
    cfg = SimConfig(fmm_order=3, tree_radius=2.0, tree_steps=3)
    sim = Simulator(cfg, N, engine="fmm3_kd")
    eng = sim._fmm
    ctx = (profile(activities=[ProfilerActivity.CPU]) if recorded
           else P._NULL)
    with ctx:
        fs = eng.build(pos)
        keys = [set(eng.last_build_times)]
        ppad = eng.pad_array(pos, fs, fill=FAR)
        eng.build_host_padded(ppad.numpy(), fs.inv_perm.numpy(), "cpu")
        keys.append(set(eng.last_build_times))
        eng.refresh(ppad, fs)
        keys.append(set(eng.last_build_times))
    sim.close()
    assert keys == [{"fetch", "kd", "geom", "traverse", "lists", "upload"},
                    BUILD_KEYS, REFRESH_KEYS]
    assert all(v >= 0.0 for v in eng.last_build_times.values())
    assert (P.totals().get("kd.traverse", {}).get("count", 0)
            == (3 if recorded else 0))


@pytest.mark.parametrize("dim", [2, 3])
def test_list_builds_count_their_near_entries(beam, clean, tmp_path, dim):
    """A build under ``profiling.trace`` counts its near (P2P) entries,
    sub-leaf rows and longest row, as the built state's CSR holds them."""
    engine = {2: "fmm2_kd", 3: "fmm3_kd"}[dim]
    cfg = SimConfig(dim=dim, omega0=(1.095, 1.0, 1.0)[:dim], fmm_order=3,
                    tree_radius=2.0, tree_steps=3)
    sim = Simulator(cfg, N, engine=engine)
    try:
        with P.trace(str(tmp_path)):
            fs = sim._fmm.build(torch.from_numpy(beam[0][:, :dim].copy()))
    finally:
        sim.close()
    row_ptr = fs.p2p_row_ptr.numpy()
    tot = P.totals()
    assert tot["kd.lists.near_entries"]["count"] == row_ptr[-1] > 0
    assert tot["kd.lists.near_rows"]["count"] == len(row_ptr) - 1
    assert (tot["kd.lists.near_row_max"]["count"]
            == np.diff(row_ptr).max() > 0)


def _intervals(events, cat, names=None, tid=None):
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == cat
                  and (names is None or e["name"] in names)
                  and (tid is None or e["tid"] == tid))


def test_the_trace_holds_the_rebuild_thread_on_its_clock(beam, async_host,
                                                         tmp_path, clean):
    """Resort every 2 boundaries, adopted at the next one: each boundary
    adopts the job the one before submitted (a full re-sort, then a
    refresh, in turn).  Every rebuild-thread span sits on its own thread
    id, inside [its job's submit start, the adopting wait's end]."""
    with P.trace(str(tmp_path)):
        rebuilds, _, _ = _run(beam, windows=5, resort=2, pipeline=1)
    with open(tmp_path / P.TRACE_FILE) as f:
        doc = json.load(f)
    clock = doc["programSpans"]
    assert clock["matched"] >= 10 and clock["merged"] > 0
    events = doc["traceEvents"]
    rebuild = _intervals(events, P.SPAN_CATEGORY)
    tids = {e["tid"] for e in events if e.get("cat") == P.SPAN_CATEGORY}
    main = {e["tid"] for e in events if e.get("cat") == "user_annotation"
            and e["name"] == "sim.boundary"}
    assert len(tids) == 1 and not tids & main
    names = {e["args"]["name"] for e in events if e.get("ph") == "M"
             and e.get("name") == "thread_name" and e["tid"] in tids}
    assert any(n.startswith("tree-build") for n in names)
    assert all(n.startswith("kd.") for _, _, n in rebuild)
    submits = _intervals(events, "user_annotation", {"sim.boundary.submit"})
    waits = _intervals(events, "user_annotation", {"sim.boundary.wait"})
    assert len(waits) == (rebuilds.get("adopt_full", 0)
                          + rebuilds.get("adopt_refresh", 0))
    # split the worker's spans into jobs at each job's first part
    jobs = []
    for span in rebuild:
        if span[2] in ("kd.unpad_host", "kd.refresh.geom_dev"):
            jobs.append([])
        jobs[-1].append(span)
    assert len(jobs) >= len(waits) >= 3
    tol = clock["spread_us"]
    for job, sub, wait in zip(jobs, submits, waits):
        assert job[0][0] >= sub[0] - tol
        assert job[-1][1] <= wait[1] + tol


def test_step_graph_stage_sample_bookkeeping(clean):
    """A run leaves its last replay's stage marks as a pending sample of
    its k steps; release (or the next run) reads it: complete, each stage
    (from its mark to the next) counts k times; not complete, one sample
    is missed."""

    class Ev:
        def __init__(self, ms, done=True):
            self.ms, self.done = ms, done

        def query(self):
            return self.done

        def elapsed_time(self, other):
            return other.ms - self.ms

    g = StepGraph(lambda state, frozen: state)
    assert g._sample == 0
    g.release()                              # nothing pending: nothing read
    assert P.totals() == {}
    g._stages = [("fmm.m2l", Ev(1.0)), ("fmm.p2p", Ev(3.5)), (None, Ev(4.0))]
    g._sample = 5
    g.release()
    tot = P.totals()
    assert g._sample == 0 and g._stages == []
    assert tot["fmm.m2l"] == {"count": 5, "seconds": pytest.approx(0.0125)}
    assert tot["fmm.p2p"]["seconds"] == pytest.approx(0.0025)
    assert tot["stage.steps"]["count"] == 5
    assert "stage.samples_missed" not in tot
    g._stages = [("fmm.m2l", Ev(0.0)), (None, Ev(2.0, done=False))]
    g._sample = 3
    g.release()
    tot = P.totals()
    assert tot["stage.samples_missed"]["count"] == 1
    assert tot["fmm.m2l"]["count"] == 5 and tot["stage.steps"]["count"] == 5
    with pytest.raises(ValueError, match="CUDA"):
        g.run((torch.zeros(1),), (), 1)
