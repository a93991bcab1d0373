"""The 2D transverse-beam deployment (``benchmark/configs/kd2_kv_100k.json``
under the traffic ``kd2_kv_100k.w2``) on the CPU at N = 4096, held to the
benchmark's plain reference (``benchmark/reference/coulomb.py``: float64,
nothing of the port).

The configuration's own file and cadence, with N cut: an ``fmm2_kd``
Simulator on the matched KV beam, windows of 2 steps, a full re-sort at
every boundary adopted at the next, the auto stale margin.  Four windows
run through ``advance_padded``, one step a call (the boundary still comes
every 2 steps), so that each window's last step can be held to the drift
of the step before it.  At the start and at each window's last step the
Coulomb acceleration (the output less the exact trap term) must be within
a mean relative error of 1e-3 of the exact sum, and nothing may be
non-finite.  The reference computed in bfloat16 in the program's place
must fail that force check: the tolerance tells float32 from the next
precision below it."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import beam as B
from benchmark import program as BP
from benchmark.reference import coulomb as R
from coulomb_oscillators_tpu_torch.models.beams import matched_beam_2d
from coulomb_oscillators_tpu_torch.simulate import Simulator
from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "kd2_kv_100k.w2"
N = 4096
SEED = 2147483777
WINDOWS = 4
FORCE_TOL = 1e-3        # the configuration's guarantee
DRIFT_TOL = 1e-4        # the cell's drift limit


def _load(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return json.load(f)


def _coulomb_err(acc, pos, record, dtype=None):
    """Mean relative error of the Coulomb part of `acc` (or, with `dtype`,
    of the reference computed in that precision in the program's place) on
    the targets, against the exact float64 sum."""
    tg = record["targets"]
    exact = R.coulomb(pos, tg, record["eps2"], record["kappa"], "cpu")
    if dtype is None:
        coul = (torch.from_numpy(acc[tg]).double()
                - R.trap(pos[tg], record["omega0_sq"], "cpu"))
    else:
        coul = R.coulomb(pos, tg, record["eps2"], record["kappa"], "cpu",
                         dtype)
    return float(((coul - exact).norm(dim=1) / exact.norm(dim=1)).mean())


@pytest.fixture(scope="module")
def record():
    """The program's states: the start, then each window's last two."""
    config = _load("benchmark", "configs", "kd2_kv_100k.json")
    workload = _load("benchmark", "workloads", f"{CELL}.json")
    cfg = BP.sim_config(config, workload)
    assert (cfg.tree_steps, cfg.tree_resort_every, cfg.tree_pipeline) == \
        (2, 1, 1)
    assert cfg.dim == 2 and cfg.stale_margin < 0     # the auto margin
    pos, vel = BP.make_beam(dict(config, n=N), cfg, SEED)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in config["program_env"].items():
            mp.setenv(k, str(v))
        for k in config["program_env_unset"]:
            mp.delenv(k, raising=False)
        sim = Simulator(cfg, N, engine=config["engine"])
        try:
            st = sim.init_acc(particle_state_from_numpy(pos, vel,
                                                        device="cpu"))
            start = BP.host_state(st)
            windows = []
            for _ in range(WINDOWS):
                pair = []
                for _ in range(2):
                    sim.advance_padded(1)
                    pair.append(BP.host_state(sim.current_state()))
                windows.append(pair)
            rebuilds = dict(sim.rebuilds)
        finally:
            sim.close()
    sim_cfg = config["sim"]
    return {"pos0": pos, "start": start, "windows": windows,
            "rebuilds": rebuilds, "dt": sim_cfg["dt"],
            "eps2": sim_cfg["eps"] ** 2, "kappa": sim_cfg["xi"] / N,
            "omega0_sq": [w * w for w in sim_cfg["omega0"]],
            "targets": B.targets(N, N, SEED)}


def test_the_configuration_is_the_2d_clis_matched_beam():
    """The file's beam and coupling are ``matched_beam_2d`` at the 2D
    CLI's defaults (omega0 = 2 pi (6.22, 6.21), emittances (3e-5, 1e-5),
    tune depression 0.8), in full digits."""
    config = _load("benchmark", "configs", "kd2_kv_100k.json")
    omega0 = 2 * np.pi * np.array([6.22, 6.21])
    beam = matched_beam_2d(omega0, (0.03e-3, 0.01e-3), 0.8)
    assert config["sim"]["omega0"] == list(omega0)
    assert config["beam"]["A"] == list(beam["A"])
    assert config["beam"]["omega"] == list(beam["omega"])
    assert config["sim"]["xi"] == beam["xi"]
    assert config["reduced"] == ["precision"]
    assert config["sim"]["precision"] == "float32"


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_kd2_deployment_against_the_plain_reference(record, precision):
    """float32: the program's own outputs hold the force, drift and
    non-finite checks at the start and at every window's last step.
    bfloat16: the reference computed in bfloat16 in the program's place
    fails the force check at every one of those states."""
    # one boundary before each window after the first: the pipeline's
    # priming refresh, then a full re-sort adopted at each
    assert sum(record["rebuilds"].values()) == WINDOWS - 1
    checked = [(record["pos0"], record["start"]["acc"])]
    checked += [(b["pos"], b["acc"]) for _, b in record["windows"]]
    dtype = torch.bfloat16 if precision == "bfloat16" else None
    errs = [_coulomb_err(acc, pos, record, dtype) for pos, acc in checked]
    if dtype is not None:
        assert min(errs) > FORCE_TOL, errs
        return
    assert max(errs) <= FORCE_TOL, errs
    for a, b in record["windows"]:
        want = R.drift(a["pos"], a["vel"], a["acc"], record["dt"], "cpu")
        got = torch.from_numpy(b["pos"]).double()
        scale = want.abs() + want.pow(2).mean(0).sqrt()
        assert float(((got - want).abs() / scale).max()) <= DRIFT_TOL
    states = [record["start"]] + [s for w in record["windows"] for s in w]
    assert all(np.isfinite(s[k]).all() for s in states
               for k in ("pos", "vel", "acc"))
