"""The plain reference and the comparison, against NumPy in float64."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import compare as CMP
from benchmark.reference import coulomb as R
from benchmark.reference import snapshot as S

EPS2, KAPPA, DT = 1e-18, 2e-6 / 300, 5e-4
OMEGA0_SQ = (1.095 ** 2, 1.0, 1.0)


def _beam(n=300, seed=3):
    g = np.random.default_rng(seed)
    pos = (g.standard_normal((n, 3)) * (0.003, 0.001, 0.01)).astype(
        np.float32)
    vel = (g.standard_normal((n, 3)) * (0.003, 0.001, 0.01)).astype(
        np.float32)
    return pos, vel


def _numpy_coulomb(pos, targets):
    x = pos.astype(np.float64)
    out = np.zeros((len(targets), 3))
    for i, t in enumerate(targets):
        for s in range(x.shape[0]):
            d = x[t] - x[s]
            out[i] += d * (d @ d + EPS2) ** -1.5
    return out * KAPPA


def test_coulomb_equals_a_float64_numpy_sum():
    pos, _ = _beam()
    tg = np.array([0, 7, 150, 299])
    got = R.coulomb(pos, tg, EPS2, KAPPA, "cpu").numpy()
    want = _numpy_coulomb(pos, tg)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_coulomb_blocks_do_not_change_the_sum(monkeypatch):
    pos, _ = _beam()
    tg = np.arange(300)
    whole = R.coulomb(pos, tg, EPS2, KAPPA, "cpu")
    monkeypatch.setattr(R, "BLOCK_ELEMENTS", 7 * 300)
    np.testing.assert_array_equal(R.coulomb(pos, tg, EPS2, KAPPA, "cpu"),
                                  whole)


def test_bfloat16_control_is_far_from_float64():
    pos, _ = _beam()
    tg = np.arange(0, 300, 3)
    ref = R.coulomb(pos, tg, EPS2, KAPPA, "cpu")
    ctl = R.coulomb(pos, tg, EPS2, KAPPA, "cpu", torch.bfloat16)
    err = float(((ctl - ref).norm(dim=1) / ref.norm(dim=1)).mean())
    assert 1e-3 < err < 1.0


def test_trap_drift_and_kicks_equal_numpy():
    pos, vel = _beam()
    acc0 = pos * -3.0
    acc1 = pos * 2.0
    x, v = pos.astype(np.float64), vel.astype(np.float64)
    np.testing.assert_allclose(R.trap(pos, OMEGA0_SQ, "cpu").numpy(),
                               -x * np.array(OMEGA0_SQ), rtol=1e-15)
    np.testing.assert_allclose(
        R.drift(pos, vel, acc0, DT, "cpu").numpy(),
        x + DT * (v + 0.5 * DT * acc0.astype(np.float64)), rtol=1e-15)
    np.testing.assert_allclose(
        R.kicks(vel, acc0, acc1, DT, "cpu").numpy(),
        v + 0.5 * DT * acc0.astype(np.float64)
        + 0.5 * DT * acc1.astype(np.float64), rtol=1e-15)


def test_snapshot_read_parses_the_reference_format(tmp_path):
    pos, vel = _beam(50)
    p = tmp_path / "out0_0.000500.bin"
    p.write_bytes(pos.tobytes() + vel.tobytes())
    got_p, got_v = S.read(str(p))
    np.testing.assert_array_equal(got_p, pos)
    np.testing.assert_array_equal(got_v, vel)
    p.write_bytes(pos.tobytes()[:-4])
    with pytest.raises(ValueError):
        S.read(str(p))


def _exact_record(n=300, steps=3, seed=5):
    """A record whose states follow the leapfrog step with the exact force:
    every reading of it is rounding."""
    pos, vel = _beam(n, seed)
    tg = np.arange(n)

    def acc_of(p):
        a = (R.coulomb(p, tg, EPS2, KAPPA, "cpu")
             + R.trap(p, OMEGA0_SQ, "cpu")).numpy()
        return a.astype(np.float32)

    acc = acc_of(pos)
    out = [{"pos": pos, "vel": vel, "acc": acc, "force": True}]
    for _ in range(steps):
        p = R.drift(pos, vel, acc, DT, "cpu").numpy().astype(np.float32)
        a = acc_of(p)
        v = R.kicks(vel, acc, a, DT, "cpu").numpy().astype(np.float32)
        pos, vel, acc = p, v, a
        out.append({"pos": pos, "vel": vel, "acc": acc, "force": True})
    return {"dt": DT, "eps2": EPS2, "kappa": KAPPA, "omega0_sq": OMEGA0_SQ,
            "targets": tg, "start": {"pos": out[0]["pos"],
                                     "acc": out[0]["acc"]},
            "steps": out}


def test_readings_of_an_exact_record_are_rounding_and_control_fails():
    rec = _exact_record()
    prog = CMP.readings(rec, "cpu")
    assert prog["force_err"] < 1e-5
    assert prog["drift_err"] < 1e-6
    assert prog["kick_err"] < 1e-2
    assert prog["nonfinite"] == 0
    limits = {"force_err": 1e-3, "drift_err": 1e-4, "kick_err": 0.1}
    assert all(ok for *_, ok in CMP.judge(prog, limits))
    ctl = CMP.readings(rec, "cpu", control="all")
    assert not all(ok for *_, ok in CMP.judge(ctl, limits))
    # the force alone in bfloat16: the step stays at float32's rounding,
    # the force and the kick read bfloat16's error
    ctl = CMP.readings(rec, "cpu", control="force")
    assert ctl["drift_err"] < 1e-6
    assert ctl["force_err"] > 1e-3 and ctl["kick_err"] > 1e-3
    assert not all(ok for *_, ok in CMP.judge(ctl, limits))
    with pytest.raises(ValueError, match="no control"):
        CMP.readings(rec, "cpu", control="half")


def test_readings_see_a_permuted_step_and_an_unmoved_step():
    rec = _exact_record()
    swapped = dict(rec["steps"][2])
    swapped["pos"] = swapped["pos"][np.r_[1, 0, 2:300]]
    bad = dict(rec, steps=rec["steps"][:2] + [swapped] + rec["steps"][3:])
    assert CMP.readings(bad, "cpu")["drift_err"] > 1e-3
    still = dict(rec["steps"][2], pos=rec["steps"][1]["pos"])
    bad = dict(rec, steps=rec["steps"][:2] + [still] + rec["steps"][3:])
    assert CMP.readings(bad, "cpu")["drift_err"] > 1e-5


def test_judge_fails_a_missing_or_nonfinite_number():
    out = CMP.judge({"a": 1.0, "b": float("nan")},
                    {"a": 1.0, "b": 1.0, "c": 0})
    assert [ok for *_, ok in out] == [True, False, False]
