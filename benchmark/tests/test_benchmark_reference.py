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


def _coulomb_3d_before(pos, targets, eps2, kappa, device,
                       dtype=torch.float64, block_elements=1 << 26):
    """A frozen copy of the 3D-only ``coulomb`` the cells were measured
    with before the reference took 2D (block size as an argument)."""
    src = R._tensor(pos, device, dtype)
    tgt = src[R._tensor(targets, device, torch.int64)]
    n = src.shape[0]
    xs, ys, zs = src[:, 0], src[:, 1], src[:, 2]
    e2 = torch.tensor(eps2, dtype=dtype, device=device)
    block = max(1, block_elements // max(n, 1))
    out = []
    for i in range(0, tgt.shape[0], block):
        t = tgt[i:i + block]
        dx = t[:, 0:1] - xs
        dy = t[:, 1:2] - ys
        dz = t[:, 2:3] - zs
        r2 = dx * dx + dy * dy + dz * dz + e2
        w = torch.rsqrt(r2)
        w = w * w * w
        out.append(torch.stack([(dx * w).sum(1), (dy * w).sum(1),
                                (dz * w).sum(1)], 1))
    k = torch.tensor(kappa, dtype=dtype, device=device)
    return (torch.cat(out) * k).to(torch.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16],
                         ids=["float64", "bfloat16"])
@pytest.mark.parametrize("block", [1 << 26, 7 * 300])
def test_coulomb_3d_is_bitwise_the_frozen_function(monkeypatch, dtype,
                                                   block):
    """The 3D sum runs the operations it ran before it took 2D, in the
    same order and blocks: every bit of the reference and of the control
    is unchanged, so no existing cell reads differently."""
    monkeypatch.setattr(R, "BLOCK_ELEMENTS", block)
    for seed in (3, 2 ** 31 + 7):
        pos, _ = _beam(300, seed)
        tg = np.sort(np.random.default_rng(seed).choice(300, 40, False))
        for targets in (tg, np.arange(300)):
            got = R.coulomb(pos, targets, EPS2, KAPPA, "cpu", dtype)
            want = _coulomb_3d_before(pos, targets, EPS2, KAPPA, "cpu",
                                      dtype, block)
            assert got.dtype == want.dtype == torch.float64
            assert torch.equal(got.view(torch.int64),
                               want.view(torch.int64))


def _numpy_coulomb_2d(pos, targets, eps2, kappa):
    x = pos.astype(np.float64)
    out = np.zeros((len(targets), 2))
    for i, t in enumerate(targets):
        for s in range(x.shape[0]):
            d = x[t] - x[s]
            out[i] += d / (d @ d + eps2)
    return out * kappa


def test_coulomb_2d_equals_a_float64_numpy_sum(monkeypatch):
    """In 2D the law is kappa d / (|d|^2 + eps2), the gradient of -log r,
    self pair included (it adds 0); blocks do not change the sum."""
    pos, _ = _beam(300, 11)
    pos = np.ascontiguousarray(pos[:, :2])
    tg = np.array([0, 7, 150, 299])
    eps2, kappa = 1e-18, 9.29e-4 / 300
    want = _numpy_coulomb_2d(pos, tg, eps2, kappa)
    got = R.coulomb(pos, tg, eps2, kappa, "cpu")
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    monkeypatch.setattr(R, "BLOCK_ELEMENTS", 300)
    np.testing.assert_array_equal(R.coulomb(pos, tg, eps2, kappa, "cpu"),
                                  got)
    ctl = R.coulomb(pos, tg, eps2, kappa, "cpu", torch.bfloat16)
    err = float(((ctl - got).norm(dim=1) / got.norm(dim=1)).mean())
    assert 1e-3 < err < 1.0
    with pytest.raises(ValueError, match="dimension 4"):
        R.coulomb(np.zeros((5, 4), np.float32), tg[:1], eps2, kappa, "cpu")


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


@pytest.mark.parametrize("dim", [3, 2])
def test_a_snapshot_short_of_a_particle_misses_every_value(tmp_path, dim):
    """A snapshot file one particle short reads 2 x dim values missing."""
    pos, vel = (np.ascontiguousarray(a[:, :dim]) for a in _beam(50))
    path = tmp_path / "out0_0.000500.bin"
    path.write_bytes(pos[:-1].tobytes() + vel[:-1].tobytes())
    rec = {"dt": DT, "eps2": EPS2, "kappa": KAPPA,
           "omega0_sq": OMEGA0_SQ[:dim], "targets": np.arange(50),
           "start": None,
           "steps": [{"pos": pos, "vel": vel, "acc": pos, "force": False}],
           "snapshot": {"path": str(path), "pos": pos, "vel": vel}}
    assert CMP.readings(rec, "cpu")["snapshot_mismatch"] == 2 * dim
    path.write_bytes(pos.tobytes() + vel.tobytes())
    assert CMP.readings(rec, "cpu")["snapshot_mismatch"] == 0


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
