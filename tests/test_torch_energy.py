"""Port vs reference: the energy diagnostics (twins of tests/test_energy.py
and of the potential test in tests/test_fmm_kd.py), and the kd engine's
``potential`` fed the reference's own state."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu.models import init_dist as ID
from coulomb_oscillators_tpu.ops import energy as JE
from coulomb_oscillators_tpu.ops.fmm.kdtree import KdFmmEngine as JEngine
from coulomb_oscillators_tpu_torch import SimConfig as TConfig
from coulomb_oscillators_tpu_torch.models import oscillator as TM
from coulomb_oscillators_tpu_torch.ops import direct as TD
from coulomb_oscillators_tpu_torch.ops import energy as TE
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import (
    KdFmmEngine, fmm_state_from_numpy)
from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err
from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

torch.set_num_threads(1)

ARGS = (1e-18, 2e-6 / 1000, (1.2, 1.0, 1.0))
ARGS2 = (1e-18, 2e-6 / 1000, (1.2, 1.0))
X_STD = (0.003, 0.001, 0.01)
N_KD = 1500


def _state(n=1000, seed=3, dim=3):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(n, dim)) * 0.01).astype(np.float32)
    vel = (rng.normal(size=(n, dim)) * 0.001).astype(np.float32)
    return pos, vel


def _brute(pos, vel, eps2, kappa, om2):
    p = pos.astype(np.float64)
    d = p[:, None, :] - p[None, :, :]
    d2 = (d * d).sum(-1) + eps2
    phi = 1.0 / np.sqrt(d2)
    np.fill_diagonal(phi, 0.0)
    return (0.5 * np.sum(vel.astype(np.float64) ** 2)
            + 0.5 * np.sum(p * p * np.asarray(om2))
            + 0.5 * kappa * phi.sum())


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_f64_oracle_matches_brute_force():
    pos, vel = _state()
    got = TE.total_energy_f64(pos, vel, *ARGS)
    assert _rel(got, _brute(pos, vel, *ARGS)) < 1e-14


@pytest.mark.parametrize("dim", [2, 3])
def test_f64_oracle_equals_reference(dim):
    """The same numpy code: equal to 1e-14 (tensor input too)."""
    pos, vel = _state(n=700, dim=dim)
    args = ARGS if dim == 3 else ARGS2
    want = JE.total_energy_f64(pos, vel, *args)
    assert _rel(TE.total_energy_f64(pos, vel, *args), want) < 1e-14
    assert _rel(TE.total_energy_f64(torch.from_numpy(pos),
                                    torch.from_numpy(vel), *args), want) < 1e-14


@pytest.mark.parametrize("dim", [2, 3])
def test_potential_rows_kahan_matches_reference(dim):
    """Both compensated; per-chunk sums in another order: <= 1e-6 per row."""
    pos, _ = _state(n=700, dim=dim)
    got = TE.potential_rows_kahan(torch.from_numpy(pos), 1e-18).numpy()
    ref = np.asarray(JE.potential_rows_kahan(jnp.asarray(pos), 1e-18))
    assert np.max(np.abs(got - ref) / np.abs(ref)) <= 1e-6


def test_total_energy_kahan_matches_reference():
    pos, vel = _state()
    got = TE.total_energy_kahan(torch.from_numpy(pos),
                                torch.from_numpy(vel), *ARGS)
    assert _rel(got, JE.total_energy_kahan(pos, vel, *ARGS)) <= 1e-9


def test_kahan_hybrid_matches_oracle():
    pos, vel = _state()
    got = TE.total_energy_kahan(pos, vel, *ARGS)
    want = TE.total_energy_f64(pos, vel, *ARGS)
    # device rows are f32 (but Kahan-compensated): ~1e-9 total is expected,
    # two orders below the 1e-6 certification bound
    assert _rel(got, want) < 3e-9


def test_kahan_rows_exclude_self_term():
    pos, _ = _state(n=700)
    rows = TE.potential_rows_kahan(torch.from_numpy(pos), 1e-18).numpy()
    # a self term would add 1/eps = 1e9 per row; rows must stay O(1e2-1e5)
    assert np.all(rows < 1e8)
    p = pos.astype(np.float64)
    d = p[:, None, :] - p[None, :, :]
    phi = 1.0 / np.sqrt((d * d).sum(-1) + 1e-18)
    np.fill_diagonal(phi, 0.0)
    want = phi.sum(axis=1)
    assert (np.abs(rows - want) / np.abs(want)).max() < 1e-5


@pytest.mark.parametrize("dim", [2, 3])
def test_coulomb_potential_and_total_energy_match(dim):
    """float32 chunk sums in another order: <= 1e-5 relative."""
    pos, vel = _state(n=600, dim=dim)
    args = ARGS if dim == 3 else ARGS2
    tp, tv = torch.from_numpy(pos), torch.from_numpy(vel)
    got = float(TE.coulomb_potential(tp, args[0], args[1], row_chunk=128))
    ref = float(JE.coulomb_potential(jnp.asarray(pos), args[0], args[1],
                                     row_chunk=128))
    assert _rel(got, ref) <= 1e-5
    got = float(TE.total_energy(tp, tv, *args))
    ref = float(JE.total_energy(jnp.asarray(pos), jnp.asarray(vel), *args))
    assert _rel(got, ref) <= 1e-5


@pytest.fixture(scope="module")
def beam():
    pos, vel = ID.init_gaussian(N_KD, X_STD, X_STD)
    return pos, vel


def test_kd_potential_matches_reference(beam):
    """The port's potential on the reference's own state (same lists): the
    reference subtracts the self term 1/sqrt(eps2) = 1e9 from a float32
    row sum after the fact (a float32 step of 64 there), the port drops
    the self pair inside its near-field sum, so the two agree only to the
    reference's own error: mean relative difference <= 2e-3."""
    pos, _ = beam
    cfg = dict(fmm_order=5, tree_radius=2.5)
    jeng = JEngine(JConfig(**cfg), N_KD, use_pallas=True)
    jfs = jeng.build(jnp.asarray(pos))
    ref = np.asarray(jeng.potential(jnp.asarray(pos), jfs))
    fs = fmm_state_from_numpy({f: np.asarray(getattr(jfs, f))
                               for f in jfs._fields}, "cpu")
    got = KdFmmEngine(TConfig(**cfg), N_KD).potential(
        torch.from_numpy(pos), fs).numpy()
    assert got.shape == (N_KD,)
    assert np.mean(np.abs(got - ref) / np.abs(ref)) <= 2e-3


def test_fmm_potential_vs_direct(beam):
    """Twin of tests/test_fmm_kd.py::test_fmm_potential_vs_direct."""
    pos, _ = beam
    cfg = TConfig(fmm_order=5, tree_radius=2.5)
    eng = KdFmmEngine(cfg, N_KD)
    tpos = torch.from_numpy(pos)
    phi = eng.potential(tpos, eng.build(tpos)).numpy()
    P = pos.astype(np.float64)
    d = P[:, None, :] - P[None, :, :]
    r = np.sqrt((d ** 2).sum(-1) + cfg.eps2)
    np.fill_diagonal(r, np.inf)
    phiref = cfg.kappa(N_KD) * (1.0 / r).sum(1)
    err = np.abs(phi - phiref) / np.abs(phiref)
    assert err.mean() < 2e-3, err.mean()


def test_kd_potential_ncoll_and_fmm_energy(beam):
    """coll=False: an empty P2P list leaves the far field alone, with no
    self term to remove; total_energy_fmm tracks the pairwise Hamiltonian
    within the potential's own error."""
    pos, vel = beam
    cfg = TConfig(fmm_order=5, tree_radius=2.5)
    tpos = torch.from_numpy(pos)
    eng = KdFmmEngine(cfg.replace(coll=False), N_KD)
    fs = eng.build(tpos)
    assert int(fs.p2p_valid.sum()) == 0
    assert bool(torch.isfinite(eng.potential(tpos, fs)).all())
    eng = KdFmmEngine(cfg, N_KD)
    st = particle_state_from_numpy(pos, vel, device="cpu")
    e_fmm = float(TM.total_energy_fmm(cfg, st, eng, eng.build(tpos)))
    e_ref = TE.total_energy_f64(pos, vel, cfg.eps2, cfg.kappa(N_KD),
                                cfg.omega0_sq())
    assert _rel(e_fmm, e_ref) < 1e-5


def test_accuracy_grade_config_stiffens_mac():
    """Twin of tests/test_energy.py::test_accuracy_grade_config_stiffens_mac:
    at an auto-level geometry the accuracy-grade config (accuracy < 1e-4)
    selects the plateau-exact sub-leaf boost and beats the throughput
    config's force error."""
    n = 8192
    base = TConfig(fmm_order=6, tree_radius=2.5)
    u = tuple(w * xs for w, xs in zip(base.omega0, X_STD))
    pos, _ = ID.init_gaussian(n, X_STD, u, dtype=np.float32)
    pos = torch.from_numpy(pos)
    ref = TD.direct_kahan(pos, base.eps2, base.kappa(n))
    errs = {}
    for name, cfg in (("throughput", base),
                      ("accuracy", base.replace(accuracy=1e-6))):
        eng = KdFmmEngine(cfg, n)
        assert eng.sub_depth > 0, "geometry must exercise the sub-leaf MAC"
        errs[name] = float(mean_rel_err(eng.force(pos, eng.build(pos)), ref))
    assert KdFmmEngine(base.replace(accuracy=1e-6), n).mac_sub_boost == 2.0
    assert errs["accuracy"] < errs["throughput"], errs
    assert errs["accuracy"] < 2e-5, errs
