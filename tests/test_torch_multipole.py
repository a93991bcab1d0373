"""Port vs reference: the multipole tables and the operators the kd engine
calls, for p = 1..7 (p = 7 exercises the dense branches above
SPARSE_P_MAX), dim 2 and 3, float32 and float64, on the same seeded inputs.

The port sums each operator's table terms with one matmul where the
reference adds them one by one, so results differ only by summation order:
float32 is held to 1e-5 relative to max |out|, float64 to 1e-12.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu.ops.multipole import harmonics as JH
from coulomb_oscillators_tpu.ops.multipole import operators as JO
from coulomb_oscillators_tpu.ops.multipole import packing as JP
from coulomb_oscillators_tpu.ops.multipole.tables import build_tables as jbt
from coulomb_oscillators_tpu_torch.ops.multipole import harmonics as TH
from coulomb_oscillators_tpu_torch.ops.multipole import operators as TO
from coulomb_oscillators_tpu_torch.ops.multipole import packing as TP
from coulomb_oscillators_tpu_torch.ops.multipole.tables import build_tables as tbt

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.fixture(autouse=True)
def _x64():
    """float64 on the reference side needs jax_enable_x64 (the reference's
    own pattern, tests/test_multipole.py); restore it after each test."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", range(1, 8))
def test_tables_bit_equal(dim, p):
    for nd in (False, True):
        a, b = tbt(dim, p, no_dipole=nd), jbt(dim, p, no_dipole=nd)
        for f in ("S_M", "S_Mfull", "S_Lt", "S_Lf", "S_H", "maxH"):
            assert getattr(a, f) == getattr(b, f)
        for f in ("m_order", "m_slots", "nt_order", "p2m_coef", "extend_L",
                  "m2l_idx", "m2l_coef", "m2m_idx", "m2m_coef", "l2l_idx",
                  "l2l_coef", "numcoef", "m2l_W", "m2m_W", "l2l_W"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert TP.sym_layout(p, dim)[0] == JP.sym_layout(p, dim)[0]
    assert np.array_equal(TH.numerator_matrix(p, dim),
                          JH.numerator_matrix(p, dim))


def _inputs(dim, p, B=48):
    rng = np.random.default_rng(10 * p + dim)
    t = jbt(dim, p, no_dipole=True)
    return dict(
        M=rng.normal(size=(B, t.S_M)),
        Lt=rng.normal(size=(B, t.S_Lt)),
        s=rng.uniform(-0.5, 0.5, size=(B, dim)),
        rho=rng.uniform(0.3, 0.9, size=B),
        R=rng.normal(size=(B, dim)) * 3.0,
        la=rng.uniform(0.5, 1.0, size=B),
        lb=rng.uniform(0.5, 1.0, size=B),
        u=rng.uniform(-1.0, 1.0, size=(B, 5, dim)),
    )


def _close(a, b, tol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300), \
        np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", range(1, 8))
def test_operators_match(p, dim, precision):
    x = {k: v.astype(precision) for k, v in _inputs(dim, p).items()}
    J = {k: jnp.asarray(v) for k, v in x.items()}
    T = {k: torch.from_numpy(v) for k, v in x.items()}
    jt, tt = jbt(dim, p, no_dipole=True), tbt(dim, p, no_dipole=True)
    tol = TOL[precision]

    _close(TO.eval_monomial_cols(T["u"], p, dim),
           jnp.stack(JO.eval_monomial_cols(J["u"], p, dim), axis=-1), tol)
    Rh_t = T["R"] / torch.linalg.vector_norm(T["R"], dim=1, keepdim=True)
    Rh_j = J["R"] / jnp.linalg.norm(J["R"], axis=1, keepdims=True)
    _close(TH.eval_H(Rh_t, jt.maxH, dim), JH.eval_H(Rh_j, jt.maxH, dim), tol)
    _close(TO.m2m(tt, T["M"], T["s"], T["rho"]),
           JO.m2m(jt, J["M"], J["s"], J["rho"]), tol)
    _close(TO.expand_L(tt, T["Lt"]), JO.expand_L(jt, J["Lt"]), tol)
    _close(TO.l2l(tt, T["Lt"], T["s"], T["rho"]),
           JO.l2l(jt, J["Lt"], J["s"], J["rho"]), tol)
    geo_t = TO.m2l_fold_geo(tt, tuple(T["R"].unbind(1)), T["la"], T["lb"])
    geo_j = JO.m2l_fold_geo(jt, tuple(J["R"][:, d] for d in range(dim)),
                            J["la"], J["lb"])
    for a, b in zip(geo_t, geo_j):
        _close(a, b, tol)
    _close(TO.m2l_sparse_pre(tt, T["M"], *geo_t),
           JO.m2l_sparse_pre(jt, J["M"], *geo_j), tol)
    assert TO._l2p_terms(dim, p) == JO._l2p_terms(dim, p)


# ---- the operators the uniform-grid engines and the potentials call ----
# p = 1..8 (p = 7, 8 take the dense branches), dims 2 and 3, float32 and
# float64, with and without the dipole slots (the octree builds its tables
# with them, the kd engine without)

OPS_P = range(1, 9)


def _both(p, dim, precision, no_dipole, B=40):
    """Seeded inputs for both packages: (reference tables, port tables,
    jnp inputs, torch inputs)."""
    rng = np.random.default_rng(100 * p + 10 * dim + no_dipole)
    t = jbt(dim, p, no_dipole=no_dipole)
    x = dict(
        M=rng.normal(size=(B, t.S_M)), M2=rng.normal(size=(B, t.S_M)),
        Lt=rng.normal(size=(B, t.S_Lt)),
        R=rng.normal(size=(B, dim)) * 3.0,
        la=rng.uniform(0.5, 1.0, size=B), lb=rng.uniform(0.5, 1.0, size=B),
        e=rng.uniform(-1.0, 1.0, size=(B, dim)),
        q=rng.uniform(0.5, 1.5, size=B),
        w=rng.uniform(-1.0, 1.0, size=(4, 6, dim)),
        Lg=rng.normal(size=(4, t.S_Lt)), lg=rng.uniform(0.5, 1.0, size=4),
        mask=rng.uniform(size=(4, 6)) < 0.7)
    x = {k: (v if v.dtype == bool else v.astype(precision))
         for k, v in x.items()}
    return (t, tbt(dim, p, no_dipole=no_dipole),
            {k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.from_numpy(v) for k, v in x.items()})


def _sweep(p, dim):
    for precision in ("float32", "float64"):
        for nd in (False, True):
            yield (TOL[precision],) + _both(p, dim, precision, nd)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", OPS_P)
def test_p2m_contrib_and_monomials_match(p, dim):
    for tol, jt, tt, J, T in _sweep(p, dim):
        _close(TO.eval_monomials_M(tt, T["e"]), JO.eval_monomials_M(jt, J["e"]),
               tol)
        _close(TO.eval_monomials_L(tt, T["e"]), JO.eval_monomials_L(jt, J["e"]),
               tol)
        _close(TO.p2m_contrib(tt, T["e"]), JO.p2m_contrib(jt, J["e"]), tol)
        _close(TO.p2m_contrib(tt, T["e"], T["q"]),
               JO.p2m_contrib(jt, J["e"], J["q"]), tol)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", OPS_P)
def test_m2l_matches(p, dim):
    for tol, jt, tt, J, T in _sweep(p, dim):
        _close(TO.m2l(tt, T["M"], T["R"], T["la"], T["lb"]),
               JO.m2l(jt, J["M"], J["R"], J["la"], J["lb"]), tol)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", OPS_P)
def test_m2l_both_matches(p, dim):
    for tol, jt, tt, J, T in _sweep(p, dim):
        got = TO.m2l_both(tt, T["M"], T["M2"], T["R"], T["la"], T["lb"])
        ref = JO.m2l_both(jt, J["M"], J["M2"], J["R"], J["la"], J["lb"])
        for a, b in zip(got, ref):
            _close(a, b, tol)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", OPS_P)
def test_l2p_field_matches(p, dim):
    for tol, jt, tt, J, T in _sweep(p, dim):
        _close(TO.l2p_field(tt, T["Lt"], T["e"], T["la"]),
               JO.l2p_field(jt, J["Lt"], J["e"], J["la"]), tol)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", OPS_P)
def test_l2p_field_blocked_matches(p, dim):
    for tol, jt, tt, J, T in _sweep(p, dim):
        _close(TO.l2p_field_blocked(tt, T["Lg"], T["w"], T["lg"]),
               JO.l2p_field_blocked(jt, J["Lg"], J["w"], J["lg"]), tol)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", OPS_P)
def test_l2p_potential_matches(p, dim):
    for tol, jt, tt, J, T in _sweep(p, dim):
        _close(TO.l2p_potential(tt, T["Lt"], T["e"]),
               JO.l2p_potential(jt, J["Lt"], J["e"]), tol)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", OPS_P)
def test_m2p_field_and_potential_match(p, dim):
    for tol, jt, tt, J, T in _sweep(p, dim):
        _close(TO.m2p_field(tt, T["M"], T["R"], T["lb"]),
               JO.m2p_field(jt, J["M"], J["R"], J["lb"]), tol)
        _close(TO.m2p_potential(tt, T["M"], T["R"], T["lb"]),
               JO.m2p_potential(jt, J["M"], J["R"], J["lb"]), tol)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", OPS_P)
def test_column_forms_match(p, dim):
    """p2m_from_cols and l2p_field_cols: the reference takes and returns
    lists of monomial columns, the port stacks them on the last axis."""
    for tol, jt, tt, J, T in _sweep(p, dim):
        Vt = TO.eval_monomial_cols(T["w"], jt.PL, dim)
        Vj = JO.eval_monomial_cols(J["w"], jt.PL, dim)
        _close(TO.p2m_from_cols(tt, Vt, T["mask"]),
               JO.p2m_from_cols(jt, Vj, J["mask"]), tol)
        Lf_t, Lf_j = TO.expand_L(tt, T["Lg"]), JO.expand_L(jt, J["Lg"])
        _close(TO.l2p_field_cols(tt, Lf_t, Vt, T["lg"]),
               JO.l2p_field_cols(jt, Lf_j, Vj, J["lg"]), tol)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("p", [2, 5, 8])
def test_shift_operators_with_dipole_slots_match(p, dim):
    """m2m and l2l on the tables with the dipole slots (the octree's);
    test_operators_match holds them on the kd engine's no_dipole tables."""
    for tol, jt, tt, J, T in _sweep(p, dim):
        s_t, s_j = 0.3 * T["e"], 0.3 * J["e"]
        rho_t, rho_j = 0.5 + 0.2 * T["la"], 0.5 + 0.2 * J["la"]
        _close(TO.m2m(tt, T["M"], s_t, rho_t), JO.m2m(jt, J["M"], s_j, rho_j),
               tol)
        _close(TO.l2l(tt, T["Lt"], s_t, rho_t),
               JO.l2l(jt, J["Lt"], s_j, rho_j), tol)
