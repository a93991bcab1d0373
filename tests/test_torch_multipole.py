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
