"""Port vs reference: the six reductions of ops/reductions.py.

The same numpy arrays go through the JAX functions and the port's torch
functions; float32 results agree to rtol 1e-6 (elementwise arithmetic is
the same, sums run in another order), float64 to 1e-12.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu.ops import reductions as JR
from coulomb_oscillators_tpu_torch.ops import reductions as TR

torch.set_num_threads(1)

SHAPES = [(512, 3), (2048, 2), (1, 3)]


def _pair(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape).astype(dtype)
    b = (a + 1e-3 * rng.normal(size=shape)).astype(dtype)
    return a, b


def _check(got, ref, dtype):
    rtol = 1e-6 if dtype == np.float32 else 1e-12
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    assert got.dtype == dtype
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=0)


@pytest.fixture(params=[np.float32, np.float64], ids=["f32", "f64"])
def dtype(request):
    if request.param == np.float64:
        prev = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        yield request.param
        jax.config.update("jax_enable_x64", prev)
    else:
        yield request.param


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", ["rel_diff1", "rel_diff2", "mean_rel_err",
                                  "rel_err_l2"])
def test_pair_reductions_match(name, shape, dtype):
    a, b = _pair(shape, dtype, 11)
    got = getattr(TR, name)(torch.from_numpy(a), torch.from_numpy(b))
    ref = getattr(JR, name)(jnp.asarray(a), jnp.asarray(b))
    assert got.shape == ref.shape
    _check(got, ref, dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_minmax_matches(shape, dtype):
    a, _ = _pair(shape, dtype, 12)
    got, ref = TR.minmax(torch.from_numpy(a)), JR.minmax(jnp.asarray(a))
    for g, r in zip(got, ref):
        assert g.shape == (shape[1],)
        assert np.array_equal(g.numpy(), np.asarray(r))     # exact: no sums


@pytest.mark.parametrize("expo", [1.0, 2.0, 0.5, 3.0])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pow_reduce_matches(shape, expo, dtype):
    a, _ = _pair(shape, dtype, 13)
    got = TR.pow_reduce(torch.from_numpy(a), expo)
    ref = JR.pow_reduce(jnp.asarray(a), expo)
    assert got.shape == ()
    _check(got, ref, dtype)


def test_known_values():
    """The metrics' definitions on hand-made rows."""
    ref = torch.tensor([[3.0, 4.0, 0.0], [0.0, 0.0, 2.0]])
    test = torch.tensor([[3.0, 4.0, 5.0], [0.0, 0.0, 1.0]])
    assert torch.allclose(TR.rel_diff1(test, ref), torch.tensor([1.0, 0.5]))
    assert float(TR.mean_rel_err(test, ref)) == pytest.approx(0.75)
    assert float(TR.rel_err_l2(test, ref)) == pytest.approx(
        (26.0 / 29.0) ** 0.5)
    mn, mx = TR.minmax(test)
    assert mn.tolist() == [0.0, 0.0, 1.0] and mx.tolist() == [3.0, 4.0, 5.0]
    assert float(TR.pow_reduce(torch.tensor([-2.0, 3.0]), 2.0)) == 13.0
