"""Port vs reference: the direct O(N^2) force — twins of tests/test_direct.py
on the port's plain paths, the port's ``direct`` on CPU tensors against the
reference's ``direct_jnp``, and what the kernel's wrapper refuses before
any launch.  The kernel itself runs on the card
(tests/test_torch_direct_cuda.py, chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu.ops import direct as JD
from coulomb_oscillators_tpu_torch.ops import direct as TD
from coulomb_oscillators_tpu_torch.ops.reductions import mean_rel_err

torch.set_num_threads(1)

EPS2 = 1e-18
KAPPA = 2e-6 / 1000
# csrc/direct.cu's (targets per CUDA block, resident blocks a SM) by dim
KERNEL_GEOMETRY = {2: (1024, 4), 3: (2048, 2)}


def _numpy_direct(pos, eps2, kappa, dim):
    """Independent float64 transliteration of the force law (direct.cuh:23-35)."""
    pos = np.asarray(pos, dtype=np.float64)
    d = pos[:, None, :] - pos[None, :, :]
    dist2 = np.sum(d * d, axis=-1) + eps2
    if dim == 3:
        w = dist2 ** -1.5
    elif dim == 4:
        w = dist2 ** -2.0          # 4D profile (direct.cuh:32-35)
    else:
        w = 1.0 / dist2
    return kappa * np.einsum("ij,ijd->id", w, d)


def _err(out, ref):
    return float(mean_rel_err(out, torch.as_tensor(ref, dtype=torch.float32)))


@pytest.mark.parametrize("dim", [2, 3, 4])
@pytest.mark.parametrize("n", [17, 256, 1000])
def test_direct_plain_matches_numpy_f64(dim, n, rng):
    pos = rng.normal(size=(n, dim)).astype(np.float32) * 0.01
    ref = _numpy_direct(pos, EPS2, KAPPA, dim)
    out = TD.direct_plain(torch.from_numpy(pos), EPS2, KAPPA, row_chunk=128)
    err = _err(out, ref)
    assert err < 5e-5, err


@pytest.mark.parametrize("dim", [2, 3])
def test_direct_kahan_matches_numpy_f64(dim, rng):
    n = 777
    pos = rng.normal(size=(n, dim)).astype(np.float32) * 0.01
    ref = _numpy_direct(pos, EPS2, KAPPA, dim)
    out = TD.direct_kahan(torch.from_numpy(pos), EPS2, KAPPA, src_chunk=256)
    err = _err(out, ref)
    assert err < 2e-5, err


def test_kahan_beats_naive_on_large_n(rng):
    n = 4096
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 0.003
    ref = _numpy_direct(pos, EPS2, KAPPA, 3)
    tpos = torch.from_numpy(pos)
    err_kahan = _err(TD.direct_kahan(tpos, EPS2, KAPPA), ref)
    err_naive = _err(TD.direct_plain(tpos, EPS2, KAPPA), ref)
    assert err_kahan <= err_naive * 1.5
    assert err_kahan < 1e-5


def test_momentum_conservation(rng):
    # Newton's 3rd law: total internal force sums to ~0.
    n = 512
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 0.01
    acc = TD.direct_kahan(torch.from_numpy(pos), EPS2, KAPPA).numpy()
    total = np.abs(acc.sum(axis=0))
    typical = float(np.abs(acc).mean())
    assert np.all(total < 1e-3 * typical * n)


@pytest.mark.parametrize("dim", [2, 3])
def test_direct_on_cpu_matches_direct_jnp(dim, rng):
    """A CPU tensor takes the plain version: the same f32 pair law as the
    reference's jnp path, summed in another order (torch.sum vs einsum);
    mean relative difference <= 1e-6."""
    n = 1000
    pos = rng.normal(size=(n, dim)).astype(np.float32) * 0.01
    before = TD.launches
    got = TD.direct(torch.from_numpy(pos), EPS2, KAPPA)
    ref = np.array(JD.direct_jnp(jnp.asarray(pos), EPS2, KAPPA))
    assert TD.launches == before            # the plain version never counts
    err = float(mean_rel_err(got, torch.from_numpy(ref)))
    assert err <= 1e-6, err


def test_direct_wrapper_refusals():
    """The wrapper refuses what the reference refuses (dims other than 2
    and 3) on every device, and on a non-CPU tensor anything but float32,
    before it builds or launches anything."""
    before = TD.launches
    with pytest.raises(ValueError, match="dim"):
        TD.direct(torch.zeros(8, 4), EPS2, KAPPA)
    with pytest.raises(ValueError, match="dim"):
        TD.direct(torch.zeros(8), EPS2, KAPPA)
    with pytest.raises(ValueError, match="float32"):
        TD.direct(torch.empty(8, 3, dtype=torch.float64, device="meta"),
                  EPS2, KAPPA)
    with pytest.raises(ValueError, match="device"):
        TD.direct(torch.empty(8, 3, device="meta"), EPS2, KAPPA)
    assert TD.launches == before
    # float64 stays the CPU path's (the -cpu 2D driver computes in it)
    out = TD.direct(torch.zeros(8, 2, dtype=torch.float64), EPS2, KAPPA)
    assert out.dtype == torch.float64 and TD.launches == before


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("sm", [1, 132])
@pytest.mark.parametrize("n", [1, 255, 257, 1000, 30001, 1_000_000])
def test_splits_cover_every_tile_once(n, sm, dim):
    """The kernel's source splits: S contiguous runs of `per` sources (a
    multiple of 32) that cover all n sources, none empty, within the
    grid's y limit; the grid of target blocks x S fills its last wave of
    the card's resident slots to >= 90% from the CLI's N up.  The
    geometry is the kernel's on the H100 (tests/test_torch_direct_cuda.py
    checks it)."""
    tpb, bps = KERNEL_GEOMETRY[dim]
    S, per = TD.splits_for(n, sm, tpb, bps)
    blocks = -(-n // tpb)
    slots = sm * bps
    assert 1 <= S <= 65535 and per >= 1 and per % 32 == 0
    assert S * per >= n and (S - 1) * per < n
    fill = blocks * S / (-(-(blocks * S) // slots) * slots)
    if sm == 132 and n >= 30001:
        assert fill >= 0.9, fill
    if sm == 132 and n == 30001:
        assert blocks == (15 if dim == 3 else 30)
        assert blocks * S >= 0.9 * slots   # fills the card at the CLI's N


def test_forced_splits_refuse_an_empty_split():
    """A forced split count that would leave a split empty raises before
    anything is built or launched."""
    before = TD.launches
    with pytest.raises(ValueError, match="empty"):
        TD.launch(torch.zeros(5, 3), EPS2, KAPPA, splits=4)
    assert TD.launches == before
