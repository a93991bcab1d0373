"""The P2P pass's plain PyTorch version against a float64 numpy sum on
seeded synthetic partner lists (pads, the sentinel, empty and clamped
rows, every lane-group mask), in dims 3 and 2, and the wrapper's dispatch
on a CPU tensor.  CPU only, no JAX."""

import numpy as np
import pytest
import torch

from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
from torch_p2p_lists import brute, rel_dev, synthetic

torch.set_num_threads(1)

EPS2 = 1e-18
TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.mark.parametrize("dim", [3, 2], ids=["dim3", "dim2"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("CB", [128, 256])
@pytest.mark.parametrize("nsub", [1, 2, 4, 8])
def test_plain_matches_float64_sum(nsub, CB, dtype, dim):
    """max|da| / max|a| <= 1e-5 in float32 and 1e-12 in float64 against
    the entry-by-entry float64 sum (weight r^3 in dim 3, r^2 in dim 2);
    the wrapper takes the plain version on a CPU tensor."""
    pos, rp, col = synthetic(nsub, CB, dtype=dtype, seed=nsub * CB, dim=dim)
    ref = brute(pos, rp, col, nsub, EPS2)
    args = (torch.from_numpy(pos), torch.from_numpy(rp),
            torch.from_numpy(col), nsub, EPS2)
    got = p2p_cuda.p2p_plain(*args)
    assert got.dtype == torch.from_numpy(pos).dtype
    assert rel_dev(got.numpy(), ref) <= TOL[dtype]
    assert torch.equal(p2p_cuda.p2p(*args), got)


@pytest.mark.parametrize("dim", [3, 2], ids=["dim3", "dim2"])
@pytest.mark.parametrize("nsub,CB", [(4, 128), (1, 256)])
def test_pair_counts(nsub, CB, dim):
    """pair_counts against a loop over the same lists, in either dim."""
    pos, rp, col = synthetic(nsub, CB, seed=7, dim=dim)
    C = CB // nsub
    Gb = pos.shape[0]
    real = (pos[..., 0] < p2p_cuda.PAD_X).reshape(-1, C).sum(1)
    cols = col.view(np.uint32)
    entries = pairs = real_pairs = 0
    for row in range(Gb * nsub):
        for e in range(min(rp[row + 1] - rp[row], cols.shape[1])):
            v = int(cols[row, e])
            blk, bits = v & ((1 << (32 - nsub)) - 1), v >> (32 - nsub)
            entries += 1
            if blk >= Gb:
                continue
            for q in range(nsub):
                if (bits >> q) & 1:
                    pairs += C * C
                    real_pairs += int(real[row]) * int(real[blk * nsub + q])
    got = p2p_cuda.pair_counts(torch.from_numpy(pos), torch.from_numpy(rp),
                               torch.from_numpy(col), nsub)
    assert (got["entries"], got["pairs"], got["real_pairs"]) == (
        entries, pairs, real_pairs)
    assert got["bytes"] == 2 * pos.nbytes + 4 * (entries + rp.shape[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_dispatch_cpu_dim2_is_plain_and_bad_dim_raises(dtype):
    """On a CPU tensor p2p_cuda.p2p with [Gb, CB, 2] is bitwise p2p_plain
    and launches nothing; [Gb, CB, 4] raises before any dispatch."""
    pos, rp, col = synthetic(4, 128, seed=11, dim=2)
    args = (torch.from_numpy(pos).to(dtype), torch.from_numpy(rp),
            torch.from_numpy(col), 4, EPS2)
    before = (p2p_cuda.launches, p2p_cuda.launches_2d)
    got = p2p_cuda.p2p(*args)
    assert (p2p_cuda.launches, p2p_cuda.launches_2d) == before
    assert got.shape == args[0].shape and got.dtype == dtype
    assert torch.equal(got, p2p_cuda.p2p_plain(*args))
    wide = torch.zeros(pos.shape[:2] + (4,), dtype=dtype)
    with pytest.raises(ValueError, match="Gb, CB, 2"):
        p2p_cuda.p2p(wide, *args[1:])
