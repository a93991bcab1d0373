"""The mesh-mode Simulator's step, cut at its collectives, on CPU ranks.

On CUDA tensors the mesh-mode step runs as CUDA graphs, one segment
between two collectives (``utils/graphs.py``, ``simulate.py``).  CUDA
graphs have no CPU mode, so here the conditions for that are checked on two
gloo CPU ranks (one spawn for the module; the rank side is
tests/torch_parallel_workers.py), with the capture lint's recorder
(tests/test_torch_capture_lint.py) and its ``FORBIDDEN`` list:

  * no segment of the step issues a forbidden ATen operation (a
    collective's own staging runs between two segments, unrecorded);
  * every rank issues the same collectives a force evaluation, in the same
    order: one all_gather, one all_reduce_sum, one ring_shift a halo hop;
  * each segment's operations (names and shapes) are the same at steps 1
    and 2 of a window, after the pipeline's priming refresh and after an
    adopted background re-sort, for fmm3_kd and fmm2_kd;
  * the re-capture vote is true on both ranks when only one rank's capture
    key changed;
  * the near field's padded entry list (what CPU ranks sum) is
    bitwise the plain sum over the rank's CSR.

No JAX.
"""

import pytest
import torch

import torch_parallel_workers as W
from coulomb_oscillators_tpu_torch.parallel import mesh as PM

torch.set_num_threads(1)

N = 2048
CASES = {"fmm3_kd": ("fmm3_kd", N, 3), "fmm2_kd": ("fmm2_kd", N, 2)}


@pytest.fixture(scope="module")
def ranks():
    return PM.spawn(W.mesh_graph_scenarios, 2, CASES, device="cpu",
                    timeout=300)


@pytest.mark.parametrize("engine", sorted(CASES))
def test_mesh_step_segments_are_capture_clean(ranks, engine):
    r = ranks[engine]
    assert r["bad"] == []
    assert r["eager"]                              # the CPU has no graphs
    assert r["rebuilds"] == {"sync_refresh": 1, "adopt_full": 1}


@pytest.mark.parametrize("engine", sorted(CASES))
def test_mesh_step_collectives_per_force_evaluation(ranks, engine):
    r = ranks[engine]
    want = ["all_gather", "all_reduce_sum"] + ["ring_shift"] * len(r["halo"])
    assert all(c == want for c in r["cuts"]), r["cuts"]
    assert r["segments"] == [len(want) + 1] * 4
    assert r["cuts_equal_across_ranks"]


@pytest.mark.parametrize("engine", sorted(CASES))
def test_mesh_step_segments_repeat_across_adoptions(ranks, engine):
    """Steps 2, after the priming refresh and after the adopted re-sort
    issue step 1's operations on step 1's shapes, segment by segment."""
    assert ranks[engine]["same_ops"] == [True, True, True]


def test_recapture_vote_is_rank_consistent(ranks):
    assert not ranks["changed_here"]            # the ranks' keys differ
    assert ranks["votes"] == [True, False, True]
    assert ranks["votes_equal"]


@pytest.mark.parametrize("dim", [2, 3])
def test_sharded_entries_sum_equals_csr_sum(ranks, dim):
    assert ranks["entries"][dim]
