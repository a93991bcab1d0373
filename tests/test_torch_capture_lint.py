"""The Simulator's window step is capture-clean, on the CPU.

A CUDA graph replays the work a step queued on the card when it was
captured, so the step may not wait for the card (a host read of a device
value, a data-dependent shape), may not copy between devices, and must
issue the same operations on the same shapes at every step.  Here every
single-device path's step runs under a ``TorchDispatchMode`` that records
each ATen operation: for the plain engine ("direct"), the kd engines
("fmm3_kd", "fmm2_kd") and the uniform-grid engines ("fmm3",
"fmm3_traceless", "appel") at N=2048.  Steps 1 and 2 must issue no
``nonzero``, ``_local_scalar_dense`` (``.item()``), ``lift_fresh`` (a
tensor made from Python data), ``masked_select``, ``unique`` or
device-changing copy, and the same operation sequence (names and shapes);
the sequence stays the same after the tree is replaced at a window
boundary (the kd pipeline's priming refresh and an adopted background
re-sort with its repad; a synchronous rebuild for the grid engines).  The
kd engines are checked again with the stored-fold M2L (``CO_M2L_FLY=0``),
whose step refolds the M2L geometry in its geometry refresh.

The plain P2P sum that the kd engine runs on its padded pair list equals
the CSR form's bitwise on the CPU.  No JAX.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from coulomb_oscillators_tpu_torch import SimConfig
from coulomb_oscillators_tpu_torch.models import init_dist as ID
from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import FAR, KdFmmEngine
from coulomb_oscillators_tpu_torch.simulate import Simulator
from coulomb_oscillators_tpu_torch.state import particle_state_from_numpy

torch.set_num_threads(1)

N = 2048
FORBIDDEN = ("nonzero", "_local_scalar_dense", "lift_fresh",
             "lift_fresh_copy", "masked_select", "unique", "_unique",
             "_unique2", "unique_dim", "unique_consecutive", "equal",
             "is_nonzero")
ENGINES = {"direct": 3, "fmm3_kd": 3, "fmm2_kd": 2, "fmm3": 3,
           "fmm3_traceless": 3, "appel": 3}


def _devices(x):
    out = []
    for a in x if isinstance(x, (list, tuple)) else (x,):
        if isinstance(a, torch.Tensor):
            out.append(a.device)
        elif isinstance(a, (list, tuple)):
            out.extend(_devices(a))
    return out


def _shapes(x):
    out = []
    for a in x if isinstance(x, (list, tuple)) else (x,):
        if isinstance(a, torch.Tensor):
            out.append(tuple(a.shape))
        elif isinstance(a, (list, tuple)):
            out.extend(_shapes(a))
    return tuple(out)


class _Recorder(TorchDispatchMode):
    """Every ATen operation as (name, input shapes, output shapes), and
    the forbidden ones and the device-changing copies apart."""

    def __init__(self):
        super().__init__()
        self.ops, self.bad = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        self.ops.append((name, _shapes(list(args)), _shapes(out)))
        if name in FORBIDDEN:
            self.bad.append(name)
        if name in ("_to_copy", "copy_", "to", "_copy_from"):
            devs = set(_devices(list(args)) + _devices(out))
            if len(devs) > 1:
                self.bad.append(f"{name} across {sorted(map(str, devs))}")
        return out


def _record(fn):
    rec = _Recorder()
    with rec:
        fn()
    assert not rec.bad, rec.bad
    assert rec.ops
    return rec.ops


def _config(engine, dim):
    kd = engine.endswith("_kd")
    return SimConfig(dim=dim, fmm_order=3, tree_radius=2.0 if kd else 1.0,
                     tree_steps=3, omega0=(1.0,) * dim,
                     **({"tree_async": True} if kd else {}))


def _state(engine, dim):
    """The Gaussian beam for the kd and plain engines; a uniform box for
    the uniform-grid ones (a beam would crowd their cubic grid's cells)."""
    x_std = (0.003, 0.001, 0.01)[:dim]
    pos, vel = ID.init_gaussian(N, x_std, x_std, dim=dim, seed=3)
    if engine in ("fmm3", "fmm3_traceless", "appel"):
        pos = np.random.default_rng(3).uniform(
            -0.01, 0.01, size=(N, dim)).astype(np.float32)
    return particle_state_from_numpy(pos, vel, device="cpu")


@pytest.mark.parametrize("engine", list(ENGINES))
def test_window_step_is_capture_clean(engine):
    _assert_capture_clean(engine)


@pytest.mark.parametrize("engine", ["fmm3_kd", "fmm2_kd"])
def test_window_step_is_capture_clean_with_the_stored_fold(monkeypatch,
                                                           engine):
    """The same checks with the stored-fold M2L (CO_M2L_FLY=0): the
    step's geometry refresh folds the M2L geometry again and its force
    reads the fold."""
    monkeypatch.setenv("CO_M2L_FLY", "0")
    sim = _assert_capture_clean(engine)
    fs = sim._fstate
    assert not sim._fmm.m2l_fly
    assert fs.m2l_h2.shape == (fs.m2l_tgt.shape[0], sim._fmm.tables.S_H)


def _assert_capture_clean(engine):
    """Steps of `engine`'s Simulator before and after its tree is replaced
    issue no forbidden operation and the same sequence; returns the closed
    Simulator."""
    dim = ENGINES[engine]
    sim = Simulator(_config(engine, dim), N, engine=engine)
    try:
        st = sim.init_acc(_state(engine, dim))
        if engine.endswith("_kd"):
            sim.advance_padded(1)                      # warm-up
            steps = [_record(lambda: sim.advance_padded(1)),
                     _record(lambda: sim.advance_padded(1))]
            sim.start_window()                         # priming refresh
            assert sim.rebuilds["sync_refresh"] == 1
            steps.append(_record(lambda: sim.advance_padded(1)))
            sim.advance_padded(2)
            sim.start_window()                         # adopted re-sort
            assert sim.rebuilds["adopt_full"] == 1, dict(sim.rebuilds)
            steps.append(_record(lambda: sim.advance_padded(1)))
        else:
            box = [sim.run(st, 1)]                     # warm-up

            def step():
                box[0] = sim.run(box[0], 1)

            steps = [_record(step), _record(step)]
            if sim._fmm is not None:
                step()                                 # rebuild + step
                assert sim.rebuilds["sync_full"] == 1
                steps.append(_record(step))
        for i, ops in enumerate(steps[1:], 2):
            assert ops == steps[0], f"step {i} differs from step 1"
        assert sim.graph is None                       # eager on the CPU
    finally:
        sim.close()
    return sim


@pytest.mark.parametrize("dim", [3, 2])
def test_padded_list_sum_equals_csr_sum(dim):
    """The kd engine's near field over its padded pair list (pad entries:
    the dummy target, lane mask 0) is bitwise the plain sum over the CSR's
    valid prefix."""
    x_std = (0.003, 0.001, 0.01)[:dim]
    pos_h, _ = ID.init_gaussian(N, x_std, x_std, dim=dim, seed=4)
    cfg = SimConfig(dim=dim, fmm_order=3, tree_radius=2.0,
                    omega0=(1.0,) * dim)
    eng = KdFmmEngine(cfg, N)
    pos = torch.from_numpy(pos_h)
    fs = eng.build(pos)
    assert int(fs.p2p_valid.sum()) < fs.p2p_tgt.shape[0]   # pads exist
    pblk = eng.pad_array(pos, fs, fill=FAR).reshape(eng.G_blk, eng.C_blk,
                                                    dim)
    csr = p2p_cuda.p2p_plain(pblk, fs.p2p_row_ptr, fs.p2p_col2d, eng.nsub,
                             cfg.eps2)
    lst = p2p_cuda.p2p_plain_entries(pblk, fs.p2p_tgt, fs.p2p_src,
                                     eng.nsub, cfg.eps2)
    assert torch.equal(lst, csr)
    ppad = pblk.reshape(eng.G_sub, eng.st.C, dim)
    assert torch.equal(eng._stage_p2p(ppad, fs), csr.reshape(ppad.shape))
