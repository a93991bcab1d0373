"""Port vs reference: config, state, initial distributions, integrators,
trap term, reductions and the plain direct paths; plus the port's import
hygiene and chip_smoke.py's refusal to run without a GPU.

Inputs come from numpy seeds and go to both packages; the reference runs on
its CPU jnp paths (its Pallas kernels are never called).
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from coulomb_oscillators_tpu import SimConfig as JConfig
from coulomb_oscillators_tpu.models import init_dist as JID
from coulomb_oscillators_tpu.models import integrators as JI
from coulomb_oscillators_tpu.ops import direct as JD
from coulomb_oscillators_tpu.ops import elastic as JE
from coulomb_oscillators_tpu.ops import reductions as JR
from coulomb_oscillators_tpu.state import ParticleState as JState
from coulomb_oscillators_tpu_torch import SimConfig as TConfig
from coulomb_oscillators_tpu_torch.models import init_dist as TID
from coulomb_oscillators_tpu_torch.models import integrators as TI
from coulomb_oscillators_tpu_torch.ops import direct as TD
from coulomb_oscillators_tpu_torch.ops import elastic as TE
from coulomb_oscillators_tpu_torch.ops import reductions as TR
from coulomb_oscillators_tpu_torch.state import (ParticleState as TState,
                                                 particle_state_from_numpy)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_simconfig_fields_and_defaults_equal():
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TConfig)}
    assert jf == tf
    j, t = JConfig(), TConfig()
    assert t.dtype == torch.float32 and TConfig(precision="float64").dtype \
        == torch.float64
    assert (t.eps2, t.kappa(1000), t.omega0_sq()) == \
        (j.eps2, j.kappa(1000), j.omega0_sq())
    assert t.replace(fmm_order=6) == TConfig(fmm_order=6)


@pytest.mark.parametrize("bad", [dict(dim=4), dict(precision="bf16"),
                                 dict(omega0=(1.0, 1.0)), dict(fmm_order=0),
                                 dict(eps=0.0)])
def test_simconfig_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        JConfig(**bad)
    with pytest.raises(ValueError):
        TConfig(**bad)


def test_init_dist_bit_equal():
    x, u = (0.003, 0.001, 0.01), (0.0033, 0.001, 0.01)
    for a, b in zip(TID.init_gaussian(3000, x, u, seed=11),
                    JID.init_gaussian(3000, x, u, seed=11)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(TID.init_uniform(500, (-1, -2, -3), (1, 2, 3)),
                          JID.init_uniform(500, (-1, -2, -3), (1, 2, 3)))
    for a, b in zip(TID.init_kv(400, (1.0, 2.0), (0.5, 0.7)),
                    JID.init_kv(400, (1.0, 2.0), (0.5, 0.7))):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(TI.INTEGRATORS))
def test_integrator_step_matches(name):
    assert TI.INTEGRATORS[name] == JI.INTEGRATORS[name]
    assert TI.FORCE_EVALS[name] == JI.FORCE_EVALS[name]
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(64, 3)).astype(np.float32)
    vel = rng.normal(size=(64, 3)).astype(np.float32)
    acc = rng.normal(size=(64, 3)).astype(np.float32)
    w2 = (1.2, 0.9, 1.0)
    jstep = JI.make_step(lambda p: JE.elastic(p, w2), name, 5e-3)
    tstep = TI.make_step(lambda p: TE.elastic(p, w2), name, 5e-3)
    js = JState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(acc))
    ts = particle_state_from_numpy(pos, vel, acc, device="cpu")
    for _ in range(3):
        js, ts = jstep(js), tstep(ts)
    # f32 elementwise arithmetic in the same order; 1e-6 allows XLA's
    # fused multiply-adds against torch's separate rounding
    for a, b in zip(ts, js):
        assert _rel(a.numpy(), b) < 1e-6


def test_elastic_and_reductions_match():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(200, 3)).astype(np.float32)
    b = (a + 1e-3 * rng.normal(size=(200, 3))).astype(np.float32)
    w2 = (1.1, 0.8, 1.3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    # elementwise f32: identical operations, 1e-6 covers contraction
    assert _rel(TE.elastic(ta, w2), JE.elastic(ja, w2)) < 1e-6
    assert _rel(TE.add_elastic(ta, tb, w2), JE.add_elastic(ja, jb, w2)) < 1e-6
    for f, g in ((TR.rel_diff1, JR.rel_diff1), (TR.rel_diff2, JR.rel_diff2),
                 (TR.mean_rel_err, JR.mean_rel_err)):
        # reductions over 3 components / 200 rows in another order
        assert _rel(f(ta, tb), g(ja, jb)) < 1e-6


def test_particle_state_create():
    pos = np.ones((4, 3), np.float32)
    st = TState.create(pos, 2 * pos, device="cpu")
    assert st.n == 4 and st.dim == 3 and float(st.acc.abs().sum()) == 0.0
    # a tensor keeps its device without a device argument
    assert TState.create(st.pos, st.vel).pos.device.type == "cpu"


@pytest.mark.parametrize("build", [
    lambda p, v, **kw: particle_state_from_numpy(p, v, **kw),
    lambda p, v, **kw: TState.create(p, v, **kw)],
    ids=["particle_state_from_numpy", "ParticleState.create"])
def test_state_builders_default_to_the_card(build):
    """Host arrays go to cuda:0 unless a device is named: without a card
    the default raises (never a quiet CPU state); device="cpu" works."""
    pos = np.ones((4, 3), np.float32)
    if torch.cuda.is_available():
        st = build(pos, 2 * pos)
        assert all(t.device == torch.device("cuda", 0) for t in st)
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build(pos, 2 * pos)
    st = build(pos, 2 * pos, device="cpu")
    assert all(t.device.type == "cpu" for t in st)
    assert torch.equal(st.vel, torch.from_numpy(2 * pos))


@pytest.fixture(scope="module")
def cloud():
    x = (0.003, 0.001, 0.01)
    pos, _ = TID.init_gaussian(900, x, x, seed=3)
    return pos


def test_direct_plain_matches_direct_jnp(cloud):
    eps2, kappa = 1e-18, 2e-6 / 900
    got = TD.direct_plain(torch.from_numpy(cloud), eps2, kappa, row_chunk=256)
    ref = JD.direct_jnp(jnp.asarray(cloud), eps2, kappa, row_chunk=256)
    # f32 sums over 900 sources in another order (torch.sum vs einsum)
    assert _rel(got, ref) < 1e-5


def test_direct_kahan_matches(cloud):
    eps2, kappa = 1e-18, 2e-6 / 900
    got = TD.direct_kahan(torch.from_numpy(cloud), eps2, kappa)
    ref = JD.direct_kahan(jnp.asarray(cloud), eps2, kappa)
    # both compensated; per-chunk sums still differ in order
    assert _rel(got, ref) < 1e-5


def test_direct_kahan_targets_matches(cloud):
    eps2, kappa = 1e-18, 2e-6 / 900
    tgt = cloud[::7]
    got = TD.direct_kahan_targets(torch.from_numpy(tgt),
                                  torch.from_numpy(cloud), eps2, kappa,
                                  src_chunk=128)
    ref = JD.direct_kahan_targets(jnp.asarray(tgt), jnp.asarray(cloud), eps2,
                                  kappa, src_chunk=128)
    assert _rel(got, ref) < 1e-5
    # and it is the full Kahan sum restricted to those rows
    full = TD.direct_kahan(torch.from_numpy(cloud), eps2, kappa)
    assert _rel(got, full[::7]) < 1e-5


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    code = (
        "import os, sys, pkgutil, importlib\n"
        "import coulomb_oscillators_tpu_torch as P\n"
        "os.environ.pop('CO_M2L_FLY', None)\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'CO_M2L_FLY' not in os.environ, 'an import set CO_M2L_FLY'\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'coulomb_oscillators_tpu' or "
        "k.startswith('coulomb_oscillators_tpu.'))\n"
        "assert not bad, bad\n"
        "new = ['utils.font', 'utils.profiling', 'scripts._common', "
        "'scripts.view', 'scripts.profile_force', "
        "'scripts.stale_margin_probe', 'scripts.cadence_probe', "
        "'scripts.bench', 'parallel.mesh', 'parallel.fmm_shard', "
        "'parallel.fmm_pshard', 'scripts.graft_entry', "
        "'scripts.pshard_scaling', 'scripts.stale_anatomy', "
        "'scripts.err_diag', 'scripts.leaf_size_probe', "
        "'scripts.sortmode_probe', 'scripts.m2l_window_stats', "
        "'scripts.m2l_micro', 'scripts.m2l_micro2', 'scripts.l2p_micro', "
        "'ops.fmm.m2l_cuda']\n"
        "missing = [m for m in new if P.__name__ + '.' + m not in "
        "sys.modules]\n"
        "assert not missing, missing\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_parallel_workers\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'coulomb_oscillators_tpu' or "
        "k.startswith('coulomb_oscillators_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if "
        "k.startswith('coulomb_oscillators_tpu_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_chip_smoke_refuses_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != REPO:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
        res = subprocess.run([sys.executable, script], cwd=cwd,
                             env=_clean_env(), capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
