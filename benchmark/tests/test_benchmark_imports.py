"""The import check: in a fresh process, nothing the benchmark loads has
the top-level name ``jax``, ``jaxlib``, ``flax`` or
``coulomb_oscillators_tpu``, compared whole (the port,
``coulomb_oscillators_tpu_torch``, is not a match); and the reference
alone loads nothing of the port either."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.tests.conftest import REPO

FORBIDDEN = ["jax", "jaxlib", "flax", "coulomb_oscillators_tpu"]

HARNESS = """
import json, os, sys, tempfile
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from benchmark import calibrate, harness as H, run
from benchmark.tests.conftest import add_tiny_cells, copy_benchmark
bench = H.load_json({repo!r}, "BENCHMARK.json")
for m in bench["end_to_end"] + bench["per_layer"]:
    H.load_module({repo!r}, "metrics", m["name"])
for d in sorted(os.listdir(os.path.join({repo!r}, "benchmark", "drivers"))):
    if d.endswith(".py"):
        H.load_module({repo!r}, "drivers", d[:-3])
root = copy_benchmark(tempfile.mkdtemp())
add_tiny_cells(root)
out = H.run_cell(root, "tiny_cli.s", 5, 0.2, device="cpu")
assert out["correct"], out
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
from benchmark.reference import compare, coulomb, snapshot
pos = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
coulomb.coulomb(pos, np.arange(8), 1e-18, 1e-6, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(code: str) -> list:
    res = subprocess.run([sys.executable, "-c", code.format(repo=REPO)],
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.splitlines()[-1])


def test_a_run_loads_nothing_of_jax_or_the_jax_package():
    names = _top_names(HARNESS)
    assert "coulomb_oscillators_tpu_torch" in names
    assert not set(names) & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = _top_names(REFERENCE)
    assert not set(names) & set(FORBIDDEN + ["coulomb_oscillators_tpu_torch"])
