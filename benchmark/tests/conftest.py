"""Fixtures of the benchmark's own tests (run them with ``python -m pytest
benchmark/tests -q`` from the repository's root; they run on the CPU, and
the one marked ``cuda`` skips without a card).

``tiny_root`` is a copy of the benchmark (``BENCHMARK.json`` and
``benchmark/``) in a temporary directory, with three cells added the way a
later change adds one, by new files and new entries: ``tiny_beam.w`` (the
1M configuration's file at N = 2000, the ``window`` driver at a 4/2/2
cadence), ``tiny_cli.s`` (the CLI configuration's file at N = 2001, the
``cli_loop`` driver with a snapshot every 20 steps) and ``tiny_kd2.w``
(the 1M configuration's file made 2D: ``fmm2_kd`` at p = 4, r = 2, N =
2000, the KV beam of the 2D CLI's defaults, the ``window`` driver at
4/2/2).  Each keeps its source cell's limits.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

WINDOW_442 = {"sim": {"tree_steps": 4, "tree_resort_every": 2,
                      "tree_pipeline": 2},
              "warmup_windows": 3, "steps_per_s": 20.0, "trace_steps": 4,
              "check": {"targets": 256, "every": 2}}

# the 2D CLI's default beam (cli.py: models/beams.matched_beam_2d at omega0
# = 2 pi (6.22, 6.21), emittances (3e-5, 1e-5), tune depression 0.8): its
# semi-axes, depressed phase advances and coupling xi, as numbers
KD2 = {"engine": "fmm2_kd",
       "beam": {"kind": "kv",
                "A": [0.0018633884990322802, 0.0011320074052916915],
                "omega": [34.56005498097551, 31.21486460606819]},
       "sim": {"dim": 2, "omega0": [39.081412610657026, 39.018580757585234],
               "xi": 0.0009292208408064241, "fmm_order": 4,
               "tree_radius": 2.0}}

# tiny config: (source config, source cell, tiny cell, N, traffic keys,
# configuration keys; "sim" is merged into the source's)
TINY = {
    "tiny_beam": ("kd3_beam_1m", "kd3_beam_1m.tuned", "tiny_beam.w", 2000,
                  WINDOW_442, {}),
    "tiny_cli": ("kd3_cli_30k", "kd3_cli_30k.snap200", "tiny_cli.s", 2001,
                 {"snapshot_every": 20, "warmup_blocks": 1,
                  "steps_per_s": 100.0, "trace_steps": 20,
                  "check": {"targets": 2001, "every": 1}}, {}),
    "tiny_kd2": ("kd3_beam_1m", "kd3_beam_1m.tuned", "tiny_kd2.w", 2000,
                 WINDOW_442, KD2),
}


def add_tiny_cells(root: str) -> None:
    """Add the tiny cells to the benchmark copy under `root`: new files
    and new entries only."""
    bpath = os.path.join(root, "BENCHMARK.json")
    with open(bpath) as f:
        bench = json.load(f)
    for name, (cfg, cell, tiny_cell, n, over, cover) in TINY.items():
        with open(os.path.join(root, "benchmark", "configs",
                               f"{cfg}.json")) as f:
            config = json.load(f)
        sim = dict(config["sim"], **cover.get("sim", {}))
        config.update(cover, name=name, n=n, sim=sim)
        with open(os.path.join(root, "benchmark", "configs",
                               f"{name}.json"), "w") as f:
            json.dump(config, f)
        with open(os.path.join(root, "benchmark", "workloads",
                               f"{cell}.json")) as f:
            wl = json.load(f)
        wl.update(config=name, **over)
        with open(os.path.join(root, "benchmark", "workloads",
                               f"{tiny_cell}.json"), "w") as f:
            json.dump(wl, f)
        bench["configs"].append({"name": name, "source": "tiny",
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": ["n"], "why": "CPU tests"})
        bench["workloads"].append({"name": tiny_cell, "config": name,
                                   "traffic": tiny_cell.split(".")[1],
                                   "chips": 1, "why": "CPU tests"})
        for m in bench["per_layer"]:
            m["workloads"].append(tiny_cell)
    with open(bpath, "w") as f:
        json.dump(bench, f)


def copy_benchmark(dst: str) -> str:
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    torch.set_num_threads(2)
    root = copy_benchmark(str(tmp_path_factory.mktemp("bench")))
    add_tiny_cells(root)
    return root
