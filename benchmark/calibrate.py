"""The readings that each cell's limits are set from: the program's and the
controls', on several seeds, in one process, on cuda:0.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3
        [--seconds 2] [--out FILE]

For each seed: one run of the cell (set-up, a short window at the cell's
own load, the states after it) whose result also holds every reading of
the program and of the two controls on the same states
(``harness.run_cell(..., control=True)``): ``control``, the reference
computed in bfloat16 in the program's place, and ``control_force``, its
Coulomb sum alone in bfloat16 with the step in float32.  Each control's
readings are held to those of the cell's limits that a control reads
(``nonfinite`` and ``snapshot_mismatch`` are the program's outputs'), and
its ``correct`` printed beside them.  Prints one JSON line a seed and, last,
the largest program reading and the smallest reading of each control.
The benchmark's own runs never compute the controls.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from benchmark import harness as H
from benchmark.reference import compare as CMP

CONTROLS = ("control", "control_force")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on the card; none is visible",
              file=sys.stderr)
        return 3
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    limits = H.load_json(root, "benchmark", "workloads",
                         f"{args.workload}.json")["limits"]
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = H.run_cell(root, args.workload, seed, args.seconds,
                         device="cuda:0", control=True)
        row = {"seed": seed, "correct": out["correct"],
               "program": out["readings"], "steps": out["diag"]["steps"]}
        for c in CONTROLS:
            row[c] = out[c]
            row[f"{c}_correct"] = all(ok for *_, ok in CMP.judge(
                out[c], {k: v for k, v in limits.items() if k in out[c]}))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows),
               "limits": limits,
               "program_max": {k: max(r["program"][k] for r in rows)
                               for k in rows[0]["program"]}}
    for c in CONTROLS:
        summary[f"{c}_min"] = {k: min(r[c][k] for r in rows)
                               for k in rows[0][c]}
        summary[f"{c}_correct"] = [r[f"{c}_correct"] for r in rows]
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
