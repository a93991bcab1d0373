"""The comparison that decides a run's `correct`.

After the measured window the harness steps the program on, one step at a
time through its own entry point, and records what it hands back: a
*record* (a dict of host arrays, built by the driver module's ``collect`` with
``benchmark/program.py``):

  ``dt``, ``eps2``, ``kappa``, ``omega0_sq``: the configuration's physics;
  ``targets``: particle indices drawn from the seed;
  ``start``: ``{"pos", "acc"}``, the seeded beam and the acceleration the
      program's set-up computed for it (or None);
  ``steps``: consecutive states ``{"pos", "vel", "acc", "force"}`` [N, D]
      (D = 3 or 2) in the original particle order, step j + 1 being the
      program's step from step j; ``force`` marks the steps whose force is
      checked;
  ``snapshot``: ``{"path", "pos", "vel"}``, a file the program wrote and
      the state it was handed (or None).

:func:`readings` turns a record into numbers, for the program's outputs or
for a control's, put in the program's place on the same inputs: the
reference in bfloat16 (``control="all"``), or its Coulomb sum alone in
bfloat16 with the trap term and the step in float32 (``control="force"``):

  ``force_err``: over the start and every checked step, the largest mean
      relative error of the Coulomb acceleration on the targets (the
      output's acceleration less the exact trap term) against the exact
      float64 sum;
  ``drift_err``: over every step, the largest deviation of any
      particle's new position from x + dt (v + dt/2 a) of the state before
      it, per axis over that coordinate's size plus the axis's rms
      position (so a particle far out in the halo reads its rounding, not
      a multiple of it): it sees a step that did not move, particles
      stepped from another particle's state (a wrong permutation at a
      re-sort), and any particle left out;
  ``kick_err``: over every checked step, the mean over the targets of the
      new velocity's deviation from v + dt/2 a + dt/2 a_exact(new x), over
      the Coulomb part of that last half kick (the trap's part, nearly
      opposite to it in the core, would make the ratio swing): the force
      as the state carries it;
  ``nonfinite``: values of the record that are not finite;
  ``snapshot_mismatch``: values of the snapshot file, read as the format
      says, that differ from the state the program was handed, plus any
      difference in their count.

:func:`judge` holds the numbers named in a cell's ``limits`` to them.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import coulomb as R
from benchmark.reference import snapshot as S

BF16 = torch.bfloat16


def _rel_mean(err: torch.Tensor, ref: torch.Tensor) -> float:
    """Mean over rows of |err| / |ref|."""
    return float((err.norm(dim=1) / ref.norm(dim=1)).mean())


class Exact:
    """The exact Coulomb and trap accelerations at the targets of each
    checked state, computed once and shared by every reading."""

    def __init__(self, record: dict, device):
        self.rec, self.device = record, device
        self._coul = {}

    def coulomb(self, key) -> torch.Tensor:
        if key not in self._coul:
            r = self.rec
            pos = r["start"]["pos"] if key == "start" else \
                r["steps"][key]["pos"]
            self._coul[key] = R.coulomb(pos, r["targets"], r["eps2"],
                                        r["kappa"], self.device)
        return self._coul[key]

    def trap(self, pos) -> torch.Tensor:
        return R.trap(pos[self.rec["targets"]], self.rec["omega0_sq"],
                      self.device)


def checked(record: dict) -> list:
    """Keys of the states whose force is checked: "start" and step
    indices."""
    keys = ["start"] if record.get("start") is not None else []
    return keys + [i for i, s in enumerate(record["steps"]) if s["force"]]


def _state(record, key):
    return record["start"] if key == "start" else record["steps"][key]


def readings(record: dict, device, control: str | None = None,
             exact: Exact | None = None) -> dict:
    """The numbers of a record: for the program's outputs, or with
    `control` ("all" or "force", module docstring) for that control's
    outputs made from the same inputs."""
    if control not in (None, "all", "force"):
        raise ValueError(f"no control {control!r}")
    step = BF16 if control == "all" else torch.float32
    exact = exact or Exact(record, device)
    tg = torch.from_numpy(np.asarray(record["targets"])).to(device)
    dt = record["dt"]
    steps = record["steps"]
    out = {}

    def acc_out(key):
        st = _state(record, key)
        if control:
            return (R.coulomb(st["pos"], record["targets"], record["eps2"],
                              record["kappa"], device, BF16)
                    + R.trap(st["pos"][record["targets"]],
                             record["omega0_sq"], device, step))
        return torch.from_numpy(st["acc"]).to(device)[tg].double()

    force = []
    for key in checked(record):
        pos = _state(record, key)["pos"]
        coul = acc_out(key) - exact.trap(pos)
        ref = exact.coulomb(key)
        force.append(_rel_mean(coul - ref, ref))
    out["force_err"] = max(force) if force else 0.0

    drift = []
    for j in range(len(steps) - 1):
        a, b = steps[j], steps[j + 1]
        want = R.drift(a["pos"], a["vel"], a["acc"], dt, device)
        got = (R.drift(a["pos"], a["vel"], a["acc"], dt, device, step)
               if control else torch.from_numpy(b["pos"]).to(device).double())
        scale = want.abs() + want.pow(2).mean(0).sqrt()
        drift.append(float(((got - want).abs() / scale).max()))
    out["drift_err"] = max(drift) if drift else 0.0

    kick = []
    for j in range(len(steps) - 1):
        a, b = steps[j], steps[j + 1]
        if not b["force"]:
            continue
        coul = exact.coulomb(j + 1)
        a1 = coul + exact.trap(b["pos"])
        vel0, acc0 = (torch.from_numpy(a[k]).to(device)[tg]
                      for k in ("vel", "acc"))
        want = R.kicks(vel0, acc0, a1, dt, device)
        if control:
            got = R.kicks(vel0, acc0, acc_out(j + 1), dt, device, step)
        else:
            got = torch.from_numpy(b["vel"]).to(device)[tg].double()
        kick.append(_rel_mean(got - want, 0.5 * dt * coul))
    out["kick_err"] = max(kick) if kick else 0.0

    if not control:
        arrays = [s[k] for s in steps for k in ("pos", "vel", "acc")]
        if record.get("start") is not None:
            arrays.append(record["start"]["acc"])
        out["nonfinite"] = float(sum(int((~np.isfinite(x)).sum())
                                     for x in arrays))
        snap = record.get("snapshot")
        if snap is not None:
            n, dim = snap["pos"].shape
            pos, vel = S.read(snap["path"], dim)
            if pos.shape[0] != n:
                out["snapshot_mismatch"] = float(abs(pos.shape[0] - n)
                                                 * 2 * dim)
            else:
                out["snapshot_mismatch"] = float(
                    (pos.view(np.uint32) != snap["pos"].view(np.uint32)).sum()
                    + (vel.view(np.uint32)
                       != snap["vel"].view(np.uint32)).sum())
    return out


def judge(values: dict, limits: dict) -> list:
    """[(name, value, limit, ok)] for every number a cell compares: each
    must be at most its limit (a number missing from `values` fails)."""
    out = []
    for name, limit in limits.items():
        v = values.get(name)
        ok = v is not None and np.isfinite(v) and v <= limit
        out.append((name, v, limit, bool(ok)))
    return out
