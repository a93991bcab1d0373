"""What the measurement scripts share: the device rule, the card's
identity, the production beam, the seeded oracle targets, the knobs an
engine or Simulator reads when it is made, and the timing of a study's
variants."""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

X_STD = (0.003, 0.001, 0.01)     # the production Gaussian beam (README)
N_TARGETS = 2048                 # Kahan-oracle targets, default_rng(0)


def pick_device(name=None) -> torch.device:
    """``cuda:0`` unless the caller names another device.  A measurement
    script measures the card: without one, and without an explicit
    ``--device cpu``, this raises instead of timing the host."""
    if name not in (None, "cuda"):
        return torch.device(name)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this script measures the card; pass "
            "--device cpu to run it on the host (tests, rehearsals)")
    return torch.device("cuda", 0)


def device_info(device) -> dict:
    """Where the numbers were taken: for a card its nvidia-smi name and
    power limit with the torch and CUDA versions, else the word cpu."""
    info = {"torch": torch.__version__}
    if torch.device(device).type != "cuda":
        return dict(info, device="cpu")
    from coulomb_oscillators_tpu_torch.scripts.ladder import card
    return dict(info, **card(), cuda=torch.version.cuda)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def beam(n: int, config=None):
    """The production Gaussian beam at `n` in float32: (pos, vel) on the
    host, x_std = X_STD, u = omega0 * x_std, seed 0."""
    from coulomb_oscillators_tpu_torch import SimConfig
    from coulomb_oscillators_tpu_torch.models import init_dist as ID
    config = config or SimConfig()
    u = tuple(w * x for w, x in zip(config.omega0, X_STD))
    return ID.init_gaussian(n, X_STD, u, dtype=np.float32)


def oracle_targets(n: int) -> np.ndarray:
    """Indices of the seeded oracle targets (2048, or all below that)."""
    return np.random.default_rng(0).choice(n, min(N_TARGETS, n),
                                           replace=False)


@contextlib.contextmanager
def graphs_env(on):
    """``CO_CUDA_GRAPHS`` for the Simulators built inside: True or False
    forces the card's CUDA graphs on or off, None leaves the environment's
    choice (the Simulator reads the knob when it is built)."""
    saved = os.environ.get("CO_CUDA_GRAPHS")
    try:
        if on is not None:
            os.environ["CO_CUDA_GRAPHS"] = "1" if on else "0"
        yield
    finally:
        if saved is None:
            os.environ.pop("CO_CUDA_GRAPHS", None)
        else:
            os.environ["CO_CUDA_GRAPHS"] = saved


@contextlib.contextmanager
def m2l_env(fly: bool):
    """``CO_M2L_FLY`` for the engines built inside: fly mode (True) or the
    stored fold (False).  The engine reads the knob when it is made, so
    the mode is set only around the construction and restored after it."""
    saved = os.environ.get("CO_M2L_FLY")
    try:
        os.environ["CO_M2L_FLY"] = "1" if fly else "0"
        yield
    finally:
        if saved is None:
            os.environ.pop("CO_M2L_FLY", None)
        else:
            os.environ["CO_M2L_FLY"] = saved


def host_rss() -> int:
    """This process's resident host memory in bytes (0 where /proc is
    absent)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:
        return 0


def emit(out: dict, path=None, omit=()) -> None:
    """Write a study's result to `path` (when given), then print it, less
    the keys in `omit`, as the one ``@@`` JSON line."""
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {path}", flush=True)
    print("@@ " + json.dumps({k: v for k, v in out.items() if k not in omit}),
          flush=True)


def time_variants(fns, device, reps: int) -> dict:
    """Times of each named nullary variant: on the card the median of
    `reps` CUDA-event times (``event_ms``), the summed kernel time of one
    traced call (``kernel_ms``) and the device memory one call allocates
    above what was held before it (``extra_bytes``, with the absolute
    ``peak_bytes``); on the CPU the host clock's median (``host_ms``),
    which is no device number."""
    from coulomb_oscillators_tpu_torch.utils import profiling as prof
    if torch.device(device).type != "cuda":
        return {k: {"host_ms": v}
                for k, v in prof.stage_times(fns, reps, device).items()}
    event = prof.stage_times(fns, reps, device)
    kernel = prof.stage_device_times(fns, device)
    out = {}
    for k, fn in fns.items():
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        fn()
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        out[k] = {"event_ms": event[k], "kernel_ms": kernel[k],
                  "peak_bytes": peak, "extra_bytes": peak - base}
    return out


# a traced call whose kernels sum to less than this share of its event time
# (where that is at least LOST_EVENT_MS; shorter calls may be launch-bound)
# lost kernel events from its trace
LOST_SHARE, LOST_EVENT_MS = 0.5, 1.0


def check_traces(times: dict) -> None:
    """Raise if a card row of :func:`time_variants` lost kernel events from
    its trace: kernels summing to nothing, or to less than LOST_SHARE of
    its event time where that is LOST_EVENT_MS or more.  (Seen on the card
    in a process that had traced many earlier runs; the cause is not
    known.)  Host rows pass."""
    lost = [f"{k}: {v['kernel_ms']:.3f} kernel ms, {v['event_ms']:.3f} "
            f"event ms" for k, v in times.items() if "kernel_ms" in v
            and (v["kernel_ms"] <= 0 or (
                v["event_ms"] >= LOST_EVENT_MS
                and v["kernel_ms"] < LOST_SHARE * v["event_ms"]))]
    if lost:
        raise RuntimeError(f"traces lost their kernels: {lost}")


def graph_info(sim) -> dict:
    """A Simulator's CUDA-graph facts: whether its steps replay a graph,
    and its captures and their seconds."""
    g = sim.graph
    return {"graphs": g is not None, "captures": g.captures if g else 0,
            "capture_s": g.capture_seconds if g else 0.0}

