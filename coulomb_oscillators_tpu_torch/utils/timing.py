"""Timing harness.

Twin of ``coulomb_oscillators_tpu/utils/timing.py`` (reference: the
`test_time` lambda, Simulation/main3.cu:707-735): one warm-up call, then
geometric loop-doubling until at least `min_loop` seconds have elapsed;
report duration / loop_count.

PyTorch returns from a CUDA call before the card has finished it, so each
measurement completes the work with ``torch.cuda.synchronize(device)`` on
the device of the result (the first tensor found in it); a CPU result is
already complete.  No host fetch is needed.
"""

from __future__ import annotations

import time
from typing import Callable, TypeVar

import torch

T = TypeVar("T")


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (tuple, list)):
        for leaf in x:
            t = _first_tensor(leaf)
            if t is not None:
                return t
    return None


def _complete(x) -> None:
    """Wait until the device that holds `x` has finished its work."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def test_time_chained(fn: Callable[[T], T], init: T,
                      min_loop: float = 1.0, warmup: bool = True) -> float:
    """Average seconds per call of a chainable fn (state -> state); each
    output is the next input."""
    state = init
    if warmup:
        state = fn(state)
        _complete(state)

    loop_counter = 0
    loop_n = 1
    begin = time.perf_counter()
    while True:
        for _ in range(loop_n):
            state = fn(state)
        _complete(state)
        duration = time.perf_counter() - begin
        loop_counter += loop_n
        loop_n *= 2
        if duration >= min_loop:
            return duration / loop_counter


def test_time(fn: Callable[[], object], min_loop: float = 0.0,
              warmup: bool = True) -> float:
    """Average seconds per call of a nullary fn; every call's result is
    completed before the next call."""
    if warmup:
        _complete(fn())

    loop_counter = 0
    loop_n = 1
    begin = time.perf_counter()
    while True:
        for _ in range(loop_n):
            _complete(fn())
        duration = time.perf_counter() - begin
        loop_counter += loop_n
        loop_n *= 2
        if duration >= min_loop:
            return duration / loop_counter
