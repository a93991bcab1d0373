"""The yardstick of the P2P kernel: the work its lists need and the least
time one H100 could take for it.

The peaks are NVIDIA's published H100 SXM figures (dense rates, at the
full 700 W power limit): 67 TFLOP/s in float32 outside the tensor cores,
3.35 TB/s of HBM, and the special-function units' 16 rsqrt results a
clock on each of 132 SMs at the 1.98 GHz boost clock.  A 3D pair of the
softened Coulomb sum counts 20 flops (3 subtractions, 3 fused
multiply-adds for |d|^2 + eps2, 2 multiplies for r^3, 3 fused
multiply-adds into the sum, and the rsqrt as 3) and one rsqrt; a 2D pair
14 flops.  These are frozen here, with the count below, so that no later
change to the program moves the yardstick.

The work is counted from the near lists a step ran, never from what the
kernel chose to run: every physical particle pair, self pairs included,
of each (target sub-leaf, source block, sub-leaf mask) entry, with the
sub-leaves' particle counts of a balanced kd split of n particles over
2^L sub-leaves; the bytes are the padded positions read once, the output
written once, and the entries and the row pointers read once.
"""

from __future__ import annotations

import numpy as np
import torch

FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
MUFU_PER_S = 132 * 16 * 1.98e9
FLOPS_PER_PAIR = {2: 14, 3: 20}

# force evaluations a step of each integrator makes (integrator.cuh)
FORCE_EVALS = {"euler": 1, "pre_euler": 1, "leapfrog": 1, "forestruth": 3,
               "fr": 3, "pefrl": 4}


def subleaf_counts(n: int, L: int) -> np.ndarray:
    """Particles in each of the 2^L sub-leaves of a balanced split: sub-leaf
    j holds slots [j n / 2^L, (j + 1) n / 2^L)."""
    g = 1 << L
    beg = (np.arange(g + 1, dtype=np.int64) * n) // g
    return np.diff(beg)


def p2p_work(row_ptr: torch.Tensor, col2d: torch.Tensor, nsub: int,
             n: int, L: int, slots: int, dim: int = 3,
             item: int = 4) -> dict:
    """The work of one P2P evaluation over a CSR of near entries:
    `row_ptr` [2^L + 1] (one row per target sub-leaf), `col2d` [2^L, dmax]
    packed entries ``blk | mask << (32 - nsub)`` (bit q selects sub-leaf q
    of source block blk; a block id of 2^L / nsub or more is a pad).
    `slots` is the padded slots of a sub-leaf.  Returns ``pairs``,
    ``entries`` and ``bytes``."""
    dev = row_ptr.device
    mult = torch.from_numpy(subleaf_counts(n, L)).to(dev)
    g = mult.shape[0]
    gb = g // nsub
    shift = 32 - nsub
    deg = (row_ptr[1:] - row_ptr[:-1]).long().clamp(min=0,
                                                    max=col2d.shape[1])
    cols = torch.arange(col2d.shape[1], device=dev)
    rows, ks = torch.nonzero(cols[None, :] < deg[:, None], as_tuple=True)
    v = col2d[rows, ks].long() & 0xFFFFFFFF
    blk = v & ((1 << shift) - 1)
    real = blk < gb
    blk = blk.clamp(max=gb - 1)
    src = torch.zeros_like(rows)
    for q in range(nsub):
        bit = ((v >> (shift + q)) & 1) * real
        src += bit * mult[blk * nsub + q]
    pairs = int((mult[rows] * src).sum())
    entries = int(rows.shape[0])
    nbytes = 2 * g * slots * dim * item + 4 * (entries + row_ptr.shape[0])
    return {"pairs": pairs, "entries": entries, "bytes": nbytes}


def bound_ms(pairs: float, nbytes: float, dim: int = 3) -> float:
    """The least ms one H100 could take: the largest of the flops over the
    float32 peak, one rsqrt a pair over the special-function rate, and
    the bytes over the HBM rate."""
    flop = pairs * FLOPS_PER_PAIR[dim] / FP32_FLOPS
    mufu = pairs / MUFU_PER_S
    byte = nbytes / HBM_BYTES
    return 1e3 * max(flop, mufu, byte)
