"""Simulation configuration (jax-free).

Twin of ``coulomb_oscillators_tpu/config.py``: the same fields, defaults,
checks and helpers; ``dtype`` returns a ``torch.dtype``.

The reference is the TPU-native replacement for the reference's mutable globals and compile-time
defines (reference: Simulation/constants.cuh:22-52 — SCAL/DIM defines and the
BLOCK_SIZE/EPS2/fmm_order/tree_radius/tree_L/tree_steps/dens_inhom/coll
globals).  Here everything is an immutable dataclass carried explicitly;
precision and dimensionality are runtime config, not #defines.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch


@functools.lru_cache(maxsize=256)
def round_to_dtype(x: float, dtype: torch.dtype) -> float:
    """A binary64 constant rounded to `dtype`, returned as the Python float
    of that exact value (the reference's ``dtype.type(x)``), so a multiply
    by it sees no second rounding and no device copy.  Cached: a step
    rounds its constants once per dtype, not once per call."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


# Default trap frequencies / distribution moments
# (reference: Simulation/main3.cu:230-245).
_DEFAULT_OMEGA0_3D = (1.095, 1.0, 1.0)
_DEFAULT_X_STD_3D = (0.003, 0.001, 0.01)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Immutable simulation configuration.

    Attributes mirror the reference CLI flags (Simulation/main3.cu:247-623)
    plus the globals of constants.cuh; see each field's comment.
    """

    # --- core numerics -----------------------------------------------------
    dim: int = 3                  # constants.cuh:26 (DIM)
    precision: str = "float32"    # constants.cuh:22 (SCAL): "float32" or "float64"
    eps: float = 1e-9             # softening; EPS2 = eps**2 (constants.cuh:39, main3.cu:283)

    # --- physics -----------------------------------------------------------
    xi: float = 2e-6              # coupling; force scale is xi/N (main3.cu:240,686)
    omega0: Tuple[float, ...] = _DEFAULT_OMEGA0_3D  # trap frequencies (main3.cu:241)

    # --- FMM ---------------------------------------------------------------
    fmm_order: int = 3            # expansion order p (constants.cuh:42)
    tree_radius: float = 1.0      # MAC interaction radius (constants.cuh:43)
    tree_L: int = 0               # max tree level; 0 = auto heuristic (constants.cuh:44)
    tree_steps: int = 8           # tree rebuilt every `tree_steps` iters (constants.cuh:45)
    tree_async: bool = True       # TPU extension: pipeline the host re-sort of each
                                  # rebuild behind the device scan window (the adopted
                                  # permutation is one window stale, but node geometry
                                  # and MAC pair lists are recomputed exactly at
                                  # adoption, so the FMM error bound is preserved —
                                  # staleness only swells leaf bounds slightly).
                                  # False = the reference's fully synchronous rebuild
                                  # cadence (fmm_cart3_kdtree.cuh:1619-1642).
    tree_async_build: str = "host"  # async-rebuild builder: "host" = native kd
                                  # quickselect (exact equal-count splits; costs
                                  # an O(N) position fetch per rebuild).
                                  # "device" = on-chip Morton sort + host
                                  # traversal on fetched node bounds — cheaper
                                  # per rebuild, but Morton equal-count leaves
                                  # are MUCH looser on concentrated anisotropic
                                  # clouds (13x the P2P pairs on the N=1M beam);
                                  # only use for quasi-uniform distributions
    tree_pipeline: int = 1        # async-rebuild adoption depth (host builder):
                                  # each rebuild's position snapshot is adopted
                                  # exactly this many window boundaries later.
                                  # 1 = classic one-window-stale pipeline; 2
                                  # doubles the wall budget the background
                                  # rebuild gets before it stalls the device
                                  # (tunnel-transport robustness) at the cost
                                  # of one extra window of tree staleness
                                  # (max tree_steps*(pipeline+1) steps, still
                                  # deterministic).
    tree_resort_every: int = 1    # windows between FULL re-sorts (host kd +
                                  # position fetch); boundaries in between
                                  # run a background REFRESH instead (exact
                                  # node bounds from on-device leaf stats +
                                  # MAC re-traversal — 10x less transport,
                                  # permutation unchanged).  Bounds staleness
                                  # at adoption stays one window regardless;
                                  # re-sort staleness only loosens leaf
                                  # partition tightness (a few % more pairs).
                                  # 1 = full re-sort every window (reference
                                  # cadence, fmm_cart3_kdtree.cuh:1619-1642).
    dens_inhom: float = 1.0       # density-inhomogeneity factor for auto level (constants.cuh:52)
    coll: bool = True             # include near-field P2P pass (constants.cuh:50)
    unsort: bool = True           # return accelerations in input particle order
    accuracy: float = 0.0         # requested mean relative force-error bound
                                  # (the -accuracy flag, main3.cu:236-237);
                                  # 0 = none.  A tight bound (<1e-4) makes the
                                  # kd engine stiffen its sub-leaf MAC
                                  # automatically (mac_sub_boost -> 2.0, the
                                  # block-granularity error plateau) so
                                  # accuracy-grade runs never pay the
                                  # throughput-tuned boost's extra ~4% error.
    mac_sub_boost: float = 0.0    # sub-leaf MAC acceptance-radius boost
                                  # (TPU extension, see KdFmmEngine); 0 = auto
                                  # (1.5 throughput-tuned, or 2.0 when
                                  # `accuracy` < 1e-4)
    geom_refresh: bool = True     # TPU extension: recompute expansion
                                  # geometry (node centers/length scales +
                                  # folded M2L harmonics) from CURRENT
                                  # positions on device at every force eval
                                  # of the padded window scan, lists frozen.
                                  # Removes the frozen-geometry component of
                                  # the within-window stale force error that
                                  # dominates long reuse windows (the
                                  # reference freezes everything between
                                  # rebuilds, fmm_cart3_kdtree.cuh:1619-1642,
                                  # and eats the drift).  Cost: one [G,C]
                                  # reduce + heap sweep + M2L geometry
                                  # re-fold per step, a few ms at N=1M.

    stale_margin: float = -1.0    # TPU extension: temporal MAC slack —
                                  # inflate node bounds by this absolute
                                  # distance at traversal time so pairs
                                  # accepted into the frozen M2L/P2P lists
                                  # stay admissible for the whole reuse
                                  # window (the frozen ACCEPTANCE SET is
                                  # the dominant stale-error term,
                                  # docs/stale_anatomy_r05.json).  <0 =
                                  # auto: per-axis rms|v_ax|*dt*
                                  # max_list_age*2.0,
                                  # set by the Simulator at init; 0 = off
                                  # (reference behavior: freeze and eat
                                  # the drift); >0 = explicit distance.
    # --- integration -------------------------------------------------------
    dt: float = 5e-4              # main3.cu:231
    integrator: str = "leapfrog"  # {euler, leapfrog, forestruth, pefrl} (main3.cu:238,389-401)

    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")
        if self.precision not in ("float32", "float64"):
            raise ValueError(f"precision must be float32/float64, got {self.precision}")
        if len(self.omega0) != self.dim:
            raise ValueError(f"omega0 must have {self.dim} components")
        if self.fmm_order < 1:
            raise ValueError("fmm_order must be >= 1")
        if self.eps <= 0:
            raise ValueError("eps must be > 0")

    # ------------------------------------------------------------------ #
    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.precision)

    @property
    def eps2(self) -> float:
        """Squared softening parameter (constants.cuh:39)."""
        return self.eps * self.eps

    def kappa(self, n: int) -> float:
        """Coulomb force prefactor xi/N (main3.cu:686: par[0])."""
        return self.xi / float(n)

    def omega0_sq(self) -> Tuple[float, ...]:
        """Trap spring constants omega0^2 (main3.cu:689-691: par[3..5])."""
        return tuple(w * w for w in self.omega0)

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)
