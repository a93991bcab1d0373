"""Fast Multipole Method force engines of the port.

Twin of ``coulomb_oscillators_tpu/ops/fmm/__init__.py``, with the same
registry:
  * "fmm3_kd" / "fmm2_kd" (and "fmm_kd", dim from the config) — kd-tree FMM
    with dual-tree MAC traversal, the production path (kdtree.py);
  * "fmm3" / "fmm3_traceless" / "fmm2" / "fmm2_traceless" — uniform-grid
    octree / quadtree FMM (octree.py);
  * "appel" — the monopole tree code (appel.py).
"""

from coulomb_oscillators_tpu_torch.ops.fmm.appel import AppelEngine
from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine
from coulomb_oscillators_tpu_torch.ops.fmm.octree import OctreeFmmEngine

_KD_NAMES = ("fmm3_kd", "fmm2_kd", "fmm_kd")
_OCT_NAMES = ("fmm3", "fmm2", "fmm3_traceless", "fmm2_traceless")


def make_engine_object(config, n, name: str):
    """Engine instance for the simulator (build/force API)."""
    if name in _KD_NAMES:
        return KdFmmEngine(config, n)
    if name == "appel":
        return AppelEngine(config, n)
    if name in _OCT_NAMES:
        storage = "traceless" if name.endswith("_traceless") else "symmetric"
        return OctreeFmmEngine(config, n, multipole_storage=storage)
    raise ValueError(f"unknown FMM engine {name!r}")


def make_engine(config, n, name: str):
    """pos -> acc callable that rebuilds its tree every call (test modes;
    for amortized stepping use the engine object / Simulator).  The engine
    object is the callable's ``.engine``."""
    eng = make_engine_object(config, n, name)

    def force(pos):
        return eng.force(pos, eng.build(pos))

    force.engine = eng
    return force
