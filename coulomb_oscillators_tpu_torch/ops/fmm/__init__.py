"""Fast Multipole Method force engines of the port.

Twin of ``coulomb_oscillators_tpu/ops/fmm/__init__.py``.  Only the kd-tree
engine in dim 3 ("fmm3_kd", or "fmm_kd" with a dim-3 config) is ported;
every other engine name raises NotImplementedError naming its ROADMAP.md
item.
"""

from coulomb_oscillators_tpu_torch.ops.fmm.kdtree import KdFmmEngine

_KD_NAMES = ("fmm3_kd", "fmm_kd")
_NOT_PORTED = {
    "fmm2_kd": "queue 1, item 9 (fmm2_kd and float64)",
    "fmm3": "queue 1, item 9 (octree engines)",
    "fmm2": "queue 1, item 9 (octree engines)",
    "fmm3_traceless": "queue 1, item 9 (octree engines)",
    "fmm2_traceless": "queue 1, item 9 (octree engines)",
    "appel": "queue 1, item 9 (Appel engine)",
}


def make_engine_object(config, n, name: str):
    """Engine instance for the simulator (build/force API)."""
    if name in _KD_NAMES:
        return KdFmmEngine(config, n)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported yet: ROADMAP.md "
            f"{_NOT_PORTED[name]}")
    raise ValueError(f"unknown FMM engine {name!r}")
