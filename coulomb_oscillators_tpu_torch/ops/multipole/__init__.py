"""Cartesian multipole algebra for the FMM.

Twin of ``coulomb_oscillators_tpu/ops/multipole/``: the same host-side
tables (numpy copies) and the operators the kd engine calls, on tensors.
"""
