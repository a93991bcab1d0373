"""Measurement scripts of the port: twins of the repository's root
``bench.py`` and of ``scripts/{stale_margin_probe,cadence_probe,
profile_force,view,ladder,energy_drift}.py``, and the kernels' own benches
(``p2p_bench``, ``direct_bench``).  Run one as
``python -m coulomb_oscillators_tpu_torch.scripts.<name>``."""
