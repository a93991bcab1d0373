"""Measurement scripts of the port (twins of the repository's
``scripts/ladder.py`` and ``scripts/energy_drift.py``)."""
