"""The benchmark's own tests (CPU; ``python -m pytest benchmark/tests``)."""
