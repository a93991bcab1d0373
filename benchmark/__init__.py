"""The benchmark of ``coulomb_oscillators_tpu_torch`` (the PyTorch + CUDA
port): ``python3 -m benchmark.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the repository's root.  ``harness.py`` says how a
run goes; ``BENCHMARK.json`` at the root lists the cells and metrics."""
