"""Entry point: ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, from the repository's root."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _program_env(argv) -> None:
    """The cell's configuration's ``program_env``, set before NumPy and
    PyTorch are imported: their thread pools read it once, at import.
    A cell or file that is not there is left to the harness to report."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    args, _ = ap.parse_known_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            cfg = next(w["config"] for w in json.load(f)["workloads"]
                       if w["name"] == args.workload)
        with open(os.path.join(root, "benchmark", "configs",
                               f"{cfg}.json")) as f:
            env = json.load(f).get("program_env", {})
    except (OSError, StopIteration, KeyError, ValueError):
        return
    os.environ.update({k: str(v) for k, v in env.items()})


if __name__ == "__main__":
    _program_env(sys.argv[1:])
    from benchmark import harness
    sys.exit(harness.main(t_start=T_START))
