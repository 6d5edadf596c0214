"""Run one cell of ``BENCHMARK.json`` once, on the CUDA card of this machine.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints diagnostics and, last, each number that
``correct`` compares beside its limit on standard error, and one JSON line
on standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its per-layer
metrics), ``device``, with ``--trace 1`` a ``breakdown``, and ``checks``.
Exits non-zero, printing no result, where there is no CUDA card or fewer
than the cell asks for, where a JAX module was loaded, or where anything
fails."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HOST_THREADS = 2  # the host's work is one thread launching; few threads keep the run's load steady


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    sys.path.insert(0, str(ROOT))  # the port's kernel library builds into its own build/ directory, inside the checkout
    from port_bench import cell as cell_run
    from port_bench import check, spec

    cell = spec.load_cell(args.workload)
    import torch

    torch.set_num_threads(HOST_THREADS)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(line):
        print(line, file=sys.stderr, flush=True)

    result = cell_run.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START, log)
    log(f"card: {card_line()}")
    forbidden = cell_run.forbidden_modules()
    if forbidden:
        log(f"modules loaded in the run's process: {forbidden}")
        return 3
    for line in check.lines(result["checks"]):
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
