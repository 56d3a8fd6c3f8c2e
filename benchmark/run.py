"""Run one cell of the benchmark once on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's inputs from the seed, warms its shapes, runs timed calls
of the program for ``--seconds``, checks every answer against the plain
reference and prints the result as one JSON object, the last line of
standard output; the numbers compared, each beside its limit, are the last
lines of standard error. ``--trace 1`` runs the window under the profiler
and reports the cell's per-layer metrics instead of its end-to-end ones.
Exits non-zero, with no result, without a CUDA card (or with fewer cards
than the cell asks for).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Build and kernel caches at fixed places inside the checkout."""
    cache = ROOT / "benchmark" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import harness

    chips = harness.Bench(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available():
        print("no CUDA card is visible; the benchmark runs only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
