"""Run one cell of the benchmark of ``tweediemix_tpu_torch`` on this
machine's CUDA devices and print its result as the last line of standard
output (one JSON object).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a traced slice after the window. Without the CUDA
devices the cell asks for, it prints no result and exits with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# kernel builds stay inside the checkout, at a fixed path
os.environ.setdefault("TWEEDIEMIX_COMPILE_CACHE", os.path.join(ROOT, "build"))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark.harness import run

    return run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
