"""Read a cell's control and judge it by the cell's own limits: the numbers
that decide ``correct``, each computed with the control one precision below
the configuration's in the program's place (the workload's ``control``: a
program built with its own lower-precision path, or the plain UNet at fewer
bits; the update in bfloat16 and the decode with TF32 always), and compared
through ``harness.judge``, the comparison that a run makes. The benchmark's
runs never run it.

    python3 benchmark/controls.py --workload <cell> --seeds <n> [<n> ...] [--requests 2]

Prints one JSON line per seed, on the cell's own sizes and requests: the
control's ``correct`` (false where the limits hold), each number beside its
limit, the numbers it fails, and the program's own numbers of that build.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("TWEEDIEMIX_COMPILE_CACHE", os.path.join(ROOT, "build"))
os.environ.setdefault("USE_FLAX", "0")


def control_numbers(cell: str, seed: int, requests: int, device: str = "cuda",
                    cell_data=None):
    """(the program's numbers as built for the control, the control's)."""
    import importlib

    from benchmark.harness import Reservoir, load_cell, request_seed

    wl, cfg = load_cell(cell) if cell_data is None else cell_data
    control = wl["control"]
    built = dict(wl, **control.get("program", {}))
    for key, value in built.get("env", {}).items():
        os.environ[key] = value
    driver = importlib.import_module(f"benchmark.systems.{cfg['system']}")
    system = driver.System(cfg, built, seed, device)
    system.warm()
    reservoir = Reservoir(requests, seed)
    for i in range(requests):
        rseed = request_seed(seed, i)
        system.request(rseed, reservoir.current)
        reservoir.offer(dict(seed=rseed))
    system.wl = dict(wl, check=built["check"])  # compared against the cell's own reference
    return system.check(reservoir, control=control)


def judged(cell: str, seed: int, requests: int, device: str = "cuda", cell_data=None) -> dict:
    from benchmark.harness import judge, load_cell

    wl, _ = load_cell(cell) if cell_data is None else cell_data
    program, control = control_numbers(cell, seed, requests, device, cell_data)
    correct, compared = judge(control, wl["limits"], 0)
    return dict(workload=cell, seed=seed, correct=correct,
                fails=[k for k, (v, lim) in compared.items() if not v <= lim],
                compared={k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()},
                program_as_built=program)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=2)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(judged(args.workload, seed, args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
