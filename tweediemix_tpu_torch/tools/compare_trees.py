"""Parent/change comparison of the main paths on one card.

Each turn runs one tree's own ``chip_smoke.py`` in a fresh process: its
``phase_build``, then the named main-path phases, in turns A, B, B, A, so that
drift of the host or the card over the call falls on both trees alike.

    python -m tweediemix_tpu_torch.tools.compare_trees A B [--phases w8a8 bf16 video]
        [--out FILE]

A and B are directories that each hold a checkout of the repository (for
example ``git archive <commit> | tar -x -C build/parent``). Each phase's
result is one JSON line, with the tree and the turn, printed and (with
--out) appended to FILE; a one-line summary per phase follows it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = {"w8a8": "phase_w8a8_main_path", "bf16": "phase_main_path",
          "video": "phase_video_main_path"}

# run in the tree's own directory, with that tree first on sys.path
_CHILD = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke
assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == os.getcwd()
chip_smoke.phase_build()
for phase, fn in json.loads(sys.argv[1]):
    out = getattr(chip_smoke, fn)()
    torch.cuda.empty_cache()
    print("RESULT " + json.dumps(dict(phase=phase, **out)), flush=True)
"""


def summary(row: dict) -> str:
    """s/image or s/clip of each timed run, and the profiled calls' device ms."""
    runs = row.get("runs", [])
    per = [r.get("s_per_image", r.get("s_per_clip")) for r in runs]
    prof = {k: round(v["device_busy_ms"], 2) for k, v in (row.get("profile") or {}).items()
            if isinstance(v, dict) and "device_busy_ms" in v}
    return f"{row['tree']} turn {row['turn']} {row['phase']}: s per run {per} device ms {prof}"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("a")
    parser.add_argument("b")
    parser.add_argument("--phases", nargs="+", default=["w8a8"], choices=sorted(PHASES))
    parser.add_argument("--timeout", type=float, default=900.0, help="seconds per turn")
    parser.add_argument("--out", help="append the JSON lines here")
    args = parser.parse_args()
    phases = json.dumps([[p, PHASES[p]] for p in args.phases])
    failed = False
    for turn, tree in enumerate((args.a, args.b, args.b, args.a)):
        proc = subprocess.run([sys.executable, "-c", _CHILD, phases], cwd=os.path.abspath(tree),
                              capture_output=True, text=True, timeout=args.timeout)
        rows = [json.loads(line[len("RESULT "):]) for line in proc.stdout.splitlines()
                if line.startswith("RESULT ")]
        if proc.returncode != 0 or len(rows) != len(args.phases):
            failed = True
            print(f"{tree} turn {turn}: exit code {proc.returncode}\n{proc.stdout[-3000:]}\n"
                  f"{proc.stderr[-3000:]}", flush=True)
        for row in rows:
            row = dict(tree=tree, turn=turn, **row)
            print(summary(row), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
