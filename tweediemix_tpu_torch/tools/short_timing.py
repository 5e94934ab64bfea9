"""Device-only times of the frame-axis (short-sequence) attention kernel, and
the same times of an earlier tree's kernel beside them.

    python -m tweediemix_tpu_torch.tools.short_timing [--parent DIR] [--out FILE]

Needs one CUDA card and nvcc. At the video path's five shapes, on q/k/v as
views of one merged projection and as contiguous tensors, it times the
kernel by three readings (``utils/profiling.py``), each after a check against
the plain version (max err / max |plain| <= 1e-2):

- ``ms``: device ms per launch, 50 launches captured in one CUDA graph and
  the replay timed with CUDA events (the host's enqueue rate cannot show);
- ``flushed_ms``: the same with a 64 MB read between launches, so that the
  50 MB L2 holds none of the inputs; the share of the bytes bound is taken
  from it;
- ``host_us``: host microseconds per wrapper call with the device kept busy.

With ``--parent DIR`` (a checkout, for example ``git archive <commit> | tar
-x -C build/parent``) both trees are timed, in turns parent, this, this,
parent. Each turn runs this file in a fresh process rooted at its tree: the
process imports that tree's own ``short_seq_attention``, whose library the
tree builds with the same nvcc into its own ``build/``, and takes its timers
from this file's ``utils/profiling.py``, loaded by its path, so that both
trees are timed alike. Each result is one JSON line per tree, shape and
layout, printed and (with --out) appended to FILE.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

H100_HBM_BYTES = 3.35e12  # HBM3 bytes/s, H100 SXM data sheet
# (N, S, heads, dh) of the video path's five shapes per UNet call
# (transformer_in, levels 0-2, mid) and their launches per clip (50 steps)
SHAPES = [(8192, 16, 8, 64), (8192, 16, 5, 64), (2048, 16, 10, 64), (512, 16, 20, 64),
          (128, 16, 20, 64)]
LAUNCHES_PER_CLIP = [100, 500, 500, 500, 100]
TOL = 1e-2
TURNS = ("parent", "this", "this", "parent")
ROOT = Path(__file__).resolve().parents[2]  # the checkout this file belongs to
_ROW = "ROW "  # a child process's result lines


def _timers():
    """This checkout's ``utils/profiling.py``, loaded by its path (it imports
    nothing of the package), beside whichever tree's package is imported."""
    spec = importlib.util.spec_from_file_location(
        "short_timing_profiling", ROOT / "tweediemix_tpu_torch" / "utils" / "profiling.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def short_bytes(n: int, s: int, heads: int, dh: int) -> float:
    """Bytes the function must move: q, k and v read once, o written once."""
    return 4.0 * n * s * heads * dh * 2


def short_inputs(n, s, heads, dh, merged: bool, seed: int):
    """bf16 q/k/v [n, s, heads·dh] on the card: ``chunk(3)`` views of one
    merged projection (as the model's self-attention gives them) or three
    contiguous tensors."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    d = heads * dh
    if merged:
        qkv = torch.randn((n, s, 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
        return qkv.chunk(3, dim=-1)
    return [torch.randn((n, s, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


def time_tree() -> list:
    """The three readings of the imported package's kernel at every shape
    and layout, each after its check against the plain version."""
    import torch

    from tweediemix_tpu_torch.ops.short_attention import (
        short_seq_attention,
        short_seq_attention_reference,
    )

    timers = _timers()
    rows = []
    for n, s, heads, dh in SHAPES:
        for merged in (True, False):
            q, k, v = short_inputs(n, s, heads, dh, merged, seed=n + heads)

            def fn():
                return short_seq_attention(q, k, v, heads)

            plain = short_seq_attention_reference(q.float(), k.float(), v.float(), heads)
            err = (fn().float() - plain).abs().max().item() / plain.abs().max().item()
            if not err <= TOL:
                raise AssertionError(f"kernel disagrees with its plain version at "
                                     f"{(n, s, heads, dh)}: {err:.3e} > {TOL}")
            rows.append(dict(shape=[n, s, heads, dh], merged_qkv=merged, rel_err=err,
                             ms=timers.graph_ms(fn), flushed_ms=timers.flushed_ms(fn),
                             host_us=timers.host_us_per_call(fn)))
            del q, k, v, plain
            torch.cuda.empty_cache()
    return rows


def _run_turn(root: Path) -> list:
    """``time_tree`` of the checkout at ``root``, in a fresh process."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child"],
                          cwd=root, env=dict(os.environ, PYTHONPATH=str(root)),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"short_timing: the turn of {root} failed ({proc.returncode}):\n"
                         f"{proc.stderr[-4000:]}")
    return [json.loads(line[len(_ROW):]) for line in proc.stdout.splitlines()
            if line.startswith(_ROW)]


def summarise(tree: str, turns: list) -> list:
    """One row per shape and layout: the turns' mean readings, the bytes
    bound, the share of it (from the flushed reading) and the loss per clip."""
    out = []
    for i, first in enumerate(turns[0]):
        rows = [turn[i] for turn in turns]
        assert all(r["shape"] == first["shape"] and r["merged_qkv"] == first["merged_qkv"]
                   for r in rows)
        n, s, heads, dh = first["shape"]
        nbytes = short_bytes(n, s, heads, dh)
        bound_ms = nbytes / H100_HBM_BYTES * 1e3
        per_clip = LAUNCHES_PER_CLIP[SHAPES.index(tuple(first["shape"]))]
        mean = {key: sum(r[key] for r in rows) / len(rows)
                for key in ("rel_err", "ms", "flushed_ms", "host_us")}
        out.append(dict(tree=tree, shape=first["shape"], merged_qkv=first["merged_qkv"],
                        bytes=nbytes, bound_ms=bound_ms, launches_per_clip=per_clip, **mean,
                        share_of_bound=bound_ms / mean["flushed_ms"],
                        gbytes_per_s=nbytes / mean["flushed_ms"] / 1e6,
                        loss_ms_per_clip=per_clip * (mean["flushed_ms"] - bound_ms),
                        turns=rows))
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="an earlier checkout to time beside this one")
    parser.add_argument("--out", help="append the JSON lines here")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("short_timing needs a CUDA card")
    if args.child:
        for row in time_tree():
            print(_ROW + json.dumps(row), flush=True)
        return
    if args.parent:
        trees = dict(parent=args.parent.resolve(), this=ROOT)
        turns = {}
        for name in TURNS:
            turns.setdefault(name, []).append(_run_turn(trees[name]))
    else:
        turns = dict(this=[time_tree()])
    for name, runs in turns.items():
        for row in summarise(name, runs):
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
