"""Calibrate per-site static activation scales for the W8A8 serving path
(counterpart of the repository's ``tools/calibrate_quant.py``).

Runs warm-up UNet forwards at the headline fusion geometry (batch N+1 = 4
rows, timesteps 999, 501 and 1 across the trajectory) with a hook on every
quantised matmul (``ops/quant.py::calibrate``) and writes a JSON table
``{site: margin · abs_max}`` that ``TWEEDIEMIX_QUANT_SCALES`` (and
``ops/quant.py::load_static_scales``) reads. ``calibrate`` takes the place
of the JAX package's ``TWEEDIEMIX_QUANT_CALIBRATE`` collection: there is no
such environment knob in the port.

    python -m tweediemix_tpu_torch.tools.calibrate_quant [--out quant_scales.json] \\
        [--res 1024] [--margin 1.25] [--micro]

The UNet is ``UNetConfig.sdxl(concept_slots=4, quant="int8")`` in bf16 on the
card (``--micro``: the micro config in fp32), its weights 0.02 · N(0, 1)
drawn from a numpy seed per tensor, as the JAX tool draws its random
weights (its ``jax.random`` stream is not reproduced); the probe inputs come
from a numpy seed too. It runs on the card; ``main(argv, device="cpu")``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections.abc import Mapping

import numpy as np
import torch

N_CONCEPTS = 3  # concepts with the background; fused batch rows = N + 1
PROBE_TIMESTEPS = (999, 501, 1)
WEIGHT_STD = 0.02


class SeededTensors(Mapping):
    """Checkpoint-named tensors of ``shapes``, each WEIGHT_STD · N(0, 1) in
    fp32 from ``numpy.random.default_rng([seed, i])``, i its index in sorted
    name order, drawn when read."""

    def __init__(self, shapes: Mapping, seed: int):
        self.shapes = dict(shapes)
        self._index = {name: i for i, name in enumerate(sorted(self.shapes))}
        self.seed = seed

    def __getitem__(self, name: str) -> torch.Tensor:
        rng = np.random.default_rng([self.seed, self._index[name]])
        return torch.from_numpy(WEIGHT_STD * rng.standard_normal(self.shapes[name], np.float32))

    def __iter__(self):
        return iter(self.shapes)

    def __len__(self) -> int:
        return len(self.shapes)


def random_unet(ucfg, seed: int = 0, device="cuda"):
    """A ``UNet2DConditionModel(ucfg)`` on ``device`` with seeded random
    weights: the base tensors from ``seed``, each further concept slot's
    cross-attention K/V from ``seed + slot``; quantised sites take int8
    weights from these fp32 values."""
    from tweediemix_tpu_torch.concepts.delta import is_cross_kv
    from tweediemix_tpu_torch.models.convert import checkpoint_shapes, load_checkpoint
    from tweediemix_tpu_torch.models.unet2d import UNet2DConditionModel

    module = UNet2DConditionModel(ucfg, device="meta")
    shapes = checkpoint_shapes(module)
    cross = {n: s for n, s in shapes.items() if is_cross_kv(n)}
    concepts = [SeededTensors(cross, seed + slot) for slot in range(1, ucfg.concept_slots)]
    return load_checkpoint(module, SeededTensors(shapes, seed), device, concept_kvs=concepts)


def probe_inputs(batch: int, hw: int, ctx_len: int, ctx_dim: int, pool_dim: int, seed: int = 0):
    """numpy (x [B, hw, hw, 4], ctx [B, ctx_len, ctx_dim] · 0.1, pooled
    [B, pool_dim] · 0.1, time ids [B, 6] of a (8·hw)² image, row index [B])."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, hw, hw, 4), np.float32)
    ctx = (0.1 * rng.standard_normal((batch, ctx_len, ctx_dim), np.float32))
    pooled = (0.1 * rng.standard_normal((batch, pool_dim), np.float32))
    size = float(hw * 8)
    tids = np.tile(np.array([[size, size, 0, 0, size, size]], np.float32), (batch, 1))
    return x, ctx, pooled, tids, np.arange(batch, dtype=np.int64)


def calibrate_unet(unet, inputs, margin: float = 1.25) -> dict:
    """{site: margin · the largest |x| seen at that site} over one forward
    per ``PROBE_TIMESTEPS`` entry, ``inputs`` from ``probe_inputs`` (moved
    to the UNet's device)."""
    from tweediemix_tpu_torch.ops.quant import calibrate

    device = next(unet.parameters()).device
    x, ctx, pooled, tids, idx = (torch.from_numpy(a).to(device) for a in inputs)
    return calibrate(unet, [(x, t, ctx, pooled, tids, idx) for t in PROBE_TIMESTEPS],
                     margin=margin)


def main(argv=None, device="cuda") -> int:
    from tweediemix_tpu_torch.device import resolve_device
    from tweediemix_tpu_torch.models.unet2d import UNetConfig

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="quant_scales.json")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--margin", type=float, default=1.25,
                    help="headroom multiplier over the observed abs-max")
    ap.add_argument("--micro", action="store_true", help="micro config (smoke runs)")
    args = ap.parse_args(argv)
    device = resolve_device(device)

    b = N_CONCEPTS + 1
    if args.micro:
        ucfg = UNetConfig.micro(concept_slots=b, quant="int8")
        hw, ctx_len = 8, 16
    else:
        ucfg = UNetConfig.sdxl(dtype=torch.bfloat16, concept_slots=b, quant="int8")
        hw, ctx_len = args.res // 8, 77
    unet = random_unet(ucfg, seed=0, device=device)
    inputs = probe_inputs(b, hw, ctx_len, ucfg.cross_attention_dim, ucfg.pooled_projection_dim,
                          seed=0)
    table = calibrate_unet(unet, inputs, margin=args.margin)
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    vals = sorted(table.values())
    print(f"calibrated {len(table)} sites -> {args.out}; abs-max "
          f"min {vals[0]:.3g} / median {vals[len(vals) // 2]:.3g} / max {vals[-1]:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
