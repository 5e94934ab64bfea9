"""Seeded random weights and inputs, made on the device in a few large calls.

``draw(shapes, dtype, seed, stream, device)`` gives checkpoint-named tensors
for ``shapes`` ({name: shape}): a matrix or convolution kernel is
N(0, 1/(3 fan_in)) (the variance of PyTorch's default initialisation), a
1-D ``weight`` (a norm's scale) 1 + 0.1 N(0, 1), a bias 0.02 N(0, 1). The
tensors of one init are views into one buffer filled by one ``randn``
call from a generator seeded by ``(seed, stream, group)``, so the same
arguments give the same tensors, bit for bit, in any process: a run draws
the weights for the program, frees them, and draws them again for the
reference after its window.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch


def seed_of(*parts: int) -> int:
    """A 63-bit generator seed from whole numbers of any size."""
    return int(np.random.SeedSequence([abs(int(p)) for p in parts]).generate_state(
        1, np.uint64)[0] >> 1)


def generator(device, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(*parts))


def init_of(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """(mean, std) of a tensor's draw (module docstring)."""
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(3.0 * math.prod(shape[1:]))
    if name.endswith("weight"):
        return 1.0, 0.1
    return 0.0, 0.02


def draw(shapes: Mapping[str, Sequence[int]], dtype: torch.dtype, seed: int, stream: int,
         device) -> Dict[str, torch.Tensor]:
    groups: Dict[Tuple[float, float], list] = {}
    for name in sorted(shapes):
        groups.setdefault(init_of(name, shapes[name]), []).append(name)
    out = {}
    for g, (key, names) in enumerate(sorted(groups.items())):
        mean, std = key
        sizes = [math.prod(shapes[n]) for n in names]
        buf = torch.randn(sum(sizes), generator=generator(device, seed, stream, g),
                          device=device, dtype=torch.float32)
        buf = buf.mul_(std).add_(mean).to(dtype)
        for name, part in zip(names, torch.split(buf, sizes)):
            out[name] = part.view(tuple(shapes[name]))
    return out


def normal(shape, scale: float, seed: int, stream: int, device) -> torch.Tensor:
    """scale * N(0, 1) of ``shape`` in fp32."""
    return scale * torch.randn(tuple(shape), generator=generator(device, seed, stream),
                               device=device)


def uniform(shape, low: float, high: float, seed: int, stream: int, device) -> torch.Tensor:
    return low + (high - low) * torch.rand(tuple(shape), generator=generator(device, seed, stream),
                                           device=device)


def shapes_of(module: torch.nn.Module) -> Dict[str, tuple]:
    """{name: shape} of a module's parameters (built on ``meta``)."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
