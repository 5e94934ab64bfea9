"""Sinusoidal timestep / size-condition embeddings (counterpart of
``tweediemix_tpu/models/embeddings.py``, diffusers conventions)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def timestep_embedding(
    t: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """t: [...] → [..., dim] sinusoidal features (fp32); ``flip_sin_to_cos``
    puts cos first."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = t.float()[..., None] * freqs
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear_1 → SiLU → linear_2 MLP over Fourier features."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))
