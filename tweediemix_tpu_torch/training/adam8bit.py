"""Blockwise int8-state AdamW, the counterpart of
``tweediemix_tpu/training/adam8bit.py`` (the reference trainer's
bitsandbytes ``AdamW8bit`` under ``--use_8bit_adam``).

Both moments are stored as int8 in blocks of ``BLOCK`` values with one fp32
abs-max scale per block, linear codes as in the JAX package; the second
moment is stored as its square root, so a small but non-zero curvature
survives 8 bits. Each step dequantises, updates in fp32 as ``optim.AdamW``
does, and quantises again.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from tweediemix_tpu_torch.training.optim import AdamW

BLOCK = 256


def quantize_blockwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8 [nblocks, BLOCK], scale fp32 [nblocks, 1]); the flat
    tensor is zero-padded to whole blocks."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = math.prod(shape)
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def quantize_v_blockwise(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second moment, stored in the square-root domain."""
    return quantize_blockwise(torch.sqrt(v))


def dequantize_v_blockwise(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    s = dequantize_blockwise(q, scale, shape)
    return s * s


class AdamW8bit(AdamW):
    """``AdamW`` whose moments live as int8 blocks between steps (the JAX
    package's ``adamw8bit``: ``scale_by_adam8bit``, decay, learning rate)."""

    def init_moments(self, p: torch.Tensor) -> Dict:
        zeros = torch.zeros_like(p, dtype=torch.float32)
        m_q, m_s = quantize_blockwise(zeros)
        v_q, v_s = quantize_blockwise(zeros)
        return dict(m_q=m_q, m_scale=m_s, v_q=v_q, v_scale=v_s)

    def read_moments(self, st: Dict, p: torch.Tensor):
        return (dequantize_blockwise(st["m_q"], st["m_scale"], p.shape),
                dequantize_v_blockwise(st["v_q"], st["v_scale"], p.shape))

    def write_moments(self, st: Dict, mu: torch.Tensor, nu: torch.Tensor) -> None:
        st["m_q"], st["m_scale"] = quantize_blockwise(mu)
        st["v_q"], st["v_scale"] = quantize_v_blockwise(nu)
