"""Concept-stacked linear projections (counterpart of
``tweediemix_tpu/ops/stacked.py``).

Concept weights are stacked tensors with a leading slot axis; a per-row
index picks each batch row's slot (slot 0 = the base model for
Custom-Diffusion K/V, the zero delta for LoRA): a gather and one batched
matmul.
"""

from __future__ import annotations

import torch


def stacked_linear(
    x: torch.Tensor,
    w_stack: torch.Tensor,
    idx: torch.Tensor,
    b_stack: torch.Tensor | None = None,
) -> torch.Tensor:
    """x [B, S, Din] @ w_stack[idx] ([C, Din, Dout] stack) (+ b_stack[idx]).

    ``torch.bmm`` accumulates in fp32 and rounds once to x's dtype."""
    out = torch.bmm(x, w_stack[idx].to(x.dtype))
    if b_stack is not None:
        out = (out.float() + b_stack[idx][:, None, :].float()).to(x.dtype)
    return out


def lora_delta(
    x: torch.Tensor,
    down_stack: torch.Tensor,
    up_stack: torch.Tensor,
    idx: torch.Tensor,
) -> torch.Tensor:
    """Per-row LoRA delta ``(x @ down[idx]) @ up[idx]``, contracted in fp32
    (rank-r factors are tiny, and bf16 rounding of an r=4 inner product is
    a real loss). down_stack [C, Din, r], up_stack [C, r, Dout]."""
    h = torch.bmm(x.float(), down_stack[idx].float())
    return torch.bmm(h, up_stack[idx].float()).to(x.dtype)
