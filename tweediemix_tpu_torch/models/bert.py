"""BERT encoder, GroundingDINO's text backbone (counterpart of
``tweediemix_tpu/models/bert.py``).

HF ``BertModel`` without its pooler: word, position and token-type
embeddings summed and LayerNormed (eps 1e-12), then post-norm layers
(attention → residual + LayerNorm → exact-GELU MLP → residual + LayerNorm).
The attention mask is GroundingDINO's 3-D block-diagonal phrase mask
[B, S, S] (True = attend: each "phrase." segment attends within itself),
added to the scores as 0 or ``finfo(float32).min``; a 2-D padding mask
[B, S] is broadcast over the queries. The attention is plain fp32 math, as
in the JAX package. Parameter names are the JAX tree's (``layer_0.query``,
``word_embeddings``), so ``models/convert.py`` maps one onto the other by
layout alone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tweediemix_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @staticmethod
    def base(**kw) -> "BertConfig":
        """bert-base-uncased (the defaults)."""
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        defaults = dict(vocab_size=2000, hidden_size=32, num_layers=2,
                        num_heads=2, intermediate_size=64,
                        max_position_embeddings=64)
        defaults.update(kw)
        return BertConfig(**defaults)


def additive_mask(mask: torch.Tensor) -> torch.Tensor:
    """A boolean attend mask [B, S, S] (or a padding mask [B, S], True =
    a real token, broadcast over the queries) → the additive [B, 1, S, S]
    mask: 0 where attended, ``finfo(float32).min`` elsewhere."""
    if mask.ndim == 2:
        mask = mask[:, None, :].expand(-1, mask.shape[1], -1)
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, None], zero, torch.finfo(torch.float32).min)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)
        self.attn_out = nn.Linear(d, d)
        self.attn_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(d, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, d)
        self.output_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, additive: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, d = x.shape
        h = self.cfg.num_heads
        dh = d // h

        def split(t):
            return t.reshape(b, s, h, dh).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        if additive is not None:
            scores = scores + additive
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
        x = self.attn_norm(x + self.attn_out(ctx.transpose(1, 2).reshape(b, s, d)))
        y = self.output(F.gelu(self.intermediate(x)))
        return self.output_norm(x + y)


class BertTextEncoder(nn.Module):
    """forward(input_ids [B, S], attend mask [B, S, S] or [B, S] bool or
    None, token_type_ids, position_ids) → the last hidden state [B, S,
    hidden], fp32. Parameters are created on ``device``."""

    def __init__(self, config: BertConfig, device="cuda"):
        super().__init__()
        self.config = cfg = config
        d = cfg.hidden_size
        with torch.device(resolve_device(device)):
            self.word_embeddings = nn.Parameter(torch.empty(cfg.vocab_size, d))
            self.position_embeddings = nn.Parameter(torch.empty(cfg.max_position_embeddings, d))
            self.token_type_embeddings = nn.Parameter(torch.empty(cfg.type_vocab_size, d))
            self.embeddings_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
            for i in range(cfg.num_layers):
                self.add_module(f"layer_{i}", BertLayer(cfg))
            for p in (self.word_embeddings, self.position_embeddings, self.token_type_embeddings):
                nn.init.normal_(p, std=0.02)

    def forward(self, input_ids, attend_mask=None, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device).expand(b, s)
        x = (self.word_embeddings[input_ids] + self.position_embeddings[position_ids]
             + self.token_type_embeddings[token_type_ids])
        x = self.embeddings_norm(x)
        additive = None if attend_mask is None else additive_mask(attend_mask)
        for i in range(self.config.num_layers):
            x = getattr(self, f"layer_{i}")(x, additive)
        return x
