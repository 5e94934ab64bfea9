"""GroundingDINO, the reference's text-conditioned box detector (counterpart
of ``tweediemix_tpu/models/dino.py``).

The reference segments each concept with GroundingDINO Swin-B (boxes from a
caption, then SAM on each box); its ``groundingdino_swinb_cogcoor.pth`` loads
through ``models/convert.py::load_dino``. The model, in fp32:

* a Swin backbone (``models/swin.py``): three stages plus one extra
  stride-2 3×3 conv level, each projected to ``d_model`` by a conv and
  GroupNorm(32);
* a BERT text backbone (``models/bert.py``) under GroundingDINO's
  block-diagonal phrase mask, projected to ``d_model``;
* the feature-enhancer encoder: per layer, image↔text fusion
  (``BiMultiHeadAttention`` with layer-scale residuals), text
  self-attention with sine position embeddings, and multi-scale
  deformable image self-attention;
* two-stage query selection: the top ``num_queries`` encoder positions by
  their best text similarity seed the decoder's reference boxes;
* the decoder: query self-attention → text cross-attention → deformable
  image cross-attention → FFN, refining the boxes through the one shared
  ``bbox_embed``; class logits are the query·text products.

The deformable sampling is the JAX package's: four corner gathers per level
with zero padding (``grid_sample``'s semantics, ``align_corners=False``, at
x = loc·w − 0.5), weighted by one softmax over every level and point of a
head. Every attention is plain fp32 math (none reaches ``ops/attention.py``).
Both top-k selections order equal scores by the lower index first, as
``jax.lax.top_k`` does (a stable descending sort). Images are fully valid
(batch-1 full images, no pixel masks). Static geometry (sine embeddings,
reference points, anchor proposals) is numpy, made once per map size and
device. Parameter names are the JAX tree's (``encoder_layers_0.fusion_layer
.attn.vision_proj``), so ``models/convert.py`` maps one onto the other by
layout alone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tweediemix_tpu_torch.device import resolve_device
from tweediemix_tpu_torch.models.bert import BertConfig, BertTextEncoder, additive_mask
from tweediemix_tpu_torch.models.swin import SwinBackbone, SwinConfig
from tweediemix_tpu_torch.segmentation.lang_sam import resize_bilinear

# BERT's special tokens that delimit phrases: [CLS], [SEP], ".", "?"
# (bert-base-uncased's ids)
SPECIAL_TOKENS = (101, 102, 1012, 1029)
# ImageNet statistics (the reference's RandomResize + Normalize transform)
DINO_IMAGE_MEAN = (0.485, 0.456, 0.406)
DINO_IMAGE_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DinoConfig:
    swin: SwinConfig = dataclasses.field(default_factory=SwinConfig.swin_b)
    text: BertConfig = dataclasses.field(default_factory=BertConfig.base)
    d_model: int = 256
    num_queries: int = 900
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_attention_heads: int = 8
    decoder_attention_heads: int = 8
    encoder_ffn_dim: int = 2048
    decoder_ffn_dim: int = 2048
    num_feature_levels: int = 4
    encoder_n_points: int = 4
    decoder_n_points: int = 4
    max_text_len: int = 256
    layer_norm_eps: float = 1e-5
    positional_embedding_temperature: float = 20.0
    max_boxes: int = 8  # boxes the predict wrapper returns

    @staticmethod
    def swin_b(**kw) -> "DinoConfig":
        """groundingdino_swinb_cogcoor (the reference's detector)."""
        return DinoConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "DinoConfig":
        defaults = dict(
            swin=SwinConfig.tiny(), text=BertConfig.tiny(), d_model=32,
            num_queries=10, encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=4, decoder_attention_heads=4,
            encoder_ffn_dim=64, decoder_ffn_dim=64, num_feature_levels=3,
            max_text_len=16, max_boxes=4,
        )
        defaults.update(kw)
        return DinoConfig(**defaults)


# -- static geometry (numpy) ----------------------------------------------------------


def _sine_position_embedding(h: int, w: int, d_model: int, temperature: float) -> np.ndarray:
    """DETR's 2-D sine embedding of a fully valid (h, w) map, [h·w, d_model]."""
    half = d_model // 2
    eps = 1e-6
    y = (np.arange(1, h + 1, dtype=np.float32) / (h + eps) * 2 * np.pi)[:, None]
    x = (np.arange(1, w + 1, dtype=np.float32) / (w + eps) * 2 * np.pi)[None, :]
    y = np.broadcast_to(y, (h, w))
    x = np.broadcast_to(x, (h, w))
    dim_t = temperature ** (2 * (np.arange(half, dtype=np.float32) // 2) / half)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])], -1).reshape(h, w, half)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])], -1).reshape(h, w, half)
    return np.concatenate([py, px], -1).reshape(h * w, d_model)


def get_sine_pos_embed(pos: torch.Tensor, num_pos_feats: int, temperature: float = 10000.0,
                       exchange_xy: bool = True) -> torch.Tensor:
    """[..., n] positions → [..., n·num_pos_feats], sin/cos interleaved per
    coordinate; ``exchange_xy`` swaps the first two coordinates' parts."""
    dim_t = temperature ** (2 * (np.arange(num_pos_feats, dtype=np.float32) // 2) / num_pos_feats)
    dim_t = torch.from_numpy(dim_t).to(pos.device)

    def sine(x):
        v = x[..., None] * (2 * math.pi) / dim_t
        return torch.stack([v[..., 0::2].sin(), v[..., 1::2].cos()], -1).reshape(
            *v.shape[:-1], num_pos_feats)

    parts = [sine(pos[..., i]) for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


def _encoder_reference_points(shapes) -> np.ndarray:
    """Each position's normalised centre (x, y), [S, 2]."""
    refs = []
    for h, w in shapes:
        ry, rx = np.meshgrid(np.linspace(0.5, h - 0.5, h, dtype=np.float32) / h,
                             np.linspace(0.5, w - 0.5, w, dtype=np.float32) / w, indexing="ij")
        refs.append(np.stack([rx.reshape(-1), ry.reshape(-1)], -1))
    return np.concatenate(refs, 0)


def _output_proposals(shapes) -> Tuple[np.ndarray, np.ndarray]:
    """Two-stage anchors: ([S, 4] logit cxcywh, +inf where invalid; [S]
    valid = every coordinate in (0.01, 0.99)). The anchor size is 0.05·2^level."""
    props = []
    for level, (h, w) in enumerate(shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                             indexing="ij")
        grid = np.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1).reshape(-1, 2)
        wh = np.full_like(grid, 0.05 * 2.0**level)
        props.append(np.concatenate([grid, wh], -1))
    p = np.concatenate(props, 0)
    valid = ((p > 0.01) & (p < 0.99)).all(-1)
    p = np.log(p / (1 - p))
    p[~valid] = np.inf
    return p.astype(np.float32), valid


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def stable_top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, equal values
    lower index first (``jax.lax.top_k``'s order; ``torch.topk`` promises
    none on CUDA)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


# -- deformable attention -------------------------------------------------------------


def multi_scale_deformable_attention(value, shapes, sampling_locations, attention_weights):
    """value [B, S, H, dh] (the levels' positions concatenated);
    sampling_locations [B, Q, H, L, P, 2] normalised (x, y); attention
    weights [B, Q, H, L, P] → [B, Q, H·dh]. Bilinear sampling with zero
    padding at x = loc·w − 0.5, through four corner gathers per level."""
    b, _, h, dh = value.shape
    q, p = sampling_locations.shape[1], sampling_locations.shape[4]
    sampled, start = [], 0
    for lvl, (hh, ww) in enumerate(shapes):
        v = value[:, start:start + hh * ww].transpose(1, 2).reshape(b * h, hh * ww, dh)
        start += hh * ww
        loc = sampling_locations[:, :, :, lvl]  # [B, Q, H, P, 2]
        x = (loc[..., 0] * ww - 0.5).transpose(1, 2).reshape(b * h, q * p)
        y = (loc[..., 1] * hh - 0.5).transpose(1, 2).reshape(b * h, q * p)
        x0, y0 = torch.floor(x), torch.floor(y)
        wx, wy = x - x0, y - y0

        def corner(xi, yi, weight):
            inside = (xi >= 0) & (xi < ww) & (yi >= 0) & (yi < hh)
            idx = (yi.clamp(0, hh - 1) * ww + xi.clamp(0, ww - 1)).long()
            g = torch.gather(v, 1, idx[:, :, None].expand(-1, -1, dh))
            return g * (weight * inside)[:, :, None]

        out = (corner(x0, y0, (1 - wx) * (1 - wy)) + corner(x0 + 1, y0, wx * (1 - wy))
               + corner(x0, y0 + 1, (1 - wx) * wy) + corner(x0 + 1, y0 + 1, wx * wy))
        sampled.append(out.reshape(b * h, q, p, dh))
    stacked = torch.stack(sampled, dim=2)  # [BH, Q, L, P, dh]
    w = attention_weights.transpose(1, 2).reshape(b * h, q, len(shapes), -1)[..., None]
    out = (stacked * w).sum(dim=(2, 3))  # [BH, Q, dh]
    return out.reshape(b, h, q, dh).transpose(1, 2).reshape(b, q, h * dh)


class DeformableAttention(nn.Module):
    """Query-conditioned sampling offsets and one softmax over each head's
    levels × points, then ``multi_scale_deformable_attention``."""

    def __init__(self, d_model: int, heads: int, n_points: int, n_levels: int):
        super().__init__()
        self.heads, self.n_points, self.n_levels = heads, n_points, n_levels
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, hidden, enc_hidden, pos, reference_points, shapes):
        """hidden [B, Q, C]; enc_hidden [B, S, C]; reference_points
        [B, Q, L, 2] (centres) or [B, Q, L, 4] (boxes)."""
        if pos is not None:
            hidden = hidden + pos
        b, q, d = hidden.shape
        h, lv, p = self.heads, self.n_levels, self.n_points
        value = self.value_proj(enc_hidden).reshape(b, -1, h, d // h)
        offsets = self.sampling_offsets(hidden).reshape(b, q, h, lv, p, 2)
        weights = torch.softmax(self.attention_weights(hidden).reshape(b, q, h, lv * p), dim=-1)
        weights = weights.reshape(b, q, h, lv, p)
        if reference_points.shape[-1] == 2:
            normalizer = torch.tensor([[w_, h_] for h_, w_ in shapes], dtype=torch.float32,
                                      device=hidden.device)
            locs = (reference_points[:, :, None, :, None, :]
                    + offsets / normalizer[None, None, None, :, None, :])
        else:
            locs = (reference_points[:, :, None, :, None, :2]
                    + offsets / p * reference_points[:, :, None, :, None, 2:] * 0.5)
        return self.output_proj(multi_scale_deformable_attention(value, shapes, locs, weights))


# -- attention and fusion blocks ------------------------------------------------------


class MultiheadAttention(nn.Module):
    """query/key/value/out_proj projections, an additive mask."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, queries, keys, values, additive=None):
        b, sq, d = queries.shape
        h = self.heads
        dh = d // h

        def split(t):
            return t.reshape(b, -1, h, dh).transpose(1, 2)

        q, k, v = split(self.query(queries)), split(self.key(keys)), split(self.value(values))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        if additive is not None:
            scores = scores + additive
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, sq, d))


class TextEnhancerLayer(nn.Module):
    """Text self-attention (half the heads) + relu FFN (half width), post-norm."""

    def __init__(self, c: DinoConfig):
        super().__init__()
        self.self_attn = MultiheadAttention(c.d_model, c.encoder_attention_heads // 2)
        self.layer_norm_before = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps)
        self.fc1 = nn.Linear(c.d_model, c.encoder_ffn_dim // 2)
        self.fc2 = nn.Linear(c.encoder_ffn_dim // 2, c.d_model)
        self.layer_norm_after = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps)

    def forward(self, text, text_pos, additive):
        q = text + text_pos
        text = self.layer_norm_before(text + self.self_attn(q, q, text, additive))
        return self.layer_norm_after(text + self.fc2(F.relu(self.fc1(text))))


class BiMultiHeadAttention(nn.Module):
    """Image↔text cross-attention from one score matrix and two softmaxes,
    stabilised as upstream: the whole [B·H, Sv, St] tensor shifted by its
    one global max and clamped at ±50000; the text side's transposed copy
    shifted by its own row max and clamped; -inf only at the text padding,
    on the vision side."""

    def __init__(self, c: DinoConfig):
        super().__init__()
        embed = c.encoder_ffn_dim // 2
        self.heads = c.encoder_attention_heads // 2
        self.vision_proj = nn.Linear(c.d_model, embed)
        self.text_proj = nn.Linear(c.d_model, embed)
        self.values_vision_proj = nn.Linear(c.d_model, embed)
        self.values_text_proj = nn.Linear(c.d_model, embed)
        self.out_vision_proj = nn.Linear(embed, c.d_model)
        self.out_text_proj = nn.Linear(embed, c.d_model)

    def forward(self, vision, text, text_padding_mask=None):
        b, sv, _ = vision.shape
        st = text.shape[1]
        heads = self.heads
        embed = self.vision_proj.out_features
        dh = embed // heads

        def split(t):
            return t.reshape(b, -1, heads, dh).transpose(1, 2).reshape(b * heads, -1, dh)

        def merge(t, s):
            return t.reshape(b, heads, s, dh).transpose(1, 2).reshape(b, s, embed)

        vq = split(self.vision_proj(vision) * dh**-0.5)
        tk = split(self.text_proj(text))
        vv = split(self.values_vision_proj(vision))
        tv = split(self.values_text_proj(text))

        attn = torch.bmm(vq, tk.transpose(1, 2))  # [B·H, Sv, St]
        attn = (attn - attn.max()).clamp(-50000, 50000)
        attn_t = attn.transpose(1, 2)
        attn_t = (attn_t - attn_t.max(dim=-1, keepdim=True).values).clamp(-50000, 50000)
        text_w = torch.softmax(attn_t, dim=-1)
        if text_padding_mask is not None:  # True = padding
            pad = text_padding_mask[:, None, None, :].expand(b, heads, 1, st).reshape(b * heads, 1, st)
            attn = attn.masked_fill(pad, -torch.inf)
        vision_w = torch.softmax(attn, dim=-1)
        return (self.out_vision_proj(merge(torch.bmm(vision_w, tv), sv)),
                self.out_text_proj(merge(torch.bmm(text_w, vv), st)))


class FusionLayer(nn.Module):
    """Pre-norm bi-attention with layer-scale residuals."""

    def __init__(self, c: DinoConfig):
        super().__init__()
        self.layer_norm_vision = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps)
        self.layer_norm_text = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps)
        self.attn = BiMultiHeadAttention(c)
        self.vision_param = nn.Parameter(torch.full((c.d_model,), 1e-4))
        self.text_param = nn.Parameter(torch.full((c.d_model,), 1e-4))

    def forward(self, vision, text, text_padding_mask=None):
        vision = self.layer_norm_vision(vision)
        text = self.layer_norm_text(text)
        dv, dt = self.attn(vision, text, text_padding_mask)
        return vision + self.vision_param * dv, text + self.text_param * dt


class DeformableLayer(nn.Module):
    """Deformable image self-attention + relu FFN, post-norm."""

    def __init__(self, c: DinoConfig):
        super().__init__()
        self.self_attn = DeformableAttention(c.d_model, c.encoder_attention_heads,
                                             c.encoder_n_points, c.num_feature_levels)
        self.self_attn_layer_norm = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps)
        self.fc1 = nn.Linear(c.d_model, c.encoder_ffn_dim)
        self.fc2 = nn.Linear(c.encoder_ffn_dim, c.d_model)
        self.final_layer_norm = nn.LayerNorm(c.d_model, eps=c.layer_norm_eps)

    def forward(self, vision, pos, reference_points, shapes):
        vision = self.self_attn_layer_norm(
            vision + self.self_attn(vision, vision, pos, reference_points, shapes))
        return self.final_layer_norm(vision + self.fc2(F.relu(self.fc1(vision))))


class EncoderLayer(nn.Module):
    """fusion → text enhancement → deformable image self-attention."""

    def __init__(self, c: DinoConfig):
        super().__init__()
        self.fusion_layer = FusionLayer(c)
        self.text_enhancer_layer = TextEnhancerLayer(c)
        self.deformable_layer = DeformableLayer(c)

    def forward(self, vision, text, vision_pos, text_pos, reference_points, shapes,
                text_attend_mask, text_padding_mask):
        vision, text = self.fusion_layer(vision, text, text_padding_mask)
        text = self.text_enhancer_layer(text, text_pos, additive_mask(text_attend_mask))
        vision = self.deformable_layer(vision, vision_pos, reference_points, shapes)
        return vision, text


class DecoderLayer(nn.Module):
    """query self-attention → text cross-attention → deformable image
    cross-attention → relu FFN, each post-norm."""

    def __init__(self, c: DinoConfig):
        super().__init__()
        d, eps = c.d_model, c.layer_norm_eps
        self.self_attn = MultiheadAttention(d, c.decoder_attention_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.encoder_attn_text = MultiheadAttention(d, c.decoder_attention_heads)
        self.encoder_attn_text_layer_norm = nn.LayerNorm(d, eps=eps)
        self.encoder_attn = DeformableAttention(d, c.decoder_attention_heads, c.decoder_n_points,
                                                c.num_feature_levels)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, c.decoder_ffn_dim)
        self.fc2 = nn.Linear(c.decoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, hidden, query_pos, reference_points, enc_vision, enc_text, text_additive,
                shapes):
        q = hidden + query_pos
        hidden = self.self_attn_layer_norm(hidden + self.self_attn(q, q, hidden))
        attn = self.encoder_attn_text(hidden + query_pos, enc_text, enc_text, text_additive)
        hidden = self.encoder_attn_text_layer_norm(hidden + attn)
        attn = self.encoder_attn(hidden, enc_vision, query_pos, reference_points, shapes)
        hidden = self.encoder_attn_layer_norm(hidden + attn)
        return self.final_layer_norm(hidden + self.fc2(F.relu(self.fc1(hidden))))


class MLPHead(nn.Module):
    """relu MLP ``layers_0`` … ``layers_{n-1}`` (DETR's prediction head)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layers_{i}", nn.Linear(
                input_dim if i == 0 else hidden_dim,
                output_dim if i == num_layers - 1 else hidden_dim))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


# -- the model ------------------------------------------------------------------------


class GroundingDino(nn.Module):
    """forward(pixels [B, H, W, 3] ImageNet-normalised, input_ids [B, S],
    text_attend_mask [B, S, S] bool phrase mask, position_ids [B, S],
    text_token_mask [B, S] bool (True = a real token)) → (logits [B,
    num_queries, max_text_len], -inf past the text and at padding; boxes
    [B, num_queries, 4] normalised cxcywh), fp32. ``encode_text``,
    ``encode_image``, ``encode`` and ``decode`` are its four stages in
    order. Parameters are created on ``device``."""

    def __init__(self, config: DinoConfig, device="cuda"):
        super().__init__()
        self.config = c = config
        device = resolve_device(device)
        d = c.d_model
        self.backbone = SwinBackbone(c.swin, device=device)
        self.text_backbone = BertTextEncoder(c.text, device=device)
        chans = c.swin.out_channels
        with torch.device(device):
            for i in range(c.num_feature_levels):
                if i < len(chans):  # 1x1 convs on the backbone's levels, 3x3 stride 2 beyond
                    conv = nn.Conv2d(chans[i], d, 1)
                else:
                    conv = nn.Conv2d(chans[-1] if i == len(chans) else d, d, 3, stride=2, padding=1)
                self.add_module(f"input_proj_{i}_conv", conv)
                self.add_module(f"input_proj_{i}_norm",
                                nn.GroupNorm(32 if d % 32 == 0 else d, d, eps=1e-5))
            self.text_projection = nn.Linear(c.text.hidden_size, d)
            self.query_position_embeddings = nn.Embedding(c.num_queries, d)
            self.level_embed = nn.Parameter(torch.randn(c.num_feature_levels, d))
            for i in range(c.encoder_layers):
                self.add_module(f"encoder_layers_{i}", EncoderLayer(c))
            for i in range(c.decoder_layers):
                self.add_module(f"decoder_layers_{i}", DecoderLayer(c))
            self.decoder_layer_norm = nn.LayerNorm(d, eps=c.layer_norm_eps)
            self.reference_points_head = MLPHead(2 * d, d, d, 2)
            self.enc_output = nn.Linear(d, d)
            self.enc_output_norm = nn.LayerNorm(d, eps=c.layer_norm_eps)
            self.encoder_output_bbox_embed = MLPHead(d, d, 4, 3)
            # one bbox head shared by the decoder's refinement and the output
            self.bbox_embed = MLPHead(d, d, 4, 3)
        self._geometry: Dict[tuple, Dict[str, torch.Tensor]] = {}

    def geometry(self, shapes, device) -> Dict[str, torch.Tensor]:
        """The static tensors of these level shapes on ``device``: sine
        position embeddings ``pos`` [S, d], encoder reference points
        ``refs`` [S, 2], anchor ``proposals`` [S, 4] and ``valid`` [S]."""
        key = (shapes, device)
        if key not in self._geometry:
            c = self.config
            pos = np.concatenate([_sine_position_embedding(h, w, c.d_model,
                                                           c.positional_embedding_temperature)
                                  for h, w in shapes], axis=0)
            proposals, valid = _output_proposals(shapes)
            self._geometry[key] = {name: torch.from_numpy(np.ascontiguousarray(a)).to(device) for name, a in (
                ("pos", pos), ("refs", _encoder_reference_points(shapes)),
                ("proposals", proposals), ("valid", valid))}
        return self._geometry[key]

    def _contrastive(self, queries, text, text_token_mask):
        logits = torch.bmm(queries, text.transpose(1, 2))
        logits = logits.masked_fill(~text_token_mask[:, None, :], -torch.inf)
        pad = self.config.max_text_len - logits.shape[-1]
        if pad > 0:
            logits = F.pad(logits, (0, pad), value=-torch.inf)
        return logits[..., : self.config.max_text_len]

    def encode_text(self, input_ids, text_attend_mask, position_ids, token_type_ids=None):
        """→ (text [B, S, d], its sine position embedding [B, S, d])."""
        text = self.text_projection(
            self.text_backbone(input_ids, text_attend_mask, token_type_ids, position_ids))
        text_pos = get_sine_pos_embed(position_ids.float()[..., None], self.config.d_model,
                                      exchange_xy=False)
        return text, text_pos

    def encode_image(self, pixel_values):
        """→ (vision [B, S, d] over every level, its position embedding
        with the level embeddings, the level shapes)."""
        c = self.config
        feats = [f.permute(0, 3, 1, 2) for f in self.backbone(pixel_values)]
        maps = []
        for i in range(c.num_feature_levels):
            src = feats[i] if i < len(feats) else (feats[-1] if i == len(feats) else maps[-1])
            conv, norm = getattr(self, f"input_proj_{i}_conv"), getattr(self, f"input_proj_{i}_norm")
            maps.append(norm(conv(src)))
        shapes = tuple((m.shape[2], m.shape[3]) for m in maps)
        vision = torch.cat([m.flatten(2).transpose(1, 2) for m in maps], dim=1)
        counts = torch.tensor([h * w for h, w in shapes], device=vision.device)
        vision_pos = (self.geometry(shapes, vision.device)["pos"]
                      + torch.repeat_interleave(self.level_embed, counts, dim=0))[None]
        return vision, vision_pos, shapes

    def encode(self, vision, text, vision_pos, text_pos, shapes, text_attend_mask, text_token_mask):
        """The feature-enhancer encoder → (vision, text)."""
        c = self.config
        refs = self.geometry(shapes, vision.device)["refs"]
        refs = refs[None, :, None, :].expand(vision.shape[0], -1, c.num_feature_levels, 2)
        for i in range(c.encoder_layers):
            vision, text = getattr(self, f"encoder_layers_{i}")(
                vision, text, vision_pos, text_pos, refs, shapes, text_attend_mask, ~text_token_mask)
        return vision, text

    def decode(self, vision, text, shapes, text_token_mask):
        """Two-stage query selection, the decoder and the head → (logits, boxes)."""
        c = self.config
        b = vision.shape[0]
        geo = self.geometry(shapes, vision.device)
        oq = torch.where(geo["valid"][None, :, None], vision, 0.0)
        oq = self.enc_output_norm(self.enc_output(oq))
        enc_class = self._contrastive(oq, text, text_token_mask)
        enc_coords = self.encoder_output_bbox_embed(oq) + geo["proposals"][None]
        topk = stable_top_k(torch.nan_to_num(enc_class.max(dim=-1).values, neginf=-1e30), c.num_queries)
        reference_points = torch.sigmoid(torch.gather(enc_coords, 1, topk[..., None].expand(-1, -1, 4)))
        init_reference_points = reference_points

        hidden = self.query_position_embeddings.weight[None].expand(b, -1, -1)
        text_additive = torch.where(text_token_mask[:, None, None, :], 0.0, torch.finfo(torch.float32).min)
        refs = []
        for i in range(c.decoder_layers):
            ref_input = reference_points[:, :, None, :].expand(-1, -1, c.num_feature_levels, 4)
            query_pos = self.reference_points_head(get_sine_pos_embed(ref_input[:, :, 0, :], c.d_model // 2))
            hidden = getattr(self, f"decoder_layers_{i}")(hidden, query_pos, ref_input, vision, text,
                                                          text_additive, shapes)
            reference_points = torch.sigmoid(self.bbox_embed(hidden) + inverse_sigmoid(reference_points))
            refs.append(reference_points)
        # the head reads the last layer; the earlier layers' outputs only
        # feed training's auxiliary losses
        ref = init_reference_points if c.decoder_layers == 1 else refs[-2]
        final = self.decoder_layer_norm(hidden)
        logits = self._contrastive(final, text, text_token_mask)
        boxes = torch.sigmoid(self.bbox_embed(final) + inverse_sigmoid(ref))
        return logits, boxes

    def forward(self, pixel_values, input_ids, text_attend_mask, position_ids, text_token_mask,
                token_type_ids=None):
        text, text_pos = self.encode_text(input_ids, text_attend_mask, position_ids, token_type_ids)
        vision, vision_pos, shapes = self.encode_image(pixel_values)
        vision, text = self.encode(vision, text, vision_pos, text_pos, shapes, text_attend_mask,
                                   text_token_mask)
        return self.decode(vision, text, shapes, text_token_mask)


# -- captions and the predict wrapper ------------------------------------------------


def generate_special_token_masks(input_ids: np.ndarray):
    """(attend mask [B, S, S] bool, position_ids [B, S]): each phrase (the
    tokens after one special token up to and including the next) attends
    within itself and counts its positions from 0; a special token at
    either end attends only to itself, at position 0."""
    bsz, n = input_ids.shape
    special = np.isin(input_ids, np.asarray(SPECIAL_TOKENS))
    attend = np.eye(n, dtype=bool)[None].repeat(bsz, 0)
    position_ids = np.zeros((bsz, n), dtype=np.int64)
    for row in range(bsz):
        prev = 0
        for col in np.nonzero(special[row])[0]:
            if col == 0 or col == n - 1:
                attend[row, col, col] = True
                position_ids[row, col] = 0
            else:
                attend[row, prev + 1:col + 1, prev + 1:col + 1] = True
                position_ids[row, prev + 1:col + 1] = np.arange(col - prev)
            prev = col
    return attend, position_ids


def preprocess_caption(caption: str) -> str:
    """Lowercase, stripped, ending in a period."""
    out = caption.lower().strip()
    return out if out.endswith(".") else out + "."


class DinoDetector:
    """(image [H, W, 3] in [0, 1], caption) → (boxes [max_boxes, 4] xyxy
    in [0, 1], scores [max_boxes]) on the model's device: the image resized
    to ``swin.image_size``² (antialiased, as ``jax.image.resize``) and
    ImageNet-normalised; the caption lowercased, ended with a period and
    tokenized, its phrase masks built; each query's score the sigmoid of its
    best token logit; the top ``max_boxes`` queries (equal scores lower
    index first) as clipped corner boxes. Takes ``LangSAM``'s detector
    place."""

    def __init__(self, config: DinoConfig, model: GroundingDino, tokenizer):
        self.config = config
        self.model = model.eval()
        self.tokenizer = tokenizer

    @property
    def device(self) -> torch.device:
        return self.model.level_embed.device

    @torch.inference_mode()
    def __call__(self, image: torch.Tensor, caption: str, box_threshold: float = 0.20):
        c, device = self.config, self.device
        size = c.swin.image_size
        img = resize_bilinear(image.to(device, torch.float32).permute(2, 0, 1), size, size).permute(1, 2, 0)
        mean = torch.tensor(DINO_IMAGE_MEAN, device=device)
        img = (img - mean) / torch.tensor(DINO_IMAGE_STD, device=device)
        ids = np.asarray(self.tokenizer([preprocess_caption(caption)]))
        attend, pos = generate_special_token_masks(ids)
        logits, boxes = self.model(img[None], torch.from_numpy(ids).to(device),
                                   torch.from_numpy(attend).to(device), torch.from_numpy(pos).to(device),
                                   torch.from_numpy(ids != 0).to(device))
        scores = torch.sigmoid(torch.nan_to_num(logits[0], neginf=-1e30)).max(dim=-1).values
        idx = stable_top_k(scores, min(c.max_boxes, scores.shape[0]))
        cxcy, wh = boxes[0][idx, :2], boxes[0][idx, 2:]
        return torch.clamp(torch.cat([cxcy - wh / 2, cxcy + wh / 2], dim=-1), 0.0, 1.0), scores[idx]
