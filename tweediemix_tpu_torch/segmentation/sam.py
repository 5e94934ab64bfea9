"""SAM (Segment Anything): image encoder, prompt encoder and mask decoder
(counterpart of ``tweediemix_tpu/segmentation/sam.py``).

Box-prompted mask prediction, as the JAX package computes it and under
segment-anything's parameter names (``image_encoder.blocks.7.attn.qkv``,
``prompt_encoder.pe_layer.positional_encoding_gaussian_matrix``,
``mask_decoder.output_upscaling.0``), so a ``sam_vit_h`` checkpoint loads
without renaming (``models/convert.py::load_sam``):

* ``SAMImageEncoder``: a ViT over 16×16 patches with absolute position
  embeddings, window attention (the 64² grid zero-padded to 70² after
  ``norm1``; the padded tokens get ``qkv``'s bias, take part in the window
  attention and are sliced off), and decomposed relative-position biases;
  a conv/LayerNorm neck to ``prompt_dim`` channels. Its attention stays
  plain ``torch.matmul`` and softmax in fp32, as the JAX package keeps it
  in ``einsum``: at a global block of ViT-H the scores are [16, 4096,
  4096] fp32 (1 GiB), and the bias is added into them in place;
* ``SAMPromptEncoder``: random-Fourier position encoding; a box becomes
  two corner points plus the learned corner embeddings
  (``point_embeddings.2``/``.3``). The point and mask prompts of upstream
  are not used (only boxes are), so their parameters are not held;
* ``SAMMaskDecoder``: the two-way transformer (token self-attention,
  token→image and image→token cross-attention at half width, an MLP),
  the 4× upscaling transposed convolutions and the hypernetwork and IoU
  heads. Its attention goes through ``ops/attention.py`` as in the JAX
  package (7 tokens against 4096: the flash gate is not reached).

Images and features are NHWC at the module boundaries, as in the JAX
package; the transposed convolutions run NCHW inside. Everything runs in
``config.dtype`` (fp32): the masks are thresholds at 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tweediemix_tpu_torch.device import resolve_device
from tweediemix_tpu_torch.ops.attention import merge_heads, multi_head_attention, split_heads


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    image_size: int = 1024
    patch_size: int = 16
    encoder_dim: int = 1280  # ViT-H
    encoder_layers: int = 32
    encoder_heads: int = 16
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    use_rel_pos: bool = True
    prompt_dim: int = 256
    decoder_layers: int = 2
    # upstream's cross-attention runs at prompt_dim / 2
    attention_downsample_rate: int = 2
    decoder_heads: int = 8
    num_mask_tokens: int = 4
    dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @staticmethod
    def vit_h(**kw) -> "SAMConfig":
        return SAMConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "SAMConfig":
        defaults = dict(
            image_size=64, patch_size=8, encoder_dim=32, encoder_layers=2,
            encoder_heads=2, window_size=4, global_attn_indexes=(1,),
            prompt_dim=16, decoder_heads=2,
        )
        defaults.update(kw)
        return SAMConfig(**defaults)


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """[B, H, W, C] → [B·nw, win, win, C], zero-padding H and W up to
    multiples of ``win`` (ViT-H: grid 64, window 14, padded to 70)."""
    b, h, w, c = x.shape
    ph, pw = (-h) % win, (-w) % win
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // win, win, wp // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c)


def window_unpartition(x: torch.Tensor, win: int, hw: Tuple[int, int]) -> torch.Tensor:
    """The inverse of ``window_partition``, with the padding sliced off."""
    h, w = hw
    hp, wp = h + (-h) % win, w + (-w) % win
    b = x.shape[0] // ((hp // win) * (wp // win))
    x = x.reshape(b, hp // win, wp // win, win, win, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def rel_pos_terms(q: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                  gh: int, gw: int, heads: int):
    """SAM's decomposed relative-position bias as its two terms: q [B*,
    gh·gw, C] (a window or the whole grid), tables rel_h [2·gh − 1, hd] and
    rel_w [2·gw − 1, hd] → (bh [B*, heads, gh, gw, gh], bw [B*, heads, gh,
    gw, gw]). The bias of query (i, j) and key (k, l) is bh[..., i, j, k] +
    bw[..., i, j, l] (``add_rel_pos_bias_``); q and k have one size, so the
    table index is q_idx − k_idx + size − 1."""
    bsz, _, c = q.shape
    qr = q.reshape(bsz, gh, gw, heads, c // heads)
    ar_h = torch.arange(gh, device=q.device)
    ar_w = torch.arange(gw, device=q.device)
    rh = rel_h[ar_h[:, None] - ar_h[None, :] + gh - 1].to(q.dtype)  # [gh, gh, hd]
    rw = rel_w[ar_w[:, None] - ar_w[None, :] + gw - 1].to(q.dtype)  # [gw, gw, hd]
    bh = torch.einsum("bhwnc,hkc->bnhwk", qr, rh)
    bw = torch.einsum("bhwnc,wkc->bnhwk", qr, rw)
    return bh, bw


def add_rel_pos_bias_(scores: torch.Tensor, bh: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """In place: scores [B*·heads, gh·gw, gh·gw] += the bias of
    ``rel_pos_terms``, without building the [gh·gw, gh·gw] bias itself."""
    b, n, gh, gw, _ = bh.shape
    s6 = scores.view(b, n, gh, gw, gh, gw)
    s6 += bh[..., :, None]
    s6 += bw[..., None, :]
    return scores


class ViTAttention(nn.Module):
    def __init__(self, dim: int, heads: int, input_size: int, use_rel_pos: bool):
        super().__init__()
        self.heads = heads
        self.use_rel_pos = use_rel_pos
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if use_rel_pos:
            hd = dim // heads
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B*, g, g, C] (windows or the whole grid) → the same shape."""
        bsz, gh, gw, c = x.shape
        q, k, v = self.qkv(x.reshape(bsz, gh * gw, c)).chunk(3, dim=-1)
        if self.use_rel_pos:
            hd = c // self.heads
            qs, ks, vs = (split_heads(a, self.heads) for a in (q, k, v))
            s = torch.matmul(qs.float(), ks.float().transpose(1, 2)) * (hd**-0.5)
            add_rel_pos_bias_(s, *rel_pos_terms(q, self.rel_pos_h, self.rel_pos_w, gh, gw, self.heads))
            p = torch.softmax(s, dim=-1).to(vs.dtype)
            del s
            o = merge_heads(torch.matmul(p, vs), self.heads)
        else:
            o = multi_head_attention(q, k, v, self.heads)
        return self.proj(o).reshape(bsz, gh, gw, c)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act):
        super().__init__()
        self.act = act
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class ViTBlock(nn.Module):
    """One encoder block on [B, H, W, C]; ``window_size`` 0 is global
    attention over the whole ``grid``."""

    def __init__(self, dim: int, heads: int, window_size: int, grid: int, use_rel_pos: bool = True):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ViTAttention(dim, heads, window_size or grid, use_rel_pos)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, 4 * dim, F.gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        y = self.norm1(x)
        if self.window_size > 0:
            y = window_partition(y, self.window_size)
        y = self.attn(y)
        if self.window_size > 0:
            y = window_unpartition(y, self.window_size, (h, w))
        x = x + y
        return x + self.mlp(self.norm2(x))


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] → [B, g, g, dim]."""
        return self.proj(pixels.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SAMImageEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d, g, p = cfg.encoder_dim, cfg.grid, cfg.prompt_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, d)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, d))
        self.blocks = nn.ModuleList(
            ViTBlock(d, cfg.encoder_heads, 0 if i in cfg.global_attn_indexes else cfg.window_size,
                     g, cfg.use_rel_pos)
            for i in range(cfg.encoder_layers))
        self.neck = nn.Sequential(
            nn.Conv2d(d, p, 1, bias=False), LayerNorm2d(p, eps=1e-6),
            nn.Conv2d(p, p, 3, padding=1, bias=False), LayerNorm2d(p, eps=1e-6))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] normalised → [B, g, g, prompt_dim]."""
        x = self.patch_embed(pixels.to(self.pos_embed.dtype)) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.neck(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.randn(2, num_pos_feats))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """coords in [0, 1], [..., 2] → [..., 2·num_pos_feats]."""
        proj = (2.0 * coords - 1.0) @ self.positional_encoding_gaussian_matrix * (2 * math.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class SAMPromptEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        p = cfg.prompt_dim
        self.pe_layer = PositionEmbeddingRandom(p // 2)
        # upstream's entries 2 and 3 are the box corners (0, 1: point labels)
        self.point_embeddings = nn.ModuleDict({"2": nn.Embedding(1, p), "3": nn.Embedding(1, p)})
        self.no_mask_embed = nn.Embedding(1, p)

    def forward(self, boxes: torch.Tensor):
        """boxes [B, 4] xyxy in [0, 1] → (sparse corner embeddings [B, 2,
        D], the no-mask dense embedding [D], added per channel to the image
        features when no mask prompt is given)."""
        pe = self.pe_layer(boxes.reshape(-1, 2, 2))
        corner = torch.cat([self.point_embeddings["2"].weight, self.point_embeddings["3"].weight])
        return pe + corner[None], self.no_mask_embed.weight[0]

    def dense_pe(self, grid: int) -> torch.Tensor:
        """Position encoding of the image grid for the decoder, [g, g, D]."""
        ar = torch.arange(grid, device=self.no_mask_embed.weight.device)
        coords = (torch.stack(torch.meshgrid(ar, ar, indexing="xy"), dim=-1) + 0.5) / grid
        return self.pe_layer(coords.to(self.no_mask_embed.weight.dtype))


class SAMAttention(nn.Module):
    """q/k/v/out projections, with the inner width cut by
    ``downsample_rate`` (upstream's cross-attention)."""

    def __init__(self, dim: int, heads: int, downsample_rate: int = 1):
        super().__init__()
        inner = dim // downsample_rate
        self.heads = heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v):
        o = multi_head_attention(self.q_proj(q), self.k_proj(k), self.v_proj(v), self.heads)
        return self.out_proj(o)


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int, heads: int, downsample_rate: int = 2):
        super().__init__()
        self.self_attn = SAMAttention(dim, heads, 1)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.cross_attn_token_to_image = SAMAttention(dim, heads, downsample_rate)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, 8 * dim, F.relu)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.norm4 = nn.LayerNorm(dim, eps=1e-6)
        self.cross_attn_image_to_token = SAMAttention(dim, heads, downsample_rate)

    def forward(self, tokens, image, token_pe, image_pe, first: bool):
        # token self-attention; upstream's first layer replaces the queries
        # with its output (no residual, no PE)
        q = tokens if first else tokens + token_pe
        attn = self.self_attn(q, q, tokens)
        tokens = self.norm1(attn if first else tokens + attn)
        attn = self.cross_attn_token_to_image(tokens + token_pe, image + image_pe, image)
        tokens = self.norm2(tokens + attn)
        tokens = self.norm3(tokens + self.mlp(tokens))
        attn = self.cross_attn_image_to_token(image + image_pe, tokens + token_pe, tokens)
        image = self.norm4(image + attn)
        return tokens, image


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d = cfg.prompt_dim
        self.layers = nn.ModuleList(
            TwoWayBlock(d, cfg.decoder_heads, cfg.attention_downsample_rate)
            for _ in range(cfg.decoder_layers))
        self.final_attn_token_to_image = SAMAttention(d, cfg.decoder_heads,
                                                      cfg.attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(d, eps=1e-6)


class MLP(nn.Module):
    """Linear layers with ReLU between them."""

    def __init__(self, widths):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class SAMMaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d, m = cfg.prompt_dim, cfg.num_mask_tokens
        self.transformer = TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(m, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, stride=2), LayerNorm2d(d // 4, eps=1e-6), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(MLP([d, d, d, d // 8]) for _ in range(m))
        self.iou_prediction_head = MLP([d, d, d, m])

    def forward(self, image_feats, image_pe, sparse_prompts):
        """image_feats [B, g, g, D], image_pe [g, g, D], sparse [B, P, D] →
        (mask logits [B, M, 4g, 4g], iou [B, M])."""
        b, g, _, d = image_feats.shape
        m = self.mask_tokens.weight.shape[0]
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1).to(image_feats.dtype),
                            sparse_prompts], dim=1)
        image = image_feats.reshape(b, g * g, d)
        img_pe = image_pe.reshape(1, g * g, d).expand(b, -1, -1)
        tok_pe = tokens  # SAM uses the initial tokens as their own PE
        tf = self.transformer
        for i, layer in enumerate(tf.layers):
            tokens, image = layer(tokens, image, tok_pe, img_pe, i == 0)
        attn = tf.final_attn_token_to_image(tokens + tok_pe, image + img_pe, image)
        tokens = tf.norm_final_attn(tokens + attn)
        iou_token, mask_tokens = tokens[:, 0], tokens[:, 1 : 1 + m]

        img = self.output_upscaling(image.reshape(b, g, g, d).permute(0, 3, 1, 2))  # [B, d/8, 4g, 4g]
        hyper = torch.stack([mlp(mask_tokens[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.matmul(hyper, img.flatten(2)).reshape(b, m, *img.shape[2:])
        return masks, self.iou_prediction_head(iou_token)


class SAM(nn.Module):
    """Box-prompted segmentation: (image, boxes) → one mask per box.
    Parameters are created on ``device`` in ``config.dtype``."""

    def __init__(self, config: SAMConfig, device="cuda"):
        super().__init__()
        self.config = config
        with torch.device(resolve_device(device)):
            self.image_encoder = SAMImageEncoder(config)
            self.prompt_encoder = SAMPromptEncoder(config)
            self.mask_decoder = SAMMaskDecoder(config)
        self.to(config.dtype)

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(pixels)

    def decode_boxes(self, image_feats: torch.Tensor, boxes: torch.Tensor):
        """image_feats [1, g, g, D], boxes [N, 4] xyxy in [0, 1] → (mask
        logits [N, 4g, 4g], iou [N]) of mask token 0 (upstream's
        ``multimask_output=False``)."""
        g = image_feats.shape[1]
        sparse, no_mask = self.prompt_encoder(boxes.to(image_feats.dtype))
        image_pe = self.prompt_encoder.dense_pe(g)
        feats = image_feats.expand(boxes.shape[0], -1, -1, -1) + no_mask
        masks, iou = self.mask_decoder(feats, image_pe, sparse)
        return masks[:, 0], iou[:, 0]

    def forward(self, pixels: torch.Tensor, boxes: torch.Tensor):
        return self.decode_boxes(self.encode_image(pixels), boxes)
