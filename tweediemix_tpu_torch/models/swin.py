"""Swin Transformer backbone of the GroundingDINO detector (counterpart of
``tweediemix_tpu/models/swin.py``).

NHWC at the module boundaries, as the JAX package: a 4×4 patch embedding
and LayerNorm, then stages of window-attention blocks with a
relative-position bias table; odd blocks shift the map cyclically by half a
window (``torch.roll``) and mask the wrapped pairs with -100. A map that is
not a whole number of windows is zero-padded after ``layernorm_before`` and
cropped after the attention. Every odd block shifts, also where the map is
no larger than one window (Swin-B 384's last stage: 12² at window 12), as
the JAX package does. Between stages, ``SwinPatchMerging`` concatenates
each 2×2 neighbourhood in HF's order ((even, even), (odd, even), (even,
odd), (odd, odd) in (row, col)) → LayerNorm → Linear 4C → 2C. The
``out_indices`` stages come back LayerNormed, before their downsampling.
The attention (144 tokens per window at Swin-B) is plain fp32 math.
Parameter names are the JAX tree's (``layers_0_blocks_1.attention.query``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tweediemix_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    image_size: int = 384
    patch_size: int = 4
    num_channels: int = 3
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-5
    # the stages that feed the detector, 1-indexed (stage i has
    # embed_dim * 2**(i-1) channels); GroundingDINO takes the last three
    out_indices: Tuple[int, ...] = (2, 3, 4)

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * 2**i for i in range(len(self.depths)))

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.stage_dims[i - 1] for i in self.out_indices)

    @staticmethod
    def swin_b(**kw) -> "SwinConfig":
        """Swin-B 384 (groundingdino_swinb_cogcoor's backbone)."""
        return SwinConfig(**kw)

    @staticmethod
    def swin_t(**kw) -> "SwinConfig":
        """Swin-T 224 (grounding-dino-tiny's backbone)."""
        defaults = dict(image_size=224, embed_dim=96, depths=(2, 2, 6, 2),
                        num_heads=(3, 6, 12, 24), window_size=7)
        defaults.update(kw)
        return SwinConfig(**defaults)

    @staticmethod
    def tiny(**kw) -> "SwinConfig":
        """Micro config for the CPU tests (shifted windows included)."""
        defaults = dict(image_size=32, patch_size=4, embed_dim=8,
                        depths=(2, 2), num_heads=(2, 2), window_size=2,
                        out_indices=(1, 2))
        defaults.update(kw)
        return SwinConfig(**defaults)


def _rel_pos_index(window: int) -> np.ndarray:
    """[ws², ws²] index into the (2·ws − 1)² relative-position table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def _shift_attn_mask(height: int, width: int, window: int, shift: int) -> np.ndarray:
    """Additive (-100 / 0) mask of the shifted windows, [nW, ws², ws²]:
    pairs from different regions of the rolled map are masked."""
    img = np.zeros((height, width))
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    count = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = count
            count += 1
    img = img.reshape(height // window, window, width // window, window)
    win = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] → [B·nW, ws², C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """[B·nW, ws², C] → [B, H, W, C]."""
    c = x.shape[-1]
    x = x.reshape(-1, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


class SwinWindowAttention(nn.Module):
    """Window self-attention with the relative-position bias (HF's
    ``SwinAttention``: query/key/value, output dense as ``out``)."""

    def __init__(self, dim: int, heads: int, window: int, qkv_bias: bool = True):
        super().__init__()
        self.heads, self.window = heads, window
        self.query = nn.Linear(dim, dim, bias=qkv_bias)
        self.key = nn.Linear(dim, dim, bias=qkv_bias)
        self.value = nn.Linear(dim, dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.out = nn.Linear(dim, dim)
        self._index = {}  # device → the table's index, made once per device

    def _table_index(self, device) -> torch.Tensor:
        if device not in self._index:
            self._index[device] = torch.from_numpy(_rel_pos_index(self.window).reshape(-1)).to(device)
        return self._index[device]

    def forward(self, x: torch.Tensor, attn_mask=None) -> torch.Tensor:
        """x [B·nW, ws², C]; attn_mask [nW, ws², ws²] additive, or None."""
        n, s, c = x.shape
        h = self.heads
        dh = c // h

        def split(t):
            return t.reshape(n, s, h, dh).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        bias = self.relative_position_bias_table[self._table_index(x.device)].reshape(s, s, h)
        scores = scores + bias.permute(2, 0, 1)[None]
        if attn_mask is not None:
            nw = attn_mask.shape[0]
            scores = (scores.reshape(n // nw, nw, h, s, s) + attn_mask[None, :, None]).reshape(n, h, s, s)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.out(out.transpose(1, 2).reshape(n, s, c))


class SwinBlock(nn.Module):
    """LayerNorm → (shifted) window attention → residual → LayerNorm →
    exact-GELU MLP → residual, on [B, H, W, C]."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float,
                 qkv_bias: bool, eps: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.layernorm_before = nn.LayerNorm(dim, eps=eps)
        self.attention = SwinWindowAttention(dim, heads, window, qkv_bias)
        self.layernorm_after = nn.LayerNorm(dim, eps=eps)
        self.intermediate = nn.Linear(dim, int(mlp_ratio * dim))
        self.output = nn.Linear(int(mlp_ratio * dim), dim)
        self._masks = {}  # (padded h, padded w, device) → the shift mask

    def _shift_mask(self, hp: int, wp: int, device) -> torch.Tensor:
        key = (hp, wp, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(_shift_attn_mask(hp, wp, self.window, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, shift = self.window, self.shift
        shortcut = x
        x = self.layernorm_before(x)
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = self._shift_mask(hp, wp, x.device)
        x = window_reverse(self.attention(window_partition(x, ws), mask), ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :h, :w]
        x = shortcut + x
        return x + self.output(F.gelu(self.intermediate(self.layernorm_after(x))))


class SwinPatchMerging(nn.Module):
    """2×2 neighbourhoods concatenated (HF's order) → LayerNorm → Linear
    4C → 2C without bias; an odd side is zero-padded first."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinBackbone(nn.Module):
    """forward(pixels [B, H, W, 3]) → the ``out_indices`` stages' maps
    [B, h, w, C], each LayerNormed, fp32. Parameters are created on
    ``device``."""

    def __init__(self, config: SwinConfig, device="cuda"):
        super().__init__()
        self.config = cfg = config
        p = cfg.patch_size
        with torch.device(resolve_device(device)):
            self.patch_embed = nn.Conv2d(cfg.num_channels, cfg.embed_dim, p, stride=p)
            self.patch_norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)
            for i, depth in enumerate(cfg.depths):
                dim = cfg.stage_dims[i]
                for j in range(depth):
                    self.add_module(f"layers_{i}_blocks_{j}", SwinBlock(
                        dim, cfg.num_heads[i], cfg.window_size,
                        0 if j % 2 == 0 else cfg.window_size // 2,
                        cfg.mlp_ratio, cfg.qkv_bias, cfg.layer_norm_eps))
                if (i + 1) in cfg.out_indices:
                    self.add_module(f"norm_stage{i + 1}", nn.LayerNorm(dim, eps=cfg.layer_norm_eps))
                if i < len(cfg.depths) - 1:
                    self.add_module(f"layers_{i}_downsample", SwinPatchMerging(dim, cfg.layer_norm_eps))

    def forward(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        cfg = self.config
        x = self.patch_embed(pixels.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = self.patch_norm(x)
        maps = []
        for i, depth in enumerate(cfg.depths):
            for j in range(depth):
                x = getattr(self, f"layers_{i}_blocks_{j}")(x)
            if (i + 1) in cfg.out_indices:
                maps.append(getattr(self, f"norm_stage{i + 1}")(x))
            if i < len(cfg.depths) - 1:
                x = getattr(self, f"layers_{i}_downsample")(x)
        return tuple(maps)
