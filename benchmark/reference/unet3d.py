"""Plain I2VGen-XL UNet (diffusers' ``I2VGenXLUNet``, as configured by
``ali-vilab/i2vgen-xl/unet/config.json``) with the first-frame feature
injection of TweedieMix's ``run_video.py``: a hard copy of frame 0 at the
outputs of the two mid-block resnets and an ``interp_ratio`` blend after
``up_blocks[1].resnets[0]``.

Parameter names are the diffusers checkpoint's (the spatial transformers
project with 1x1 convolutions). Inputs and outputs are [B, F, h, w, 4];
inside, frames are folded into the batch [B*F, C, h, w], temporal layers
see [B, C, F, h, w] or pixel rows [B*h*w, F, C]. The context tokens and
the projected image latents do not change over a request and are tagged
``invariant`` for the work count.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.ops import Conv, GroupNorm, LayerNorm, Linear, timestep_embedding
from benchmark.reference.unet2d import (
    Attention,
    BasicTransformerBlock,
    Block,
    Downsample,
    FeedForward,
    ResnetBlock2D,
    Upsample,
)


def fold(x):
    b, f, h, w, c = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(b * f, c, h, w)


def unfold(x, b):
    bf, c, h, w = x.shape
    return x.reshape(b, bf // b, c, h, w).permute(0, 1, 3, 4, 2)


def to_pixels(x, b):
    """[B*F, C, h, w] -> [B*h*w, F, C]."""
    bf, c, h, w = x.shape
    return x.reshape(b, bf // b, c, h, w).permute(0, 3, 4, 1, 2).reshape(b * h * w, bf // b, c)


def from_pixels(y, b, h, w):
    _, f, c = y.shape
    return y.reshape(b, h, w, f, c).permute(0, 3, 4, 1, 2).reshape(b * f, c, h, w)


def frames_first(x, f):
    """[B*F, C, h, w] -> [B, C, F, h, w]."""
    bf, c, h, w = x.shape
    return x.reshape(bf // f, f, c, h, w).transpose(1, 2)


class Seq(nn.Module):
    """Layers at fixed indices of a diffusers ``nn.Sequential``; SiLU between
    consecutive products."""

    def __init__(self, layers: Dict[int, nn.Module], pool_at: int = -1, pool: int = 0):
        super().__init__()
        self.idx = sorted(layers)
        for i, m in layers.items():
            self.add_module(str(i), m)
        self.pool_at, self.pool = pool_at, pool

    def forward(self, x):
        for n, i in enumerate(self.idx):
            if n:
                x = F.silu(x)
            if i == self.pool_at:
                x = F.avg_pool2d(x, x.shape[2] // self.pool)
            x = getattr(self, str(i))(x)
        return x


class TemporalConv(nn.Module):
    """Four GroupNorm -> SiLU -> (3,1,1) conv stages over frames, and a
    residual; stage 1's conv at index 2, stages 2-4's at 3."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        for s in range(1, 5):
            stage = nn.Module()
            stage.add_module("0", GroupNorm(groups, ch, 1e-5))
            stage.add_module("2" if s == 1 else "3",
                             Conv(ch, ch, (3, 1, 1), padding=(1, 0, 0), dims=3))
            self.add_module(f"conv{s}", stage)

    def forward(self, x, f):
        y = frames_first(x, f)
        for s in range(1, 5):
            stage = getattr(self, f"conv{s}")
            y = getattr(stage, "2" if s == 1 else "3")(F.silu(getattr(stage, "0")(y)))
        return x.float() + y.transpose(1, 2).reshape(x.shape)


class TemporalBlock(nn.Module):
    """Two self-attentions over frames and a GEGLU MLP."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dim_head=dim_head)
        self.attn2 = Attention(dim, heads, dim_head=dim_head)
        self.ff = FeedForward(dim)

    def forward(self, x):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x))
        return x + self.ff(self.norm3(x))


class TemporalTransformer(nn.Module):
    def __init__(self, ch: int, heads: int, dim_head: int, groups: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(groups, ch, 1e-6)
        self.proj_in = Linear(ch, inner)
        self.transformer_blocks = nn.ModuleList([TemporalBlock(inner, heads, dim_head)])
        self.proj_out = Linear(inner, ch)

    def forward(self, x, f):
        bf, c, h, w = x.shape
        b = bf // f
        y = self.norm(frames_first(x, f))
        y = self.proj_in(y.permute(0, 3, 4, 2, 1).reshape(b * h * w, f, c))
        for block in self.transformer_blocks:
            y = block(y)
        return x.float() + from_pixels(self.proj_out(y), b, h, w)


class SpatialTransformer(nn.Module):
    """One transformer block between 1x1-conv projections."""

    def __init__(self, ch: int, heads: int, ctx_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, ch, 1e-6)
        self.proj_in = Conv(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(ch, heads, ctx_dim)])
        self.proj_out = Conv(ch, ch, 1)

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            y = block(y, ctx, None)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(y) + x.float()


class ImageEncoder(nn.Module):
    """The image latents' temporal encoder: norm1 -> attn1 (+ residual), then
    the GELU MLP (+ residual) with no norm before it."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, 2, dim_head=dim)
        self.ff = FeedForward(dim, act="gelu")

    def forward(self, x):
        x = x + self.attn1(self.norm1(x))
        return x + self.ff(x)


def _invariant(module: nn.Module) -> nn.Module:
    for m in module.modules():
        if isinstance(m, (Linear, Conv)):
            m.invariant = True
    return module


class UNet3D(nn.Module):
    """forward(x [B,F,h,w,4], t, ctx [B,S,ctx_dim], image_latents
    [B,F,h,w,4], image_emb [B,1,ctx_dim], fps [B], inject) -> eps
    [B,F,h,w,4] fp32; ``inject`` turns on both first-frame injections.
    ``cfg``: the configuration file's ``unet`` object."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        chs, cin = cfg["block_out_channels"], cfg["in_channels"]
        hd, groups, ctx_dim = cfg["attention_head_dim"], cfg["norm_num_groups"], cfg["cross_attention_dim"]
        lpb, temb = cfg["layers_per_block"], chs[0] * 4
        self.conv_in = Conv(2 * cin, chs[0], 3, padding=1)
        self.time_embedding = _MLP(chs[0], temb, temb, names=("linear_1", "linear_2"))
        self.fps_embedding = _MLP(chs[0], temb, temb)
        self.context_embedding = _invariant(_MLP(ctx_dim, temb, ctx_dim * cin))
        self.image_latents_context_embedding = _invariant(Seq(
            {0: Conv(cin, cin * 8, 3, padding=1), 3: Conv(cin * 8, cin * 16, 3, stride=2, padding=1),
             5: Conv(cin * 16, ctx_dim, 3, stride=2, padding=1)}, pool_at=3,
            pool=cfg["context_pool_size"]))
        self.image_latents_proj_in = _invariant(Seq(
            {0: Conv(cin, cin * 4, 3, padding=1), 2: Conv(cin * 4, cin * 4, 3, padding=1),
             4: Conv(cin * 4, cin, 3, padding=1)}))
        self.image_latents_temporal_encoder = _invariant(ImageEncoder(cin))
        self.transformer_in = TemporalTransformer(chs[0], 8, hd, groups)

        def heads(ch):
            return max(1, ch // hd)

        def layers(cin_, cout, attn):
            return (ResnetBlock2D(cin_, cout, temb, groups), TemporalConv(cout, groups),
                    SpatialTransformer(cout, heads(cout), ctx_dim, groups) if attn else None,
                    TemporalTransformer(cout, heads(cout), hd, groups) if attn else None)

        def block(parts, **samplers):
            res, convs, att, temp = zip(*parts)
            return Block(res, [a for a in att if a is not None], temp_convs=convs,
                         temp_attentions=[t for t in temp if t is not None], **samplers)

        self.down_blocks = nn.ModuleList()
        skips, c = [chs[0]], chs[0]
        for level, kind in enumerate(cfg["down_block_types"]):
            cout = chs[level]
            parts = []
            for _ in range(lpb):
                parts.append(layers(c, cout, kind.startswith("CrossAttn")))
                c = cout
                skips.append(cout)
            down = [Downsample(cout)] if level < len(chs) - 1 else []
            if down:
                skips.append(cout)
            self.down_blocks.append(block(parts, downsamplers=down))
        mid = chs[-1]
        self.mid_block = block([layers(mid, mid, True), layers(mid, mid, False)])
        self.up_blocks = nn.ModuleList()
        rev = list(reversed(chs))
        for i, kind in enumerate(reversed(cfg["down_block_types"])):
            cout = rev[i]
            parts = []
            for _ in range(lpb + 1):
                parts.append(layers(c + skips.pop(), cout, kind.startswith("CrossAttn")))
                c = cout
            self.up_blocks.append(block(parts, upsamplers=[Upsample(cout)] if i < len(chs) - 1 else []))
        self.conv_norm_out = GroupNorm(groups, chs[0], 1e-5)
        self.conv_out = Conv(chs[0], cfg["out_channels"], 3, padding=1)

    def context_tokens(self, ctx, image_latents, image_emb):
        """[text, frame-0 conv tokens, 4 image-embedding tokens]."""
        b, cin, d = image_latents.shape[0], self.cfg["in_channels"], self.cfg["cross_attention_dim"]
        img = self.image_latents_context_embedding(image_latents[:, 0].float().permute(0, 3, 1, 2))
        img = img.permute(0, 2, 3, 1).reshape(b, -1, d)
        emb = self.context_embedding(image_emb.float().reshape(b, 1, d)).reshape(b, cin, d)
        return torch.cat([ctx.float(), img, emb], dim=1)

    def project_image_latents(self, image_latents):
        b = image_latents.shape[0]
        il = self.image_latents_proj_in(fold(image_latents.float()))
        h, w = il.shape[2:]
        seq = self.image_latents_temporal_encoder(to_pixels(il, b))
        return unfold(from_pixels(seq, b, h, w), b)

    def forward(self, x, t, ctx, image_latents, image_emb, fps, inject: bool, interp_ratio: float):
        cfg = self.cfg
        b, f = x.shape[:2]
        c0 = cfg["block_out_channels"][0]
        tokens = self.context_tokens(ctx, image_latents, image_emb)
        il = self.project_image_latents(image_latents)
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(b)
        temb = self.time_embedding(timestep_embedding(t, c0))
        temb = temb + self.fps_embedding(timestep_embedding(fps.float(), c0))
        temb_f = temb.repeat_interleave(f, dim=0)
        ctx_f = tokens.repeat_interleave(f, dim=0)

        def inject_first(h, copy: bool, interp: bool):
            if not (copy or interp):
                return h
            y = h.reshape(b, f, *h.shape[1:])
            first = y[:, :1]
            if copy:
                y = first.expand_as(y)
            else:
                y = torch.cat([first, interp_ratio * first + (1 - interp_ratio) * y[:, 1:]], dim=1)
            return y.reshape(h.shape)

        def level(blk, j, h, copy=False, interp=False):
            h = inject_first(blk.resnets[j](h, temb_f), copy, interp)
            h = blk.temp_convs[j](h, f)
            if j < len(blk.attentions):
                h = blk.attentions[j](h, ctx_f)
                h = blk.temp_attentions[j](h, f)
            return h

        h = self.conv_in(fold(torch.cat([x.float(), il], dim=-1)))
        h = self.transformer_in(h, f)
        skips = [h]
        for blk in self.down_blocks:
            for j in range(len(blk.resnets)):
                h = level(blk, j, h)
                skips.append(h)
            for down in blk.downsamplers:
                h = down(h)
                skips.append(h)
        h = level(self.mid_block, 0, h, copy=inject)
        h = level(self.mid_block, 1, h, copy=inject)
        for i, blk in enumerate(self.up_blocks):
            for j in range(len(blk.resnets)):
                h = level(blk, j, torch.cat([h, skips.pop()], dim=1),
                          interp=inject and (i, j) == (1, 0))
            for up in blk.upsamplers:
                h = up(h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return unfold(h, b)


class _MLP(nn.Module):
    """Linear -> SiLU -> Linear, under diffusers' names (``0``/``2`` of an
    ``nn.Sequential``, or ``linear_1``/``linear_2``)."""

    def __init__(self, din, dhidden, dout, names=("0", "2")):
        super().__init__()
        self.names = names
        self.add_module(names[0], Linear(din, dhidden))
        self.add_module(names[1], Linear(dhidden, dout))

    def forward(self, x):
        return getattr(self, self.names[1])(F.silu(getattr(self, self.names[0])(x)))
