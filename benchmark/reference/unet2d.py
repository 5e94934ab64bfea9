"""Plain SDXL UNet (diffusers' ``UNet2DConditionModel`` as configured by
``stabilityai/stable-diffusion-xl-base-1.0/unet/config.json``) with
Custom-Diffusion concepts: each cross-attention's K/V weight has one slot
per concept, and a per-row index picks the slot (slot 0 is the base
model's weight).

Parameter names are the diffusers checkpoint's. Inputs and outputs are
NHWC latents [B, h, w, 4]; inside, NCHW. Every product runs in fp32 (or
as ``ops.Precision`` says, for a control or the W8A8 configuration).
Cross-attention K/V products are tagged ``invariant``: the text context
does not change over a request.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.ops import (
    FP32,
    _count,
    MLP2,
    Conv,
    GroupNorm,
    LayerNorm,
    Linear,
    attention,
    timestep_embedding,
)


def site_key(name: str) -> str:
    """A quantised matmul's checkpoint module name -> its key in the W8A8
    scale table (``down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q``
    -> ``down_blocks_1_attentions_0/transformer_blocks_0/attn1/qkv``: a
    self-attention's q, k and v share one input, so one key)."""
    for pattern, repl in (
        (r"(down_blocks|up_blocks)\.(\d+)\.(attentions|temp_attentions)\.(\d+)", r"\1_\2_\3_\4"),
        (r"mid_block\.(attentions|temp_attentions)\.(\d+)", r"mid_block_\1_\2"),
        (r"transformer_blocks\.(\d+)", r"transformer_blocks_\1"),
        (r"\bto_out\.0$", "to_out_0"),
        (r"\bff\.net\.0\.proj$", "ff.net_0_proj"),
        (r"\bff\.net\.2$", "ff.net_2"),
        (r"\battn1\.to_[qkv]$", "attn1.qkv"),
    ):
        name = re.sub(pattern, repl, name)
    return name.replace(".", "/")


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, ctx_dim: Optional[int] = None,
                 dim_head: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head if dim_head else dim
        self.heads = heads
        self.is_cross = ctx_dim is not None
        kv_dim = ctx_dim or dim
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(kv_dim, inner, bias=False, invariant=self.is_cross)
        self.to_v = Linear(kv_dim, inner, bias=False, invariant=self.is_cross)
        self.to_out = nn.ModuleList([Linear(inner, dim)])
        self.precision = FP32
        # concept slots of the cross-attention K/V: [slots] weights [inner, ctx]
        self.k_slots: List[torch.Tensor] = []
        self.v_slots: List[torch.Tensor] = []

    def _slot_proj(self, ctx, idx, lin, slots):
        """Each row's K or V through its concept slot's weight."""
        if not slots or ctx.is_meta:
            return lin(ctx)
        out = torch.empty((*ctx.shape[:-1], lin.weight.shape[0]), device=ctx.device)
        for s in idx.unique().tolist():
            rows = (idx == s).nonzero().flatten()
            wt = lin.weight if s == 0 else slots[s - 1]
            out[rows] = F.linear(ctx[rows].float(), wt.float())
        _count("invariant", 2.0 * ctx.numel() * lin.weight.shape[0])
        return out

    def forward(self, x, ctx=None, idx=None):
        q = self.to_q(x)
        if self.is_cross:
            k = self._slot_proj(ctx, idx, self.to_k, self.k_slots)
            v = self._slot_proj(ctx, idx, self.to_v, self.v_slots)
        else:
            k, v = self.to_k(x), self.to_v(x)
        return self.to_out[0](attention(q, k, v, self.heads, self.precision))


class GEGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.proj = Linear(dim, 2 * hidden)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, act: str = "geglu"):
        super().__init__()
        first = GEGLU(dim, 4 * dim) if act == "geglu" else GELU(dim, 4 * dim)
        self.net = nn.ModuleList([first, nn.Identity(), Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class GELU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.proj = Linear(dim, hidden)

    def forward(self, x):
        return F.gelu(self.proj(x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ctx_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, ctx_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx, idx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx, idx)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer with linear projections."""

    def __init__(self, channels: int, heads: int, layers: int, ctx_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, ctx_dim) for _ in range(layers)])
        self.proj_out = Linear(channels, channels)

    def forward(self, x, ctx, idx):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        for block in self.transformer_blocks:
            y = block(y, ctx, idx)
        return self.proj_out(y).reshape(b, h, w, c).permute(0, 3, 1, 2) + x.float()


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, 1e-5)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb, cout)
        self.norm2 = GroupNorm(groups, cout, 1e-5)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        x = self.conv_shortcut(x) if self.conv_shortcut is not None else x.float()
        return x + h


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Block(nn.Module):
    def __init__(self, resnets, attentions=(), downsamplers=None, upsamplers=None, **extra):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if downsamplers is not None:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers is not None:
            self.upsamplers = nn.ModuleList(upsamplers)
        for name, mods in extra.items():
            setattr(self, name, nn.ModuleList(mods))


class UNet2D(nn.Module):
    """forward(x [B,h,w,4], t, ctx [B,S,ctx_dim], pooled [B,P], time_ids
    [B,6], concept_idx [B]) -> eps [B,h,w,4] fp32. ``cfg`` is the
    configuration file's ``unet`` object (diffusers' keys)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        chs = cfg["block_out_channels"]
        heads = cfg["attention_head_dim"]  # diffusers' name for SDXL's head counts
        depth = cfg["transformer_layers_per_block"]
        groups, ctx_dim, lpb = cfg["norm_num_groups"], cfg["cross_attention_dim"], cfg["layers_per_block"]
        temb = chs[0] * 4
        self.conv_in = Conv(cfg["in_channels"], chs[0], 3, padding=1)
        self.time_embedding = MLP2(chs[0], temb, temb)
        add_in = cfg["projection_class_embeddings_input_dim"]
        self.add_embedding = MLP2(add_in, temb, temb)
        self.down_blocks = nn.ModuleList()
        skips, cin = [chs[0]], chs[0]
        for level, kind in enumerate(cfg["down_block_types"]):
            cout = chs[level]
            res, att = [], []
            for _ in range(lpb):
                res.append(ResnetBlock2D(cin, cout, temb, groups))
                if kind.startswith("CrossAttn"):
                    att.append(Transformer2D(cout, heads[level], depth[level], ctx_dim, groups))
                cin = cout
                skips.append(cout)
            down = [Downsample(cout)] if level < len(chs) - 1 else []
            if down:
                skips.append(cout)
            self.down_blocks.append(Block(res, att, downsamplers=down))
        mid = chs[-1]
        self.mid_block = Block(
            [ResnetBlock2D(mid, mid, temb, groups), ResnetBlock2D(mid, mid, temb, groups)],
            [Transformer2D(mid, heads[-1], depth[-1], ctx_dim, groups)])
        self.up_blocks = nn.ModuleList()
        rev = list(reversed(chs))
        for i, kind in enumerate(cfg["up_block_types"]):
            level = len(chs) - 1 - i
            cout = rev[i]
            res, att = [], []
            for _ in range(lpb + 1):
                res.append(ResnetBlock2D(cin + skips.pop(), cout, temb, groups))
                if kind.startswith("CrossAttn"):
                    att.append(Transformer2D(cout, heads[level], depth[level], ctx_dim, groups))
                cin = cout
            up = [Upsample(cout)] if i < len(chs) - 1 else []
            self.up_blocks.append(Block(res, att, upsamplers=up))
        self.conv_norm_out = GroupNorm(groups, chs[0], 1e-5)
        self.conv_out = Conv(chs[0], cfg["out_channels"], 3, padding=1)

    def quant_sites(self) -> Dict[str, str]:
        """{module name: scale-table key} of the W8A8 configuration's
        quantised matmuls: every transformer's proj_in/proj_out, each
        block's attn1 q/k/v and to_out, attn2's to_q and to_out, and the
        feed-forward's two products (a concept-stacked K/V stays exact)."""
        keep = re.compile(r"(proj_in|proj_out|attn1\.to_[qkv]|attn[12]\.to_out\.0|attn2\.to_q"
                          r"|ff\.net\.0\.proj|ff\.net\.2)$")
        return {n: site_key(n) for n, m in self.named_modules()
                if isinstance(m, Linear) and "attentions" in n and keep.search(n)}

    def mark_sites(self) -> int:
        """Give each quantised matmul its site key; returns the number of
        distinct keys."""
        sites = self.quant_sites()
        for name, m in self.named_modules():
            if name in sites:
                m.site = sites[name]
        return len(set(sites.values()))

    def set_concepts(self, concept_kvs: Sequence[Dict[str, torch.Tensor]]) -> None:
        """Concept slots 1..N of every cross-attention K/V, from
        checkpoint-named tensors (``...attn2.to_k.weight``); a concept
        that lacks a layer takes the base weight there."""
        for name, m in self.named_modules():
            if isinstance(m, Attention) and m.is_cross:
                m.k_slots = [kv.get(f"{name}.to_k.weight", m.to_k.weight) for kv in concept_kvs]
                m.v_slots = [kv.get(f"{name}.to_v.weight", m.to_v.weight) for kv in concept_kvs]

    def forward(self, x, t, ctx, pooled, time_ids, idx):
        cfg = self.cfg
        b = x.shape[0]
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(b)
        temb = self.time_embedding(timestep_embedding(t, cfg["block_out_channels"][0]))
        ids = timestep_embedding(time_ids.reshape(-1), cfg["addition_time_embed_dim"]).reshape(b, -1)
        temb = temb + self.add_embedding(torch.cat([pooled.float(), ids], dim=-1))
        h = self.conv_in(x.float().permute(0, 3, 1, 2))
        skips = [h]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                h = resnet(h, temb)
                if len(block.attentions):
                    h = block.attentions[j](h, ctx, idx)
                skips.append(h)
            for down in block.downsamplers:
                h = down(h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, ctx, idx)
        h = self.mid_block.resnets[1](h, temb)
        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), temb)
                if len(block.attentions):
                    h = block.attentions[j](h, ctx, idx)
            for up in block.upsamplers:
                h = up(h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1)
