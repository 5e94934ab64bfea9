"""SDXL UNet2DConditionModel with concept-aware attention (counterpart of
``tweediemix_tpu/models/unet2d.py``).

Module and parameter names follow the diffusers checkpoint layout
(``down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_q.weight``), plus
the concept extensions of the JAX package:

* self-attention holds its q, k and v weights as one merged ``to_qkv``
  Linear [3·inner, C] (q rows, then k, then v), built once at load by
  ``models/convert.py``, so a forward runs one projection and copies no
  weight;

* Custom-Diffusion concepts: cross-attention K/V weights stacked as
  ``to_k_stack``/``to_v_stack`` [slots, ctx_dim, inner] (slot 0 = the base
  model, the JAX package's [in, out] layout); a per-row ``concept_idx``
  picks the slot, so the N-concept fused forward is one batched call.
* LoRA concepts: stacked rank-r ``to_{q,k,v,out}_lora_{down,up}`` factors on
  both attentions (slot 0 = zero delta).
* W8A8 serving (``quant="int8"``): the JAX package's quantised sites become
  ``ops.quant.QLinear`` (attn1's ``to_qkv`` and ``to_out.0``, attn2's
  ``to_q`` and ``to_out.0``, a non-stacked attn2's ``to_k``/``to_v``, the
  GEGLU ``ff.net.0.proj`` and ``ff.net.2``, ``proj_in`` and ``proj_out``);
  ``"int8_conv"`` adds ``ops.quant.QConv2d`` for the resnets' ``conv1``/
  ``conv2`` and the down/up-sampler convs. Every other weight stays exact:
  ``time_emb_proj``, ``conv_shortcut``, ``conv_in``/``conv_out``, the K/V
  stacks, the embeddings. Each ``QLinear`` is told its JAX site key
  (``quant_site``), under which static activation scales are stored.
* Training: ``detach_first_token_kv`` stops the gradient through the first
  context token's cross-attention K/V (the Custom-Diffusion trick), and
  ``remat`` recomputes each resnet and transformer block in the backward
  (``torch.utils.checkpoint``); neither changes a parameter's name or
  shape.

The public forward takes and returns NHWC latents [B, h, w, 4] like the JAX
model; inside, activations are NCHW.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tweediemix_tpu_torch.device import resolve_device
from tweediemix_tpu_torch.models.embeddings import TimestepEmbedding, timestep_embedding
from tweediemix_tpu_torch.ops.attention import multi_head_attention
from tweediemix_tpu_torch.ops.quant import QUANT_MODES, QConv2d, QLinear
from tweediemix_tpu_torch.ops.stacked import lora_delta, stacked_linear
from tweediemix_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SDXL-base defaults; ``micro()``/``tiny()`` shrink it for tests."""

    sample_size: int = 128
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "UpBlock2D",
    )
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 2, 10)
    num_attention_heads: Tuple[int, ...] = (5, 10, 20)
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    addition_time_embed_dim: int = 256
    pooled_projection_dim: int = 1280
    concept_slots: int = 0
    lora_slots: int = 0
    lora_rank: int = 4
    # training: stop the gradient through the first context token's K/V
    detach_first_token_kv: bool = False
    # training: recompute resnet/transformer blocks in the backward
    remat: bool = False
    # W8A8 serving: None, "int8" (transformer matmuls) or "int8_conv" (also
    # the resnet and resampler 3x3 convs)
    quant: Optional[str] = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.quant is not None and self.quant not in QUANT_MODES:
            raise ValueError(f"UNetConfig.quant must be None or one of {QUANT_MODES}, got {self.quant!r}")

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def projection_class_embeddings_input_dim(self) -> int:
        return self.pooled_projection_dim + 6 * self.addition_time_embed_dim

    @staticmethod
    def sdxl(**kw) -> "UNetConfig":
        return UNetConfig(**kw)

    @staticmethod
    def micro(**kw) -> "UNetConfig":
        """Single-level config for fast CPU equivalence tests."""
        defaults = dict(
            sample_size=8,
            block_out_channels=(32,),
            down_block_types=("CrossAttnDownBlock2D",),
            up_block_types=("CrossAttnUpBlock2D",),
            layers_per_block=1,
            transformer_layers_per_block=(1,),
            num_attention_heads=(2,),
            cross_attention_dim=32,
            norm_num_groups=8,
            addition_time_embed_dim=8,
            pooled_projection_dim=32,
        )
        defaults.update(kw)
        return UNetConfig(**defaults)

    @staticmethod
    def tiny(**kw) -> "UNetConfig":
        """Small config with SDXL's topology, for CPU tests."""
        defaults = dict(
            sample_size=8,
            block_out_channels=(32, 64),
            down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
            up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
            layers_per_block=1,
            transformer_layers_per_block=(1, 2),
            num_attention_heads=(2, 4),
            cross_attention_dim=32,
            norm_num_groups=8,
            addition_time_embed_dim=8,
            pooled_projection_dim=32,
        )
        defaults.update(kw)
        return UNetConfig(**defaults)


def linear(din: int, dout: int, bias: bool = True, quant: Optional[str] = None,
           keep_weight: bool = False) -> nn.Module:
    """``nn.Linear``, or its W8A8 form under ``quant``."""
    if quant:
        return QLinear(din, dout, bias=bias, keep_weight=keep_weight)
    return nn.Linear(din, dout, bias=bias)


def conv3x3(cin: int, cout: int, stride: int = 1, quant: Optional[str] = None) -> nn.Module:
    """3x3 conv with padding 1, quantised under ``"int8_conv"`` only."""
    if quant == "int8_conv":
        return QConv2d(cin, cout, stride=stride)
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


class Attention(nn.Module):
    """QKV attention with optional concept-stacked K/V and LoRA deltas."""

    def __init__(
        self,
        query_dim: int,
        heads: int,
        dim_head: int,
        cross_attention_dim: Optional[int] = None,  # None → self-attention
        concept_slots: int = 0,
        lora_slots: int = 0,
        lora_rank: int = 4,
        quant: Optional[str] = None,
        detach_first_token_kv: bool = False,
    ):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.is_cross = cross_attention_dim is not None
        self.detach_first_token_kv = detach_first_token_kv and self.is_cross
        ctx_dim = cross_attention_dim if self.is_cross else query_dim
        self.stacked = bool(concept_slots) and self.is_cross
        self.lora_slots = lora_slots
        if not self.is_cross:
            self.to_qkv = linear(query_dim, 3 * inner, bias=False, quant=quant)
        elif self.stacked:
            self.to_q = linear(query_dim, inner, bias=False, quant=quant)
            std = ctx_dim**-0.5
            self.to_k_stack = nn.Parameter(torch.randn(concept_slots, ctx_dim, inner) * std)
            self.to_v_stack = nn.Parameter(torch.randn(concept_slots, ctx_dim, inner) * std)
        else:
            self.to_q = linear(query_dim, inner, bias=False, quant=quant)
            # the float weight stays beside the int8 one: precompute_cross_kv
            # projects with it, as the JAX package's does even under quant
            self.to_k = linear(ctx_dim, inner, bias=False, quant=quant, keep_weight=True)
            self.to_v = linear(ctx_dim, inner, bias=False, quant=quant, keep_weight=True)
        self.to_out = nn.ModuleList([linear(inner, query_dim, quant=quant)])
        if lora_slots:
            dims = dict(to_q=(query_dim, inner), to_k=(ctx_dim, inner),
                        to_v=(ctx_dim, inner), to_out=(inner, query_dim))
            for name, (din, dout) in dims.items():
                self.register_parameter(f"{name}_lora_down", nn.Parameter(
                    torch.randn(lora_slots, din, lora_rank) / lora_rank))
                self.register_parameter(f"{name}_lora_up", nn.Parameter(
                    torch.zeros(lora_slots, lora_rank, dout)))

    def lora(self, name: str, inp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return lora_delta(inp, getattr(self, f"{name}_lora_down"),
                          getattr(self, f"{name}_lora_up"), idx)

    def kv(self, ctx: torch.Tensor, idx: torch.Tensor, precomputed: bool = False):
        """This cross-attention's K and V rows for context ``ctx``.
        ``precompute_cross_kv`` (``precomputed``) takes a non-stacked K/V
        from the float weight even under quant, as the JAX package does."""
        if self.stacked:
            k = stacked_linear(ctx, self.to_k_stack, idx)
            v = stacked_linear(ctx, self.to_v_stack, idx)
        elif precomputed:
            k, v = F.linear(ctx, self.to_k.weight), F.linear(ctx, self.to_v.weight)
        else:
            k, v = self.to_k(ctx), self.to_v(ctx)
        if self.lora_slots:
            k = k + self.lora("to_k", ctx, idx)
            v = v + self.lora("to_v", ctx, idx)
        if self.detach_first_token_kv:
            k = torch.cat([k[:, :1].detach(), k[:, 1:]], dim=1)
            v = torch.cat([v[:, :1].detach(), v[:, 1:]], dim=1)
        return k, v

    def forward(self, x, ctx=None, concept_idx=None, kv=None):
        if concept_idx is None and (self.stacked or self.lora_slots):
            concept_idx = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
        if not self.is_cross:
            q, k, v = self.to_qkv(x).chunk(3, dim=-1)
            if self.lora_slots:
                q = q + self.lora("to_q", x, concept_idx)
                k = k + self.lora("to_k", x, concept_idx)
                v = v + self.lora("to_v", x, concept_idx)
        else:
            q = self.to_q(x)
            if self.lora_slots:
                q = q + self.lora("to_q", x, concept_idx)
            # kv: precomputed by precompute_cross_kv (the UNet call's runner)
            k, v = kv if kv is not None else self.kv(ctx, concept_idx)
        out = multi_head_attention(q, k, v, self.heads)
        proj = self.to_out[0](out)
        if self.lora_slots:
            # the LoRA out-delta reads the pre-projection hidden
            proj = proj + self.lora("to_out", out, concept_idx)
        return proj


class GEGLU(nn.Module):
    def __init__(self, dim: int, hidden: int, quant: Optional[str] = None):
        super().__init__()
        self.proj = linear(dim, hidden * 2, quant=quant)

    def forward(self, x):
        # first half is x, second half the gate; exact (erf) GELU
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU MLP (diffusers ``FeedForward`` with geglu activation)."""

    def __init__(self, dim: int, quant: Optional[str] = None):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4, quant), nn.Identity(),
                                  linear(dim * 4, dim, quant=quant)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, cross_attention_dim,
                 concept_slots=0, lora_slots=0, lora_rank=4, quant=None,
                 detach_first_token_kv=False):
        super().__init__()
        kw = dict(lora_slots=lora_slots, lora_rank=lora_rank, quant=quant)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim,
                               concept_slots=concept_slots,
                               detach_first_token_kv=detach_first_token_kv, **kw)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, quant)

    def forward(self, x, ctx, concept_idx, kv=None):
        x = x + self.attn1(self.norm1(x), None, concept_idx)
        x = x + self.attn2(self.norm2(x), ctx, concept_idx, kv=kv)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """Spatial transformer with linear projections (SDXL's
    ``use_linear_projection=True``)."""

    def __init__(self, channels, heads, dim_head, num_layers, cross_attention_dim,
                 norm_num_groups, concept_slots=0, lora_slots=0, lora_rank=4, quant=None,
                 detach_first_token_kv=False):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(norm_num_groups, channels, eps=1e-6)
        self.proj_in = linear(channels, inner, quant=quant)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim,
                                  concept_slots, lora_slots, lora_rank, quant,
                                  detach_first_token_kv)
            for _ in range(num_layers)
        ])
        self.proj_out = linear(inner, channels, quant=quant)

    def forward(self, x, ctx, concept_idx, kv=None):
        """x: NCHW; kv: (k [L, B, S, inner], v [L, B, S, inner]) or None."""
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = self.proj_in(x)
        for i, block in enumerate(self.transformer_blocks):
            x = block(x, ctx, concept_idx, kv=None if kv is None else (kv[0][i], kv[1][i]))
        x = self.proj_out(x)
        return x.reshape(b, h, w, c).permute(0, 3, 1, 2) + residual


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels, out_channels, temb_channels, norm_num_groups, quant=None):
        super().__init__()
        self.norm1 = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-5)
        self.conv1 = conv3x3(in_channels, out_channels, quant=quant)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = nn.GroupNorm(norm_num_groups, out_channels, eps=1e-5)
        self.conv2 = conv3x3(out_channels, out_channels, quant=quant)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels, quant=None):
        super().__init__()
        self.conv = conv3x3(channels, channels, stride=2, quant=quant)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels, quant=None):
        super().__init__()
        self.conv = conv3x3(channels, channels, quant=quant)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UNetBlock(nn.Module):
    """One down/up level: resnets, optional attentions and resampler (the
    diffusers ``*Block2D`` containers; the UNet drives them)."""

    def __init__(self, resnets, attentions, downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if downsamplers is not None:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers is not None:
            self.upsamplers = nn.ModuleList(upsamplers)


class UNet2DConditionModel(nn.Module):
    """SDXL denoising UNet.

    forward(sample [B,h,w,4], timestep (int or [B]), encoder_hidden_states
    [B,S,ctx], pooled_projections [B,pooled], time_ids [B,6], concept_idx [B],
    cross_kv) → eps [B,h,w,4] fp32. Parameters are created on ``device`` in
    ``config.dtype``; under ``quant`` the int8 weights are quantised from the
    fp32 draw before that cast.
    """

    def __init__(self, config: UNetConfig, device="cuda"):
        super().__init__()
        self.config = cfg = config
        with torch.device(resolve_device(device)):
            self._build(cfg)
        for name, m in self.named_modules():
            if isinstance(m, QLinear):
                m.site = quant_site(name)
        self.to(cfg.dtype)

    def _build(self, cfg: UNetConfig):
        temb_ch = cfg.time_embed_dim
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.block_out_channels[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(cfg.block_out_channels[0], temb_ch)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb_ch)

        def transformer(level, channels):
            heads = cfg.num_attention_heads[level]
            return Transformer2DModel(
                channels, heads, cfg.block_out_channels[level] // heads,
                cfg.transformer_layers_per_block[level], cfg.cross_attention_dim,
                cfg.norm_num_groups, cfg.concept_slots, cfg.lora_slots, cfg.lora_rank,
                cfg.quant, cfg.detach_first_token_kv,
            )

        n_levels = len(cfg.block_out_channels)
        self.down_blocks = nn.ModuleList()
        skip_channels = [cfg.block_out_channels[0]]
        in_ch = cfg.block_out_channels[0]
        for level, block_type in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[level]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(in_ch, out_ch, temb_ch, cfg.norm_num_groups, cfg.quant))
                if block_type == "CrossAttnDownBlock2D":
                    attns.append(transformer(level, out_ch))
                in_ch = out_ch
                skip_channels.append(out_ch)
            samplers = []
            if level < n_levels - 1:
                samplers.append(Downsample2D(out_ch, cfg.quant))
                skip_channels.append(out_ch)
            self.down_blocks.append(UNetBlock(resnets, attns, downsamplers=samplers))

        mid_ch = cfg.block_out_channels[-1]
        self.mid_block = UNetBlock(
            [ResnetBlock2D(mid_ch, mid_ch, temb_ch, cfg.norm_num_groups, cfg.quant),
             ResnetBlock2D(mid_ch, mid_ch, temb_ch, cfg.norm_num_groups, cfg.quant)],
            [transformer(n_levels - 1, mid_ch)],
        )

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(cfg.block_out_channels))
        in_ch = mid_ch
        for i, block_type in enumerate(cfg.up_block_types):
            level = n_levels - 1 - i
            out_ch = rev[i]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(in_ch + skip_channels.pop(), out_ch, temb_ch,
                                             cfg.norm_num_groups, cfg.quant))
                if block_type == "CrossAttnUpBlock2D":
                    attns.append(transformer(level, out_ch))
                in_ch = out_ch
            samplers = [Upsample2D(out_ch, cfg.quant)] if i < n_levels - 1 else []
            self.up_blocks.append(UNetBlock(resnets, attns, upsamplers=samplers))

        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, cfg.block_out_channels[0], eps=1e-5)
        self.conv_out = nn.Conv2d(cfg.block_out_channels[0], cfg.out_channels, 3, padding=1)

    def transformer(self, name: str) -> Transformer2DModel:
        """The Transformer2DModel that ``cross_attention_names`` calls ``name``
        (e.g. ``down_blocks_1_attentions_0``, ``mid_block_attentions_0``)."""
        if name.startswith("mid_block_attentions_"):
            return self.mid_block.attentions[int(name.rsplit("_", 1)[1])]
        kind, level, _, j = name.rsplit("_", 3)
        blocks = self.down_blocks if kind == "down_blocks" else self.up_blocks
        return blocks[int(level)].attentions[int(j)]

    def forward(self, sample, timestep, encoder_hidden_states, pooled_projections,
                time_ids, concept_idx=None, cross_kv=None):
        with span("unet", rows=sample.shape[0], graph="eager"):
            return self.denoise(sample, timestep, encoder_hidden_states, pooled_projections,
                                time_ids, concept_idx, cross_kv)

    def denoise(self, sample, timestep, encoder_hidden_states, pooled_projections,
                time_ids, concept_idx=None, cross_kv=None):
        """The forward's body, without its ``unet`` span: what
        ``models/unet_graph.py`` captures inside a span of its own, with the
        K/V of ``precompute_cross_kv`` as ``cross_kv``."""
        cfg = self.config
        dtype = cfg.dtype
        b = sample.shape[0]
        dev = sample.device
        remat = cfg.remat and torch.is_grad_enabled()

        def run(block, *args):
            if remat:
                return checkpoint(block, *args, use_reentrant=False)
            return block(*args)

        def attend(block, j, name, x):
            kv = None if cross_kv is None else cross_kv[name]
            return run(block.attentions[j], x, ctx, concept_idx, kv)

        with span("unet.embed"):
            if concept_idx is None:
                concept_idx = torch.zeros(b, dtype=torch.long, device=dev)
            timestep = torch.as_tensor(timestep, device=dev).expand(b)
            t_emb = timestep_embedding(timestep, cfg.block_out_channels[0])
            temb = self.time_embedding(t_emb.to(dtype))
            ids_emb = timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim)
            ids_emb = ids_emb.reshape(b, 6 * cfg.addition_time_embed_dim)
            add_emb = torch.cat([pooled_projections, ids_emb.to(pooled_projections.dtype)],
                                dim=-1)
            temb = temb + self.add_embedding(add_emb.to(dtype))
            ctx = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))

        res_stack = [x]
        for level, block in enumerate(self.down_blocks):
            with span(f"unet.down.{level}"):
                for j, resnet in enumerate(block.resnets):
                    x = run(resnet, x, temb)
                    if len(block.attentions):
                        x = attend(block, j, f"down_blocks_{level}_attentions_{j}", x)
                    res_stack.append(x)
                for sampler in block.downsamplers:
                    x = sampler(x)
                    res_stack.append(x)

        with span("unet.mid"):
            x = run(self.mid_block.resnets[0], x, temb)
            x = attend(self.mid_block, 0, "mid_block_attentions_0", x)
            x = run(self.mid_block.resnets[1], x, temb)

        for i, block in enumerate(self.up_blocks):
            with span(f"unet.up.{i}"):
                for j, resnet in enumerate(block.resnets):
                    x = run(resnet, torch.cat([x, res_stack.pop()], dim=1), temb)
                    if len(block.attentions):
                        x = attend(block, j, f"up_blocks_{i}_attentions_{j}", x)
                for sampler in block.upsamplers:
                    x = sampler(x)

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1).float()


_SITE_RENAMES = (
    (re.compile(r"(down_blocks|up_blocks)\.(\d+)\.(attentions|temp_attentions)\.(\d+)"),
     r"\1_\2_\3_\4"),
    (re.compile(r"mid_block\.(attentions|temp_attentions)\.(\d+)"), r"mid_block_\1_\2"),
    (re.compile(r"transformer_blocks\.(\d+)"), r"transformer_blocks_\1"),
    (re.compile(r"\bto_out\.0$"), "to_out_0"),
    (re.compile(r"\bff\.net\.0\.proj$"), "ff.net_0_proj"),
    (re.compile(r"\bff\.net\.2$"), "ff.net_2"),
    (re.compile(r"\b(attn[12])\.to_qkv$"), r"\1.qkv"),
)


def quant_site(name: str) -> str:
    """A quantised matmul's module name → the JAX package's site key
    (``"/".join(scope.path)``; a merged self-attention site ends in
    ``/qkv``, the video UNet's temporal ``attn2`` included):
    ``down_blocks.1.attentions.0.transformer_blocks.0.ff.net.2``
    → ``down_blocks_1_attentions_0/transformer_blocks_0/ff/net_2``."""
    for pattern, repl in _SITE_RENAMES:
        name = pattern.sub(repl, name)
    return name.replace(".", "/")


def cross_attention_names(cfg: UNetConfig):
    """(level, module name) of every Transformer2DModel, in call order."""
    names = []
    n_levels = len(cfg.block_out_channels)
    for level, block_type in enumerate(cfg.down_block_types):
        if block_type == "CrossAttnDownBlock2D":
            for j in range(cfg.layers_per_block):
                names.append((level, f"down_blocks_{level}_attentions_{j}"))
    names.append((n_levels - 1, "mid_block_attentions_0"))
    for i, block_type in enumerate(cfg.up_block_types):
        level = n_levels - 1 - i
        if block_type == "CrossAttnUpBlock2D":
            for j in range(cfg.layers_per_block + 1):
                names.append((level, f"up_blocks_{i}_attentions_{j}"))
    return names


def precompute_cross_kv(unet: UNet2DConditionModel, encoder_hidden_states, concept_idx=None):
    """Every attn2's K/V rows for a fixed text context.

    The per-row stacked-weight gather, the K/V projections and their LoRA
    deltas of one UNet call; the result goes to the UNet as ``cross_kv``.
    The fusion pipeline's UNet call builds it on every call
    (``models/unet_graph.py``: inside the CUDA graph on a card). A
    non-stacked K/V is a plain float projection here even under quant, as
    in the JAX package (its in-module path quantises).

    Returns {transformer_name: (k [L, B, S, inner], v [L, B, S, inner])}.
    """
    cfg = unet.config
    ctx = encoder_hidden_states.to(cfg.dtype)
    if concept_idx is None:
        concept_idx = torch.zeros(ctx.shape[0], dtype=torch.long, device=ctx.device)
    cache = {}
    for _, name in cross_attention_names(cfg):
        kvs = [blk.attn2.kv(ctx, concept_idx, precomputed=True)
               for blk in unet.transformer(name).transformer_blocks]
        cache[name] = (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))
    return cache
