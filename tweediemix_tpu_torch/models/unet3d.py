"""I2VGen-XL video UNet with first-frame feature injection (counterpart of
``tweediemix_tpu/models/unet3d.py``).

Module and parameter names follow diffusers' ``I2VGenXLUNet`` checkpoint
(``down_blocks.0.temp_convs.0.conv1.2.weight``, ``transformer_in``,
``image_latents_proj_in.0``, ``fps_embedding.0``), with the spatial layers
of the port's SDXL UNet (``ResnetBlock2D``, ``Transformer2DModel`` with
linear projections, ``Down/Upsample2D``) and, as there, one merged
``to_qkv`` per self-attention. Each level runs spatial resnet → temporal
conv → spatial transformer → temporal transformer.

W8A8 (``quant="int8"``) quantises the JAX package's sites: the spatial
transformers (as in the SDXL UNet), and the temporal transformers'
``proj_in``/``proj_out`` and each temporal block's ``attn1``, ``attn2`` (both
self-attentions, one merged ``to_qkv`` each) and ``ff``, ``transformer_in``
included; ``"int8_conv"`` adds the resnets' and resamplers' 3x3 convs. The
temporal convs, the context conv stack, the image-latent encoder and the
time/fps embeddings stay float. Each ``QLinear`` carries its JAX site key.

The first-frame injection of the reference is a forward argument: a hard
copy of frame 0 at the outputs of the two mid-block resnets
(``inject_copy``) and an ``interp_ratio`` blend after
``up_blocks[1].resnets[0]`` (``inject_interp``), each a Python branch on a
host flag.

The public forward takes and returns [B, F, h, w, 4] latents like the JAX
model. Inside, activations are frame-folded NCHW [B·F, C, h, w]: spatial
layers see frames as batch rows, temporal convs [B, C, F, h, w] (so their
GroupNorm takes its statistics over frames, rows and columns per sample, as
the JAX model's full-tensor GroupNorm does), temporal transformers
[B·h·w, F, C] pixel rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tweediemix_tpu_torch.device import resolve_device
from tweediemix_tpu_torch.models.embeddings import TimestepEmbedding, timestep_embedding
from tweediemix_tpu_torch.models.unet2d import (
    Attention,
    Downsample2D,
    FeedForward,
    ResnetBlock2D,
    Transformer2DModel,
    UNetBlock,
    Upsample2D,
    linear,
    norm_act,
    quant_site,
)
from tweediemix_tpu_torch.ops.quant import QUANT_MODES, QLinear
from tweediemix_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "DownBlock3D",
    )
    layers_per_block: int = 2
    attention_head_dim: int = 64
    cross_attention_dim: int = 1024
    norm_num_groups: int = 32
    context_pool_size: int = 32  # avg-pool target of the context conv stack
    # W8A8: None, "int8" (transformer matmuls, spatial and temporal) or
    # "int8_conv" (also the resnet and resampler 3x3 convs)
    quant: Optional[str] = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.quant is not None and self.quant not in QUANT_MODES:
            raise ValueError(f"UNet3DConfig.quant must be None or one of {QUANT_MODES}, got {self.quant!r}")

    @property
    def up_block_types(self):
        return tuple(
            {"CrossAttnDownBlock3D": "CrossAttnUpBlock3D", "DownBlock3D": "UpBlock3D"}[t]
            for t in reversed(self.down_block_types)
        )

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @staticmethod
    def i2vgen(**kw) -> "UNet3DConfig":
        return UNet3DConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "UNet3DConfig":
        defaults = dict(
            block_out_channels=(32, 64),
            down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
            layers_per_block=1,
            attention_head_dim=16,
            cross_attention_dim=32,
            norm_num_groups=8,
            context_pool_size=4,
        )
        defaults.update(kw)
        return UNet3DConfig(**defaults)


def fold_frames(x: torch.Tensor) -> torch.Tensor:
    """[B, F, h, w, C] → [B·F, C, h, w]: frames into the batch, channels first."""
    b, f, h, w, c = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(b * f, c, h, w)


def unfold_frames(x: torch.Tensor, b: int) -> torch.Tensor:
    """[B·F, C, h, w] → [B, F, h, w, C]."""
    bf, c, h, w = x.shape
    return x.reshape(b, bf // b, c, h, w).permute(0, 1, 3, 4, 2)


def _to_pixel_seq(x: torch.Tensor, b: int) -> torch.Tensor:
    """[B·F, C, h, w] → [B·h·w, F, C] for temporal ops."""
    bf, c, h, w = x.shape
    return x.reshape(b, bf // b, c, h, w).permute(0, 3, 4, 1, 2).reshape(b * h * w, bf // b, c)


def _from_pixel_seq(y: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """[B·h·w, F, C] → [B·F, C, h, w]."""
    _, f, c = y.shape
    return y.reshape(b, h, w, f, c).permute(0, 3, 4, 1, 2).reshape(b * f, c, h, w)


def _frames_channels_first(x: torch.Tensor, num_frames: int) -> torch.Tensor:
    """[B·F, C, h, w] → contiguous [B, C, F, h, w]."""
    bf, c, h, w = x.shape
    return x.reshape(bf // num_frames, num_frames, c, h, w).transpose(1, 2).contiguous()


class MLPEmbedding(nn.Sequential):
    """Linear → SiLU → Linear with distinct widths: diffusers'
    ``nn.Sequential`` ``context_embedding`` (ctx → temb → 4·ctx) and
    ``fps_embedding`` (320 → temb → temb), indices 0 and 2."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__(nn.Linear(in_dim, hidden_dim), nn.SiLU(), nn.Linear(hidden_dim, out_dim))


class TemporalConvLayer(nn.Module):
    """diffusers ``TemporalConvLayer``: four GroupNorm → SiLU → conv-over-frames
    stages and one residual. ``convK`` is diffusers' ``nn.Sequential`` (norm at
    0, conv at 2, or at 3 behind the dropout slot of stages 2-4); the forward
    runs slots 0 and 1 as one ``norm_act`` (GroupNorm and SiLU in one kernel
    launch on a card), then the conv."""

    def __init__(self, channels: int, norm_num_groups: int):
        super().__init__()

        def stage(i):
            layers = [nn.GroupNorm(norm_num_groups, channels, eps=1e-5), nn.SiLU()]
            if i > 1:
                layers.append(nn.Identity())  # diffusers' Dropout, off at inference
            layers.append(nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0)))
            return nn.Sequential(*layers)

        self.conv1, self.conv2, self.conv3, self.conv4 = (stage(i) for i in range(1, 5))

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        """x: [B·F, C, h, w]."""
        y = _frames_channels_first(x, num_frames)
        for stage in (self.conv1, self.conv2, self.conv3, self.conv4):
            y = stage[-1](norm_act(stage[0], y))  # slots 0-1 in one op; slot 2 is off
        return x + y.transpose(1, 2).reshape(x.shape)


class TemporalBasicBlock(nn.Module):
    """diffusers ``BasicTransformerBlock`` with ``double_self_attention``:
    two self-attentions over the frame axis and a GEGLU MLP."""

    def __init__(self, dim: int, heads: int, dim_head: int, quant: Optional[str] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head, quant=quant)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, quant=quant)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim, quant)

    def forward(self, x):  # [N, F, C]
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x))
        return x + self.ff(self.norm3(x))


class TransformerTemporalModel(nn.Module):
    """diffusers ``TransformerTemporalModel``: GroupNorm over (channel group,
    frames, rows, columns), linear in, frame-axis transformer blocks over
    every pixel row, linear out, residual."""

    def __init__(self, in_channels: int, heads: int, dim_head: int, num_layers: int = 1,
                 norm_num_groups: int = 32, quant: Optional[str] = None):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(norm_num_groups, in_channels, eps=1e-6)
        self.proj_in = linear(in_channels, inner, quant=quant)
        self.transformer_blocks = nn.ModuleList(
            [TemporalBasicBlock(inner, heads, dim_head, quant) for _ in range(num_layers)])
        self.proj_out = linear(inner, in_channels, quant=quant)

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        """x: [B·F, C, h, w]."""
        bf, c, h, w = x.shape
        b = bf // num_frames
        y = norm_act(self.norm, _frames_channels_first(x, num_frames), silu=False)  # [B, C, F, h, w]
        y = self.proj_in(y.permute(0, 3, 4, 2, 1).reshape(b * h * w, num_frames, c))
        for block in self.transformer_blocks:
            y = block(y)
        return x + _from_pixel_seq(self.proj_out(y), b, h, w)


class GELUProjection(nn.Module):
    """diffusers' ``GELU`` activation module: a linear ``proj``, then the
    exact (erf) GELU."""

    def __init__(self, dim: int, inner_dim: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner_dim)

    def forward(self, x):
        return F.gelu(self.proj(x))


class GELUFeedForward(nn.Module):
    """diffusers ``FeedForward(activation_fn="gelu")``: proj → gelu → out."""

    def __init__(self, dim: int, inner_dim: int):
        super().__init__()
        self.net = nn.ModuleList([GELUProjection(dim, inner_dim), nn.Identity(),
                                  nn.Linear(inner_dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class ImageLatentsTemporalEncoder(nn.Module):
    """``I2VGenXLTransformerTemporalEncoder``: norm1 → attn1 (+ residual),
    then the MLP (+ residual) with no norm before it (an upstream quirk)."""

    def __init__(self, dim: int, heads: int, dim_head: int, ff_inner_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head)
        self.ff = GELUFeedForward(dim, ff_inner_dim)

    def forward(self, x):  # [N, F, C]
        x = x + self.attn1(self.norm1(x))
        return x + self.ff(x)


class ContextPool(nn.Module):
    """Average pool to ``size``² with window and stride h // size, as the
    JAX model pools (diffusers' ``AdaptiveAvgPool2d`` at the sizes it
    allows); the latent size must be a multiple of ``size``."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x):
        stride = x.shape[2] // self.size
        if stride * self.size != x.shape[2]:
            raise ValueError(f"latent size {x.shape[2]} must be a multiple of "
                             f"context_pool_size {self.size}")
        return F.avg_pool2d(x, stride)


def _inject_first_frame(x, inject_copy, inject_interp, interp_ratio: float):
    """First-frame feature injection on [B, F, ...] features: with
    ``inject_copy`` every frame becomes frame 0; else with ``inject_interp``
    frames 1.. become ``interp_ratio``·frame0 + (1 - ``interp_ratio``)·frame;
    with both flags off (0 or False) x is returned as it is."""
    first = x[:, :1]
    if inject_copy > 0:
        return first.expand_as(x)
    if inject_interp > 0:
        return torch.cat([first, interp_ratio * first + (1.0 - interp_ratio) * x[:, 1:]], dim=1)
    return x


class UNet3DBlock(UNetBlock):
    """One down/mid/up level with its temporal layers (diffusers'
    ``*Block3D`` containers; the UNet drives them)."""

    def __init__(self, resnets, temp_convs, attentions, temp_attentions, downsamplers=None,
                 upsamplers=None):
        super().__init__(resnets, attentions, downsamplers, upsamplers)
        self.temp_convs = nn.ModuleList(temp_convs)
        self.temp_attentions = nn.ModuleList(temp_attentions)


class UNet3DConditionModel(nn.Module):
    """I2VGen-XL denoising UNet.

    forward(sample [B,F,h,w,4], timestep, encoder_hidden_states [B,S,ctx],
    image_latents [B,F,h,w,4], image_embeddings [B,1,ctx] or [B,ctx], fps,
    inject_copy, inject_interp, interp_ratio, cached_ctx, cached_il, cross_kv,
    return_cache) → eps [B,F,h,w,4] fp32. ``return_cache`` returns the
    step-invariant (context tokens [B,S',ctx], projected image latents
    [B,F,h,w,4]) instead; ``cached_ctx``/``cached_il`` take them back, and
    ``cross_kv`` ({name: (k, v)}, each [1, B·F, S', inner], already repeated
    over the frames) replaces every spatial cross-attention's K/V
    (``precompute_video_cache``). Parameters are created on ``device`` in
    ``config.dtype``.
    """

    def __init__(self, config: UNet3DConfig, device="cuda"):
        super().__init__()
        self.config = cfg = config
        with torch.device(resolve_device(device)):
            self._build(cfg)
        for name, m in self.named_modules():
            if isinstance(m, QLinear):
                m.site = quant_site(name)
        self.to(cfg.dtype)

    def _build(self, cfg: UNet3DConfig):
        c0, temb_ch, cin = cfg.block_out_channels[0], cfg.time_embed_dim, cfg.in_channels
        ctx_dim, groups, hd = cfg.cross_attention_dim, cfg.norm_num_groups, cfg.attention_head_dim
        quant = cfg.quant
        self.conv_in = nn.Conv2d(2 * cin, c0, 3, padding=1)  # noisy latent + image latent
        self.time_embedding = TimestepEmbedding(c0, temb_ch)
        self.fps_embedding = MLPEmbedding(c0, temb_ch, temb_ch)
        self.context_embedding = MLPEmbedding(ctx_dim, temb_ch, ctx_dim * cin)
        self.image_latents_context_embedding = nn.Sequential(
            nn.Conv2d(cin, cin * 8, 3, padding=1), nn.SiLU(), ContextPool(cfg.context_pool_size),
            nn.Conv2d(cin * 8, cin * 16, 3, stride=2, padding=1), nn.SiLU(),
            nn.Conv2d(cin * 16, ctx_dim, 3, stride=2, padding=1),
        )
        self.image_latents_proj_in = nn.Sequential(
            nn.Conv2d(cin, cin * 4, 3, padding=1), nn.SiLU(),
            nn.Conv2d(cin * 4, cin * 4, 3, padding=1), nn.SiLU(),
            nn.Conv2d(cin * 4, cin, 3, padding=1),
        )
        self.image_latents_temporal_encoder = ImageLatentsTemporalEncoder(cin, 2, cin, cin * 4)
        self.transformer_in = TransformerTemporalModel(c0, 8, hd, 1, groups, quant)

        def heads(ch):
            return max(1, ch // hd)

        def level_layers(in_ch, out_ch, has_attn):
            return (ResnetBlock2D(in_ch, out_ch, temb_ch, groups, quant),
                    TemporalConvLayer(out_ch, groups),
                    Transformer2DModel(out_ch, heads(out_ch), hd, 1, ctx_dim, groups,
                                       quant=quant) if has_attn else None,
                    TransformerTemporalModel(out_ch, heads(out_ch), hd, 1, groups,
                                             quant) if has_attn else None)

        def block(layers, **samplers):
            resnets, convs, attns, temps = zip(*layers)
            return UNet3DBlock(resnets, convs, [a for a in attns if a is not None],
                               [t for t in temps if t is not None], **samplers)

        n_levels = len(cfg.block_out_channels)
        self.down_blocks = nn.ModuleList()
        skip_channels = [c0]
        in_ch = c0
        for level, block_type in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[level]
            layers = []
            for _ in range(cfg.layers_per_block):
                layers.append(level_layers(in_ch, out_ch, block_type == "CrossAttnDownBlock3D"))
                in_ch = out_ch
                skip_channels.append(out_ch)
            samplers = []
            if level < n_levels - 1:
                samplers.append(Downsample2D(out_ch, quant))
                skip_channels.append(out_ch)
            self.down_blocks.append(block(layers, downsamplers=samplers))

        mid_ch = cfg.block_out_channels[-1]
        mid = [level_layers(mid_ch, mid_ch, True), level_layers(mid_ch, mid_ch, False)]
        self.mid_block = block(mid)

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(cfg.block_out_channels))
        in_ch = mid_ch
        for i, block_type in enumerate(cfg.up_block_types):
            out_ch = rev[i]
            layers = []
            for _ in range(cfg.layers_per_block + 1):
                layers.append(level_layers(in_ch + skip_channels.pop(), out_ch,
                                           block_type == "CrossAttnUpBlock3D"))
                in_ch = out_ch
            samplers = [Upsample2D(out_ch, quant)] if i < n_levels - 1 else []
            self.up_blocks.append(block(layers, upsamplers=samplers))

        self.conv_norm_out = nn.GroupNorm(groups, c0, eps=1e-5)
        self.conv_out = nn.Conv2d(c0, cfg.out_channels, 3, padding=1)

    def transformer(self, name: str) -> Transformer2DModel:
        """The spatial transformer that ``video_cross_attention_names`` calls
        ``name`` (e.g. ``down_blocks_1_attentions_0``, ``mid_block_attentions_0``)."""
        if name.startswith("mid_block_attentions_"):
            return self.mid_block.attentions[int(name.rsplit("_", 1)[1])]
        kind, level, _, j = name.rsplit("_", 3)
        blocks = self.down_blocks if kind == "down_blocks" else self.up_blocks
        return blocks[int(level)].attentions[int(j)]

    def context_tokens(self, encoder_hidden_states, image_latents, image_embeddings):
        """[text, frame-0 conv tokens, 4 image-embedding tokens] → [B, S', ctx]."""
        cfg = self.config
        b, cin = image_latents.shape[0], cfg.in_channels
        if image_embeddings.dim() == 2:
            image_embeddings = image_embeddings[:, None]
        frame0 = image_latents[:, 0].to(cfg.dtype).permute(0, 3, 1, 2)  # raw first-frame latent
        img_ctx = self.image_latents_context_embedding(frame0).permute(0, 2, 3, 1)
        img_ctx = img_ctx.reshape(b, -1, cfg.cross_attention_dim)
        img_emb = self.context_embedding(image_embeddings.to(cfg.dtype))
        img_emb = img_emb.reshape(b, cin, cfg.cross_attention_dim)
        return torch.cat([encoder_hidden_states.to(cfg.dtype), img_ctx, img_emb], dim=1)

    def project_image_latents(self, image_latents):
        """Conv projection and temporal encoder of every frame's image latent:
        [B, F, h, w, 4] → [B, F, h, w, 4] (concatenated to the sample at conv_in)."""
        b = image_latents.shape[0]
        il = self.image_latents_proj_in(fold_frames(image_latents.to(self.config.dtype)))
        h, w = il.shape[2:]
        seq = self.image_latents_temporal_encoder(_to_pixel_seq(il, b))
        return unfold_frames(_from_pixel_seq(seq, b, h, w), b)

    def forward(self, sample, timestep, encoder_hidden_states, image_latents, image_embeddings,
                fps, inject_copy=0.0, inject_interp=0.0, interp_ratio: float = 0.7,
                cached_ctx=None, cached_il=None, cross_kv=None, return_cache: bool = False):
        cfg = self.config
        dtype = cfg.dtype
        b, f = sample.shape[:2]
        dev = sample.device
        ctx = (self.context_tokens(encoder_hidden_states, image_latents, image_embeddings)
               if cached_ctx is None else cached_ctx.to(dtype))
        il = self.project_image_latents(image_latents) if cached_il is None else cached_il.to(dtype)
        if return_cache:
            return ctx, il

        c0 = cfg.block_out_channels[0]

        def inject(x, copy, interp):
            if not (copy > 0 or interp > 0):
                return x
            y = _inject_first_frame(x.reshape(b, f, *x.shape[1:]), copy, interp, interp_ratio)
            return y.reshape(x.shape)

        def spatial_attn(blk, j, name, x):
            kv = None if cross_kv is None else cross_kv[name]
            return blk.attentions[j](x, ctx_f, None, kv=kv)

        def level(blk, j, name, x, copy=0.0, interp=0.0):
            x = inject(blk.resnets[j](x, temb_f), copy, interp)
            x = blk.temp_convs[j](x, f)
            if j < len(blk.attentions):
                x = spatial_attn(blk, j, name, x)
                x = blk.temp_attentions[j](x, f)
            return x

        with span("unet", rows=b):
            with span("unet.embed"):
                timestep = torch.as_tensor(timestep, device=dev).expand(b)
                fps = torch.as_tensor(fps, dtype=torch.float32, device=dev).expand(b)
                temb = self.time_embedding(timestep_embedding(timestep, c0).to(dtype))
                temb = temb + self.fps_embedding(timestep_embedding(fps, c0).to(dtype))
                temb_f = temb.repeat_interleave(f, dim=0)  # per folded frame
                ctx_f = ctx.repeat_interleave(f, dim=0) if cross_kv is None else None

            x = self.conv_in(fold_frames(torch.cat([sample.to(dtype), il], dim=-1)))
            x = self.transformer_in(x, f)

            res_stack = [x]
            for lvl, blk in enumerate(self.down_blocks):
                with span(f"unet.down.{lvl}"):
                    for j in range(len(blk.resnets)):
                        x = level(blk, j, f"down_blocks_{lvl}_attentions_{j}", x)
                        res_stack.append(x)
                    for sampler in blk.downsamplers:
                        x = sampler(x)
                        res_stack.append(x)

            # mid, with the hard-copy injection at each resnet's output
            with span("unet.mid"):
                x = level(self.mid_block, 0, "mid_block_attentions_0", x, copy=inject_copy)
                x = level(self.mid_block, 1, None, x, copy=inject_copy)

            for i, blk in enumerate(self.up_blocks):
                with span(f"unet.up.{i}"):
                    for j in range(len(blk.resnets)):
                        x = torch.cat([x, res_stack.pop()], dim=1)
                        # the interpolated injection after up_blocks[1].resnets[0]
                        interp = inject_interp if (i, j) == (1, 0) else 0.0
                        x = level(blk, j, f"up_blocks_{i}_attentions_{j}", x, interp=interp)
                    for sampler in blk.upsamplers:
                        x = sampler(x)

            x = self.conv_out(norm_act(self.conv_norm_out, x))
            return unfold_frames(x, b).float()


def video_cross_attention_names(cfg: UNet3DConfig):
    """Names of every spatial cross-attention transformer, in call order."""
    names = []
    for level, btype in enumerate(cfg.down_block_types):
        if btype == "CrossAttnDownBlock3D":
            for j in range(cfg.layers_per_block):
                names.append(f"down_blocks_{level}_attentions_{j}")
    names.append("mid_block_attentions_0")
    for i, btype in enumerate(cfg.up_block_types):
        if btype == "CrossAttnUpBlock3D":
            for j in range(cfg.layers_per_block + 1):
                names.append(f"up_blocks_{i}_attentions_{j}")
    return names


def precompute_video_cache(unet: UNet3DConditionModel, encoder_hidden_states, image_latents,
                           image_embeddings, fps):
    """Every step-invariant piece of the video UNet, once per trajectory:
    the context tokens, the projected image latents and every spatial
    cross-attention's K/V over that context, the K/V already repeated over
    the F frames of each clip row (b-major, as the frames are folded) so no
    step repeats them. Returns ``(cached_ctx, cached_il, cross_kv)`` for
    ``UNet3DConditionModel.forward``; ``cross_kv[name]`` is (k, v), each
    [1, B·F, S', inner]."""
    ctx, il = unet(image_latents, 0, encoder_hidden_states, image_latents, image_embeddings,
                   fps, return_cache=True)
    f = image_latents.shape[1]
    kv = {}
    for name in video_cross_attention_names(unet.config):
        k, v = unet.transformer(name).transformer_blocks[0].attn2.kv(ctx, None, precomputed=True)
        kv[name] = (k.repeat_interleave(f, dim=0)[None], v.repeat_interleave(f, dim=0)[None])
    return ctx, il, kv
