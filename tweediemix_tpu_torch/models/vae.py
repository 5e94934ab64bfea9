"""SDXL AutoencoderKL: encoder, decoder, latent scaling (counterpart of
``tweediemix_tpu/models/vae.py``).

Decoding runs in fp32, like the reference's upcast VAE. The mid-trajectory
Tweedie preview uses the reference's 1/0.18215 scale; the final decode uses
``scaling_factor`` (0.13025 for SDXL) and, when the config has them,
``latents_mean``/``latents_std``. Public functions take and return NHWC
tensors; inside, activations are NCHW. Module names follow the diffusers
checkpoint layout.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tweediemix_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025
    preview_scaling_factor: float = 0.18215
    latents_mean: Tuple[float, ...] | None = None
    latents_std: Tuple[float, ...] | None = None
    dtype: torch.dtype = torch.float32

    @staticmethod
    def sdxl(**kw) -> "VAEConfig":
        return VAEConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "VAEConfig":
        defaults = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)
        defaults.update(kw)
        return VAEConfig(**defaults)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels, out_channels, groups):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block.

    At a 1024² decode this is c=512 over 16384 tokens: a 1 GiB fp32 score
    matrix, computed as plain fp32 math (dh=512 is outside the flash
    kernel's head dims, as it is outside the TPU kernel's)."""

    def __init__(self, channels, groups):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        res = x
        x = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        s = torch.bmm(q.float(), k.float().transpose(1, 2)) * (c**-0.5)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        del s
        out = self.to_out[0](torch.bmm(p, v))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + res


class VAEDownsample(nn.Module):
    """Strided conv with diffusers' asymmetric (0, 1) padding."""

    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VAEUpsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VAEBlock(nn.Module):
    def __init__(self, resnets, attentions=(), downsamplers=None, upsamplers=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsamplers is not None:
            self.downsamplers = nn.ModuleList(downsamplers)
        if upsamplers is not None:
            self.upsamplers = nn.ModuleList(upsamplers)


def _mid_block(ch, groups):
    return VAEBlock([VAEResnetBlock(ch, ch, groups), VAEResnetBlock(ch, ch, groups)],
                    [VAEAttention(ch, groups)])


def _run_mid(mid, x):
    x = mid.resnets[0](x)
    x = mid.attentions[0](x)
    return mid.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        in_ch = chs[0]
        for i, ch in enumerate(chs):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(VAEResnetBlock(in_ch, ch, g))
                in_ch = ch
            down = [VAEDownsample(ch)] if i < len(chs) - 1 else []
            self.down_blocks.append(VAEBlock(resnets, downsamplers=down))
        self.mid_block = _mid_block(chs[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            for down in block.downsamplers:
                x = down(x)
        x = _run_mid(self.mid_block, x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid_block(rev[0], g)
        self.up_blocks = nn.ModuleList()
        in_ch = rev[0]
        for i, ch in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(VAEResnetBlock(in_ch, ch, g))
                in_ch = ch
            up = [VAEUpsample(ch)] if i < len(rev) - 1 else []
            self.up_blocks.append(VAEBlock(resnets, upsamplers=up))
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            for up in block.upsamplers:
                x = up(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """encode → (mean, logvar) via quant_conv; decode via post_quant_conv.
    Parameters are created on ``device`` in ``config.dtype``."""

    def __init__(self, config: VAEConfig, device="cuda"):
        super().__init__()
        self.config = cfg = config
        with torch.device(resolve_device(device)):
            self.encoder = Encoder(cfg)
            self.decoder = Decoder(cfg)
            self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
            self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.to(cfg.dtype)

    def encode(self, x):
        """[B,H,W,3] → (mean, logvar), each [B,H/8,W/8,4] (pre-scaling)."""
        x = x.to(self.config.dtype).permute(0, 3, 1, 2)
        moments = self.quant_conv(self.encoder(x)).permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        """[B,h,w,4] (unscaled) → [B,H,W,3] in about [-1, 1]."""
        z = z.to(self.config.dtype).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)


def scale_latents(latents, cfg: VAEConfig):
    """encoder output → diffusion latent space (training convention)."""
    return latents * cfg.scaling_factor


def unscale_latents(latents, cfg: VAEConfig, preview: bool = False):
    """diffusion latent → decoder input. ``preview=True`` is the reference's
    1/0.18215 Tweedie-preview scale. With ``latents_mean``/``latents_std``
    in the config the final decode denormalises with them
    (``x * std / scaling_factor + mean``, over the trailing channel axis)."""
    if preview:
        return latents / cfg.preview_scaling_factor
    if cfg.latents_mean is not None and cfg.latents_std is not None:
        mean = torch.tensor(cfg.latents_mean, dtype=latents.dtype, device=latents.device)
        std = torch.tensor(cfg.latents_std, dtype=latents.dtype, device=latents.device)
        return latents * std / cfg.scaling_factor + mean
    return latents / cfg.scaling_factor


def postprocess_image(img):
    """decoder output [-1, 1] → [0, 1] clamped."""
    return torch.clamp(img / 2 + 0.5, 0.0, 1.0)
